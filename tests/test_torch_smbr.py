"""sMBR training of the PyTorch port (train/smbr.py and ``--smbr_cmd``)
against the JAX package, on the CPU:

* ``external_grad_step`` against the JAX step (a vjp pullback) and
  against autograd of the surrogate loss sum(logits * out_grad);
* ``run_smbr_training`` with a fake lattice runner (softmax - uniform on
  the posteriors, one utterance left out, one gradient too long) against
  JAX's: the parameters after the epoch, the epoch pickle, the warnings;
* the bridge on the committed fixtures of ``tests/fixtures/smbr/`` (bytes
  written by a Kaldi-spec packer, not by either package) and through a
  subprocess command with the {post}/{grad}/{trans} placeholders;
* the port's CLI with ``--smbr_cmd`` and ``--tr_trans_file`` on a small
  dense conformer, the lattice tool a Python script.

Small dense conformer (width 16, 1 block); inputs from numpy seeds.
Tolerances: parameters within rtol 1e-5 of each leaf's largest value
(float32 sums in another order)."""

import logging
import os
import pickle
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from m3asr_tpu.config import EncoderConfig as JEncoderConfig
from m3asr_tpu.io.kaldi_io import ArkWriter as JArkWriter
from m3asr_tpu.io.kaldi_io import read_ark as j_read_ark
from m3asr_tpu.io.loader import DataLoader as JLoader
from m3asr_tpu.models import conformer as j_conformer
from m3asr_tpu.train import lr_scheduler as j_lr
from m3asr_tpu.train import smbr as j_smbr

from m3asr_tpu_torch.checkpoint import (flatten_tree, params_from_jax,
                                        params_to_numpy)
from m3asr_tpu_torch.config import EncoderConfig
from m3asr_tpu_torch.io.kaldi_io import ArkWriter, read_ark
from m3asr_tpu_torch.io.loader import DataLoader
from m3asr_tpu_torch.models import conformer as t_conformer
from m3asr_tpu_torch.train import cli
from m3asr_tpu_torch.train import lr_scheduler as t_lr
from m3asr_tpu_torch.train import smbr as t_smbr

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "smbr")
ENC = dict(attention_dim=16, attention_heads=4, linear_units=24,
           num_blocks=1)
IN, OUT = 8, 5
SGD = ("constant", {}, 0.1, "sgd", {"momentum": 0.9})


def small_tree(seed=0):
    tree = jax.tree.map(np.asarray, j_conformer.init(
        jax.random.PRNGKey(seed), JEncoderConfig(**ENC), IN, OUT))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a if a.dtype.kind != "f" else (
        rng.standard_normal(a.shape) * 0.3).astype(np.float32), tree)


def j_fwd(p, x, lens):
    return j_conformer.forward(p, JEncoderConfig(**ENC), x, lens)


def t_fwd(p, x, lens):
    return t_conformer.forward(p, EncoderConfig(**ENC), x, lens)


def assert_params_close(got, ref, rtol=1e-5):
    ref = flatten_tree(jax.tree.map(np.asarray, ref))
    got = flatten_tree(params_to_numpy(got))
    assert sorted(got) == sorted(ref)
    for k in ref:
        tol = rtol * max(np.abs(ref[k]).max(), 1e-3)
        assert np.abs(got[k] - ref[k]).max() <= tol, k


def test_external_grad_step_matches_jax_and_surrogate():
    """One SGD-momentum update from out_grad: the port's parameters equal
    the JAX step's, and the update of autograd's gradient of the surrogate
    sum(logits * out_grad); out_len equals."""
    tree = small_tree(1)
    rng = np.random.default_rng(2)
    feat = rng.standard_normal((2, 23, IN)).astype(np.float32)
    lens = np.array([23, 15], np.int32)
    g = rng.standard_normal((2, 5, OUT)).astype(np.float32)
    jopt = j_lr.build_optimizer(*SGD)
    jp = jax.tree.map(jnp.asarray, tree)
    jnew, _, jlen = j_smbr.external_grad_step(
        j_fwd, jp, jopt.init(jp), jopt, jnp.asarray(feat), jnp.asarray(lens),
        g)
    topt = t_lr.build_optimizer(*SGD)
    tp = params_from_jax(tree)
    state = topt.init({k: v for k, v in flatten_tree(tp).items()})
    tnew, _, tlen = t_smbr.external_grad_step(
        t_fwd, tp, state, topt, torch.from_numpy(feat),
        torch.from_numpy(lens), g)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert_params_close(tnew, jnew)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in flatten_tree(tp).items()}
    from m3asr_tpu_torch.checkpoint import unflatten_tree
    out, _ = t_fwd(unflatten_tree(leaves), torch.from_numpy(feat),
                   torch.from_numpy(lens))
    (out * torch.from_numpy(g)).sum().backward()
    grads = {k: v.grad for k, v in leaves.items()}
    flat = flatten_tree(tp)
    upd, _ = topt.update(grads, topt.init(flat), flat)
    want = topt.apply_updates(flat, upd)
    for k, v in flatten_tree(tnew).items():
        torch.testing.assert_close(v, want[k], rtol=1e-5, atol=1e-6)


def _utterances(d, n=4, seed=3):
    rng = np.random.default_rng(seed)
    with ArkWriter(str(d / "f.ark")) as w:
        for i in range(n):
            w.write(f"u{i}", rng.standard_normal((11 + 4 * i, IN))
                    .astype(np.float32))
    with open(d / "trans.txt", "w") as f:
        for i in range(n):
            f.write(f"u{i} tok{i}\n")


def fake_tool(writer, reader, drop="u1", longer="u2"):
    """A lattice runner: softmax(posteriors) - 1/V for each utterance but
    ``drop``; ``longer``'s gradient gets 3 frames too many."""
    def run(post_ark, grad_ark):
        with writer(grad_ark) as w:
            for key, mat in reader(post_ark):
                if key == drop:
                    continue
                e = np.exp(mat - mat.max(-1, keepdims=True))
                g = (e / e.sum(-1, keepdims=True)
                     - 1.0 / mat.shape[-1]).astype(np.float32)
                if key == longer:
                    g = np.concatenate([g, np.ones((3, g.shape[1]),
                                                   np.float32)])
                w.write(key, g)
    return run


class Collect(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_run_smbr_training_matches_jax(tmp_path):
    """One epoch of two batches (batch 2, trans_file stream) with the fake
    runner: the parameters after it and smbr_epoch0.pkl within rtol 1e-5
    of JAX's; both skip u1 and clamp u2 with the same warnings."""
    _utterances(tmp_path)
    tree = small_tree(4)
    runs = {}
    for side, Loader, Writer, reader, fwd, build, to in (
            ("jax", JLoader, JArkWriter, j_read_ark, j_fwd, j_lr, None),
            ("torch", DataLoader, ArkWriter, read_ark, t_fwd, t_lr,
             params_from_jax)):
        work = tmp_path / side
        work.mkdir()
        loader = Loader(str(tmp_path / "f.ark"),
                        loader_conf={"feat_dim": IN, "batch_size": 2},
                        trans_file=str(tmp_path / "trans.txt"))
        logger = logging.getLogger(f"smbr_test_{side}")
        handler = Collect()
        logger.addHandler(handler)
        params = (jax.tree.map(jnp.asarray, tree) if to is None
                  else to(tree))
        runner = j_smbr if side == "jax" else t_smbr
        new, _, n = runner.run_smbr_training(
            None, fwd, params, build.build_optimizer(*SGD),
            make_loader=lambda: loader(output_keys=True),
            bridge=runner.KaldiLatticeBridge(runner=fake_tool(Writer,
                                                              reader)),
            work_dir=str(work), max_epochs=1, logger=logger)
        logger.removeHandler(handler)
        with open(work / "smbr_epoch0.pkl", "rb") as f:
            saved = pickle.load(f)
        runs[side] = (new, n, saved, handler.lines)
    (jnew, jn, jsaved, jlog), (tnew, tn, tsaved, tlog) = (runs["jax"],
                                                          runs["torch"])
    assert tn == jn == 2
    assert tlog == jlog and len(tlog) == 2
    assert "no gradient for 'u1'" in tlog[0] and "'u2'" in tlog[1]
    assert_params_close(tnew, jnew)
    assert_params_close(params_from_jax(tsaved), jsaved)
    moved = max(np.abs(a - b).max() for a, b in zip(
        flatten_tree(tsaved).values(), flatten_tree(tree).values()))
    assert moved > 1e-6


def _expected():
    return np.load(os.path.join(FIXDIR, "expected.npz"))


def test_bridge_reads_committed_fixtures(tmp_path):
    """The bridge reads a gradient ark it did not write (a copy of the
    committed float ark), and the port's reader parses the committed
    double, text and compressed arks as the fixtures say (the compressed
    one within its quantization step, range / 63)."""
    exp = _expected()
    bridge = t_smbr.KaldiLatticeBridge(runner=lambda post, grad: shutil.copy(
        os.path.join(FIXDIR, "grad.ark"), grad))
    grads = bridge(["utt1", "utt2"], np.zeros((2, 7, 5), np.float32),
                   np.array([7, 4]), str(tmp_path / "post.ark"),
                   str(tmp_path / "grad.ark"))
    np.testing.assert_array_equal(grads["utt1"], exp["utt1"])
    np.testing.assert_array_equal(grads["utt2"], exp["utt2"])
    got = dict(read_ark(os.path.join(FIXDIR, "grad_dm.ark")))
    np.testing.assert_allclose(got["uttd"], exp["uttd"], rtol=1e-6)
    got = dict(read_ark(os.path.join(FIXDIR, "post_text.ark")))
    np.testing.assert_allclose(got["uttt"], exp["uttt"], atol=1e-6)
    got = dict(read_ark(os.path.join(FIXDIR, "grad_cm.ark")))
    span = float(exp["uttc"].max() - exp["uttc"].min())
    np.testing.assert_allclose(got["uttc"], exp["uttc"],
                               atol=span / 63 + 1e-6)


TOOL = '''import sys
import numpy as np
from m3asr_tpu_torch.io.kaldi_io import ArkWriter, read_ark
post, grad, trans = sys.argv[1:4]
n = sum(1 for _ in open(trans))
with ArkWriter(grad) as w:
    for k, m in read_ark(post):
        e = np.exp(m - m.max(-1, keepdims=True))
        w.write(k, (e / e.sum(-1, keepdims=True) / n).astype(np.float32))
'''


@pytest.fixture
def repo_on_path(monkeypatch):
    """PYTHONPATH holding the repo, for a tool run as a subprocess."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    old = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH", root + (os.pathsep + old if old else ""))


def test_bridge_command_substitutes_placeholders(tmp_path, repo_on_path):
    """A command's {post}/{grad}/{trans} reach the subprocess; the
    transcript lines land beside the posterior ark."""
    (tmp_path / "tool.py").write_text(TOOL)
    bridge = t_smbr.KaldiLatticeBridge(command=[
        sys.executable, str(tmp_path / "tool.py"), "{post}", "{grad}",
        "{trans}"])
    logits = np.zeros((2, 3, 4), np.float32)
    grads = bridge(["a", "b"], logits, np.array([3, 2]),
                   str(tmp_path / "p.ark"), str(tmp_path / "g.ark"),
                   trans=["a one", "b two"])
    np.testing.assert_allclose(grads["a"], np.full((3, 4), 0.125))
    assert grads["b"].shape == (2, 4)
    assert (tmp_path / "p.ark.trans").read_text() == "a one\nb two\n"


def test_cli_smbr_trains_the_dense_conformer(tmp_path, repo_on_path):
    """python -m m3asr_tpu_torch.train --smbr_cmd '<python tool.py {post}
    {grad} {trans}>' --tr_trans_file on the dense conformer (CPU): two
    batches, smbr_epoch0.pkl written with the returned parameters, which
    moved from the seeded init, a train.log and the transcripts beside the
    posteriors; it returns (params, opt_state, 2)."""
    _utterances(tmp_path)
    (tmp_path / "tool.py").write_text(TOOL)
    from test_torch_train_cli import write_int_vectors
    write_int_vectors(tmp_path / "labels.ark",
                      {f"u{i}": [1, 2] for i in range(4)})
    raw = {"nnet_proto": "conformer", "input_dim": IN, "output_dim": OUT,
           "model_conf": dict(ENC), "log_period": 1, "max_epoch": 1,
           "schedule_type": "constant", "lr": 0.05, "optim": "sgd",
           "loader_conf": {"feat_dim": IN, "batch_size": 2}}
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump(raw, f)
    out = tmp_path / "exp"
    params, _, n = cli.main([
        "--config", str(tmp_path / "cfg.yaml"), "--output_dir", str(out),
        "--tr_rspecifier", str(tmp_path / "f.ark"),
        "--tr_labels", str(tmp_path / "labels.ark"),
        "--tr_trans_file", str(tmp_path / "trans.txt"),
        "--smbr_cmd", f"{sys.executable} {tmp_path / 'tool.py'} {{post}} "
                      "{grad} {trans}", "--device", "cpu"])
    assert n == 2
    with open(out / "smbr_epoch0.pkl", "rb") as f:
        saved = flatten_tree(pickle.load(f))
    got = flatten_tree(params_to_numpy(params))
    assert sorted(saved) == sorted(got)
    assert all(np.array_equal(saved[k], got[k]) for k in got)
    from m3asr_tpu_torch.config import model_config_from_dict
    from m3asr_tpu_torch.models.registry import get_family
    cfg = model_config_from_dict(dict(raw, input_dim=IN))
    init = flatten_tree(params_to_numpy(get_family("conformer").init(
        cfg, torch.Generator().manual_seed(0))))
    assert max(np.abs(init[k] - got[k]).max() for k in got) > 1e-6
    assert (out / "train.log").exists()
    assert os.path.exists(out / "post.ark.trans")
