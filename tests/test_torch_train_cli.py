"""The port's training CLI (``python -m m3asr_tpu_torch.train``, run in
process through ``train.cli.main``) and package-level API on the CPU:

* the CTC recipe and the hier recipe with the domain/accent heads on a
  tiny Kaldi ark (the small model of ``test_torch_model``, AED decoders
  of one block), with SpecAugment on the device, two accumulated
  microbatches and flash attention: the files it writes, and a resumed
  run that starts from checkpoint_last.pkl; a small DFSMN proto with its
  in-model heads in BMUF mode, run and resumed;
* what the CLI builds from a YAML that sets every key it reads (the
  model config, TrainConfig / HierTrainConfig, the optimizer's arguments
  and its updates, the parameter tree, the Trainer's settings) against
  what the root ``train.py`` builds from the same YAML and arks; the same
  for a DFSMN proto with its in-model heads, for ``--bmuf`` (the BMUF
  recipe's settings and the stacked trees) and for ``--smbr_cmd`` (what
  reaches ``run_smbr_training``);
* the exits that mirror the root ``train.py``'s, the parallel flags'
  among them;
* the loader's training options the flagship YAML sets (collate_conf
  spec_aug, batch_size, drop_last, the AED / domain / accent label
  streams) against the JAX loader on the same ark;
* ``build_engine`` with a .pt checkpoint and ``load_engine`` against the
  JAX package's ``build_engine``.
"""

import dataclasses
import os
import pickle
import random
import runpy
import struct
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

import m3asr_tpu
from m3asr_tpu.frontend.augment import CollateFunc as JCollate
from m3asr_tpu.io.loader import DataLoader as JLoader
from m3asr_tpu.train import lr_scheduler as j_lr
from m3asr_tpu.train import step as j_step
from m3asr_tpu.train import trainer as j_trainer

import m3asr_tpu_torch
from m3asr_tpu_torch.checkpoint import (flatten_tree, params_from_jax,
                                        params_to_numpy)
from m3asr_tpu_torch.frontend.augment import CollateFunc as TCollate
from m3asr_tpu_torch.io.kaldi_io import ArkWriter
from m3asr_tpu_torch.io.loader import DataLoader as TLoader
from m3asr_tpu_torch.train import cli
from m3asr_tpu_torch.train import lr_scheduler as t_lr
from m3asr_tpu_torch.train import step as t_step
from m3asr_tpu_torch.train import trainer as t_trainer

from test_torch_hier_train import hier_yaml

N_TRAIN, N_CV = 8, 3


def write_int_vectors(path, rows):
    with open(path, "wb") as f:
        for key, ids in rows.items():
            f.write(key.encode() + b" \x00B\x04" + struct.pack("<i", len(ids)))
            for x in ids:
                f.write(b"\x04" + struct.pack("<i", int(x)))


def _arks(d, prefix, n, rng):
    keys = [f"{prefix}{i}" for i in range(n)]
    with ArkWriter(str(d / f"{prefix}.ark")) as w:
        for k in keys:
            w.write(k, rng.standard_normal((rng.integers(30, 61), 20))
                    .astype(np.float32))
    write_int_vectors(d / f"{prefix}_labels.ark", {
        k: rng.integers(1, 10, rng.integers(2, 5)) for k in keys})
    write_int_vectors(d / f"{prefix}_aed.ark", {
        k: rng.integers(1, 10, rng.integers(2, 6)) for k in keys})
    write_int_vectors(d / f"{prefix}_domain.ark",
                      {k: [rng.integers(0, 3)] for k in keys})
    write_int_vectors(d / f"{prefix}_acc.ark",
                      {k: [rng.integers(0, 4)] for k in keys})


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(0)
    _arks(d, "tr", N_TRAIN, rng)
    _arks(d, "cv", N_CV, rng)
    raw = hier_yaml()
    raw["model_conf"]["encoder_conf"].update(output_dim_domain=3,
                                             output_dim_acc=4)
    raw.update(
        loader_conf={"feat_dim": 20, "batch_size": 2},
        collate_conf={"spec_aug": True,
                      "spec_aug_conf": {"max_t": 8, "max_f": 4}},
        log_period=1, save_period=2, attn_impl="flash", accum_steps=2,
        spec_aug_device=True, embed_ctc_weight=0.3, lr=2e-3,
        schedule_conf={"warmup_steps": 4})
    with open(d / "cfg.yaml", "w") as f:
        yaml.safe_dump(raw, f)
    return d


def _argv(work, out, *extra, hier=True):
    argv = ["--config", str(work / "cfg.yaml"), "--output_dir", str(out),
            "--tr_rspecifier", str(work / "tr.ark"),
            "--tr_labels", str(work / "tr_labels.ark"),
            "--cv_rspecifier", str(work / "cv.ark"),
            "--cv_labels", str(work / "cv_labels.ark"), "--device", "cpu"]
    if hier:
        argv += ["--tr_aed_labels", str(work / "tr_aed.ark"),
                 "--tr_domain_labels", str(work / "tr_domain.ark"),
                 "--tr_acc_labels", str(work / "tr_acc.ark")]
    return argv + list(extra)


@pytest.mark.parametrize("hier", [False, True])
def test_cli_trains_writes_and_resumes(work, tmp_path, hier):
    """One epoch of four steps (batch 2, two microbatches of one) writes
    train.log with every step's finite losses, scalars/scalars.jsonl, a
    TensorBoard event file and checkpoint_{last,best,final}.pkl; the hier
    recipe's tree carries the encoder, three decoders and both heads. A
    second run with --resume and --max_epochs 2 starts at global step 4
    from checkpoint_last.pkl's parameters, bit for bit, and ends at 8."""
    out = tmp_path / "exp"
    t1 = cli.main(_argv(work, out, "--max_epochs", "1", hier=hier))
    assert t1.global_step == N_TRAIN // 2 and t1.epoch == 1
    names = set(os.listdir(out))
    assert {"train.log", "scalars", "checkpoint_last.pkl",
            "checkpoint_best.pkl", "checkpoint_final.pkl"} <= names
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(out / "scalars"))
    log = (out / "train.log").read_text()
    steps = [line for line in log.splitlines() if " step " in line
             and "loss" in line]
    assert len(steps) == N_TRAIN // 2
    losses = [float(line.split(" loss ")[1].split()[0]) for line in steps]
    assert np.all(np.isfinite(losses))
    assert "valid loss" in log
    with open(out / "checkpoint_last.pkl", "rb") as f:
        last = pickle.load(f)
    tops = set(last["params"])
    assert tops == ({"encoder", "decoder", "decoder_1", "decoder_2",
                     "domain_head", "acc_head"} if hier
                    else set(t1.params))

    loaded = {}
    from m3asr_tpu_torch.train import trainer as tr_mod
    real = tr_mod.Trainer.load_checkpoint

    def spy(self, tag="last"):
        ok = real(self, tag)
        loaded["step"] = self.global_step
        loaded["params"] = {k: v.clone()
                            for k, v in flatten_tree(self.params).items()}
        return ok
    tr_mod.Trainer.load_checkpoint = spy
    try:
        t2 = cli.main(_argv(work, out, "--max_epochs", "2", "--resume",
                            hier=hier))
    finally:
        tr_mod.Trainer.load_checkpoint = real
    assert loaded["step"] == N_TRAIN // 2 and t2.global_step == N_TRAIN
    ref = flatten_tree(last["params"])
    assert sorted(ref) == sorted(loaded["params"])
    for k, v in ref.items():
        assert np.array_equal(loaded["params"][k].numpy(), v), k


# every key the CLIs read from a YAML, none at its default; the warmup is
# two steps and the decay large, so that the updates below show the
# name_nodecay mask
YAML_KEYS = dict(
    lr=2e-3, optim="adamw", optim_conf={"b1": 0.85, "eps": 1e-7},
    schedule_type="warmup_cosine",
    schedule_conf={"warmup": 0.04, "total_steps": 50},
    max_grad_norm=1.0, weight_decay=0.5, name_nodecay=["bias", "norm"],
    embed_ctc_weight=0.2, ce_weight=0.5, attn_impl="flash",
    compute_dtype="bfloat16", accum_steps=2, spec_aug_device=True,
    spec_aug_device_conf={"max_t": 4, "num_f_mask": 1}, ctc_weight=0.6,
    tap_weight=0.2, loss_scale=1e-3, lsm_weight=0.2, log_period=3,
    save_period=5, max_epoch=3)


class _Built(Exception):
    """Raised where a CLI would start its Trainer."""


def _capture(monkeypatch, lr_mod, step_mod, trainer_mod):
    """Records what a CLI hands build_optimizer (and what it returns), the
    step factory it calls (config, TrainConfig, heads) and the Trainer's
    parameters and settings; stops the CLI at the Trainer."""
    got = {}
    real_opt = lr_mod.build_optimizer

    def build_optimizer(*a, **k):
        got["opt_args"] = (a, {n: v for n, v in k.items() if n != "params"},
                           k.get("params") is not None)
        got["optimizer"] = real_opt(*a, **k)
        return got["optimizer"]
    monkeypatch.setattr(lr_mod, "build_optimizer", build_optimizer)
    for name in ("make_train_step", "make_hier_train_step"):
        def make(model_cfg, tcfg, optimizer, *a, _real=getattr(
                step_mod, name), _name=name, **k):
            got.update(factory=_name, model_cfg=model_cfg, tcfg=tcfg,
                       with_domain_acc=k.get("with_domain_acc", False))
            return _real(model_cfg, tcfg, optimizer, *a, **k)
        monkeypatch.setattr(step_mod, name, make)

    class Trainer:
        def __init__(self, model_cfg, params, optimizer, step, **k):
            got.update(params=params, trainer=k)
            raise _Built
    monkeypatch.setattr(trainer_mod, "Trainer", Trainer)
    return got


@pytest.mark.parametrize("hier", [False, True])
def test_cli_builds_what_train_py_builds(work, tmp_path, monkeypatch, hier):
    """The root train.py (run as a script) and the port's CLI on the same
    arks and a YAML that sets every key they read (schedule, AdamW with
    optim_conf, clip, weight decay and its name_nodecay mask, the step's
    and the hier recipe's weights, attention, compute type, accumulation,
    device SpecAugment, log and save periods, epochs), the CTC recipe and
    the hier recipe with the heads, each stopped where it starts its
    Trainer. The same step factory and heads; the model config, the
    TrainConfig / HierTrainConfig and build_optimizer's arguments equal
    field for field; the parameter trees the same leaves and shapes; the
    Trainer's settings equal. The two optimizers, from the JAX run's
    parameters, over three updates on the same random gradients: the
    parameters after each within rtol 1e-4 of each leaf's largest
    value."""
    with open(work / "cfg.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(YAML_KEYS)
    raw["loader_conf"]["mode"] = "ctc"
    cfg = tmp_path / "cfg.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    argv = _argv(work, tmp_path / "exp", hier=hier)
    argv[1] = str(cfg)
    i = argv.index("--device")
    root_argv = argv[:i] + argv[i + 2:] + ["--seed", "3"]

    ref = _capture(monkeypatch, j_lr, j_step, j_trainer)
    monkeypatch.setattr(sys, "argv", ["train.py"] + root_argv)
    monkeypatch.setattr(sys, "path", list(sys.path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with pytest.raises(_Built):
        runpy.run_path(os.path.join(root, "train.py"), run_name="__main__")
    got = _capture(monkeypatch, t_lr, t_step, t_trainer)
    with pytest.raises(_Built):
        cli.main(argv + ["--seed", "3"])

    assert got["factory"] == ref["factory"] == (
        "make_hier_train_step" if hier else "make_train_step")
    assert got["with_domain_acc"] == ref["with_domain_acc"] == hier
    assert dataclasses.asdict(got["model_cfg"]) == \
        dataclasses.asdict(ref["model_cfg"])
    assert type(got["tcfg"]).__name__ == type(ref["tcfg"]).__name__
    assert dataclasses.asdict(got["tcfg"]) == dataclasses.asdict(ref["tcfg"])
    assert got["opt_args"] == ref["opt_args"]
    ref_tree = flatten_tree(jax.tree.map(np.asarray, ref["params"]))
    got_tree = flatten_tree(params_to_numpy(got["params"]))
    assert {k: v.shape for k, v in got_tree.items()} == \
        {k: v.shape for k, v in ref_tree.items()}
    keep = ("batch_keys", "save_dir", "log_period", "save_period",
            "max_epochs", "step_takes_rng", "seed", "scalar_dir")
    assert {k: got["trainer"][k] for k in keep} == \
        {k: ref["trainer"][k] for k in keep}
    assert got["trainer"]["step_takes_rng"] and \
        got["trainer"]["log_period"] == 3

    rng = np.random.default_rng(2)
    jp = jax.tree.map(jnp.asarray, ref["params"])
    jopt, topt = ref["optimizer"], got["optimizer"]
    jstate = jax.jit(jopt.init)(jp)

    @jax.jit
    def jupdate(g, state, p):
        upd, state = jopt.update(g, state, p)
        return optax.apply_updates(p, upd), state
    tp = flatten_tree(params_from_jax(jax.tree.map(np.asarray, jp)))
    tstate = topt.init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.5)
                         .astype(np.float32), jax.tree.map(np.asarray, jp))
        jp, jstate = jupdate(g, jstate, jp)
        tu, tstate = topt.update(flatten_tree(params_from_jax(g)), tstate,
                                 tp)
        tp = topt.apply_updates(tp, tu)
        want = flatten_tree(params_from_jax(jax.tree.map(np.asarray, jp)))
        for k, v in want.items():
            tol = 1e-4 * max(v.abs().max().item(), 1e-3)
            assert (tp[k] - v).abs().max().item() <= tol, k


@pytest.mark.parametrize("extra,item", [
    (["--tp", "2"], "--tp with attn_impl=flash is unsupported"),
    (["--sp", "2"], "torch.distributed.run --nproc-per-node 2"),
    (["--pp", "2"], "--pp supports the non-hier recipes"),
    (["--ep", "2"], "torch.distributed.run --nproc-per-node 2"),
    (["--bmuf", "--tp", "2"], "--bmuf composes with dp/ep only"),
    (["--bmuf", "--fsdp"], "pick one"),
    (["--bmuf", "--zero1"], "pick one"),
    (["--smbr_cmd", "tool {post}"], "drop --tr_aed_labels"),
    (["--smbr_cmd", "tool {post}", "--ep", "2"], "--smbr_cmd trains in one"),
    (["--smbr_cmd", "tool {post}", "--zero1"], "--smbr_cmd trains in one"),
    (["--smbr_cmd", "tool {post}", "--bmuf"], "--smbr_cmd trains in one"),
    (["--smbr_cmd", "tool {post}", "WORLD_SIZE=2"],
     "--smbr_cmd trains in one"),
])
def test_cli_refuses_unported_flags(work, tmp_path, monkeypatch, extra,
                                    item):
    """The training CLI ports every parallel flag (item 12b is done; item
    12c, sharded export and serving loops, adds none here), so what it
    refuses is what the root train.py refuses, in its words: tp with the
    flash attention this YAML sets, pp with the hier recipe, BMUF with
    tp/sp/pp or with --zero1/--fsdp, sMBR with the hier recipe; and a
    mesh of more ranks than the world (one process here) exits naming
    the launch command. sMBR with a parallel flag, or in a world of more
    than one rank (``WORLD_SIZE=2`` in the env), exits: its loop runs in
    one process and would run unsharded on every rank."""
    env = [a for a in extra if a.startswith("WORLD_SIZE=")]
    for a in env:
        monkeypatch.setenv(*a.split("="))
    extra = [a for a in extra if a not in env]
    with pytest.raises(SystemExit, match=item.replace("-", r"\-")):
        cli.main(_argv(work, tmp_path / "exp", *extra))


@pytest.mark.parametrize("proto", ["dfsmn_san_res", "conformer"])
def test_cli_refuses_other_families(work, tmp_path, proto):
    """With AED labels (the hier recipe), a DFSMN proto exits as the root
    train.py exits (DFSMN nets carry no AED decoders) and a dense
    conformer is refused naming the proto (the recipe runs the MoE
    conformer's forward), before any parameter is drawn."""
    with open(work / "cfg.yaml") as f:
        raw = yaml.safe_load(f)
    raw["nnet_proto"] = proto
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump(raw, f)
    argv = _argv(work, tmp_path / "exp", hier=True)
    argv[1] = str(tmp_path / "cfg.yaml")
    want, match = ((SystemExit, "no AED decoders") if "dfsmn" in proto
                   else (ValueError, proto))
    with pytest.raises(want, match=match):
        cli.main(argv)


DFSMN_YAML = {
    "nnet_proto": "dfsmn_san_res_embed_domain_acc", "input_dim": 20,
    "output_dim": 11,
    "model_conf": {"num_block": 2, "fsmn_each_block": 3, "hidden_dim": 32,
                   "memory_dim": 16, "num_head": 4, "num_memory": 8,
                   "output_dim_domain": 3, "output_dim_acc": 4},
    "loader_conf": {"feat_dim": 20, "batch_size": 2}, "log_period": 1,
    "save_period": 2, "attn_impl": "flash", "lr": 2e-3, "ce_weight": 0.5,
    "schedule_conf": {"warmup_steps": 4},
    "bmuf_conf": {"block_momentum": 0.5, "block_lr": 0.9}}


def _dfsmn_argv(work, tmp_path, out, *extra):
    """The DFSMN proto with its in-model heads: CTC and domain/accent
    labels, validation arks."""
    cfg = tmp_path / "dfsmn.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump(DFSMN_YAML, f)
    argv = _argv(work, out, hier=False)
    argv[1] = str(cfg)
    return argv + ["--tr_domain_labels", str(work / "tr_domain.ark"),
                   "--tr_acc_labels", str(work / "tr_acc.ark")] + list(extra)


def test_cli_trains_dfsmn_heads_in_bmuf_mode_and_resumes(work, tmp_path):
    """dfsmn_san_res_embed_domain_acc with its in-model heads, flash
    attention, --bmuf --sync_period 2 (one replica): four steps with
    finite losses and the heads' metrics in train.log; checkpoint_last.pkl
    holds the bmuf entry (block momentum and LR from bmuf_conf, the
    sync period from the flag) whose global parameters equal the
    parameters (the run ends on a sync) with a leading replica axis of 1.
    A resumed run (--max_epochs 2) starts at step 4 with the recipe's
    state equal, bit for bit, to that entry, and ends at step 8."""
    out = tmp_path / "exp"
    t1 = cli.main(_dfsmn_argv(work, tmp_path, out, "--max_epochs", "1",
                              "--bmuf", "--sync_period", "2"))
    assert t1.global_step == N_TRAIN // 2 and t1.bmuf.dp == 1
    log = (out / "train.log").read_text()
    steps = [line for line in log.splitlines() if " step " in line
             and "domain_loss" in line and "acc_hit" in line]
    assert len(steps) == N_TRAIN // 2
    assert np.all(np.isfinite([float(line.split(" loss ")[1].split()[0])
                               for line in steps]))
    with open(out / "checkpoint_last.pkl", "rb") as f:
        last = pickle.load(f)
    entry = last["bmuf"]
    assert (entry["sync_period"], entry["block_momentum"],
            entry["block_lr"]) == (2, 0.5, 0.9)
    params = flatten_tree(last["params"])
    glob = flatten_tree(entry["global_params"])
    assert sorted(glob) == sorted(params)
    for k, v in glob.items():
        assert params[k].shape == (1,) + v.shape
        assert np.array_equal(params[k][0], v), k

    seen = {}
    from m3asr_tpu_torch.train import trainer as tr_mod
    real = tr_mod.Trainer.load_checkpoint

    def spy(self, tag="last"):
        ok = real(self, tag)
        seen["step"] = self.global_step
        seen["state"] = {k: v.clone() for k, v in flatten_tree(
            self.bmuf.state_dict()).items() if torch.is_tensor(v)}
        return ok
    tr_mod.Trainer.load_checkpoint = spy
    try:
        t2 = cli.main(_dfsmn_argv(work, tmp_path, out, "--max_epochs", "2",
                                  "--bmuf", "--sync_period", "2",
                                  "--resume"))
    finally:
        tr_mod.Trainer.load_checkpoint = real
    assert seen["step"] == N_TRAIN // 2 and t2.global_step == N_TRAIN
    ref = {k: v for k, v in flatten_tree(entry).items()
           if isinstance(v, np.ndarray)}
    assert sorted(ref) == sorted(seen["state"])
    for k, v in ref.items():
        assert np.array_equal(seen["state"][k].numpy(), v), k


def _root_and_port(monkeypatch, argv, capture):
    """The root train.py (run as a script, without --device) and the
    port's CLI on ``argv``, each stopped by ``capture(lr, step, trainer
    modules)``'s patches; returns (JAX record, port record)."""
    i = argv.index("--device")
    root_argv = argv[:i] + argv[i + 2:]
    ref = capture(monkeypatch, j_lr, j_step, j_trainer)
    monkeypatch.setattr(sys, "argv", ["train.py"] + root_argv)
    monkeypatch.setattr(sys, "path", list(sys.path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with pytest.raises(_Built):
        runpy.run_path(os.path.join(root, "train.py"), run_name="__main__")
    got = capture(monkeypatch, t_lr, t_step, t_trainer)
    with pytest.raises(_Built):
        cli.main(argv)
    return ref, got


@pytest.mark.parametrize("bmuf", [False, True])
def test_cli_builds_what_train_py_builds_for_dfsmn(work, tmp_path,
                                                    monkeypatch, bmuf):
    """The DFSMN proto with its in-model heads (domain and accent labels,
    no AED labels), plain and with --bmuf --sync_period 3: the root
    train.py and the port's CLI, each stopped where it starts its
    Trainer, call the same step factory with the heads, with equal model
    configs, TrainConfigs and build_optimizer arguments, parameter trees
    of the same leaves and shapes (a leading replica axis of 1 in BMUF
    mode: gcd(batch 2, 1 device), the JAX run given one of its CPU
    devices) and equal Trainer settings; in BMUF mode
    the recipes' dp, sync period, block momentum and block LR are equal
    and the optimizer states stacked alike."""
    extra = ["--bmuf", "--sync_period", "3"] if bmuf else []
    argv = _dfsmn_argv(work, tmp_path, tmp_path / "exp", *extra)
    # one device, as the port trains on one card (the tests' JAX has
    # several CPU devices)
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    ref, got = _root_and_port(monkeypatch, argv + ["--seed", "3"], _capture)
    assert got["factory"] == ref["factory"] == "make_train_step"
    assert got["with_domain_acc"] and ref["with_domain_acc"]
    assert dataclasses.asdict(got["model_cfg"]) == \
        dataclasses.asdict(ref["model_cfg"])
    assert dataclasses.asdict(got["tcfg"]) == dataclasses.asdict(ref["tcfg"])
    assert got["opt_args"] == ref["opt_args"]
    ref_tree = flatten_tree(jax.tree.map(np.asarray, ref["params"]))
    got_tree = flatten_tree(params_to_numpy(got["params"]))
    assert {k: v.shape for k, v in got_tree.items()} == \
        {k: v.shape for k, v in ref_tree.items()}
    keep = ("batch_keys", "save_dir", "log_period", "save_period",
            "max_epochs", "step_takes_rng", "seed", "scalar_dir")
    assert {k: got["trainer"][k] for k in keep} == \
        {k: ref["trainer"][k] for k in keep}
    assert got["trainer"]["batch_keys"][-2:] == ("domain", "acc")
    if not bmuf:
        assert got["trainer"]["bmuf"] is ref["trainer"]["bmuf"] is None
        return
    rb, gb = ref["trainer"]["bmuf"], got["trainer"]["bmuf"]
    assert (gb.dp, gb.sync_period, gb.block_momentum, gb.block_lr) == \
        (rb.dp, rb.sync_period, rb.block_momentum, rb.block_lr) == \
        (1, 3, 0.5, 0.9)
    assert all(v.shape[0] == 1 for v in got_tree.values())
    # the moments, stacked (the counts and LR scales are (1,) in JAX)
    ref_m = [a.shape for a in jax.tree.leaves(ref["trainer"]["opt_state"])
             if getattr(a, "ndim", 0) > 1]
    state = got["trainer"]["opt_state"]
    got_m = [v.shape for m in ("mu", "nu") for v in state[m].values()]
    assert sorted(got_m) == sorted(ref_m)


def test_cli_smbr_hands_run_smbr_training_what_train_py_does(
        work, tmp_path, monkeypatch):
    """--smbr_cmd with --tr_trans_file on the dense conformer, stopped
    where each CLI calls run_smbr_training: the same model config,
    optimizer arguments, parameter tree shapes, command (split as the
    shell would), epochs and log period, and loaders that yield the same
    keys and transcripts."""
    with open(work / "cfg.yaml") as f:
        raw = yaml.safe_load(f)
    raw["nnet_proto"] = "conformer"
    raw["model_conf"] = {"attention_dim": 32, "attention_heads": 4,
                         "linear_units": 48, "num_blocks": 2}
    cfg = tmp_path / "smbr.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    trans = tmp_path / "trans.txt"
    with open(trans, "w") as f:
        for i in range(N_TRAIN):
            f.write(f"tr{i} word{i}\n")
    argv = _argv(work, tmp_path / "exp", hier=False)
    argv[1] = str(cfg)
    argv += ["--smbr_cmd", "tool --post {post} --grad '{grad}'",
             "--tr_trans_file", str(trans), "--seed", "3"]

    def capture(mp, lr_mod, step_mod, trainer_mod):
        got = _capture(mp, lr_mod, step_mod, trainer_mod)
        smbr_mod = sys.modules[lr_mod.__name__.rsplit(".", 1)[0] + ".smbr"]

        def run(model_cfg, forward, params, optimizer, make_loader, bridge,
                work_dir, max_epochs=1, logger=None, log_period=100):
            got.update(model_cfg=model_cfg, params=params,
                       command=bridge.command, max_epochs=max_epochs,
                       log_period=log_period, work_dir=work_dir,
                       batches=[(b["keys"], b["trans"])
                                for b in make_loader()])
            raise _Built
        mp.setattr(smbr_mod, "run_smbr_training", run)
        return got
    import m3asr_tpu.train.smbr          # noqa: F401 (patched above)
    import m3asr_tpu_torch.train.smbr    # noqa: F401
    ref, got = _root_and_port(monkeypatch, argv, capture)
    assert dataclasses.asdict(got["model_cfg"]) == \
        dataclasses.asdict(ref["model_cfg"])
    assert got["opt_args"] == ref["opt_args"]
    assert {k: v.shape for k, v in flatten_tree(
        params_to_numpy(got["params"])).items()} == \
        {k: v.shape for k, v in flatten_tree(
            jax.tree.map(np.asarray, ref["params"])).items()}
    for k in ("command", "max_epochs", "log_period", "work_dir", "batches"):
        assert got[k] == ref[k], k
    assert got["command"] == ["tool", "--post", "{post}", "--grad", "{grad}"]
    assert len(got["batches"]) == N_TRAIN // 2


def test_cli_defaults_to_the_card(work, tmp_path, monkeypatch):
    """Without --device the CLI runs on cuda, and raises with no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(work, tmp_path / "exp")
    i = argv.index("--device")
    del argv[i:i + 2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_loader_training_options_match_jax(work):
    """The port's DataLoader and CollateFunc against the JAX package's on
    the same ark, training=True: collate_conf spec_aug (Python's random,
    seeded alike before each run), batch_size 3 with drop_last (8
    utterances: two batches), and the AED, domain and accent label
    streams; a resume skip of 3 utterances. Every array equal."""
    conf = {"feat_dim": 20, "batch_size": 3, "drop_last": True}
    collate = {"spec_aug": True, "spec_aug_conf": {"max_t": 8, "max_f": 4}}
    runs = []
    for Loader, Collate in ((JLoader, JCollate), (TLoader, TCollate)):
        for skip in (0, 3):
            random.seed(7)
            loader = Loader(str(work / "tr.ark"),
                            str(work / "tr_labels.ark"), training=True,
                            loader_conf=conf, collate_func=Collate(**collate),
                            aed_label_rspec=str(work / "tr_aed.ark"),
                            domain_rspec=str(work / "tr_domain.ark"),
                            acc_rspec=str(work / "tr_acc.ark"))
            runs.append(list(loader(skip_num=skip, output_keys=True)))
    assert [len(r) for r in runs] == [2, 1, 2, 1]
    for ref, got in zip(runs[:2], runs[2:]):
        for rb, gb in zip(ref, got):
            assert sorted(rb) == sorted(gb)
            assert {"aed_target", "aed_target_lens", "domain",
                    "acc"} <= set(gb)
            for k in rb:
                if k == "keys":
                    assert rb[k] == gb[k]
                else:
                    np.testing.assert_array_equal(gb[k], rb[k], err_msg=k)
    assert (runs[2][0]["data"] == 0).any()     # the masks were applied


def test_build_engine_and_load_engine_match_jax(tmp_path, monkeypatch):
    """m3asr_tpu_torch.build_engine(yaml, .pt) against
    m3asr_tpu.build_engine on the same golden checkpoint: logits on the
    valid frames within allclose(rtol 1e-5, atol 1e-3), the reference
    standard; load_engine of the saved engine answers bit-equal; without
    a checkpoint the seeded init serves finite logits. The package
    re-exports config, load_yaml_config and model_config_from_dict."""
    from test_op_parity import allclose
    from test_torch_engine import BUCKET, _write_inputs
    feat = _write_inputs(tmp_path)
    lens = np.array([57, 40], np.int32)
    cfg, pt = str(tmp_path / "cfg.yaml"), str(tmp_path / "ckpt.pt")
    ref, ref_len = m3asr_tpu.build_engine(cfg, pt, donate_input=False,
                                          **BUCKET).infer(feat, lens)
    eng = m3asr_tpu_torch.build_engine(cfg, pt, device="cpu", **BUCKET)
    got, got_len = eng.infer(feat, lens)
    np.testing.assert_array_equal(np.asarray(got_len), np.asarray(ref_len))
    for b, n in enumerate(np.asarray(ref_len)):
        allclose(np.asarray(got)[b, :n], np.asarray(ref)[b, :n])
    eng.save(str(tmp_path / "eng"))
    again, _ = m3asr_tpu_torch.load_engine(str(tmp_path / "eng"),
                                           device="cpu").infer(feat, lens)
    np.testing.assert_array_equal(np.asarray(again), np.asarray(got))
    seeded, _ = m3asr_tpu_torch.build_engine(cfg, device="cpu",
                                             **BUCKET).infer(feat, lens)
    assert np.isfinite(np.asarray(seeded)).all()
    assert m3asr_tpu_torch.load_yaml_config(cfg).input_dim == 20
    assert m3asr_tpu_torch.model_config_from_dict is \
        m3asr_tpu_torch.config.model_config_from_dict
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: m3asr_tpu_torch.build_engine(cfg),
                 lambda: m3asr_tpu_torch.load_engine(str(tmp_path / "eng"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
