"""Engine, engine directories and CLIs of the PyTorch port against the
JAX package, on the CPU (the port's plain expert path).

Logits are held to the reference standard allclose(rtol 1e-5,
atol 1e-3) on the valid region; decodes must be equal."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from m3asr_tpu import checkpoint as j_ckpt
from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.decode import ctc as j_ctc
from m3asr_tpu.runtime.engine import Engine as JEngine
from m3asr_tpu.runtime.engine import EngineConfig as JEngineConfig

from m3asr_tpu_torch import build as t_build
from m3asr_tpu_torch.checkpoint import load_torch_checkpoint, convert_encoder
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.decode import ctc as t_ctc
from m3asr_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                            config_from_engine_json)

from test_op_parity import allclose
from test_runtime import golden_model, small_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKET = dict(bucket_lengths=(64,), bucket_batches=(2,))


def _write_inputs(tmp_path):
    m = golden_model()
    torch.save({f"encoder.{k}": v for k, v in m.state_dict().items()},
               tmp_path / "ckpt.pt")
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump(small_yaml(), f)
    feat = np.random.default_rng(5).standard_normal((2, 57, 20)) \
        .astype(np.float32)
    np.save(tmp_path / "feat.npy", feat)
    return feat


def _jax_engine(prior=None):
    cfg = j_config(small_yaml())
    sd = {f"encoder.{k}": v.numpy()
          for k, v in golden_model().state_dict().items()}
    params = j_ckpt.convert_encoder(sd, cfg)
    return JEngine(cfg, params,
                   JEngineConfig(use_prior=prior is not None,
                                 donate_input=False, **BUCKET),
                   prior=prior)


def _run(mod, *args):
    r = subprocess.run([sys.executable, "-m", f"m3asr_tpu_torch.{mod}",
                        *map(str, args), "--device", "cpu"],
                       capture_output=True, text=True, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_cli_build_infer_matches_jax_engine(tmp_path):
    """golden torch model -> .pt -> port build CLI -> port infer CLI;
    logits equal the JAX Engine's on the same checkpoint, and greedy and
    beam decodes equal the JAX package's decodes of the JAX logits."""
    feat = _write_inputs(tmp_path)
    lens = np.array([57, 57], np.int32)
    ref, ref_len = _jax_engine().infer(feat, lens)
    np.save(tmp_path / "jax_out.npy", ref)

    out = _run("build", "-c", tmp_path / "cfg.yaml", "-m",
               tmp_path / "ckpt.pt", "-o", tmp_path / "eng",
               "--buckets", "2x64", "--strict")
    assert "all" in out and "keys consumed" in out
    out = _run("infer", "-p", tmp_path / "eng", "-i", tmp_path / "feat.npy",
               "-o", tmp_path / "jax_out.npy", "-d", "greedy")
    assert "allclose(rtol=1e-05, atol=1e-03): True" in out, out
    for b, hyp in enumerate(j_ctc.ctc_greedy_search(ref, ref_len)):
        assert f"utt{b} hyp: {hyp}" in out

    eng = Engine.load(str(tmp_path / "eng"), device="cpu")
    got, got_len = eng.infer(feat, lens)
    np.testing.assert_array_equal(got_len, ref_len)
    allclose(got, ref)
    for b in range(2):
        lp = torch.log_softmax(torch.from_numpy(got[b]), -1).numpy()
        jlp = torch.log_softmax(torch.tensor(ref[b]), -1).numpy()
        ours = t_ctc.ctc_prefix_beam_search(lp, int(got_len[b]), 4)
        theirs = j_ctc.ctc_prefix_beam_search(jlp, int(ref_len[b]), 4)
        assert [h for h, _ in ours] == [h for h, _ in theirs]


def test_jax_engine_dir_loads_in_port(tmp_path):
    """A JAX-saved engine dir (with a prior) loads in the port with
    equal logits, and a port-saved dir loads in the JAX package."""
    prior = np.random.default_rng(6).random(11) + 0.05
    prior = prior / prior.sum()
    jeng = _jax_engine(prior)
    jeng.save(str(tmp_path / "jax_eng"), raw_yaml=small_yaml())
    feat = np.random.default_rng(7).standard_normal((2, 41, 20)) \
        .astype(np.float32)
    lens = np.array([41, 23], np.int32)
    ref, ref_len = jeng.infer(feat, lens)
    eng = Engine.load(str(tmp_path / "jax_eng"), device="cpu")
    assert eng.neg_log_prior is not None
    got, got_len = eng.infer(feat, lens)
    np.testing.assert_array_equal(got_len, ref_len)
    allclose(got[1, :got_len[1]], ref[1, :ref_len[1]])
    allclose(got, ref)

    eng.save(str(tmp_path / "port_eng"))
    back, back_len = JEngine.load(str(tmp_path / "port_eng")).infer(feat,
                                                                      lens)
    np.testing.assert_array_equal(back_len, ref_len)
    allclose(back, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_save_load_roundtrip(tmp_path, dtype):
    _write_inputs(tmp_path)
    cfg = t_config(small_yaml())
    params = convert_encoder(load_torch_checkpoint(str(tmp_path / "ckpt.pt")),
                             cfg)
    eng = Engine(cfg, params, EngineConfig(dtype=dtype, **BUCKET),
                 device="cpu")
    feat = np.random.default_rng(8).standard_normal((1, 50, 20)) \
        .astype(np.float32)
    out, out_len = eng.infer(feat, np.array([50]))
    eng.save(str(tmp_path / "eng"), raw_yaml=small_yaml())
    with open(tmp_path / "eng" / "engine.json") as f:
        assert json.load(f)["dtype"] == dtype
    out2, out_len2 = Engine.load(str(tmp_path / "eng"),
                                 device="cpu").infer(feat, np.array([50]))
    np.testing.assert_array_equal(out_len2, out_len)
    np.testing.assert_array_equal(out2, out)


def test_prior_subtraction(tmp_path):
    _write_inputs(tmp_path)
    cfg = t_config(small_yaml())
    params = convert_encoder(load_torch_checkpoint(str(tmp_path / "ckpt.pt")),
                             cfg)
    prior = np.linspace(1.0, 3.0, 11)
    prior = prior / prior.sum()
    feat = np.random.default_rng(9).standard_normal((1, 30, 20)) \
        .astype(np.float32)
    plain, _ = Engine(cfg, params, EngineConfig(**BUCKET),
                      device="cpu").infer(feat, np.array([30]))
    with_prior, _ = Engine(cfg, params,
                           EngineConfig(use_prior=True, **BUCKET),
                           prior=prior, device="cpu").infer(
                               feat, np.array([30]))
    np.testing.assert_allclose(with_prior,
                               plain - np.log(prior).astype(np.float32),
                               rtol=1e-6, atol=1e-6)


def test_engine_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(t_config(small_yaml()), {}, EngineConfig())


@pytest.mark.parametrize("setting", [
    {"dtype": "int8"}, {"dtype": "int4"}, {"act_quant": True},
    {"dense_quant": True}, {"fuse_qkv": True}, {"attn_impl": "flash"},
    {"ep": 2}, {"tp": 2}, {"return_taps": True}, {"return_hidden": True},
    {"decode_output": "argmax"}, {"decode_output": "beam"},
    {"moe_impl": "tiled"}])
def test_unsupported_engine_json_raises(setting):
    meta = dict(dtype="float32", fp32_precision="high", donate_input=True,
                nnet_proto="conformer_fmoe_localComm_catEmbed")
    meta.update(setting)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        config_from_engine_json(meta)


def test_build_cli_rejects_unported_flags(tmp_path):
    _write_inputs(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_build.main(["-c", str(tmp_path / "cfg.yaml"), "-o",
                      str(tmp_path / "e"), "--int8", "--device", "cpu"])
    with pytest.raises(NotImplementedError):
        t_config({"nnet_proto": "dfsmn_san_res"})
