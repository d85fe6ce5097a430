"""Engine, engine directories and CLIs of the PyTorch port against the
JAX package, on the CPU (the port's plain expert path).

Logits are held to the reference standard allclose(rtol 1e-5,
atol 1e-3) on the valid region; decodes must be equal."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from m3asr_tpu import checkpoint as j_ckpt
from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.decode import ctc as j_ctc
from m3asr_tpu.runtime import engine as j_engine
from m3asr_tpu.runtime.engine import Engine as JEngine
from m3asr_tpu.runtime.engine import EngineConfig as JEngineConfig

from m3asr_tpu_torch import build as t_build
from m3asr_tpu_torch.checkpoint import load_torch_checkpoint, convert_encoder
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.decode import ctc as t_ctc
from m3asr_tpu_torch.models import moe_conformer as t_model
from m3asr_tpu_torch.runtime import engine as t_engine
from m3asr_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                            config_from_engine_json,
                                            moe_auto_impl)

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


def _jax_engine(prior=None, **settings):
    cfg = j_config(small_yaml())
    sd = {f"encoder.{k}": v.numpy()
          for k, v in golden_model().state_dict().items()}
    params = j_ckpt.convert_encoder(sd, cfg)
    return JEngine(cfg, params,
                   JEngineConfig(use_prior=prior is not None,
                                 donate_input=False, **BUCKET, **settings),
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
    {"fuse_qkv": True, "attn_impl": "flash"},
    {"dtype": "int8", "dense_quant": True, "tp": 2},
    {"dtype": "int4", "fuse_qkv": True, "ep": 2},
    {"dtype": "int4", "moe_impl": "quant4_tiled", "ep": 2},
    {"dense_quant": True, "ep": 2}, {"fuse_qkv": True, "tp": 2},
    {"ep": 2}, {"tp": 2}])
def test_unsupported_engine_json_raises(setting):
    """Settings not ported yet name their ROADMAP item; fuse_qkv with
    flash is refused as the JAX engine refuses it (no item: parity)."""
    meta = dict(dtype="float32", fp32_precision="high", donate_input=True,
                nnet_proto="conformer_fmoe_localComm_catEmbed")
    meta.update(setting)
    match = ("separate q/k/v weights" if setting.get("attn_impl") == "flash"
             else "ROADMAP")
    with pytest.raises(NotImplementedError, match=match):
        config_from_engine_json(meta)


@pytest.mark.parametrize("setting", [
    {"moe_impl": "ragged", "return_hidden": True},
    {"return_taps": True}, {"return_hidden": True},
    {"decode_output": "argmax"}, {"decode_output": "beam"},
    {"decode_output": "topk", "decode_topk": 3}])
def test_output_engine_json_settings_parse(setting):
    """The JAX engine.json output settings, refused before the engine's
    output modes were ported, now parse into the EngineConfig."""
    meta = dict(dtype="float32", fp32_precision="high", donate_input=True,
                nnet_proto="conformer_fmoe_localComm_catEmbed")
    meta.update(setting)
    cfg, _ = config_from_engine_json(meta)
    for name, value in setting.items():
        assert getattr(cfg, name) == value


def test_flash_engine_matches_jax_engine_and_roundtrips(tmp_path):
    """An attn_impl="flash" engine (K2's plain version on the CPU) against
    the JAX engine's XLA attention on the same checkpoint, allclose(rtol
    1e-5, atol 1e-3) on the valid region; its engine.json carries
    attn_impl both ways, and fuse_qkv with flash is refused (as the JAX
    engine refuses the pair)."""
    feat = _write_inputs(tmp_path)
    lens = np.array([57, 40], np.int32)
    jeng = _jax_engine()
    ref, ref_len = jeng.infer(feat, lens)
    cfg = t_config(small_yaml())
    params = convert_encoder(load_torch_checkpoint(str(tmp_path / "ckpt.pt")),
                             cfg)
    eng = Engine(cfg, params, EngineConfig(attn_impl="flash", **BUCKET),
                 device="cpu")
    got, got_len = eng.infer(feat, lens)
    np.testing.assert_array_equal(got_len, ref_len)
    allclose(got[0], ref[0])
    allclose(got[1, :got_len[1]], ref[1, :ref_len[1]])

    eng.save(str(tmp_path / "port_eng"), raw_yaml=small_yaml())
    with open(tmp_path / "port_eng" / "engine.json") as f:
        assert json.load(f)["attn_impl"] == "flash"
    assert JEngine.load(str(tmp_path / "port_eng")).cfg.attn_impl == "flash"
    _jax_engine(attn_impl="flash").save(str(tmp_path / "jax_eng"),
                                        raw_yaml=small_yaml())
    back = Engine.load(str(tmp_path / "jax_eng"), device="cpu")
    assert back.cfg.attn_impl == "flash"
    out, _ = back.infer(feat, lens)
    allclose(out[0], ref[0])
    with pytest.raises(NotImplementedError, match="fuse_qkv"):
        config_from_engine_json(dict(attn_impl="flash", fuse_qkv=True))


def test_build_cli_attn_impl_flash(tmp_path):
    """`build --attn_impl flash` writes it into engine.json; the loaded
    engine serves the XLA-built engine's logits (allclose(1e-5, 1e-3))."""
    _write_inputs(tmp_path)
    args = ["-c", str(tmp_path / "cfg.yaml"), "-m", str(tmp_path / "ckpt.pt"),
            "--buckets", "2x64", "--device", "cpu"]
    t_build.main(args + ["-o", str(tmp_path / "f"), "--attn_impl", "flash"])
    t_build.main(args + ["-o", str(tmp_path / "x")])
    eng = Engine.load(str(tmp_path / "f"), device="cpu")
    assert eng.cfg.attn_impl == "flash"
    feat = np.load(tmp_path / "feat.npy")
    out, _ = eng.infer(feat, np.array([57, 31]))
    ref, ref_len = Engine.load(str(tmp_path / "x"), device="cpu").infer(
        feat, np.array([57, 31]))
    allclose(out[0], ref[0])
    allclose(out[1, :ref_len[1]], ref[1, :ref_len[1]])


def test_build_cli_rejects_unported_flags(tmp_path):
    """--export and -cmvn stay refused, as do the DFSMN protos;
    --dense_quant and --fuse_qkv build an int8 engine that serves, with
    the settings in engine.json."""
    _write_inputs(tmp_path)
    args = ["-c", str(tmp_path / "cfg.yaml"), "-o", str(tmp_path / "e"),
            "--int8", "--device", "cpu", "--buckets", "2x64"]
    with pytest.raises(NotImplementedError, match="export"):
        t_build.main(args + ["--export"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_build.main(args + ["-cmvn", str(tmp_path / "cmvn")])
    with pytest.raises(NotImplementedError):
        t_config({"nnet_proto": "dfsmn_san_res"})
    t_build.main(args + ["--dense_quant", "--fuse_qkv"])
    eng = Engine.load(str(tmp_path / "e"), device="cpu")
    assert eng.cfg.dense_quant and eng.cfg.fuse_qkv
    out, out_len = eng.infer(np.load(tmp_path / "feat.npy"),
                             np.array([57, 57]))
    assert out.shape == (2, 13, 11) and np.isfinite(out).all()


# ---------------------------------------------------------------------------
# quantized engines (int8, int4, w8a8, w4a8)
# ---------------------------------------------------------------------------

def _experts(params):
    """The quantized expert leaves of a tree, as numpy."""
    ff = params["blocks"]["feed_forward"]
    return {k: np.asarray(v.numpy() if torch.is_tensor(v) else v)
            for k, v in ff.items() if k.startswith(("w1", "w2"))}


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_jax_quant_engine_dir_loads_in_port(tmp_path, dtype):
    """A JAX-built int8 / int4 engine dir loads in the port with the same
    quantized bytes and float32 scales, and serves within 0.05 of
    max|ref| of the JAX engine: off the TPU the JAX engine runs its XLA
    dequant path (bf16-rounded weights) while the port runs the card's
    policy (int8: the same `quant` stage; int4: K6's plain version, exact
    integer weights with float32 scales), both in bf16."""
    jeng = _jax_engine(dtype=dtype)
    jeng.save(str(tmp_path / "eng"), raw_yaml=small_yaml())
    eng = Engine.load(str(tmp_path / "eng"), device="cpu")
    ref_w, got_w = _experts(jax.tree.map(np.asarray, jeng.params)), \
        _experts(eng.params)
    assert sorted(got_w) == sorted(ref_w)
    for k in ref_w:
        assert got_w[k].dtype == ref_w[k].dtype, k
        assert got_w[k].tobytes() == ref_w[k].tobytes(), k
    assert got_w["w1_scale"].dtype == np.float32
    feat = np.random.default_rng(12).standard_normal((2, 57, 20)) \
        .astype(np.float32)
    lens = np.array([57, 40], np.int32)
    ref, ref_len = jeng.infer(feat, lens)
    got, got_len = eng.infer(feat, lens)
    np.testing.assert_array_equal(got_len, ref_len)
    assert _rel(got[0], ref[0]) < 0.05
    assert _rel(got[1, :got_len[1]], ref[1, :ref_len[1]]) < 0.05


def test_port_int4_engine_dir_loads_in_jax(tmp_path):
    """A port-built w4a8 engine dir loads in the JAX package with the same
    bytes and settings, and the JAX engine's logits sit within 0.05 of
    max|ref| of the port's (the JAX engine runs its XLA weight-only int4
    path off the TPU)."""
    _write_inputs(tmp_path)
    cfg = t_config(small_yaml())
    params = convert_encoder(load_torch_checkpoint(str(tmp_path / "ckpt.pt")),
                             cfg)
    eng = Engine(cfg, params, EngineConfig(dtype="int4", act_quant=True,
                                           **BUCKET), device="cpu")
    eng.save(str(tmp_path / "eng"), raw_yaml=small_yaml())
    jeng = JEngine.load(str(tmp_path / "eng"))
    assert jeng.cfg.dtype == "int4" and jeng.cfg.act_quant
    got_w = _experts(eng.params)
    ref_w = _experts(jax.tree.map(np.asarray, jeng.params))
    for k in got_w:
        assert got_w[k].tobytes() == ref_w[k].tobytes(), k
    feat = np.random.default_rng(13).standard_normal((1, 50, 20)) \
        .astype(np.float32)
    got, got_len = eng.infer(feat, np.array([50]))
    ref, ref_len = jeng.infer(feat, np.array([50]))
    np.testing.assert_array_equal(got_len, ref_len)
    assert _rel(got, ref) < 0.05


@pytest.mark.parametrize("flags", [["--int8"], ["--int4"],
                                   ["--int8", "--act_quant"],
                                   ["--int4", "--act_quant"]])
def test_build_cli_quantized_engines_serve(tmp_path, flags):
    """The build entry point writes int8 / int4 / w8a8 / w4a8 engine dirs
    that Engine.load serves on the CPU; the quantized engine's logits sit
    within 0.05 of max|ref| of the fp32 engine built from the same
    checkpoint (bf16 activations plus quantized experts)."""
    _write_inputs(tmp_path)
    args = ["-c", tmp_path / "cfg.yaml", "-m", tmp_path / "ckpt.pt",
            "--buckets", "2x64"]
    t_build.main([str(a) for a in args] + ["-o", str(tmp_path / "q"),
                                           "--device", "cpu", *flags])
    t_build.main([str(a) for a in args] + ["-o", str(tmp_path / "f"),
                                           "--device", "cpu"])
    eng = Engine.load(str(tmp_path / "q"), device="cpu")
    assert eng.cfg.dtype == flags[0][2:]
    assert eng.cfg.act_quant == ("--act_quant" in flags)
    ff = eng.params["blocks"]["feed_forward"]
    assert "w1" not in ff and ff["w1_scale"].dtype == torch.float32
    feat = np.load(tmp_path / "feat.npy")
    out, out_len = eng.infer(feat, np.array([57, 57]))
    ref, ref_len = Engine.load(str(tmp_path / "f"), device="cpu").infer(
        feat, np.array([57, 57]))
    np.testing.assert_array_equal(out_len, ref_len)
    assert _rel(out, ref) < 0.05


def test_cli_int4_act_quant_build_and_infer(tmp_path):
    """`python -m m3asr_tpu_torch.build --int4 --act_quant`, then the
    infer CLI on the engine dir, end to end on the CPU."""
    _write_inputs(tmp_path)
    out = _run("build", "-c", tmp_path / "cfg.yaml", "-m",
               tmp_path / "ckpt.pt", "-o", tmp_path / "eng", "--buckets",
               "2x64", "--int4", "--act_quant")
    assert "engine written" in out
    out = _run("infer", "-p", tmp_path / "eng", "-i", tmp_path / "feat.npy",
               "-d", "greedy")
    assert "outputs.shape:(2, 13, 11)" in out and "utt1 hyp:" in out


# post-subsampling tokens of the buckets 1x256, 1x512, 1x1024, 1x2048 and
# 4x1024; the JAX TPU branch's choice for each mode, from
# m3asr_tpu/runtime/engine.py:163-253
AUTO_TABLE = {
    (8, False): ["quant", "quant", "quant_runs", "quant_runs",
                 "quant_runs"],
    (8, True): ["quant_a8", "quant_a8", "quant_a8_runs", "quant_a8_runs",
                "quant_a8_runs"],
    (4, False): ["quant4_pallas", "quant4_pallas", "quant4_runs",
                 "quant4_runs", "quant4_runs"],
    (4, True): ["quant4_a8", "quant4_a8", "quant4_a8_runs",
                "quant4_a8_runs", "quant4_a8_runs"],
}


@pytest.mark.parametrize("bits,act_quant", sorted(AUTO_TABLE))
def test_moe_auto_impl_is_the_jax_tpu_branch(monkeypatch, bits, act_quant):
    """The port's per-bucket expert stage equals the JAX engine's TPU
    branch at 63, 127, 255, 511 and 1020 tokens (a table, and the JAX
    function itself with its backend query answering "tpu"), and the
    engine picks it from the bucket's subsampled length."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    tcfg = t_config(small_yaml())
    eng = Engine(tcfg, t_model.init(tcfg.encoder_conf, 20, 11,
                                    torch.Generator().manual_seed(0)),
                 EngineConfig(dtype={8: "int8", 4: "int4"}[bits],
                              act_quant=act_quant), device="cpu")
    buckets = [(1, 256), (1, 512), (1, 1024), (1, 2048), (4, 1024)]
    for (b, t), n, want in zip(buckets, (63, 127, 255, 511, 1020),
                               AUTO_TABLE[(bits, act_quant)]):
        assert moe_auto_impl(n, "auto", bits, act_quant) == want
        assert j_engine.moe_auto_impl("bfloat16", n, int8=True,
                                      act_quant=act_quant,
                                      int4=bits == 4) == want
        assert eng.moe_impl_for(b, t) == want
    assert moe_auto_impl(1020, "auto") == "runs_f"
    assert moe_auto_impl(63, "dense") == "dense"


def test_unflatten_repacks_legacy_int4_leaf():
    """Legacy JAX engine dirs stored int4 expert weights unpacked, one
    value per byte, under a ``__i4`` key; both packages read them back as
    the same nibble-packed ``w*_q4`` leaf."""
    q = np.random.default_rng(14).integers(-8, 8, (2, 3, 8, 6)) \
        .astype(np.int8)
    flat = {"blocks/feed_forward/w1_q__i4": q,
            "blocks/feed_forward/w1_scale": np.ones((2, 3, 1, 6),
                                                    np.float32)}
    ours = t_engine._unflatten(dict(flat))["blocks"]["feed_forward"]
    theirs = j_engine._unflatten(dict(flat))["blocks"]["feed_forward"]
    assert sorted(ours) == sorted(theirs) == ["w1_q4", "w1_scale"]
    assert ours["w1_q4"].tobytes() == np.asarray(theirs["w1_q4"]).tobytes()
    assert ours["w1_q4"].shape == (2, 3, 8, 3)
