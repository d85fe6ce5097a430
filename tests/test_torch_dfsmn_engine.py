"""DFSMN engines of the PyTorch port against the JAX package's.

The port's ``build`` -> ``infer`` CLIs on the CPU against the JAX
``build.py`` (its ``main`` in process) and ``Engine.infer``, in float32,
bf16, int8 and int4, on a small MoE-DFSMN from a golden state dict
(``test_torch_dfsmn.golden_state_dict``); each engine dir loads in the
other package with the same outputs. Refused ``moe_impl`` names and
refused outputs raise in both; the hidden, the flash attention path and
long-form decoding match JAX; ``flatten_tree`` / ``unflatten_tree``
carry the per-layer lists in the JAX engine dir's paths.

Tolerances: float32 allclose(rtol 1e-5, atol 1e-3), the reference's
own; bf16 and quantized engines within 0.05 of max|ref| against JAX in
the same mode (the routers are decisive, so no token sits at a near-tie
that bf16 rounding decides differently in the two)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import build as j_build
from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.models.registry import get_family as j_family
from m3asr_tpu.runtime import engine as j_engine

from m3asr_tpu_torch import build as t_build
from m3asr_tpu_torch import checkpoint as t_ckpt
from m3asr_tpu_torch import infer as t_infer
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.models.registry import get_family as t_family
from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

from test_op_parity import allclose, valid_region
from test_torch_dfsmn import IN, golden_state_dict, proto_yaml

MOE = "dfsmn_san_fmoe_localComm_catEmbed"
LENS = np.array([29, 17], np.int32)
BUCKET = dict(bucket_lengths=(32,), bucket_batches=(2,))


def feats(seed=60, T=29):
    return np.random.default_rng(seed).standard_normal((2, T, IN)) \
        .astype(np.float32)


def held(got, ref, fp32, lens=LENS):
    g, r = valid_region(got, lens), valid_region(ref, lens)
    if fp32:
        allclose(g, r)
    else:
        assert np.abs(g - r).max() <= 0.05 * np.abs(r).max()


def jax_eager(jeng, x, lens):
    """The JAX engine's bucket forward run eagerly (no jit) on its own
    params and stage: the logits' valid rows, float32."""
    bb, bt = jeng.buckets.pick(*x.shape[:2])
    xp = np.zeros((bb, bt, x.shape[2]), np.float32)
    xp[:x.shape[0], :x.shape[1]] = x
    lp = np.zeros((bb,), np.int32)
    lp[:len(lens)] = lens
    out = j_family(jeng.model_cfg.nnet_proto).forward(
        jeng.params, jeng.model_cfg, jnp.asarray(xp, jeng.dtype),
        jnp.asarray(lp), moe_impl=jeng._moe_impl_for(bb, bt))[0]
    return np.asarray(out, np.float32)[:x.shape[0], :x.shape[1]]


def _jax_call(fn, ns):
    """Run a JAX CLI main in process; it points the JAX compilation cache
    at the engine dir, so put the test process's setting back after."""
    cache = jax.config.jax_compilation_cache_dir
    try:
        return fn(ns)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)


def _write(tmp_path, proto=MOE):
    sd, _ = golden_state_dict(proto)
    torch.save(sd, tmp_path / "ckpt.pt")
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump(proto_yaml(proto), f)
    return tmp_path / "ckpt.pt", tmp_path / "cfg.yaml"


MODES = {"float32": [], "bfloat16": ["-f"], "int8": ["--int8"],
         "int4": ["--int4"]}


@pytest.mark.parametrize("mode", list(MODES))
def test_build_infer_cli_matches_jax(mode, tmp_path, capsys):
    """The port's build CLI (--strict) and the JAX build.py write engine
    dirs of the same flat paths and values (quantized bytes too); the
    port's engine answers as the JAX engine; each dir loads in the other
    package and answers as there; the port's infer CLI compares its
    output with a saved reference (float32)."""
    ckpt, cfg = _write(tmp_path)
    args = ["-c", str(cfg), "-m", str(ckpt), "--buckets", "2x32",
            "--skip-warmup", *MODES[mode]]
    t_build.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu",
                         "--strict"])
    ns = t_build.parse_args(args + ["-o", str(tmp_path / "jax")])
    ns.export_platforms = "tpu,cpu"
    _jax_call(j_build.main, ns)
    with np.load(tmp_path / "port" / "params.npz") as a, \
            np.load(tmp_path / "jax" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert any("fsmn_layers/1/w1" in k for k in a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    x = feats()
    port = Engine.load(str(tmp_path / "port"), device="cpu")
    jeng = _jax_call(j_engine.Engine.load, str(tmp_path / "jax"))
    ref = jeng.infer(x, LENS)
    got = port.infer(x, LENS)
    np.testing.assert_array_equal(got[1], LENS)      # no subsampling
    if mode == "int4":
        # XLA's jit of the int4 dequantization rounds differently from
        # the JAX package's own eager forward (13.6% of max|ref| apart on
        # this model); the port is held to that eager forward of the JAX
        # engine's params and stage
        held(got[0], jax_eager(jeng, x, LENS), False)
    else:
        held(got[0], ref[0], mode == "float32")
    cross = Engine.load(str(tmp_path / "jax"), device="cpu").infer(x, LENS)
    np.testing.assert_array_equal(cross[0], got[0])
    back = _jax_call(j_engine.Engine.load, str(tmp_path / "port")) \
        .infer(x, LENS)
    np.testing.assert_array_equal(back[0], ref[0])
    if mode == "float32":
        np.save(tmp_path / "feat.npy", x[0])
        np.save(tmp_path / "ref.npy", ref[0][:1])
        capsys.readouterr()
        t_infer.main(["-p", str(tmp_path / "port"), "-i",
                      str(tmp_path / "feat.npy"), "-o",
                      str(tmp_path / "ref.npy"), "-d", "greedy",
                      "--device", "cpu"])
        out = capsys.readouterr().out
        assert "allclose(rtol=1e-05, atol=1e-03): True" in out
        assert "utt0 hyp:" in out


# explicit names that map outside the DFSMN layer's table, per mode
REFUSED = [("float32", False, "pallas"), ("float32", False, "capacity"),
           ("float32", False, "ragged_padded"), ("int8", False, "pallas"),
           ("int8", False, "capacity")]


@pytest.mark.parametrize("dtype,a8,impl", REFUSED)
def test_refused_moe_impl_names_raise(dtype, a8, impl):
    """An engine whose stage falls outside the DFSMN-MoE table raises
    ValueError: the JAX engine when it traces the bucket, the port's when
    it is built."""
    raw = proto_yaml(MOE)
    sd, _ = golden_state_dict(MOE)
    params = j_family(MOE).convert(sd, j_config(raw))
    settings = dict(dtype=dtype, act_quant=a8, moe_impl=impl, **BUCKET)
    jeng = j_engine.Engine(j_config(raw), params, j_engine.EngineConfig(
        donate_input=False, **settings))
    with pytest.raises(ValueError, match="DFSMN-MoE"):
        jeng.infer(feats(), LENS)
    with pytest.raises(ValueError, match="DFSMN-MoE"):
        Engine(t_config(raw), params, EngineConfig(**settings), device="cpu")


@pytest.mark.parametrize("proto,setting", [
    ("dfsmn_base_res", "return_hidden"), ("dfsmn_san_res", "return_taps"),
    (MOE, "return_taps")])
def test_refused_outputs_raise(proto, setting):
    """dfsmn_base_res has no hidden and no DFSMN proto has the hier taps:
    NotImplementedError from both engines."""
    raw = proto_yaml(proto)
    params = j_family(proto).convert(golden_state_dict(proto)[0],
                                     j_config(raw))
    with pytest.raises(NotImplementedError):
        j_engine.Engine(j_config(raw), params,
                        j_engine.EngineConfig(**{setting: True}))
    with pytest.raises(NotImplementedError):
        Engine(t_config(raw), params, EngineConfig(**{setting: True}),
               device="cpu")


@pytest.mark.parametrize("proto,settings", [
    (MOE, dict(return_hidden=True)),
    ("dfsmn_san_res_embed_domain_acc", dict(return_hidden=True)),
    ("dfsmn_san_res", dict(attn_impl="flash")),
    (MOE, dict(attn_impl="flash", dtype="int4")),
    ("dfsmn_base_res", dict(decode_output="argmax"))])
def test_engine_outputs_match_jax(proto, settings):
    """The pre-out_linear hidden (x_cat_2 for the domain/accent proto),
    the flash path (JAX's kernel in interpret mode, K2's plain version
    here) and on-device argmax, each against the JAX engine with the same
    settings."""
    raw = proto_yaml(proto)
    params = j_family(proto).convert(golden_state_dict(proto)[0],
                                     j_config(raw))
    jeng = j_engine.Engine(j_config(raw), params, j_engine.EngineConfig(
        donate_input=False, **BUCKET, **settings))
    teng = Engine(t_config(raw), params, EngineConfig(**BUCKET, **settings),
                  device="cpu")
    x = feats(61)
    ref, got = jeng.infer(x, LENS), teng.infer(x, LENS)
    assert len(ref) == len(got)
    fp32 = settings.get("dtype", "float32") == "float32"
    if settings.get("decode_output") == "argmax":
        np.testing.assert_array_equal(got[0], ref[0])
        held(got[2], ref[2], fp32)
        return
    held(got[0], ref[0], fp32)
    if settings.get("return_hidden"):
        held(got[2], ref[2], fp32)


def test_infer_long_strides_by_frames():
    """subsample_factor() is 1 for DFSMN: infer_long over a 100-frame
    utterance in 32-frame windows stitches as the JAX engine's does."""
    raw = proto_yaml("dfsmn_san_res")
    params = j_family("dfsmn_san_res").convert(
        golden_state_dict("dfsmn_san_res")[0], j_config(raw))
    cfg = dict(bucket_lengths=(32,), bucket_batches=(1,))
    jeng = j_engine.Engine(j_config(raw), params,
                           j_engine.EngineConfig(donate_input=False, **cfg))
    teng = Engine(t_config(raw), params, EngineConfig(**cfg), device="cpu")
    assert teng.subsample_factor() == jeng.subsample_factor() == 1
    x = feats(62, T=100)[0]
    ref, got = jeng.infer_long(x), teng.infer_long(x)
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[1][0] == 100
    allclose(got[0], ref[0])


def test_moe_impl_counts_frames_as_tokens():
    """A DFSMN bucket of B x T frames is B x T expert tokens: int4 takes
    K6 up to 128 and K5 beyond, int8 the quant stage and K4, float K1."""
    raw = proto_yaml(MOE)
    params = j_family(MOE).convert(golden_state_dict(MOE)[0],
                                   j_config(raw))
    want = {"int4": ("quant4_pallas", "quant4_runs"),
            "int8": ("quant", "quant_runs"), "float32": ("runs_f", "runs_f")}
    for dtype, (small, big) in want.items():
        eng = Engine(t_config(raw), params, EngineConfig(dtype=dtype),
                     device="cpu")
        assert eng.moe_impl_for(1, 128) == small
        assert eng.moe_impl_for(1, 256) == big
        assert eng.moe_impl_for(8, 6144) == big


def test_flatten_tree_lists_match_jax_engine_paths():
    """flatten_tree gives the JAX engine dir's paths for the per-layer
    lists ("blocks_sw/0/fsmn_layers/1/w1", None leaves left out), and
    unflatten_tree rebuilds the lists as the JAX engine's listify does;
    the round trip keeps every leaf."""
    raw = proto_yaml(MOE)
    tree = jax.tree.map(np.asarray, j_family(MOE).init(
        jax.random.PRNGKey(3), j_config(raw)))
    flat = t_ckpt.flatten_tree(tree)
    jflat = j_engine._flatten(tree)
    assert sorted(flat) == sorted(jflat)
    assert "blocks_sw/0/fsmn_layers/1/w1" in flat
    assert not any(k.endswith("b2") for k in flat)
    back = t_ckpt.unflatten_tree(flat)
    jback = j_engine._unflatten(jflat)
    assert isinstance(back["blocks_sw"], list)
    assert isinstance(back["blocks_sw"][0]["fsmn_layers"], list)
    assert jax.tree.structure(back) == jax.tree.structure(jback)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(a, b)
    tp = t_ckpt.to_torch(back)
    assert isinstance(tp["embed"]["blocks"], list)
    assert t_ckpt.flatten_tree(t_ckpt.params_to_numpy(tp)).keys() == \
        flat.keys()


def test_port_init_serves(tmp_path):
    """A synthetic MoE-DFSMN from the port's seeded init (routers drawn
    at random: rand_init_router) builds with the port's build CLI and no
    checkpoint, and serves finite logits of the frames' length."""
    raw = proto_yaml(MOE)
    raw["model_conf"]["moe_conf"]["rand_init_router"] = True
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump(raw, f)
    t_build.main(["-c", str(tmp_path / "cfg.yaml"), "-o",
                  str(tmp_path / "e"), "--buckets", "2x32", "--device",
                  "cpu", "--int4", "--act_quant"])
    eng = Engine.load(str(tmp_path / "e"), device="cpu")
    assert eng.moe_impl_for(2, 32) == "quant4_a8"
    out, out_len = eng.infer(feats(63), LENS)
    assert out.shape == (2, 29, 7) and np.isfinite(out).all()
    np.testing.assert_array_equal(out_len, LENS)
    p = t_family(MOE).init(t_config(raw), torch.Generator().manual_seed(0))
    assert (p["blocks_sw"][0]["fsmn_layers"][1]["router"]["kernel"]
            != 0).any()
    assert os.path.exists(tmp_path / "e" / "engine.json")
