"""Serving options of the PyTorch port against the JAX package: dense
weight quantization (``kernel_q``/``kernel_scale``), fused q/k/v
attention (``linear_qkv``), and engines with explicit expert stages,
``dense_quant`` and ``fuse_qkv`` (engine.json both ways, the build CLI,
the request tables).

Inputs are made with numpy from a seed. The port runs on the CPU, where
its kernel stages take their plain versions; the JAX engine runs its
XLA paths, or its Pallas kernels in interpret mode where it honours an
explicit kernel request off the TPU. Tolerances are stated at each
comparison."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.models import moe_conformer as j_model
from m3asr_tpu.ops import attention as j_attn
from m3asr_tpu.ops import common as j_common
from m3asr_tpu.ops import quant as j_quant
from m3asr_tpu.runtime import engine as j_engine
from m3asr_tpu.runtime.engine import Engine as JEngine

from m3asr_tpu_torch import build as t_build
from m3asr_tpu_torch.checkpoint import (convert_encoder, flatten_tree,
                                        load_torch_checkpoint,
                                        params_from_jax, params_to_numpy)
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.models import moe_conformer as t_model
from m3asr_tpu_torch.ops import attention as t_attn
from m3asr_tpu_torch.ops import common as t_common
from m3asr_tpu_torch.ops import quant as t_quant
from m3asr_tpu_torch.ops.moe_q4 import q4_tiled_kernel
from m3asr_tpu_torch.ops.moe_stream import stream_kernel
from m3asr_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                            config_from_engine_json,
                                            moe_auto_impl)

from test_op_parity import allclose, valid_region
from test_torch_engine import BUCKET, _jax_engine, _rel, _write_inputs
from test_runtime import small_yaml as engine_yaml
from test_torch_model import inputs, random_params, small_yaml


def _flat(tree):
    return flatten_tree(jax.tree.map(np.asarray, tree)
                        if not _is_torch(tree) else params_to_numpy(tree))


def _is_torch(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return torch.is_tensor(tree)


# ---------------------------------------------------------------------------
# dense quantization and fused q/k/v, op level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounding", ["float32", "bfloat16"])
def test_quantize_dense_params_bytes_equal_jax(rounding):
    """The small model's whole tree, stacked (L, in, out) kernels
    included: the same leaves quantized (routers, depthwise and
    subsampling convs and kernels under 256 values excluded), the same
    int8 bytes and float32 scales ((L, 1, out) for stacked kernels).
    The bf16 case quantizes bf16-rounded kernels, as the engines do."""
    tree = random_params(2)
    if rounding == "bfloat16":
        jt = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
        tt = params_from_jax(tree, dtype=torch.bfloat16)
    else:
        jt, tt = tree, params_from_jax(tree)
    ref = _flat(j_quant.quantize_dense_params(jt))
    got = flatten_tree({k: v for k, v in _numpy_tree(
        t_quant.quantize_dense_params(tt)).items()})
    assert sorted(got) == sorted(ref)
    quantized = [k for k in ref if k.endswith("kernel_q")]
    assert "blocks/self_attn/linear_q/kernel_q" in quantized
    assert not any("router" in k or "conv0" in k or "depthwise" in k
                   for k in quantized)
    for k in quantized:
        s = k[:-1] + "scale"
        assert got[k].dtype == np.int8 and got[s].dtype == np.float32
        assert got[k].tobytes() == ref[k].tobytes(), k
        assert got[s].tobytes() == ref[s].tobytes(), s
    assert ref["blocks/self_attn/linear_q/kernel_scale"].shape == (3, 1, 32)
    back = _numpy_tree(t_quant.dequantize_dense_params(
        t_quant.quantize_dense_params(tt), torch.float32))
    jback = jax.tree.map(np.asarray, j_quant.dequantize_dense_params(
        j_quant.quantize_dense_params(jt), jnp.float32))
    for k, v in flatten_tree(jback).items():
        np.testing.assert_array_equal(flatten_tree(back)[k],
                                      np.asarray(v, np.float32))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return params_to_numpy(tree)
    return np.asarray(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_kernel_q_matches_jax(dtype):
    """kernel_q * kernel_scale in x's dtype, then the product: float32
    rtol 1e-5 / atol 1e-6; bf16 within 1e-2 of max|ref| (both round the
    weight and the output to bf16, summing in another order)."""
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, 64, 48)).astype(np.float32) * 0.1
    q, s = j_quant.quantize_tensor(k)
    p = {"kernel_q": q[1], "kernel_scale": s[1],
         "bias": rng.standard_normal(48).astype(np.float32)}
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = np.asarray(j_common.linear(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x, jdt)), np.float32)
    got = t_common.linear(params_from_jax(p, dtype=tdt),
                          torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    else:
        assert _rel(got.float().numpy(), ref) < 1e-2


def test_fuse_qkv_roundtrip_and_fused_rel_mha():
    """fuse_qkv_params gives JAX's fused tree exactly (every self_attn,
    stacked kernels included), defuse_qkv_params gives the original tree
    back exactly, and rel_mha on fused params equals the unfused port's
    and JAX's fused rel_mha (float32, rtol 1e-5 / atol 1e-5), with a
    chunk mask."""
    tree = random_params(4)
    fused = t_attn.fuse_qkv_params(params_from_jax(tree))
    ref = _flat(j_attn.fuse_qkv_params(jax.tree.map(jnp.asarray, tree)))
    got = _flat(fused)
    assert sorted(got) == sorted(ref)
    assert "blocks/self_attn/linear_qkv/kernel" in got
    assert "embed/blocks/self_attn/linear_qkv/bias" in got
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    assert t_attn.fuse_qkv_params(fused).keys() == fused.keys()
    back = _flat(t_attn.defuse_qkv_params(fused))
    orig = flatten_tree(tree)
    assert sorted(back) == sorted(orig)
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k])

    rng = np.random.default_rng(5)
    layer = jax.tree.map(lambda a: a[1], tree["blocks"]["self_attn"])
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    pos = rng.standard_normal((9, 32)).astype(np.float32)
    lens = np.array([9, 6], np.int32)
    mask = np.tril(np.ones((9, 9), bool))[None, None]
    jl = j_attn.fuse_qkv_params({"self_attn": jax.tree.map(jnp.asarray,
                                                            layer)})
    jref = j_attn.rel_mha(jl["self_attn"], jnp.asarray(x), jnp.asarray(pos),
                          jnp.asarray(lens), 4, mask=jnp.asarray(mask))
    tl = params_from_jax(layer)
    args = (torch.from_numpy(x), torch.from_numpy(pos),
            torch.from_numpy(lens), 4)
    plain = t_attn.rel_mha(tl, *args, mask=torch.from_numpy(mask))
    got = t_attn.rel_mha(t_attn.fuse_qkv_params({"self_attn": tl})
                         ["self_attn"], *args, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-5,
                               atol=1e-5)


def test_model_forward_fused_and_dense_quant_matches_jax():
    """The small model's forward on params fused and dense-quantized by
    the port against JAX's on params transformed by JAX, float32, on the
    valid region: the reference standard allclose(1e-5, 1e-3)."""
    tree = random_params(6)
    feat, lens = inputs(7)
    jcfg, tcfg = j_config(small_yaml()), t_config(small_yaml())
    jp = j_quant.quantize_dense_params(j_attn.fuse_qkv_params(
        jax.tree.map(jnp.asarray, tree)))
    ref, ref_len = jax.jit(lambda p, x, l: j_model.forward(
        p, jcfg.encoder_conf, x, l, moe_impl="dense"))(
            jp, jnp.asarray(feat), jnp.asarray(lens))
    tp = t_quant.quantize_dense_params(
        t_attn.fuse_qkv_params(params_from_jax(tree)))
    from m3asr_tpu_torch.checkpoint import to_torch
    with torch.inference_mode():
        out, out_len = t_model.forward(to_torch(tp), tcfg.encoder_conf,
                                       torch.from_numpy(feat),
                                       torch.from_numpy(lens),
                                       moe_impl="dense")
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    allclose(valid_region(out.numpy(), out_len),
             valid_region(np.asarray(ref), out_len))


# ---------------------------------------------------------------------------
# engines with explicit stages, dense_quant and fuse_qkv
# ---------------------------------------------------------------------------

def _port_engine(tmp_path, **settings):
    cfg = t_config(engine_yaml())
    params = convert_encoder(load_torch_checkpoint(str(tmp_path / "ckpt.pt")),
                             cfg)
    return Engine(cfg, params, EngineConfig(**BUCKET, **settings),
                  device="cpu")


FLOAT_REQUESTS = ["pallas", "tiled", "ragged", "ragged_padded", "capacity"]


@pytest.mark.parametrize("impl", FLOAT_REQUESTS)
def test_float_engine_explicit_stage_matches_jax(tmp_path, impl):
    """A float32 engine with an explicit stage against the JAX engine:
    ``pallas`` (K8's plain version here) against JAX's ``dense`` (the
    JAX engine calls K8 without interpret mode, so off the TPU the two
    kernels cannot be compared there), the XLA-path stages against the
    same stage in the JAX engine. allclose(rtol 1e-5, atol 1e-3) on the
    valid region."""
    feat = _write_inputs(tmp_path)
    lens = np.array([57, 40], np.int32)
    ref, ref_len = _jax_engine(
        moe_impl="dense" if impl == "pallas" else impl).infer(feat, lens)
    eng = _port_engine(tmp_path, moe_impl=impl)
    assert eng.moe_impl_for(2, 64) == impl
    got, got_len = eng.infer(feat, lens)
    np.testing.assert_array_equal(got_len, ref_len)
    allclose(got[0], ref[0])
    allclose(got[1, :got_len[1]], ref[1, :ref_len[1]])
    assert stream_kernel.launches == 0


# (port engine settings, JAX engine settings, bound on max|diff|/max|ref|)
QUANT_REQUESTS = [
    (dict(dtype="int8", moe_impl="quant_pallas"),
     dict(dtype="int8", moe_impl="quant"), 0.05),
    (dict(dtype="int8", moe_impl="tiled"),
     dict(dtype="int8", moe_impl="tiled"), 0.02),
    (dict(dtype="int8", act_quant=True, moe_impl="tiled"),
     dict(dtype="int8", act_quant=True, moe_impl="tiled"), 0.02),
    (dict(dtype="int8", moe_impl="capacity"),
     dict(dtype="int8", moe_impl="capacity"), 0.02),
    (dict(dtype="int4", moe_impl="quant4_tiled"),
     dict(dtype="int4", moe_impl="quant4_tiled"), 0.02),
    (dict(dtype="int4", act_quant=True, moe_impl="quant4_a8_tiled"),
     dict(dtype="int4", act_quant=True, moe_impl="quant4_a8_tiled"), 0.02),
]


@pytest.mark.parametrize("ours,theirs,bound", QUANT_REQUESTS)
def test_quant_engine_explicit_stage_matches_jax(tmp_path, ours, theirs,
                                                 bound):
    """Quantized engines with explicit stages against the JAX engine, on
    the valid region, both in bf16: K7 (``quant4_tiled``,
    ``quant4_a8_tiled``; plain versions here, the JAX kernel in interpret
    mode, which the JAX engine honours off the TPU) and the XLA-path
    stages within 0.02 of max|ref|, the bf16 model bound; int8
    ``quant_pallas`` (K8's plain version, float32 sums of bf16-rounded
    weights) against JAX's ``quant`` (bf16 products) within 0.05, the
    bound of the other quantized stages against each other."""
    feat = _write_inputs(tmp_path)
    lens = np.array([57, 40], np.int32)
    ref, ref_len = _jax_engine(**theirs).infer(feat, lens)
    got, got_len = _port_engine(tmp_path, **ours).infer(feat, lens)
    np.testing.assert_array_equal(got_len, ref_len)
    assert _rel(got[0], ref[0]) < bound
    assert _rel(got[1, :got_len[1]], ref[1, :ref_len[1]]) < bound
    assert q4_tiled_kernel.launches == stream_kernel.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "int4"])
def test_dense_quant_fuse_qkv_engine_dirs_both_ways(tmp_path, dtype):
    """dense_quant + fuse_qkv engines: the port's logits equal the JAX
    engine's (float32 allclose(1e-5, 1e-3); int4 within 0.05 of max|ref|,
    K6's plain version against JAX's XLA int4 stage off the TPU, both
    bf16, as tests/test_torch_engine.py holds them), a JAX-written dir loads in the port with the same bytes
    (kernel_q int8, kernel_scale float32, linear_qkv) and logits, and a
    port-written dir loads in the JAX package with both settings on."""
    feat = _write_inputs(tmp_path)
    lens = np.array([57, 40], np.int32)
    settings = dict(dtype=dtype, dense_quant=True, fuse_qkv=True)
    jeng = _jax_engine(**settings)
    ref, ref_len = jeng.infer(feat, lens)
    eng = _port_engine(tmp_path, **settings)
    got, got_len = eng.infer(feat, lens)
    np.testing.assert_array_equal(got_len, ref_len)

    def close(a, b):
        if dtype == "float32":
            allclose(a, b)
        else:
            assert _rel(a, b) < 0.05
    close(got[0], ref[0])
    close(got[1, :got_len[1]], ref[1, :ref_len[1]])
    ours, theirs = _flat(eng.params), _flat(jeng.params)
    assert sorted(ours) == sorted(theirs)
    for k in ("blocks/self_attn/linear_qkv/kernel_q",
              "blocks/self_attn/linear_qkv/kernel_scale",
              "embed/blocks/feed_forward/w_1/kernel_q",
              "out_linear/kernel_q"):
        assert ours[k].dtype == theirs[k].dtype, k
        assert ours[k].tobytes() == theirs[k].tobytes(), k

    jeng.save(str(tmp_path / "jax_eng"), raw_yaml=engine_yaml())
    back = Engine.load(str(tmp_path / "jax_eng"), device="cpu")
    assert back.cfg.dense_quant and back.cfg.fuse_qkv
    assert _flat(back.params).keys() == ours.keys()
    out, _ = back.infer(feat, lens)
    np.testing.assert_array_equal(out, got)
    eng.save(str(tmp_path / "port_eng"), raw_yaml=engine_yaml())
    with open(tmp_path / "port_eng" / "engine.json") as f:
        meta = json.load(f)
    assert meta["dense_quant"] and meta["fuse_qkv"]
    jback = JEngine.load(str(tmp_path / "port_eng"))
    assert jback.cfg.dense_quant and jback.cfg.fuse_qkv
    out, _ = jback.infer(feat, lens)
    close(out[0], ref[0])


def test_build_cli_dense_quant_fuse_qkv_and_moe_impl(tmp_path):
    """`build --int4 --dense_quant --fuse_qkv --moe_impl tiled` writes an
    engine dir that serves (K7's plain version here) within 0.05 of
    max|ref| of the fp32 engine built from the same checkpoint."""
    _write_inputs(tmp_path)
    args = ["-c", str(tmp_path / "cfg.yaml"), "-m", str(tmp_path / "ckpt.pt"),
            "--buckets", "2x64", "--device", "cpu"]
    t_build.main(args + ["-o", str(tmp_path / "q"), "--int4",
                         "--dense_quant", "--fuse_qkv", "--moe_impl",
                         "tiled"])
    t_build.main(args + ["-o", str(tmp_path / "f")])
    eng = Engine.load(str(tmp_path / "q"), device="cpu")
    assert eng.cfg.dense_quant and eng.cfg.fuse_qkv
    assert eng.moe_impl_for(2, 64) == "quant4_tiled"
    sa = eng.params["blocks"]["self_attn"]
    assert "linear_q" not in sa and sa["linear_qkv"]["kernel_q"].dtype == \
        torch.int8
    feat = np.load(tmp_path / "feat.npy")
    out, out_len = eng.infer(feat, np.array([57, 57]))
    ref, ref_len = Engine.load(str(tmp_path / "f"), device="cpu").infer(
        feat, np.array([57, 57]))
    np.testing.assert_array_equal(out_len, ref_len)
    assert _rel(out, ref) < 0.05


# ---------------------------------------------------------------------------
# the request tables
# ---------------------------------------------------------------------------

ALL_NAMES = ["auto", "dense", "ragged", "tiled", "ragged_padded",
             "capacity", "pallas", "runs", "runs_f", "quant", "quant_tiled",
             "quant_capacity", "quant_pallas", "quant_a8", "quant_a8_tiled",
             "quant4_pallas", "quant4_tiled", "quant4_a8",
             "quant4_a8_tiled", "quant_runs", "quant_a8_runs",
             "quant4_runs", "quant4_a8_runs", "bogus"]
# the stages of the JAX dispatch that run on each expert weight format
# (a name mapped to another fails there when the forward is traced)
RUNS_ON = {
    None: {"dense", "ragged", "tiled", "ragged_padded", "capacity",
           "pallas", "runs_f"},
    8: {"quant", "quant_capacity", "quant_pallas", "quant_tiled",
        "quant_a8", "quant_a8_tiled", "quant_runs", "quant_a8_runs",
        "quant4_runs", "quant4_a8_runs"},
    4: {"quant", "quant_capacity", "quant_pallas", "quant_tiled",
        "quant4_pallas", "quant4_tiled", "quant4_a8", "quant4_a8_tiled",
        "quant_runs", "quant_a8_runs", "quant4_runs", "quant4_a8_runs"},
}


@pytest.mark.parametrize("bits,act_quant", [(None, False), (8, False),
                                            (8, True), (4, False),
                                            (4, True)])
def test_explicit_requests_are_the_jax_tpu_branch(monkeypatch, bits,
                                                  act_quant):
    """Every moe_impl name, per engine mode, against the JAX engine's
    moe_auto_impl with its backend query answering "tpu", at 63 and 1020
    tokens: the same stage where that stage runs on the mode's weights;
    ValueError where the JAX engine raises ValueError or maps the name to
    a stage that fails on those weights."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for n in (63, 1020):
        for name in ALL_NAMES:
            try:
                want = j_engine.moe_auto_impl(
                    "bfloat16", n, int8=bits is not None, requested=name,
                    act_quant=act_quant, int4=bits == 4)
            except ValueError:
                want = None
            if want is not None and want not in RUNS_ON[bits]:
                want = None
            if want is None:
                with pytest.raises(ValueError):
                    moe_auto_impl(n, name, bits, act_quant)
            else:
                assert moe_auto_impl(n, name, bits, act_quant) == want, name
    assert moe_auto_impl(63, "tiled", 4, True) == "quant4_a8_tiled"
    assert moe_auto_impl(63, "pallas", 8) == "quant_pallas"


@pytest.mark.parametrize("setting", [
    {"dtype": "int8", "act_quant": True, "moe_impl": "pallas"},
    {"dtype": "int8", "moe_impl": "ragged"},
    {"dtype": "int4", "moe_impl": "quant_a8_tiled"},
    {"dtype": "int4", "act_quant": True, "moe_impl": "capacity"},
    {"moe_impl": "quant_tiled"}, {"moe_impl": "bogus"}])
def test_refused_requests_raise_value_error(setting):
    """Requests the JAX engine refuses (pallas on w8a8, ragged on int8)
    or cannot run (a w8a8 stage on int4 weights, a quantized stage on
    float weights) raise ValueError from engine.json, as there."""
    with pytest.raises(ValueError, match="moe_impl"):
        config_from_engine_json(dict(nnet_proto="x", **setting))
