"""Quantized expert serving of the PyTorch port against the JAX package:
the quantizer's bytes, the two plain-PyTorch expert stages (``quant``,
``quant_a8``), the plain versions of K4, K5 (run-length, int8 / int4)
and K6 (int4 dense streamer), each weight-only and a8, and the small
hier MoE conformer's forward under every quantized impl name.

Inputs are made with numpy from a seed and given to both packages. The
JAX kernels run as the JAX package's own tests run them on the CPU
(interpret mode). Tolerances, with their reasons, are stated at each
comparison; the port's wrappers take their plain versions here (CPU
tensors), so every kernel count stays 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.models import moe_conformer as j_model
from m3asr_tpu.ops import moe as j_moe
from m3asr_tpu.ops import quant as j_quant
from m3asr_tpu.ops.pallas_moe_q4 import moe_experts_pallas_q4
from m3asr_tpu.ops.pallas_moe_runs import moe_experts_pallas_runs

from m3asr_tpu_torch.checkpoint import params_from_jax
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.models import moe_conformer as t_model
from m3asr_tpu_torch.ops import moe as t_moe
from m3asr_tpu_torch.ops import quant as t_quant
from m3asr_tpu_torch.ops.moe_q4 import moe_experts_q4_reference, q4_kernel
from m3asr_tpu_torch.ops.moe_runs import (check_quant_widths,
                                          moe_experts_runs_reference,
                                          runs_q4_kernel, runs_q8_kernel)

from test_op_parity import valid_region
from test_torch_model import inputs, random_params, small_yaml

E, D, H = 4, 256, 256     # d, h >= 256: int4 has two 128-row groups


def float_experts(seed, E=E, D=D, H=H, L=None):
    """Float expert weights and biases, (E, ...) or stacked (L, E, ...)
    weights with per-layer (E, ...) biases."""
    rng = np.random.default_rng(seed)
    lead = (E,) if L is None else (L, E)
    p = {"w1": rng.standard_normal(lead + (D, H)) * 0.05,
         "w2": rng.standard_normal(lead + (H, D)) * 0.05,
         "b1": rng.standard_normal((E, H)) * 0.1,
         "b2": rng.standard_normal((E, D)) * 0.1}
    return {k: v.astype(np.float32) for k, v in p.items()}


def quantized(p, bits):
    """(JAX tree, port tree) of the same params quantized by JAX."""
    jq = j_quant.quantize_moe_params(jax.tree.map(jnp.asarray, p),
                                     bits=bits)
    return jq, params_from_jax(jax.tree.map(np.asarray, jq))


def routing(kind, n, seed, E=E):
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        return rng.choice(E, size=n, p=[0.55, 0.3, 0.1, 0.05])
    if kind == "gap":                     # experts 1 and 2 get nothing
        return np.where(np.arange(n) < 5, 0, E - 1)
    if kind == "heavy":                   # 55% of the rows on expert 2
        g = rng.integers(0, E, size=n)
        g[rng.permutation(n)[:round(0.55 * n)]] = 2
        return g
    if kind == "one":                     # every row on expert 1
        return np.full(n, 1)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# quantizer: the same bytes as the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rounding", ["float32", "bfloat16"])
def test_quantize_moe_params_bytes_equal_jax(bits, rounding):
    """Stacked (L, E, ...) weights; w1's contraction (256) splits into
    two int4 groups, w2's (192) does not divide by 128 and falls back to
    per-column scales. The bf16 case quantizes bf16-rounded weights, as
    the engines do; the port is handed a bf16 tensor."""
    p = float_experts(0, E=3, D=256, H=192, L=2)
    w = {k: p[k] for k in ("w1", "w2")}
    if rounding == "bfloat16":
        jw = {k: jnp.asarray(v, jnp.bfloat16) for k, v in w.items()}
        tw = {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in w.items()}
    else:
        jw = {k: jnp.asarray(v) for k, v in w.items()}
        tw = w
    ref = jax.tree.map(np.asarray, j_quant.quantize_moe_params(jw, bits))
    got = t_quant.quantize_moe_params(tw, bits)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert got[k].shape == ref[k].shape, k
        assert got[k].tobytes() == ref[k].tobytes(), k
    if bits == 4:
        assert got["w1_scale"].shape == (2, 3, 2, 1, 192)
        assert got["w2_scale"].shape == (2, 3, 1, 256)


def test_pack_and_unpack_int4_match_jax():
    q = np.random.default_rng(1).integers(-8, 8, (3, 5, 64)).astype(np.int8)
    packed = t_quant.pack_int4(q)
    assert packed.tobytes() == j_quant.pack_int4(q).tobytes()
    back = t_quant.unpack_int4(torch.from_numpy(packed), torch.float32)
    np.testing.assert_array_equal(back.numpy(), q.astype(np.float32))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_quant.unpack_int4(jnp.asarray(packed),
                                                     jnp.float32)))


# ---------------------------------------------------------------------------
# the plain-PyTorch stages quant / quant_a8 (the JAX package's XLA paths)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,bits", [("quant", 8), ("quant", 4),
                                       ("quant_a8", 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_oracles_match_jax(impl, bits, dtype):
    """float32: both sides compute the same products in float32
    (rtol 1e-5 / atol 1e-5; a8's integer sums are exact on both). bf16:
    both round the dequantized weights, the hidden and the output to
    bf16, and sum in another order: within 1e-2 of max|ref|, a few bf16
    steps; quant_a8 moves whole activation steps when the bf16 hidden
    lands on another side of a rounding tie: within 3e-2."""
    p = float_experts(2)
    jq, tq = quantized(p, bits)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 20, D)).astype(np.float32)
    gate = routing("skewed", 40, 4).reshape(2, 20).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = {k: v.astype(jdt) if k.startswith("b") else v
          for k, v in jq.items()}
    tp = {k: v.to(tdt) if k.startswith("b") else v for k, v in tq.items()}
    jfn = (j_quant.moe_experts_dense_q if impl == "quant"
           else j_quant.moe_experts_dense_w8a8)
    ref = np.asarray(jfn(jp, jnp.asarray(x, jdt), jnp.asarray(gate)),
                     np.float32)
    got = t_moe._dispatch(tp, torch.from_numpy(x).to(tdt),
                          torch.from_numpy(gate), impl)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        bound = (1e-2 if impl == "quant" else 3e-2) * np.abs(ref).max()
        assert np.abs(got - ref).max() <= bound


# ---------------------------------------------------------------------------
# plain versions of K4, K5 (run-length) and K6 (int4 dense streamer)
# against the JAX package's Pallas kernels
# ---------------------------------------------------------------------------

def _tol(ref, a8):
    """Weight-only: rtol 1e-3 / atol 1e-4, the JAX package's own bound
    for its q4/q8 kernels (tests/test_pallas_moe_runs.py): the int4
    kernel's factored dots carry ~34x the result's magnitude. a8: the
    integer sums are exact on both sides; an ulp of difference in SiLU
    can move a hidden value to the neighbouring step of its 127-level
    grid, so 3e-2 * max|y| / 127, as there."""
    if a8:
        return dict(rtol=0, atol=3e-2 * np.abs(ref).max() / 127 + 1e-5)
    return dict(rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("kind", ["skewed", "gap"])
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_runs_q_plain_matches_jax_kernel(bits, a8, kind):
    """K4 (int8) / K5 (int4) plain versions against
    moe_experts_pallas_runs: skewed routing, and routing that leaves two
    experts with no tokens."""
    p = float_experts(5)
    jq, tq = quantized(p, bits)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 40, D)).astype(np.float32)
    gate = routing(kind, 40, 7)[None].astype(np.int32)
    ref = np.asarray(moe_experts_pallas_runs(
        jq, jnp.asarray(x), jnp.asarray(gate), tile=16, chunk=2,
        act_quant=a8, interpret=True))
    kern = runs_q8_kernel if bits == 8 else runs_q4_kernel
    got = kern(tq, torch.from_numpy(x), torch.from_numpy(gate),
               act_quant=a8).numpy()
    np.testing.assert_allclose(got, ref, **_tol(ref, a8))
    assert runs_q8_kernel.launches == runs_q4_kernel.launches == 0


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_runs_q_plain_stacked_layer_index(bits, a8):
    """Stacked (L, E, ...) quantized weights with a layer index and this
    layer's scales give the JAX kernel's result in its stacked mode, and
    exactly the plain version's on that layer alone."""
    L = 2
    p = float_experts(8, L=L)
    jq, tq = quantized(p, bits)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 24, D)).astype(np.float32)
    gate = routing("skewed", 24, 10)[None].astype(np.int32)
    wk = ("w1_q4", "w2_q4") if bits == 4 else ("w1_q", "w2_q")
    for i in range(L):
        jl = {k: v if k in wk else v[i] if k.endswith("_scale") else v
              for k, v in jq.items()}
        ref = np.asarray(moe_experts_pallas_runs(
            jl, jnp.asarray(x), jnp.asarray(gate), tile=16, chunk=2,
            layer=jnp.int32(i), act_quant=a8, interpret=True))
        tl = {k: v if k in wk else v[i] if k.endswith("_scale") else v
              for k, v in tq.items()}
        got = moe_experts_runs_reference(tl, torch.from_numpy(x),
                                         torch.from_numpy(gate), layer=i,
                                         act_quant=a8)
        np.testing.assert_allclose(got.numpy(), ref, **_tol(ref, a8))
        alone = moe_experts_runs_reference(
            {k: v[i] if k in wk else tl[k] for k, v in tq.items()},
            torch.from_numpy(x), torch.from_numpy(gate), act_quant=a8)
        np.testing.assert_array_equal(got.numpy(), alone.numpy())
    with pytest.raises(ValueError, match="layer"):
        moe_experts_runs_reference(tl, torch.from_numpy(x),
                                   torch.from_numpy(gate))


@pytest.mark.parametrize("kind", ["skewed", "gap", "stacked", "heavy",
                                  "one"])
@pytest.mark.parametrize("a8", [False, True])
def test_q4_dense_plain_matches_jax_kernel(a8, kind):
    """K6's plain version against moe_experts_pallas_q4 (the dense
    streamer with chunk-skip): skewed routing, two experts with no
    tokens, stacked (L, E, ...) packed weights with a layer index, 55% of
    the rows on one expert (the engine's real skew), and every row on
    one expert."""
    L = 2 if kind == "stacked" else None
    p = float_experts(11, L=L)
    jq, tq = quantized(p, 4)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 14, D)).astype(np.float32)
    gate = routing("skewed" if kind == "stacked" else kind, 28, 13) \
        .reshape(2, 14).astype(np.int32)
    kw = {}
    if L is not None:
        jq = {k: v[1] if k.endswith("_scale") else v for k, v in jq.items()}
        tq = {k: v[1] if k.endswith("_scale") else v for k, v in tq.items()}
        kw = dict(layer=1)
    ref = np.asarray(moe_experts_pallas_q4(
        jq, jnp.asarray(x), jnp.asarray(gate), chunk=2, act_quant=a8,
        interpret=True, **{k: jnp.int32(v) for k, v in kw.items()}))
    got = q4_kernel(tq, torch.from_numpy(x), torch.from_numpy(gate),
                    act_quant=a8, **kw).numpy()
    np.testing.assert_allclose(got, ref, **_tol(ref, a8))
    assert q4_kernel.launches == 0


def test_q4_dense_plain_zero_rows_and_bf16():
    """K6's contract: a row of no expert (gate outside [0, E)) is 0; and
    in bf16 (the engines' type) the plain version stays within 4e-3 of
    the JAX kernel, whose dots also sum bf16 x integer products in
    float32 (another order), and rounds the hidden where it does."""
    p = float_experts(14)
    jq, tq = quantized(p, 4)
    rng = np.random.default_rng(15)
    x = rng.standard_normal((1, 12, D)).astype(np.float32)
    gate = routing("skewed", 12, 16)[None].astype(np.int32)
    tb = {k: v.to(torch.bfloat16) if k.startswith("b") else v
          for k, v in tq.items()}
    jb = {k: v.astype(jnp.bfloat16) if k.startswith("b") else v
          for k, v in jq.items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = moe_experts_q4_reference(tb, xb, torch.from_numpy(gate))
    ref = moe_experts_pallas_q4(jb, jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(gate), chunk=2, interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=4e-3)
    gate[0, [2, 7]] = [-1, E]
    out = moe_experts_q4_reference(tb, xb, torch.from_numpy(gate)).float()
    assert (out[0, [2, 7]] == 0).all()
    keep = [i for i in range(12) if i not in (2, 7)]
    np.testing.assert_array_equal(out[0, keep].numpy(),
                                  got[0, keep].float().numpy())


def test_quant_kernel_launch_without_cuda_raises():
    """No fallback: CPU tensors handed to a kernel path raise, wrong
    weights raise, and an unknown impl name raises."""
    p = float_experts(17, E=2, D=64, H=64)
    _, t8 = quantized(p, 8)
    _, t4 = quantized(p, 4)
    x = torch.zeros(1, 4, 64)
    gate = torch.zeros(1, 4, dtype=torch.int32)
    for kern, tp in ((runs_q8_kernel, t8), (runs_q4_kernel, t4),
                     (q4_kernel, t4)):
        for a8 in (False, True):
            with pytest.raises(ValueError, match="CUDA"):
                kern.launch(tp, x, gate, act_quant=a8)
        assert kern.launches == 0
    with pytest.raises(ValueError, match="int4"):
        moe_experts_q4_reference(t8, x, gate)
    with pytest.raises(ValueError, match="act_quant"):
        moe_experts_runs_reference(params_from_jax(p), x, gate,
                                   act_quant=True)
    for impl in ("quant5_tiled", "quant4_pallas_tiled"):
        with pytest.raises(ValueError, match="unknown moe impl"):
            t_moe._dispatch(t8, x, gate, impl)


# K4/K5's argument rule: widths in multiples of the 64-column block
# (moe_runs_col_block()), scale groups in multiples of 32 rows
# (moe_runs_k_step()) that divide the contraction, one group for int8
QUANT_WIDTHS = {
    "flagship int8": ("q8", 512, 1024, 1, 1, None),
    "flagship int4, 128-row groups": ("q4", 512, 1024, 4, 8, None),
    "320/640 int8": ("q8", 320, 640, 1, 1, None),
    "320/640 int4, per-column": ("q4", 320, 640, 1, 1, None),
    "int4, 32-row groups": ("q4", 512, 1024, 16, 32, None),
    "320/640 int4, 32-row groups": ("q4", 320, 640, 10, 20, None),
    "h not a multiple of 64": ("q8", 512, 1000, 1, 1, "multiples of 64"),
    "d not a multiple of 64": ("q4", 96, 192, 1, 1, "multiples of 64"),
    "16-row groups": ("q4", 512, 1024, 32, 8, "multiple of 32 rows"),
    "groups that do not divide": ("q4", 512, 1024, 3, 8,
                                  "multiple of 32 rows"),
    "int8, four groups": ("q8", 512, 1024, 4, 1, "one scale group"),
}


@pytest.mark.parametrize("case", list(QUANT_WIDTHS))
def test_k4_k5_argument_rule(case):
    """check_quant_args' width and group rule for K4/K5 (the kernel's
    column block 64 and group step 32): the flagship's widths with int8
    and with 128-row int4 groups, 320/640, and 32-row groups, whose ends
    fall inside the kernel's 64-deep slices, are taken; a width not a
    multiple of 64, a group not a multiple of 32 rows or not dividing the
    contraction, and int8 with more than one group are refused."""
    fmt, d, h, g1, g2, refusal = QUANT_WIDTHS[case]
    if refusal is None:
        check_quant_widths(fmt, d, h, g1, g2, 64, 32)
    else:
        with pytest.raises(ValueError, match=refusal):
            check_quant_widths(fmt, d, h, g1, g2, 64, 32)


# ---------------------------------------------------------------------------
# the small hier MoE conformer under every quantized impl name
# ---------------------------------------------------------------------------

IMPLS = [("quant", 8), ("quant_a8", 8), ("quant_runs", 8),
         ("quant_a8_runs", 8), ("quant4_runs", 4), ("quant4_a8_runs", 4),
         ("quant4_pallas", 4), ("quant4_a8", 4)]


def quantized_model(bits, seed=1):
    """The small model's params as the quantized engines hold them: bf16
    floats, experts quantized (by JAX) from their bf16 values, float32
    scales. Returns (JAX tree, port tree)."""
    tree = random_params(seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    blocks = dict(jp["blocks"])
    blocks["feed_forward"] = j_quant.quantize_moe_params(
        blocks["feed_forward"], bits=bits)
    jp = dict(jp, blocks=blocks)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp),
                               dtype=torch.bfloat16)


@pytest.mark.parametrize("impl,bits", IMPLS)
def test_quantized_model_forward_matches_jax(impl, bits):
    """JAX's moe_conformer.forward (called directly: off the TPU the JAX
    engine would map the kernel names to XLA paths) against the port's,
    same quantized bf16 params, batch of 2 (lengths 53 and 31), on the
    valid region: within 0.02 of max|ref|, the bf16 model bound of
    tests/test_torch_model.py (the two packages round bf16 at the same
    points and sum in another order; this seed gives 0.012-0.016). Each
    package routes on its own: no token of this seed sits at a router
    near-tie, where a flip would move its frames past the bound."""
    jp, tp = quantized_model(bits)
    feat, lens = inputs(2)
    jcfg, tcfg = j_config(small_yaml()), t_config(small_yaml())
    ref, ref_len = jax.jit(lambda p, x, l: j_model.forward(
        p, jcfg.encoder_conf, x, l, moe_impl=impl))(
            jp, jnp.asarray(feat, jnp.bfloat16), jnp.asarray(lens))
    with torch.inference_mode():
        out, out_len = t_model.forward(
            tp, tcfg.encoder_conf, torch.from_numpy(feat).to(torch.bfloat16),
            torch.from_numpy(lens), moe_impl=impl)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    ref = valid_region(np.asarray(ref, np.float32), out_len)
    got = valid_region(out.float().numpy(), out_len)
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 0.02, rel
