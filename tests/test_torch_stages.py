"""The explicit expert stages of the PyTorch port against the JAX package:
the plain versions of K8 (the dense float/int8 streamer) and K7 (the
tiled int4 grouped GEMM), the row-tile front of K6 and K8 (its plain
twin's invariants), and the plain-PyTorch XLA-path stages
(``tiled``, ``ragged``, ``ragged_padded``, ``capacity``,
``quant_tiled``, ``quant_a8_tiled``, ``quant_capacity``).

Inputs are made with numpy from a seed and given to both packages. The
JAX kernels run as the JAX package's own tests run them on the CPU
(interpret mode); shapes are tiny (E=4, d=32, h=64, int4 groups of 16
rows so that both products have several groups) to keep the interpreter
fast. The port's wrappers take their plain versions here (CPU tensors),
so every kernel count stays 0. Tolerances, with their reasons, are
stated at each comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3asr_tpu.ops import moe as j_moe
from m3asr_tpu.ops import quant as j_quant
from m3asr_tpu.ops.pallas_moe import (moe_experts_dense_pallas,
                                      moe_experts_pallas_q)
from m3asr_tpu.ops.pallas_moe_q4 import moe_experts_pallas_q4_tiled

from m3asr_tpu_torch.checkpoint import params_from_jax
from m3asr_tpu_torch.ops import moe as t_moe
from m3asr_tpu_torch.ops.moe_q4 import (moe_experts_q4_tiled_reference,
                                        q4_tiled_kernel, tiled_tile)
from m3asr_tpu_torch.ops.moe_runs import moe_experts_runs_reference
from m3asr_tpu_torch.ops.moe_stream import (
    moe_experts_dense_stream_reference, stream_kernel)
from m3asr_tpu_torch.ops.row_tiles import (TILE_ROWS, front_ints, max_tiles,
                                           read_front, row_tiles_reference)

E, D, H = 4, 32, 64
GROUP = 16        # int4 scale groups: 2 over d, 4 over h


def experts(seed, L=None, b2=True):
    """Float expert weights (E, ...) or stacked (L, E, ...), biases."""
    rng = np.random.default_rng(seed)
    lead = (E,) if L is None else (L, E)
    p = {"w1": rng.standard_normal(lead + (D, H)) * 0.1,
         "w2": rng.standard_normal(lead + (H, D)) * 0.1,
         "b1": rng.standard_normal((E, H)) * 0.1,
         "b2": rng.standard_normal((E, D)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    if not b2:
        del p["b2"]
    return p


def routing(kind, shape, seed):
    """Skewed routing, routing that leaves experts 1 and 2 with no
    tokens, all tokens on one expert, or 55% of them on one expert (the
    engine's real skew) and the rest spread."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if kind == "skewed":
        g = rng.choice(E, size=n, p=[0.55, 0.3, 0.1, 0.05])
    elif kind == "gap":
        g = np.where(np.arange(n) % 3 == 0, 0, E - 1)
    elif kind == "one":
        g = np.full(n, 2)
    elif kind == "heavy":
        g = rng.integers(0, E, size=n)
        g[rng.permutation(n)[:round(0.55 * n)]] = 1
    else:
        raise ValueError(kind)
    return g.reshape(shape).astype(np.int32)


def inputs(seed, B=2, T=13):
    return np.random.default_rng(seed).standard_normal((B, T, D)) \
        .astype(np.float32)


def both(p, dtype=np.float32):
    """(JAX tree, port tree) of p, float leaves in dtype."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = {k: jnp.asarray(v, jdt) if v.dtype.kind == "f" else jnp.asarray(v)
          for k, v in p.items()}
    return jp, params_from_jax(p, dtype=tdt)


def quantized(p, bits, float_dtype="float32"):
    """(JAX tree, port tree): p's experts quantized by JAX (int4 in
    GROUP-row groups), biases in float_dtype."""
    jq = jax.tree.map(np.asarray, j_quant.quantize_moe_params(
        jax.tree.map(jnp.asarray, p), bits=bits,
        group_size=GROUP if bits == 4 else None))
    return both(jq, float_dtype)


def rel(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max()
                 / np.abs(np.asarray(b, np.float32)).max())


# ---------------------------------------------------------------------------
# K8: the dense float / int8 streamer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["skewed", "gap", "padded", "heavy", "one"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_plain_matches_jax_kernel(dtype, kind):
    """K8's plain version on float weights against
    moe_experts_dense_pallas (interpret mode): skewed routing, experts
    with no tokens, rows of no expert (gate -1, as the JAX wrapper pads)
    with 2 x 13 = 26 rows, which the JAX wrapper pads to 32, 55% of the
    rows on one expert, and every row on one expert.
    float32: rtol 1e-5 / atol 1e-6 (float32 sums in another order).
    bf16: both take bf16 weights, sum bf16 products in float32 and round
    the hidden and the output to bf16: atol 4e-3, as K1's bf16 test."""
    jp, tp = both(experts(1, b2=kind != "padded"), dtype)
    x = inputs(2)
    gate = routing("skewed" if kind == "padded" else kind, (2, 13), 3)
    if kind == "padded":
        gate[0, [1, 6]] = -1
        gate[1, 12] = E
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = np.asarray(moe_experts_dense_pallas(
        jp, jnp.asarray(x, jdt), jnp.asarray(gate), interpret=True),
        np.float32)
    got = stream_kernel(tp, torch.from_numpy(x).to(tdt),
                        torch.from_numpy(gate))
    assert got.dtype == tdt and stream_kernel.launches == 0
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, atol=4e-3)
    if kind == "padded":
        assert (got[0, [1, 6]] == 0).all() and (got[1, 12] == 0).all()


@pytest.mark.parametrize("kind", ["skewed", "gap", "heavy", "one"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_q8_plain_matches_jax_kernel(dtype, kind):
    """K8's plain version on int8 weights against moe_experts_pallas_q:
    both dequantize as q.to(cdt) * scale.to(cdt) in x's dtype. float32
    rtol 1e-5 / atol 1e-6; bf16 atol 4e-3 (as above)."""
    jq, tq = quantized(experts(4), 8, dtype)
    x = inputs(5)
    gate = routing(kind, (2, 13), 6)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = np.asarray(moe_experts_pallas_q(
        jq, jnp.asarray(x, jdt), jnp.asarray(gate), interpret=True),
        np.float32)
    got = moe_experts_dense_stream_reference(
        tq, torch.from_numpy(x).to(tdt), torch.from_numpy(gate))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, atol=4e-3)


def test_stream_q8_rounds_scale_and_product_to_bf16():
    """The int8 streamer's weights are bf16(bf16(q) * bf16(scale)), not
    q * scale in float32: with one weight's scale rounded away from its
    float32 value, the plain version follows the rounded one."""
    _, tq = quantized(experts(7), 8, "bfloat16")
    x = torch.from_numpy(inputs(8, 1, 5)).to(torch.bfloat16)
    gate = torch.zeros(1, 5, dtype=torch.int32)
    got = moe_experts_dense_stream_reference(tq, x, gate)
    w1 = tq["w1_q"][0].to(torch.bfloat16) * \
        tq["w1_scale"][0].to(torch.bfloat16)
    w2 = tq["w2_q"][0].to(torch.bfloat16) * \
        tq["w2_scale"][0].to(torch.bfloat16)
    h = x[0].float() @ w1.float() + tq["b1"][0].float()
    h = (h * torch.sigmoid(h)).to(torch.bfloat16).float()
    y = (h @ w2.float() + tq["b2"][0].float()).to(torch.bfloat16)
    torch.testing.assert_close(got[0], y, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The row-tile front of K6 and K8 (csrc/row_tiles.cuh), in plain PyTorch
# ---------------------------------------------------------------------------

FRONT_E = 6


def front_gate(kind, n, seed):
    """Gate vectors for the front: a router-like spread, 55% on one
    expert, every row on one expert, every other expert empty, and
    rows of no expert (gate -1 and gate E) among spread ones."""
    rng = np.random.default_rng(seed)
    g = rng.choice(FRONT_E, size=n, p=[0.3, 0.25, 0.2, 0.1, 0.1, 0.05])
    if kind == "heavy":
        g[rng.permutation(n)[:round(0.55 * n)]] = 4
    elif kind == "one":
        g[:] = FRONT_E - 1
    elif kind == "half_empty":
        g = 2 * rng.integers(0, FRONT_E // 2, size=n)
    elif kind == "padded":
        g[::5] = -1
        g[3::7] = FRONT_E
    return torch.from_numpy(g.astype(np.int32))


@pytest.mark.parametrize("n", [1, 31, 32, 63, 100, 257])
@pytest.mark.parametrize("kind", ["spread", "heavy", "one", "half_empty",
                                  "padded"])
def test_row_tiles_reference_invariants(kind, n):
    """The front lists every routed row once, experts in order and rows
    ascending within each; its tiles hold 1..TILE_ROWS rows of one expert
    (full but the last of each expert), cover each expert's rows in
    order, and fit the static worst case; the rows of no expert come
    last, ascending. N is a multiple of the tile rows or not."""
    gate = front_gate(kind, n, seed=n)
    words = row_tiles_reference(gate, FRONT_E)
    assert words.dtype == torch.int32
    assert words.numel() == front_ints(n, FRONT_E)
    f = read_front(words, n, FRONT_E)
    g = gate.long()
    routed = (g >= 0) & (g < FRONT_E)
    assert sorted(f.order.tolist()) == list(range(n))
    n_routed = int(routed.sum())
    assert f.n_none == n - n_routed
    assert f.order[n_routed:].tolist() == (~routed).nonzero()[:, 0].tolist()
    want = sorted(routed.nonzero()[:, 0].tolist(),
                  key=lambda r: (int(g[r]), r))
    assert f.order[:n_routed].tolist() == want
    counts = torch.bincount(g[routed], minlength=FRONT_E)
    assert f.n_tiles == int((-(-counts // TILE_ROWS)).sum())
    assert f.n_tiles <= max_tiles(n, FRONT_E)
    slot = 0
    for t in range(f.n_tiles):
        e, s0, m = (int(a[t]) for a in (f.tile_e, f.tile_slot, f.tile_rows))
        assert s0 == slot and 1 <= m <= TILE_ROWS
        rows = f.order[s0:s0 + m]
        assert (g[rows.long()] == e).all()
        last = t + 1 == f.n_tiles or int(f.tile_e[t + 1]) != e
        assert m == TILE_ROWS or last
        slot += m
    assert slot == n_routed
    assert f.tile_e.tolist() == sorted(f.tile_e.tolist())


def test_row_tiles_reference_refuses_too_many_experts():
    """The front's buckets hold at most 127 experts and the rows of no
    expert; more is refused, as the kernels and their wrappers refuse."""
    with pytest.raises(ValueError, match="experts"):
        row_tiles_reference(torch.zeros(4, dtype=torch.int32), 128)
    assert row_tiles_reference(torch.zeros(4, dtype=torch.int32),
                               127)[0] == 1


# ---------------------------------------------------------------------------
# K7: the tiled int4 grouped GEMM
# ---------------------------------------------------------------------------

def _tol(ref, a8):
    """Weight-only: both sides dequantize each weight to x's dtype and
    take one float32 sum: rtol 1e-5 / atol 1e-5 (summation order). a8:
    the integer sums are exact on both sides; an ulp of difference in
    SiLU can move a hidden value to the next step of its 127-level grid,
    so 3e-2 * max|y| / 127, the JAX package's own w4a8 bound."""
    if a8:
        return dict(rtol=0, atol=3e-2 * np.abs(ref).max() / 127 + 1e-5)
    return dict(rtol=1e-5, atol=1e-5)


# (routing, tile, stacked layer, upper_bound)
Q4_CASES = [("skewed", 64, None, None), ("gap", 128, None, None),
            ("one", 64, 1, None), ("skewed", 64, None, 0.3)]


@pytest.mark.parametrize("kind,tile,layer,upper", Q4_CASES)
@pytest.mark.parametrize("a8", [False, True])
def test_q4_tiled_plain_matches_jax_kernel(a8, kind, tile, layer, upper):
    """K7's plain version against moe_experts_pallas_q4_tiled (interpret
    mode, its default memoized path): skewed routing, experts with no
    tokens at tile 128, all tokens on one expert with stacked (L, E, ...)
    packed weights and a layer index, and the upper_bound clamp."""
    L = None if layer is None else 2
    jq, tq = quantized(experts(9, L=L), 4)
    if layer is not None:             # this layer's scales
        jq = {k: v[layer] if k.endswith("_scale") else v
              for k, v in jq.items()}
        tq = {k: v[layer] if k.endswith("_scale") else v
              for k, v in tq.items()}
    x = inputs(10)
    gate = routing(kind, (2, 13), 11)
    kw = {} if layer is None else dict(layer=layer)
    ref = np.asarray(moe_experts_pallas_q4_tiled(
        jq, jnp.asarray(x), jnp.asarray(gate), tile=tile, upper_bound=upper,
        act_quant=a8, interpret=True, **kw))
    got = q4_tiled_kernel(tq, torch.from_numpy(x), torch.from_numpy(gate),
                          tile=tile, upper_bound=upper, act_quant=a8, **kw)
    np.testing.assert_allclose(got.numpy(), ref, **_tol(ref, a8))
    assert q4_tiled_kernel.launches == 0


@pytest.mark.parametrize("kind", ["skewed", "gap", "one"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q4_tiled_plain_a8_equals_runs_plain_a8(dtype, kind):
    """K7's plain w4a8 equals K5's bit for bit: the same per-row int8
    quantization of x and of the float32 hidden, exact integer sums and
    the same epilogue order, whatever the tile. The card's check that
    K7 a8 equals K5 a8 (chip_smoke.py) rests on this."""
    _, tq = quantized(experts(19), 4, dtype)
    x = torch.from_numpy(inputs(20)).to(getattr(torch, dtype))
    gate = torch.from_numpy(routing(kind, (2, 13), 21))
    got = moe_experts_q4_tiled_reference(tq, x, gate, act_quant=True)
    want = moe_experts_runs_reference(tq, x, gate, act_quant=True)
    assert got.dtype == want.dtype == x.dtype
    assert torch.equal(got, want)


def test_q4_tiled_plain_bf16_and_default_tile():
    """In bf16 (the int4 engines' type) the plain version stays within
    1e-2 of max|ref| of the JAX kernel (both round the dequantized
    weights and the hidden to bf16; sums in another order); the default
    tile is 64 up to 768 tokens, else 128, as the JAX wrapper picks."""
    jq, tq = quantized(experts(12), 4, "bfloat16")
    x = inputs(13)
    gate = routing("skewed", (2, 13), 14)
    ref = moe_experts_pallas_q4_tiled(
        jq, jnp.asarray(x, jnp.bfloat16), jnp.asarray(gate), interpret=True)
    got = moe_experts_q4_tiled_reference(
        tq, torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(gate))
    assert got.dtype == torch.bfloat16
    assert rel(got.float().numpy(), ref) < 1e-2
    assert [tiled_tile(n) for n in (63, 768, 769, 1020)] == [64, 64, 128, 128]


def test_q4_tiled_refusals():
    """Scale groups that do not divide the contraction, 5-D (stacked)
    scales and an activation other than swish and relu raise."""
    _, tq = quantized(experts(15), 4)
    x = torch.from_numpy(inputs(16))
    gate = torch.from_numpy(routing("skewed", (2, 13), 17))
    bad = dict(tq, w1_scale=tq["w1_scale"][:, :1].expand(E, 3, 1, H))
    with pytest.raises(ValueError, match="divide"):
        moe_experts_q4_tiled_reference(bad, x, gate)
    with pytest.raises(ValueError, match="slice"):
        moe_experts_q4_tiled_reference(
            dict(tq, w1_scale=tq["w1_scale"][None]), x, gate)
    with pytest.raises(ValueError, match="activation"):
        moe_experts_q4_tiled_reference(tq, x, gate, activation="gelu")


def test_new_kernel_launch_without_cuda_raises():
    """No fallback: CPU tensors handed to K7's or K8's kernel path raise
    and count nothing."""
    _, t4 = quantized(experts(18), 4)
    _, t8 = quantized(experts(18), 8)
    _, tf = both(experts(18))
    x = torch.zeros(1, 4, D)
    gate = torch.zeros(1, 4, dtype=torch.int32)
    for a8 in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            q4_tiled_kernel.launch(t4, x, gate, act_quant=a8)
    for tp in (tf, t8):
        with pytest.raises(ValueError, match="CUDA"):
            stream_kernel.launch(tp, x, gate)
    assert q4_tiled_kernel.launches == stream_kernel.launches == 0
    with pytest.raises(ValueError, match="int4"):
        moe_experts_q4_tiled_reference(t8, x, gate)


# ---------------------------------------------------------------------------
# the plain-PyTorch XLA-path stages
# ---------------------------------------------------------------------------

FLOAT_STAGES = ["tiled", "ragged", "ragged_padded", "capacity"]


@pytest.mark.parametrize("kind", ["skewed", "gap"])
@pytest.mark.parametrize("impl", FLOAT_STAGES)
def test_float_stages_match_jax(impl, kind):
    """float32: the same products and bias adds in float32, summed in
    another order: rtol 1e-5 / atol 1e-6."""
    jp, tp = both(experts(19))
    x = inputs(20)
    gate = routing(kind, (2, 13), 21)
    ref = np.asarray(j_moe._dispatch(jp, jnp.asarray(x), jnp.asarray(gate),
                                     impl))
    got = t_moe._dispatch(tp, torch.from_numpy(x), torch.from_numpy(gate),
                          impl)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", FLOAT_STAGES)
def test_float_stages_bf16_match_jax(impl):
    """bf16: both packages round every product, bias add and the SiLU to
    bf16 (XLA may keep an elementwise chain in float32 where PyTorch
    rounds each op), so within 2e-2 of max|ref|: a few bf16 steps."""
    jp, tp = both(experts(22), "bfloat16")
    x = inputs(23)
    gate = routing("skewed", (2, 13), 24)
    ref = j_moe._dispatch(jp, jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(gate), impl)
    got = t_moe._dispatch(tp, torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(gate), impl)
    assert got.dtype == torch.bfloat16
    assert rel(got.float().numpy(), np.asarray(ref, np.float32)) < 2e-2


@pytest.mark.parametrize("capacity", [4, None])
def test_capacity_overflow_falls_back_to_dense(capacity):
    """Capacity 4 overflows under skewed routing (expert 0 holds about
    half of 26 tokens) and takes the dense stage; the default capacity
    (min(max(8, ceil8(4N/E)), N) = 26) fits. Both equal JAX's, float32
    rtol 1e-5 / atol 1e-6, with upper_bound clamping the hidden."""
    jp, tp = both(experts(25))
    x = inputs(26)
    gate = routing("skewed", (2, 13), 27)
    ref = np.asarray(j_moe.moe_experts_capacity(
        jp, jnp.asarray(x), jnp.asarray(gate), capacity=capacity,
        upper_bound=0.2))
    got = t_moe.moe_experts_capacity(tp, torch.from_numpy(x),
                                     torch.from_numpy(gate),
                                     capacity=capacity, upper_bound=0.2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


# (impl, bits)
QUANT_STAGES = [("quant_tiled", 8), ("quant_tiled", 4),
                ("quant_capacity", 8), ("quant_capacity", 4),
                ("quant_a8_tiled", 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl,bits", QUANT_STAGES)
def test_quant_stages_match_jax(impl, bits, dtype):
    """float32: rtol 1e-5 / atol 1e-5 (a8's integer sums are exact on
    both sides). bf16: the dequantized weights, products and hidden are
    rounded to bf16 on both sides: within 2e-2 of max|ref|; a8 within
    3e-2, a bf16 hidden landing on another side of a quantization tie
    moving a whole step."""
    jq, tq = quantized(experts(28), bits, dtype)
    x = inputs(29)
    gate = routing("skewed", (2, 13), 30)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = np.asarray(j_moe._dispatch(jq, jnp.asarray(x, jdt),
                                     jnp.asarray(gate), impl), np.float32)
    got = t_moe._dispatch(tq, torch.from_numpy(x).to(tdt),
                          torch.from_numpy(gate), impl)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert rel(got, ref) < (3e-2 if "a8" in impl else 2e-2)


def test_dispatch_takes_every_jax_name():
    """Every name of the JAX dispatch runs in the port on weights of its
    format (float, int8, int4), and an unknown name raises ValueError
    as there."""
    names = {"float32": ["dense", "ragged", "tiled", "ragged_padded",
                         "capacity", "pallas", "runs_f"],
             8: ["quant", "quant_tiled", "quant_capacity", "quant_a8",
                 "quant_a8_tiled", "quant_pallas", "quant_runs",
                 "quant_a8_runs"],
             4: ["quant", "quant_tiled", "quant_capacity", "quant_pallas",
                 "quant4_pallas", "quant4_tiled", "quant4_a8",
                 "quant4_a8_tiled", "quant4_runs", "quant4_a8_runs"]}
    x = torch.from_numpy(inputs(31))
    gate = torch.from_numpy(routing("skewed", (2, 13), 32))
    for fmt, impls in names.items():
        tp = both(experts(33))[1] if fmt == "float32" else \
            quantized(experts(33), fmt)[1]
        for impl in impls:
            out = t_moe._dispatch(tp, x, gate, impl)
            assert out.shape == x.shape and torch.isfinite(out).all(), impl
    with pytest.raises(ValueError, match="unknown moe impl"):
        t_moe._dispatch(tp, x, gate, "bogus")
