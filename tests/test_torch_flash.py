"""Flash attention of the PyTorch port (K2 forward, K3 backward) against
the JAX package, on the CPU, where the port's wrappers take their plain
versions and the JAX kernels run in Pallas interpret mode.

Inputs are numpy from a seed. Rows with no attendable key are left out
of every comparison: both sides return garbage there by contract (the
JAX kernel averages its zero-padded keys too). Tolerances: float32
allclose(rtol 1e-5, atol 1e-5) (summation order); bf16 outputs within
1e-2 of max|ref| (one bf16 step is 2^-8 of the value)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3asr_tpu.ops import attention as j_attn
from m3asr_tpu.ops import masking as j_masking
from m3asr_tpu.ops import pallas_attention as jpa
from m3asr_tpu.ops.positional import sinusoid_table

from m3asr_tpu_torch.checkpoint import (flatten_tree, params_from_jax,
                                        params_to_numpy)
from m3asr_tpu_torch.ops import attention as t_attn
from m3asr_tpu_torch.ops import flash_attention as tfa
from m3asr_tpu_torch.ops import masking as t_masking

B, H, T, D2, DK = 2, 2, 20, 16, 8
SCALE = DK ** -0.5


def _qkv(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32).astype(dtype)
            for s in ((B, H, T, D2), (B, H, T, D2), (B, H, T, DK))]


def _window(kind):
    """(lo, hi) int32 (B, T) numpy, or None."""
    if kind in ("none", "lengths", "zero_len"):
        return None
    mask = np.asarray(j_masking.subsequent_chunk_mask(T, 6))   # chunk 6
    lo, hi = jpa.window_from_mask(jnp.asarray(mask), T, T)
    lo, hi = np.asarray(lo), np.asarray(hi)
    return np.repeat(lo, B, 0), np.repeat(hi, B, 0)


CASES = {"none": None, "lengths": [20, 11], "window": [20, 14],
         "mem_cols": [20, 14], "zero_len": [20, 0]}


def _attendable(kind):
    """bool (B, T): rows with at least one attendable key."""
    lens = CASES[kind] or [T] * B
    rows = np.array([[L > 0] * T for L in lens])
    return rows


def _to_t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _jax_fwd(q2, k2, v, kind, dtype):
    lens = CASES[kind]
    w = _window(kind)
    out, lse = jpa.flash_attention_bhtd(
        jnp.asarray(q2, dtype), jnp.asarray(k2, dtype), jnp.asarray(v, dtype),
        None if lens is None else jnp.asarray(lens, jnp.int32), SCALE,
        interpret=True, return_lse=True,
        window=None if w is None else tuple(map(jnp.asarray, w)),
        mem_cols=4 if kind == "mem_cols" else 0)
    return np.asarray(out, np.float32), np.asarray(lse)


def _port_fwd(q2, k2, v, kind, dtype):
    lens = CASES[kind]
    w = _window(kind)
    out, lse = tfa.flash_attention_bhtd(
        _to_t(q2, dtype), _to_t(k2, dtype), _to_t(v, dtype),
        None if lens is None else torch.tensor(lens, dtype=torch.int32),
        SCALE, window=None if w is None else tuple(map(torch.from_numpy, w)),
        mem_cols=4 if kind == "mem_cols" else 0, return_lse=True)
    assert out.dtype == dtype and lse.dtype == torch.float32
    return out.float().numpy(), lse.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_flash_fwd_plain_matches_jax_kernel(kind, dtype):
    """K2's plain version against the JAX kernel in interpret mode: out
    and LSE, under no mask, lengths, a chunk window, a window with
    mem_cols=4, and a zero-length row (finite, not compared)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    q2, k2, v = _qkv(1)
    ref, ref_lse = _jax_fwd(q2, k2, v, kind, jdt)
    got, lse = _port_fwd(q2, k2, v, kind, tdt)
    assert np.isfinite(got).all() and np.isfinite(lse).all()
    rows = _attendable(kind)
    ref, got = ref.transpose(0, 2, 1, 3)[rows], got.transpose(0, 2, 1, 3)[rows]
    ref_lse = ref_lse[..., 0].transpose(0, 2, 1)[rows]
    lse = lse[..., 0].transpose(0, 2, 1)[rows]
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
    # the LSE is float32 on both sides; bf16 inputs make equal scores
    np.testing.assert_allclose(lse, ref_lse, rtol=1e-5, atol=1e-5)


def test_window_from_mask_matches_jax():
    mask = np.array(j_masking.add_optional_chunk_mask(
        jnp.asarray([20, 13]), T, False, False, 0, 6, -1))
    mask[1, 0, 15:] = False                     # an empty row
    ref = jpa.window_from_mask(jnp.asarray(mask), T, T)
    got = tfa.window_from_mask(torch.from_numpy(mask), T, T)
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _vjp_inputs(seed=2):
    q2, k2, v = _qkv(seed)
    g = np.random.default_rng(seed + 10).standard_normal(
        (B, H, T, DK)).astype(np.float32)
    return q2, k2, v, g


@pytest.mark.parametrize("kind", ["lengths", "window", "mem_cols"])
def test_flash_bwd_matches_jax_vjp(kind):
    """FlashAttentionFn's gradients (its backward: K3's plain version from
    the saved LSE) against jax.vjp of the JAX custom VJP with its dense
    recompute backward (float32, allclose(rtol 1e-5, atol 1e-5))."""
    q2, k2, v, g = _vjp_inputs()
    lens = CASES[kind]
    w = _window(kind)
    mem = 4 if kind == "mem_cols" else 0
    _, vjp = jax.vjp(lambda a, b, c: jpa.flash_attention_trainable(
        a, b, c, jnp.asarray(lens, jnp.int32), SCALE,
        window=None if w is None else tuple(map(jnp.asarray, w)),
        mem_cols=mem, bwd_impl="dense", interpret=True), q2, k2, v)
    ref = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q2, k2, v)]
    out = tfa.FlashAttentionFn.apply(
        *ts, torch.tensor(lens, dtype=torch.int32),
        *((None, None) if w is None else map(torch.from_numpy, w)), SCALE,
        mem)
    out.backward(torch.from_numpy(g))
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-5)


def test_flash_bwd_plain_matches_jax_kernel():
    """K3's plain version against the JAX backward kernels in interpret
    mode, from the same out and LSE (chunk window and lengths)."""
    q2, k2, v, g = _vjp_inputs(3)
    lens = jnp.asarray([20, 14], jnp.int32)
    w = _window("window")
    out, lse = jpa.flash_attention_bhtd(q2, k2, v, lens, SCALE,
                                        interpret=True, return_lse=True,
                                        window=tuple(map(jnp.asarray, w)))
    ref = jpa.flash_attention_bwd(q2, k2, v, out, lse, jnp.asarray(g), lens,
                                  SCALE, interpret=True,
                                  window=tuple(map(jnp.asarray, w)))
    got = tfa.flash_attention_bwd(
        *map(torch.from_numpy, (q2, k2, v)),
        torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(g), torch.from_numpy(np.array(lens)), SCALE,
        window=tuple(map(torch.from_numpy, w)))
    for t, r in zip(got, ref):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def _rel_mha_setup(seed=0, D=32, heads=4, Tx=21):
    p = jax.tree.map(np.asarray, j_attn.init_rel_mha(
        jax.random.PRNGKey(seed), D, heads))
    rng = np.random.default_rng(seed)
    p = {k: ({kk: rng.standard_normal(vv.shape).astype(np.float32) * 0.3
              for kk, vv in v.items()} if isinstance(v, dict)
             else rng.standard_normal(v.shape).astype(np.float32) * 0.3)
         for k, v in p.items()}
    x = rng.standard_normal((2, Tx, D)).astype(np.float32)
    pos = np.array(sinusoid_table(D)[:Tx])
    return p, x, pos


@pytest.mark.parametrize("chunk", [0, 4])
def test_flash_rel_mha_matches_jax_and_rel_mha(chunk):
    """The port's flash_rel_mha against the JAX flash_rel_mha (interpret
    mode) and against the port's rel_mha (XLA path), with lengths and,
    for chunk=4, a static chunk mask; float32 allclose(1e-5, 1e-5)."""
    p, x, pos = _rel_mha_setup()
    lens = np.array([21, 13], np.int32)
    jmask = tmask = None
    if chunk:
        jmask = j_masking.add_optional_chunk_mask(
            jnp.asarray(lens), 21, False, False, 0, chunk, -1)
        tmask = t_masking.add_optional_chunk_mask(
            torch.from_numpy(lens), 21, False, False, 0, chunk, -1)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    ref = np.asarray(jpa.flash_rel_mha(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(lens), 4, interpret=True, mask=jmask))
    tp = params_from_jax(p)
    args = (tp, torch.from_numpy(x), torch.from_numpy(pos),
            torch.from_numpy(lens), 4)
    got = tfa.flash_rel_mha(*args, mask=tmask).numpy()
    xla = t_attn.rel_mha(*args, mask=tmask).numpy()
    for b, L in enumerate(lens):
        np.testing.assert_allclose(got[b, :L], ref[b, :L], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[b, :L], xla[b, :L], rtol=1e-5,
                                   atol=1e-5)


def test_flash_rel_mha_grads_match_jax_grad():
    """Gradients of an attention layer's parameters and input through the
    port's flash path (FlashAttentionFn) against jax.grad of the JAX
    rel_mha, on the valid rows' weighted sum. float32, allclose(rtol
    1e-4, atol 1e-4 x the largest gradient): sums over the batch and
    heads reorder, and linear_k's bias, whose gradient is zero in exact
    arithmetic (it shifts a row's scores by one constant), holds float32
    noise on both sides."""
    p, x, pos = _rel_mha_setup(seed=4)
    lens = np.array([21, 9], np.int32)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    w[1, 9:] = 0.0                               # the valid region only

    def jloss(p, x):
        return jnp.sum(j_attn.rel_mha(p, x, jnp.asarray(pos),
                                      jnp.asarray(lens), 4) * w)
    ref_p, ref_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: ({kk: vv.requires_grad_(True) for kk, vv in v.items()}
              if isinstance(v, dict) else v.requires_grad_(True))
          for k, v in params_from_jax(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tfa.flash_rel_mha(tp, tx, torch.from_numpy(pos),
                            torch.from_numpy(lens), 4)
    (out * torch.from_numpy(w)).sum().backward()
    grads = params_to_numpy({k: ({kk: vv.grad for kk, vv in v.items()}
                                 if isinstance(v, dict) else v.grad)
                             for k, v in tp.items()})
    ref = flatten_tree(jax.tree.map(np.asarray, ref_p))
    ref["x"] = np.asarray(ref_x)
    got = flatten_tree(grads)
    got["x"] = tx.grad.numpy()
    atol = 1e-4 * max(np.abs(r).max() for r in ref.values())
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-4,
                                   atol=atol, err_msg=name)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks that run before any launch: widths the kernels are not
    built for, then tensors that are not on the card (no plain fallback
    inside the kernel wrapper); nothing is counted as launched."""
    q2, k2, v = (torch.from_numpy(a) for a in _qkv(6))
    with pytest.raises(ValueError, match="built for"):
        tfa.flash_kernels.forward(q2, k2, v, None, SCALE)
    q2, k2 = (torch.zeros(1, 1, 4, 128) for _ in range(2))
    v = torch.zeros(1, 1, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_kernels.forward(q2, k2, v, None, SCALE)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_kernels.forward(q2, k2.double(), v, None, SCALE)
    assert tfa.flash_kernels.fwd_launches == 0


# (B, H, T): the main path's attention shapes, 4x1000 and 1x2048 frames,
# MoE blocks (8 heads) and embed blocks (4 heads)
MAIN_PATH_SHAPES = [(4, 8, 255), (4, 4, 255), (1, 8, 511), (1, 4, 511)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES)
def test_flash_launch_rows_fill_the_card(shape, dtype):
    """Every kernel's default tile height at the main path's shapes: a
    multiple of the 16-row warp tile that the kernel is built for, and a
    grid of at least 128 blocks (the H100 has 132 SMs)."""
    B, H, T = shape
    q2 = torch.zeros(B, H, T, 256, dtype=dtype)
    fwd, (dq, dkv) = tfa.launch_rows(q2, q2)
    assert fwd in tfa.FWD_ROWS and {dq, dkv} <= set(tfa.BWD_ROWS)
    for rows in (fwd, dq, dkv):
        assert rows % 16 == 0
        assert B * H * -(-T // rows) >= 128


def test_flash_block_rows_choice():
    """The tallest tile that keeps the grid at min_blocks: 64 rows at a
    large B * H, 32 and 16 as the grid thins, never above max_rows, and
    16 where even that leaves the card part empty."""
    assert tfa.flash_block_rows(16, 8, 255) == 64
    assert tfa.flash_block_rows(16, 8, 255, max_rows=32) == 32
    assert tfa.flash_block_rows(4, 8, 255) == 64          # 128 blocks
    assert tfa.flash_block_rows(4, 8, 255, min_blocks=256) == 32
    assert tfa.flash_block_rows(4, 4, 255) == 32
    assert tfa.flash_block_rows(1, 4, 511) == 16
    assert tfa.flash_block_rows(2, 2, 20) == 16           # T too short
    with pytest.raises(ValueError, match="max_rows"):
        tfa.flash_block_rows(4, 8, 255, max_rows=48)


def test_flash_wrappers_refuse_tile_rows_the_kernels_lack():
    """A tile height outside what each kernel is built for raises before
    any launch: K2 takes 16, 32 or 64 rows, K3's kernels 16 or 32."""
    q2, k2 = (torch.zeros(1, 1, 4, 128) for _ in range(2))
    v = torch.zeros(1, 1, 4, 64)
    with pytest.raises(ValueError, match="tile rows"):
        tfa.flash_kernels.forward(q2, k2, v, None, SCALE, rows=48)
    lse = delta = torch.zeros(1, 1, 4, 1)
    with pytest.raises(ValueError, match="tile rows"):
        tfa.flash_kernels.backward(q2, k2, v, v, lse, delta, None, SCALE,
                                   rows=(64, 32))
    assert tfa.flash_kernels.fwd_launches == 0
    assert tfa.flash_kernels.dq_launches == tfa.flash_kernels.dkv_launches == 0
