"""K1 (the float run-length expert FFN) and the MoE FFN of the PyTorch
port against the JAX package.

On the CPU the port's wrapper takes its plain PyTorch version; the JAX
side runs ``moe_experts_dense`` and the Pallas kernel in interpret mode
(the JAX package's own CPU route). Routings are skewed, never uniform
only. Tolerances: float32 rtol 1e-5 / atol 1e-6; bf16 atol 4e-3 (the
kernel accumulates in float32, the dense einsum in bf16), as in
``tests/test_pallas_moe_runs.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3asr_tpu.ops import moe as j_moe
from m3asr_tpu.ops.pallas_moe_runs import moe_experts_pallas_runs

from m3asr_tpu_torch.checkpoint import params_from_jax
from m3asr_tpu_torch.ops import moe as t_moe
from m3asr_tpu_torch.ops.moe_runs import (TILE, check_f_widths,
                                          moe_experts_runs_reference,
                                          runs_kernel, runs_layout)

E, D, H = 4, 32, 48


def expert_params(seed, dtype=np.float32, b2=True):
    rng = np.random.default_rng(seed)
    p = {"w1": rng.standard_normal((E, D, H)) * 0.05,
         "b1": rng.standard_normal((E, H)) * 0.1,
         "w2": rng.standard_normal((E, H, D)) * 0.05,
         "b2": rng.standard_normal((E, D)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    if not b2:
        p["b2"] = None
    return p


def jax_tree(p, dtype=jnp.float32):
    return {k: None if v is None else jnp.asarray(v, dtype)
            for k, v in p.items()}


def routing(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        return rng.choice(E, size=n, p=[0.6, 0.25, 0.1, 0.05])
    if kind == "one_expert":
        return np.full(n, 2)
    if kind == "gap":                      # experts 1 and 2 get nothing
        return np.where(np.arange(n) < 3, 0, 3)
    raise ValueError(kind)


CASES = [("skewed", 40, True), ("one_expert", 40, True), ("gap", 40, True),
         ("skewed", 5, True), ("skewed", 40, False)]


@pytest.mark.parametrize("kind,n,b2", CASES)
def test_runs_plain_matches_jax_dense_and_pallas(kind, n, b2):
    p = expert_params(1, b2=b2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, n, D)).astype(np.float32)
    gate = routing(kind, n, seed=3)[None].astype(np.int32)
    got = runs_kernel(params_from_jax(p), torch.from_numpy(x),
                      torch.from_numpy(gate))
    jp = jax_tree(p)
    dense = j_moe.moe_experts_dense(jp, jnp.asarray(x), jnp.asarray(gate))
    pallas = moe_experts_pallas_runs(jp, jnp.asarray(x), jnp.asarray(gate),
                                     tile=8, chunk=2, interpret=True)
    for ref in (dense, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
    assert runs_kernel.launches == 0      # the CPU takes the plain version


def test_runs_plain_bf16():
    p = expert_params(4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, D)).astype(np.float32)
    gate = routing("skewed", 18, seed=6).reshape(2, 9).astype(np.int32)
    got = runs_kernel(params_from_jax(p, dtype=torch.bfloat16),
                      torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(gate))
    assert got.dtype == torch.bfloat16
    jp = jax_tree(p, jnp.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    for ref in (j_moe.moe_experts_dense(jp, xb, jnp.asarray(gate)),
                moe_experts_pallas_runs(jp, xb, jnp.asarray(gate), tile=8,
                                        chunk=2, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), atol=4e-3)


def test_runs_stacked_layer_index():
    L = 3
    ps = [expert_params(10 + i) for i in range(L)]
    stacked = {k: np.stack([q[k] for q in ps]) for k in ("w1", "w2")}
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((1, 13, D)).astype(np.float32))
    gate = torch.from_numpy(routing("skewed", 13, 8)[None].astype(np.int32))
    for i in range(L):
        per = params_from_jax(ps[i])
        st = dict(per, **params_from_jax(stacked))
        ref = moe_experts_runs_reference(per, x, gate)
        got = moe_experts_runs_reference(st, x, gate, layer=i)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        jref = moe_experts_pallas_runs(
            dict(jax_tree(ps[i]), w1=jnp.asarray(stacked["w1"]),
                 w2=jnp.asarray(stacked["w2"])),
            jnp.asarray(x.numpy()), jnp.asarray(gate.numpy()), tile=8,
            chunk=2, layer=jnp.int32(i), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(jref),
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        moe_experts_runs_reference(st, x, gate)          # no layer index


@pytest.mark.parametrize("kind", ["skewed", "gap"])
def test_tile_layout_matches_jax(kind):
    n = 37
    flat = routing(kind, n, seed=9).astype(np.int32)
    ref = j_moe._tile_layout(jnp.asarray(flat), n, E, TILE)
    got = t_moe._tile_layout(torch.from_numpy(flat), n, E, TILE)
    for a, b in zip((got[0], got[1], got[3]), (ref[0], ref[1], ref[3])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2] == ref[2]
    lay = runs_layout(torch.from_numpy(flat), E)
    counts = np.bincount(flat, minlength=E)
    np.testing.assert_array_equal(
        lay.starts.numpy(),
        np.concatenate([[0], np.cumsum((counts + TILE - 1) // TILE)]))


@pytest.mark.parametrize("impl", ["dense", "runs_f"])
def test_moe_ffn_and_gate_match_jax(impl):
    rng = np.random.default_rng(11)
    p = expert_params(12)
    p["router"] = {"kernel": (rng.standard_normal((D + 24, E)) * 0.5)
                   .astype(np.float32)}
    x = rng.standard_normal((2, 10, D)).astype(np.float32)
    emb = rng.standard_normal((2, 10, 24)).astype(np.float32)
    lens = np.array([10, 6], np.int32)
    tp = params_from_jax(p)
    jp = jax.tree.map(jnp.asarray, p)
    gv, gi = t_moe.softmax_top1_gate(
        tp["router"], torch.cat([torch.from_numpy(emb),
                                 torch.from_numpy(x)], -1),
        torch.from_numpy(lens))
    jgv, jgi = j_moe.softmax_top1_gate(
        jp["router"], jnp.concatenate([emb, x], -1), jnp.asarray(lens))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=1e-5,
                               atol=1e-6)
    assert len(set(gi.numpy().ravel())) > 1          # routing is spread
    got = t_moe.moe_ffn(tp, torch.from_numpy(x), torch.from_numpy(emb),
                        torch.from_numpy(lens), impl=impl)
    ref = j_moe.moe_ffn(jp, jnp.asarray(x), jnp.asarray(emb),
                        jnp.asarray(lens), impl="dense")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_kernel_launch_without_cuda_raises():
    """A launch never falls back: CPU tensors handed to the kernel path
    raise, and an unknown impl raises."""
    p = params_from_jax(expert_params(13))
    x = torch.zeros(1, 4, D)
    gate = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        runs_kernel.launch(p, x, gate)
    assert runs_kernel.launches == 0
    with pytest.raises(ValueError, match="unknown moe impl"):
        t_moe._dispatch(p, x, gate, "tiles")


FLAGSHIP_YAML = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                             "3m_asr_18l32e.yaml")


@pytest.mark.parametrize("widths", ["flagship", "config", "320/640",
                                    "48/96"])
def test_k1_width_rule(widths):
    """K1 takes d and h in multiples of its column block (64,
    moe_runs_f_col_block()): the flagship's widths, the shipped config's,
    and 320/640 (multiples of 64, not of 128); it refuses 48/96."""
    if widths == "config":
        import yaml
        with open(FLAGSHIP_YAML) as f:
            enc = yaml.safe_load(f)["model_conf"]["encoder_conf"]
        d, h = enc["attention_dim"], enc["moe_conf"]["hidden_units"]
    else:
        d, h = {"flagship": (512, 1024), "320/640": (320, 640),
                "48/96": (48, 96)}[widths]
    if widths == "48/96":
        with pytest.raises(ValueError, match="multiples of 64"):
            check_f_widths(d, h, 64)
    else:
        check_f_widths(d, h, 64)
