"""Training of the DFSMN and dense conformer families in the PyTorch port
against the JAX package, on the CPU:

* ``loss_fn`` and its gradients for each DFSMN proto and the dense
  ``conformer`` (with a static chunk mask), in CTC and CE mode, with the
  XLA and the flash attention paths (JAX's flash kernels in Pallas
  interpret mode, the port's K2/K3 plain versions);
* one step of the CTC step with the in-model domain/accent heads of
  ``dfsmn_san_res_embed_domain_acc`` against the JAX step, two updates;
* K3's plain version at the DFSMN width (D2, Dk) = (64, 64), memory
  slots prepended, with lengths, chunk windows and ``mem_cols``, against
  the JAX backward kernels in interpret mode.

Small sizes: 2 blocks of 3 cFSMN (embed sub-net 1 x 2), memory 16,
hidden 32, 4 heads, 8 memory slots, 4 experts; the conformer 2 blocks of
width 32. Parameters are JAX inits redrawn from a numpy seed (routers
decisive, so that no token sits at a near-tie of two experts), handed to
both packages with ``params_from_jax``. Tolerances are stated at each
test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.models.registry import get_family as j_family
from m3asr_tpu.ops import masking as j_masking
from m3asr_tpu.ops import pallas_attention as jpa
from m3asr_tpu.train import lr_scheduler as j_lr
from m3asr_tpu.train import step as j_step

from m3asr_tpu_torch.checkpoint import (flatten_tree, params_from_jax,
                                        params_to_numpy)
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.ops import flash_attention as tfa
from m3asr_tpu_torch.train import lr_scheduler as t_lr
from m3asr_tpu_torch.train import step as t_step

from test_torch_dfsmn import IN, OUT, PROTOS, proto_yaml, redrawn

CONFORMER = {"nnet_proto": "conformer", "input_dim": IN, "output_dim": OUT,
             "model_conf": {"attention_dim": 32, "attention_heads": 4,
                            "linear_units": 48, "num_blocks": 2,
                            "static_chunk_size": 4}}
T_FRAMES = 31
LENS = np.array([31, 22], np.int32)


def train_yaml(proto):
    return CONFORMER if proto == "conformer" else proto_yaml(proto)


def train_tree(proto, seed=60):
    """The JAX init of ``proto`` redrawn from a numpy seed (numpy tree)."""
    raw = train_yaml(proto)
    return redrawn(j_family(proto).init(jax.random.PRNGKey(0),
                                        j_config(raw)), seed)


def train_batch(proto, loss_type, seed=61):
    """Features, lengths and labels: CTC targets, or frame-level CE
    alignments as long as the model's output (the conformer's output is
    subsampled 4x)."""
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((2, T_FRAMES, IN)).astype(np.float32)
    if loss_type == "ce":
        n = T_FRAMES if proto != "conformer" else (T_FRAMES - 3) // 4
        lens = LENS if proto != "conformer" else (LENS - 3) // 4
        return (feat, LENS, rng.integers(0, OUT, (2, n)).astype(np.int32),
                lens.astype(np.int32))
    return (feat, LENS, rng.integers(1, OUT, (2, 4)).astype(np.int32),
            np.array([4, 3], np.int32))


def jax_value_and_grad(proto, tree, kw, batch, heads=None):
    cfg = j_config(train_yaml(proto))
    tcfg = j_step.TrainConfig(**kw)
    extra = {} if heads is None else dict(domain_targets=heads[0],
                                          acc_targets=heads[1])
    (loss, metrics), g = jax.jit(jax.value_and_grad(
        lambda p: j_step.loss_fn(p, cfg, tcfg, *batch, **extra),
        has_aux=True))(jax.tree.map(jnp.asarray, tree))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            flatten_tree(jax.tree.map(np.asarray, g)))


def port_value_and_grad(proto, tree, kw, batch, heads=None):
    extra = {} if heads is None else dict(
        domain_targets=torch.from_numpy(heads[0]),
        acc_targets=torch.from_numpy(heads[1]))
    (loss, metrics), g = t_step.value_and_grad(
        params_from_jax(tree), t_config(train_yaml(proto)),
        t_step.TrainConfig(**kw), *map(torch.from_numpy, batch), **extra)
    return (loss.item(), {k: v.item() for k, v in metrics.items()},
            {k: v.numpy() for k, v in g.items()})


def grad_group(path):
    """A gradient leaf's group: its cFSMN layer ("blocks/0/fsmn_layers/2"),
    its attention layer ("embed/blocks/1/attn_layer"), its conformer
    sublayer ("blocks/self_attn"), or its module ("out_linear")."""
    parts = path.split("/")
    for name, extra in (("fsmn_layers", 2), ("attn_layer", 1),
                        ("blocks", 2)):
        if name in parts:
            return "/".join(parts[:parts.index(name) + extra])
    return "/".join(parts[:-1])


def assert_grads_close(got, ref, rel=1e-4):
    """Each group's gradients within ``rel`` of the group's max|g| (float32
    sums in another order; a leaf whose gradient is small beside its
    group's, such as the memory slots' next to the projections, holds
    relatively more of that noise)."""
    assert sorted(got) == sorted(ref)
    err, top = {}, {}
    for k in ref:
        grp = grad_group(k)
        err[grp] = max(err.get(grp, 0.0), np.abs(got[k] - ref[k]).max())
        top[grp] = max(top.get(grp, 0.0), np.abs(ref[k]).max())
    for grp in err:
        assert err[grp] <= rel * top[grp], (grp, err[grp], top[grp])


# dfsmn_base_res has no attention: its flash case is its xla case
CASES = [(p, a) for p in PROTOS + ["conformer"] for a in ("xla", "flash")
         if not (p == "dfsmn_base_res" and a == "flash")]


@pytest.mark.parametrize("loss_type", ["ctc", "ce"])
@pytest.mark.parametrize("proto,attn_impl", CASES)
def test_loss_fn_and_grads_match_jax(proto, attn_impl, loss_type):
    """loss_fn of each DFSMN proto and the dense conformer (a 4-frame
    static chunk mask, which K2/K3 take as windows) against
    jax.value_and_grad of the JAX loss_fn with the same attn_impl, CTC and
    CE; in CTC mode with embed CTC weight 0.3, so that the DFSMN-MoE embed
    sub-net trains too (a CE batch's alignment labels are no CTC target:
    one label a frame, blanks and repeats, infeasible). The loss and every
    metric within rtol 1e-5; the gradients as assert_grads_close (1e-4 of
    each group's max|g|)."""
    tree = train_tree(proto)
    batch = train_batch(proto, loss_type)
    kw = dict(embed_ctc_weight=0.3 if loss_type == "ctc" else 0.0,
              attn_impl=attn_impl, loss_type=loss_type)
    ref = jax_value_and_grad(proto, tree, kw, batch)
    got = port_value_and_grad(proto, tree, kw, batch)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    assert sorted(got[1]) == sorted(ref[1])
    for k in ref[1]:
        np.testing.assert_allclose(got[1][k], ref[1][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    if "fmoe" in proto and loss_type == "ctc":
        assert "embed_ctc_loss" in got[1]
        assert any(np.any(v) for k, v in got[2].items()
                   if k.startswith("embed/blocks/0/attn_layer"))
    assert_grads_close(got[2], ref[2])


HEADS = (np.array([2, 0], np.int32), np.array([1, 3], np.int32))


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_domain_acc_heads_match_jax(attn_impl):
    """The in-model pooled heads of dfsmn_san_res_embed_domain_acc: the
    loss and its metrics (domain and accent CE and hit rate) within rtol
    1e-5 of JAX, the gradients as assert_grads_close, and the heads' own
    leaves get non-zero gradients."""
    proto = "dfsmn_san_res_embed_domain_acc"
    tree = train_tree(proto, seed=62)
    batch = train_batch(proto, "ctc")
    kw = dict(ce_weight=0.5, attn_impl=attn_impl)
    ref = jax_value_and_grad(proto, tree, kw, batch, HEADS)
    got = port_value_and_grad(proto, tree, kw, batch, HEADS)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    assert {"domain_loss", "domain_hit", "acc_loss", "acc_hit"} <= \
        set(got[1]) and sorted(got[1]) == sorted(ref[1])
    for k in ref[1]:
        np.testing.assert_allclose(got[1][k], ref[1][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for head in ("out_linear_domain", "out_linear_accent"):
        assert np.any(got[2][f"{head}/kernel"])
    assert_grads_close(got[2], ref[2])


def test_domain_acc_step_matches_jax_step():
    """make_train_step(with_domain_acc=True) against the JAX step with the
    JAX positional order (..., domain, acc): two updates with SGD and a
    momentum trace (Adam would turn the noise of gradients that are zero
    in exact arithmetic into lr x sign); the metrics of each step within
    rtol 1e-5 and the parameters after the second within rtol 1e-4 of
    each leaf's largest value."""
    proto = "dfsmn_san_res_embed_domain_acc"
    tree = train_tree(proto, seed=63)
    batch = train_batch(proto, "ctc", seed=64)
    sgd = ("constant", {}, 0.05, "sgd", {"momentum": 0.9})
    jopt = j_lr.build_optimizer(*sgd, max_grad_norm=5.0)
    jstep = jax.jit(j_step.make_train_step(
        j_config(train_yaml(proto)), j_step.TrainConfig(ce_weight=0.5), jopt,
        with_domain_acc=True))
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    topt = t_lr.build_optimizer(*sgd, max_grad_norm=5.0)
    step = t_step.make_train_step(t_config(train_yaml(proto)),
                                  t_step.TrainConfig(ce_weight=0.5), topt,
                                  with_domain_acc=True, device="cpu")
    tp = params_from_jax(tree)
    ts = t_step.init_opt_state(topt, tp)
    for _ in range(2):
        jp, js, jm = jstep(jp, js, *batch, *HEADS)
        tp, ts, m = step(tp, ts, *batch, *HEADS)
        assert sorted(m) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(m[k].item(), float(jm[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    ref = flatten_tree(jax.tree.map(np.asarray, jp))
    got = flatten_tree(params_to_numpy(tp))
    assert sorted(got) == sorted(ref)
    for k in ref:
        tol = 1e-4 * max(np.abs(ref[k]).max(), 1e-3)
        assert np.abs(got[k] - ref[k]).max() <= tol, k


# the DFSMN heads: 8 of 64, 64 memory slots (here 2 heads, 16 slots)
MEM_H, MEM_T, MEM_M = 2, 40, 16


@pytest.mark.parametrize("kind", ["lengths", "window"])
def test_flash_bwd_plain_at_dfsmn_width_matches_jax(kind):
    """K3's plain version at (D2, Dk) = (64, 64) on the memory-slot layout
    (16 slots prepended: key lengths + 16; with a 6-frame chunk window
    shifted by 16 and mem_cols = 16) against the JAX backward kernels in
    interpret mode, from the JAX forward's out and LSE: dq, dk, dv within
    allclose(rtol 1e-5, atol 1e-5) on the rows with a valid key (float32
    sums in another order)."""
    rng = np.random.default_rng(65)
    B, H, T, M, dk = 2, MEM_H, MEM_T, MEM_M, 64
    S = T + M
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, T, dk), (B, H, S, dk), (B, H, S, dk), (B, H, T, dk)))
    lens = np.array([T, 23], np.int32) + M
    window = None
    if kind == "window":
        mask = jnp.asarray(j_masking.subsequent_chunk_mask(T, 6))
        lo, hi = (np.repeat(np.asarray(w), B, 0) + M
                  for w in jpa.window_from_mask(mask, T, T))
        window = (lo.astype(np.int32), hi.astype(np.int32))
    mem = M if window is not None else 0
    jw = None if window is None else tuple(map(jnp.asarray, window))
    scale = dk ** -0.5
    out, lse = jpa.flash_attention_bhtd(
        *map(jnp.asarray, (q, k, v, lens)), scale, interpret=True,
        return_lse=True, window=jw, mem_cols=mem)
    ref = jpa.flash_attention_bwd(*map(jnp.asarray, (q, k, v)), out, lse,
                                  jnp.asarray(g), jnp.asarray(lens), scale,
                                  interpret=True, window=jw, mem_cols=mem)
    got = tfa.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(np.array(out)),
        torch.from_numpy(np.array(lse)), torch.from_numpy(g),
        torch.from_numpy(lens), scale,
        window=None if window is None else tuple(map(torch.from_numpy,
                                                     window)),
        mem_cols=mem)
    assert tfa.WIDTHS.count((64, 64)) == 1
    for t, r in zip(got, ref):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_hier_recipe_refuses_other_protos():
    """The hier AED recipe runs the MoE conformer's forward and taps: a
    DFSMN or dense conformer proto is refused up front, naming the proto
    (the JAX recipe fails inside its forward)."""
    for proto in ("dfsmn_san_res", "conformer"):
        cfg = t_config(train_yaml(proto))
        with pytest.raises(ValueError, match=proto):
            t_step.make_hier_train_step(cfg, t_step.HierTrainConfig(), None,
                                        device="cpu")


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_f64(v) for v in tree]
    return tree.double() if torch.is_tensor(tree) and \
        tree.is_floating_point() else tree


@pytest.mark.parametrize("loss_type", ["ctc", "ce"])
def test_dfsmn_flash_path_is_exact_in_float64(loss_type):
    """The DFSMN-MoE step's flash path (K2's and K3's plain versions) and
    its xla path, both in float64 throughout, routing pinned to the xla
    run's: every leaf within 1e-9 of its max|g|, plus 1e-12 of the
    largest (a leaf whose gradient is zero in exact arithmetic holds only
    rounding noise). In exact arithmetic the flash formulation (P
    recomputed from the LSE, delta from the output) gives the xla path's
    gradient, so their float32 distance (phase 17's CE check) is
    rounding; the kernels equal these plain versions in float32."""
    from test_torch_hier_train import PinnedGates
    proto = "dfsmn_san_fmoe_localComm_catEmbed"
    params = _f64(params_from_jax(train_tree(proto)))
    batch = [torch.from_numpy(a) for a in train_batch(proto, loss_type)]
    batch[0] = batch[0].double()
    kw = dict(embed_ctc_weight=0.3 if loss_type == "ctc" else 0.0,
              loss_type=loss_type)
    cfg = t_config(train_yaml(proto))
    grads, calls = {}, None
    for attn_impl in ("xla", "flash"):
        with PinnedGates(calls) as rec:
            _, grads[attn_impl] = t_step.value_and_grad(
                params, cfg, t_step.TrainConfig(attn_impl=attn_impl, **kw),
                *batch)
        calls = rec.calls
    got, ref = grads["flash"], grads["xla"]
    assert sorted(got) == sorted(ref)
    assert all(v.dtype == torch.float64 for v in got.values())
    top = max(v.abs().max().item() for v in ref.values())
    for k in ref:
        err = (got[k] - ref[k]).abs().max().item()
        assert err <= 1e-9 * ref[k].abs().max().item() + 1e-12 * top, \
            (k, err)
