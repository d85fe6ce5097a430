"""The CTC training step of the PyTorch port against the JAX package, on
the CPU: the loss, the optimizer, the chunk masks, and the loss with its
gradients on a small hier MoE conformer (2 embed and 3 MoE blocks,
width 32) with the XLA and the flash attention paths.

Inputs and parameters are numpy from a seed, handed to both packages.
Tolerances are stated at each test."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.ops import masking as j_masking
from m3asr_tpu.train import losses as j_losses
from m3asr_tpu.train import lr_scheduler as j_lr
from m3asr_tpu.train import step as j_step

from m3asr_tpu_torch.checkpoint import (flatten_tree, params_from_jax,
                                        params_to_numpy)
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.ops import masking as t_masking
from m3asr_tpu_torch.train import losses as t_losses
from m3asr_tpu_torch.train import lr_scheduler as t_lr
from m3asr_tpu_torch.train import step as t_step

from test_torch_model import random_params, small_yaml


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------

def test_ctc_loss_and_grad_match_optax():
    """Loss and d loss / d logits against the JAX loss (optax.ctc_loss),
    with padded frames, padded labels, a repeated label (which needs a
    blank between) and an infeasible row (4 labels with a repeat in 3
    frames: optax's finite ~1e5, where PyTorch's own CTC is infinite).
    float32, allclose(rtol 1e-5, atol 1e-5)."""
    rng = np.random.default_rng(0)
    B, T, V, U = 4, 9, 6, 4
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    targets = rng.integers(1, V, (B, U)).astype(np.int32)
    targets[1, 1] = targets[1, 0]                    # a repeat
    targets[3] = [2, 2, 4, 1]
    logit_lens = np.array([9, 6, 7, 3], np.int32)    # row 3: infeasible
    target_lens = np.array([4, 3, 2, 4], np.int32)

    def jloss(x):
        return j_losses.ctc_loss(x, jnp.asarray(logit_lens),
                                 jnp.asarray(targets),
                                 jnp.asarray(target_lens))
    ref, ref_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    assert 1e4 < float(ref) < 1e6                  # the infeasible row
    x = torch.from_numpy(logits).requires_grad_(True)
    got = t_losses.ctc_loss(x, torch.from_numpy(logit_lens),
                            torch.from_numpy(targets),
                            torch.from_numpy(target_lens))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy()[:3], np.asarray(ref_g)[:3],
                               rtol=1e-5, atol=1e-5)
    # the infeasible row's log-alphas sit near -1e5, where one float32
    # step is 0.0078: its gradient agrees to 1e-3
    np.testing.assert_allclose(x.grad.numpy()[3], np.asarray(ref_g)[3],
                               atol=1e-3)
    # the feasible rows alone: PyTorch's CTC path only
    keep = slice(0, 3)
    ref3 = j_losses.ctc_loss(jnp.asarray(logits[keep]),
                             jnp.asarray(logit_lens[keep]),
                             jnp.asarray(targets[keep]),
                             jnp.asarray(target_lens[keep]))
    got3 = t_losses.ctc_loss(torch.from_numpy(logits[keep]),
                             torch.from_numpy(logit_lens[keep]),
                             torch.from_numpy(targets[keep]),
                             torch.from_numpy(target_lens[keep]))
    np.testing.assert_allclose(got3.item(), float(ref3), rtol=1e-5)


# ---------------------------------------------------------------------------
# schedule and optimizer
# ---------------------------------------------------------------------------

def test_warmup_noam_matches_jax():
    ref = j_lr.warmup_noam_schedule(2e-3, warmup_steps=100)
    got = t_lr.warmup_noam_schedule(2e-3, warmup_steps=100)
    for step in (0, 1, 2, 50, 100, 101, 5000):
        np.testing.assert_allclose(got(step), float(ref(jnp.int32(step))),
                                   rtol=1e-7)


def _grads_tree(rng, tree):
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.5).astype(np.float32),
        tree)


@pytest.mark.parametrize("optim_type,weight_decay,clip", [
    ("adam", 0.0, 100.0),       # clip inactive
    ("adam", 0.0, 1.0),         # clip active
    ("adam", 0.01, 1.0),        # weight decay: AdamW
    ("adamw", 0.0, -1.0),       # plain adamw: optax's default decay, no clip
])
def test_optimizer_matches_optax_chain(optim_type, weight_decay, clip):
    """Three updates of the port's optimizer against the JAX
    build_optimizer chain (optax) on identical numpy gradients: the
    parameters after each step and the moments after the last within
    rtol 2e-5 (float32 bias corrections, the same formulas in another
    order)."""
    rng = np.random.default_rng(1)
    params = {"a": {"w": rng.standard_normal((5, 3)).astype(np.float32)},
              "b": rng.standard_normal((7,)).astype(np.float32)}
    kw = dict(max_grad_norm=clip, weight_decay=weight_decay)
    jopt = j_lr.build_optimizer("warmup_noam", {"warmup_steps": 2}, 0.05,
                                optim_type, **kw)
    topt = t_lr.build_optimizer("warmup_noam", {"warmup_steps": 2}, 0.05,
                                optim_type, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy())
          for k, v in flatten_tree(params).items()}
    tstate = topt.init(tp)
    for _ in range(3):
        g = _grads_tree(rng, params)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tu, tstate = topt.update(
            {k: torch.from_numpy(v) for k, v in flatten_tree(g).items()},
            tstate, tp)
        tp = topt.apply_updates(tp, tu)
        ref = flatten_tree(jax.tree.map(np.asarray, jp))
        for k in ref:
            np.testing.assert_allclose(tp[k].numpy(), ref[k], rtol=2e-5,
                                       atol=1e-7, err_msg=k)
    adam = [s for s in jax.tree.leaves(
        jstate, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    assert int(adam.count) == tstate["count"] == 3
    for name, moment in (("mu", adam.mu), ("nu", adam.nu)):
        ref = flatten_tree(jax.tree.map(np.asarray, moment))
        for k in ref:
            np.testing.assert_allclose(tstate[name][k].numpy(), ref[k],
                                       rtol=2e-5, atol=1e-9)


def test_lr_scale_scales_updates():
    opt = t_lr.build_optimizer("warmup_noam", {"warmup_steps": 2}, 0.05)
    p = {"w": torch.ones(3)}
    g = {"w": torch.tensor([0.5, -1.0, 2.0])}
    full, _ = opt.update(g, opt.init(p), p)
    half, _ = opt.update(g, t_lr.set_lr_scale(opt.init(p), 0.5), p)
    torch.testing.assert_close(half["w"], 0.5 * full["w"])


@pytest.mark.parametrize("schedule,optim", [("warmup_cosine", "adam"),
                                            ("warmup_noam", "sgd")])
def test_unported_optimizers_raise(schedule, optim):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_lr.build_optimizer(schedule, {}, 1e-3, optim)


# ---------------------------------------------------------------------------
# chunk masks
# ---------------------------------------------------------------------------

def test_add_optional_chunk_mask_matches_jax():
    """Static chunk masks (with and without left chunks) and the fixed
    decode chunk equal the JAX package's; the dynamic draw comes from a
    torch.Generator (its numbers cannot match jax.random), so its mask is
    held to the chunk formula for the size it drew."""
    lengths = np.array([12, 7], np.int32)
    for args in ((False, False, 0, 4, -1), (False, False, 0, 3, 1),
                 (True, False, 5, 0, 1), (True, False, -1, 0, -1)):
        ref = j_masking.add_optional_chunk_mask(jnp.asarray(lengths), 12,
                                                *args)
        got = t_masking.add_optional_chunk_mask(torch.from_numpy(lengths),
                                                12, *args)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert t_masking.add_optional_chunk_mask(torch.from_numpy(lengths), 12,
                                             False, False, 0, 0, -1) is None
    size = 40
    g = torch.Generator().manual_seed(7)
    got = t_masking.dynamic_chunk_mask(g, size).numpy()
    cs0 = int(torch.randint(1, size, (), generator=torch.Generator()
                            .manual_seed(7)))
    cs = size if cs0 > size // 2 else cs0 % 25 + 1
    np.testing.assert_array_equal(
        got, np.asarray(j_masking.subsequent_chunk_mask(size, cs)))


# ---------------------------------------------------------------------------
# loss_fn and the step on a small MoE conformer
# ---------------------------------------------------------------------------

def _batch(seed=3):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((2, 53, 20)).astype(np.float32)
    lens = np.array([53, 37], np.int32)
    targets = rng.integers(1, 11, (2, 5)).astype(np.int32)
    tlens = np.array([5, 3], np.int32)
    return feat, lens, targets, tlens


def _jax_value_and_grad(tree, tcfg_kw, seed=3):
    cfg = j_config(small_yaml())
    feat, lens, targets, tlens = _batch(seed)
    tcfg = j_step.TrainConfig(**tcfg_kw)
    (loss, metrics), g = jax.jit(jax.value_and_grad(
        lambda p: j_step.loss_fn(p, cfg, tcfg, feat, lens, targets, tlens),
        has_aux=True))(jax.tree.map(jnp.asarray, tree))
    return float(loss), flatten_tree(jax.tree.map(np.asarray, g))


def _port_value_and_grad(tree, tcfg_kw, seed=3):
    feat, lens, targets, tlens = _batch(seed)
    (loss, metrics), g = t_step.value_and_grad(
        params_from_jax(tree), t_config(small_yaml()),
        t_step.TrainConfig(**tcfg_kw), *map(torch.from_numpy,
                                            (feat, lens, targets, tlens)))
    return loss.item(), {k: v.numpy() for k, v in g.items()}


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_loss_fn_and_grads_match_jax(attn_impl):
    """The port's loss and gradients, with the XLA and the flash attention
    paths, against jax.value_and_grad of the JAX loss_fn (XLA attention;
    the flash path is the same function), embed CTC weight 0.3 so that
    the embed encoder trains too. float32: the loss within rtol 1e-5;
    each leaf's gradient within 1e-3 of that leaf's max|g| plus 1e-5 of
    the largest gradient (float32 sums in another order through 5 blocks
    and the CTC recursion; leaves whose gradient is zero in exact
    arithmetic, such as the k biases, hold noise)."""
    tree = random_params(0)
    kw = dict(embed_ctc_weight=0.3)
    ref_loss, ref = _jax_value_and_grad(tree, kw)
    loss, got = _port_value_and_grad(tree, dict(kw, attn_impl=attn_impl))
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert sorted(got) == sorted(ref)
    top = max(np.abs(r).max() for r in ref.values())
    for k in ref:
        err = np.abs(got[k] - ref[k]).max()
        assert err <= 1e-3 * np.abs(ref[k]).max() + 1e-5 * top, (k, err)


def test_embed_encoder_gets_no_gradient_through_routers():
    """With no embed CTC weight the embed encoder trains through nothing
    (the routers see its output detached): every embed/ gradient is
    exactly zero, as jax.grad gives it; other leaves do get gradients."""
    _, got = _port_value_and_grad(random_params(1), {})
    embed = [k for k in got if k.startswith("embed/")]
    assert embed and all(not np.any(got[k]) for k in embed)
    assert np.any(got["blocks/self_attn/linear_q/kernel"])
    assert np.any(got["blocks/feed_forward/router/kernel"])


def test_train_step_matches_jax_step_and_bf16_step_runs():
    """One make_train_step step against the JAX step (loss and gradient
    norm within rtol 1e-4; parameters after the Adam step are not held
    tight: Adam turns near-zero gradients into lr x sign), and a step
    with bf16 compute over float32 master weights: finite, the masters
    stay float32, its loss within 2e-2 of the float32 loss."""
    tree = random_params(2)
    feat, lens, targets, tlens = _batch(4)
    cfg_j, cfg_t = j_config(small_yaml()), t_config(small_yaml())
    jt = j_step.TrainConfig(warmup_steps=10)
    jopt = j_step.make_optimizer(jt)
    jp = jax.tree.map(jnp.asarray, tree)
    _, _, jm = jax.jit(j_step.make_train_step(cfg_j, jt, jopt))(
        jp, jopt.init(jp), feat, lens, targets, tlens)
    losses = {}
    for dtype in ("float32", "bfloat16"):
        tt = t_step.TrainConfig(warmup_steps=10, compute_dtype=dtype,
                                attn_impl="flash")
        opt = t_step.make_optimizer(tt)
        params = params_from_jax(tree)
        step = t_step.make_train_step(cfg_t, tt, opt, device="cpu")
        new, state, m = step(params, t_step.init_opt_state(opt, params),
                             feat, lens, targets, tlens)
        assert state["count"] == 1
        assert all(torch.isfinite(v).all() for v in m.values())
        leaves = flatten_tree(new)
        assert all(v.dtype == torch.float32 for v in leaves.values())
        moved = params_to_numpy(new)["blocks"]["self_attn"]["linear_q"]
        assert not np.array_equal(moved["kernel"],
                                  tree["blocks"]["self_attn"]["linear_q"]
                                  ["kernel"])
        losses[dtype] = m["loss"].item()
        if dtype == "float32":
            np.testing.assert_allclose(losses[dtype], float(jm["loss"]),
                                       rtol=1e-4)
            np.testing.assert_allclose(m["grad_norm"].item(),
                                       float(jm["grad_norm"]), rtol=1e-4)
    assert abs(losses["bfloat16"] - losses["float32"]) <= \
        2e-2 * abs(losses["float32"])


@pytest.mark.parametrize("setting", [
    {"loss_type": "ce"}, {"spec_aug": True}, {"accum_steps": 2},
    {"remat": True}, {"router_l1_weight": 0.1},
    {"router_importance_weight": 0.1}])
def test_unported_train_settings_raise(setting):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_step.make_train_step(t_config(small_yaml()),
                               t_step.TrainConfig(**setting), None,
                               device="cpu")


def test_hier_recipe_and_domain_heads_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_step.make_hier_train_step()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_step.make_train_step(t_config(small_yaml()), t_step.TrainConfig(),
                               None, with_domain_acc=True, device="cpu")
