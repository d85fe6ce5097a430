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


def _optimizer_runs(schedule, conf, optim_type, steps=3, **kw):
    """``steps`` updates of the JAX build_optimizer chain (optax) and of
    the port's on identical numpy gradients; yields (port params, JAX
    params as flat numpy) after each update."""
    rng = np.random.default_rng(1)
    params = {"a": {"w": rng.standard_normal((5, 3)).astype(np.float32),
                    "bias": rng.standard_normal((3,)).astype(np.float32)},
              "norm": {"scale": rng.standard_normal((7,))
                       .astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    jopt = j_lr.build_optimizer(schedule, conf, 0.05, optim_type,
                                params=jp, **kw)
    topt = t_lr.build_optimizer(schedule, conf, 0.05, optim_type,
                                params=params, **kw)
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy())
          for k, v in flatten_tree(params).items()}
    tstate = topt.init(tp)
    for _ in range(steps):
        g = _grads_tree(rng, params)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tu, tstate = topt.update(
            {k: torch.from_numpy(v) for k, v in flatten_tree(g).items()},
            tstate, tp)
        tp = topt.apply_updates(tp, tu)
        yield tp, flatten_tree(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("schedule,optim", [("warmup_cosine", "adam"),
                                            ("warmup_noam", "sgd")])
def test_optimizers_match_optax(schedule, optim):
    """The schedule and optimizer pairs a YAML can name, three updates
    against the JAX build_optimizer chain (optax), clip active: the
    parameters after each update within rtol 1e-4."""
    conf = ({"warmup": 0.34, "total_steps": 6} if schedule ==
            "warmup_cosine" else {"warmup_steps": 2})
    for tp, ref in _optimizer_runs(schedule, conf, optim, max_grad_norm=1.0):
        for k in ref:
            np.testing.assert_allclose(tp[k].numpy(), ref[k], rtol=1e-4,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("optim,kw", [
    ("sgd", {}),
    ("sgd", {"optim_conf": {"momentum": 0.9, "nesterov": True}}),
    ("sgd", {"optim_conf": {"momentum": 0.5}, "weight_decay": 0.1}),
    ("adadelta", {"optim_conf": {"rho": 0.8}}),
    ("adadelta", {"weight_decay": 0.1}),
    ("adamw", {"weight_decay": 0.01, "name_nodecay": ["bias", "norm"]}),
    ("adam", {"weight_decay": 0.01, "name_nodecay": ["scale"]}),
])
def test_optimizer_kinds_match_optax(optim, kw):
    """sgd (with and without a Nesterov trace), adadelta and AdamW with a
    name_nodecay mask, three updates against the optax chain: the
    parameters after each within rtol 1e-4. sgd and adadelta ignore
    weight_decay, as the JAX factory does."""
    for tp, ref in _optimizer_runs("warmup_noam", {"warmup_steps": 2},
                                   optim, max_grad_norm=1.0, **kw):
        for k in ref:
            np.testing.assert_allclose(tp[k].numpy(), ref[k], rtol=1e-4,
                                       atol=1e-7, err_msg=k)


SCHEDULES = {   # name: (schedule_conf, warmup step, total steps)
    "constant": ({}, 10, 100),
    "period_adjust": ({"decay_period": 10, "lr_decay": 0.8}, 10, 100),
    "cv_adjust": ({"lr_decay_count": 3, "lr_decay": 0.5}, 3, 30),
    "warmup_linear": ({"warmup": 0.1, "total_steps": 100}, 10, 100),
    "warmup_cosine": ({"warmup": 0.1, "total_steps": 100}, 10, 100),
    "warmup_plateau": ({"t_step": 10, "d_step": 50, "f_step": 100}, 10,
                       100),
    "warmup_noam": ({"warmup_steps": 10}, 10, 100),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    """Every schedule family at steps 0, 1, w-1, w, w+1, mid, total and
    past total against the JAX schedule on an int32 count: rtol 1e-6."""
    conf, w, total = SCHEDULES[name]
    ref = j_lr.SUPPORTED_SCHEDULER[name](2e-3, **conf)
    got = t_lr.SUPPORTED_SCHEDULER[name](2e-3, **conf)
    for step in (0, 1, w - 1, w, w + 1, (w + total) // 2, total,
                 total + 37):
        np.testing.assert_allclose(got(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6, err_msg=f"{name} {step}")


def test_nodecay_mask_on_the_flagship_tree():
    """nodecay_mask on the flagship's tree (6 + 18 blocks, 32 experts,
    the three AED decoders and the heads; shapes only) equals the JAX
    mask leaf for leaf; get_lr_scale reads what set_lr_scale wrote."""
    from m3asr_tpu.config import load_yaml_config
    from m3asr_tpu.models import aed as j_aed
    from m3asr_tpu.models import moe_conformer as j_model
    cfg = load_yaml_config("configs/3m_asr_18l32e.yaml")
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: {
        "encoder": j_model.init(key, cfg.encoder_conf, 40, 5000),
        **{n: j_aed.init(key, cfg.decoder_conf, 5000, 512)
           for n in ("decoder", "decoder_1", "decoder_2")},
        **j_step.init_domain_acc_heads(key, 512)})
    names = ["bias", "norm", "pos_enc", "pos_bias_u"]
    ref = flatten_tree(jax.tree.map(bool, j_lr.nodecay_mask(shapes, names)))
    got = flatten_tree(t_lr.nodecay_mask(
        jax.tree.map(lambda s: 0, shapes), names))
    assert got == ref and 0 < sum(got.values()) < len(got)
    state = t_lr.set_lr_scale({"count": 3, "lr_scale": 1.0}, 0.25)
    assert t_lr.get_lr_scale(state) == 0.25 and state["count"] == 3


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((3, 7, 9)).astype(np.float32) * 2
    targets = rng.integers(0, 9, (3, 7)).astype(np.int32)
    targets[0, 5:] = -1
    targets[2, 2:] = -1
    return logits, targets


@pytest.mark.parametrize("normalize_length", [False, True])
def test_label_smoothing_loss_matches_jax(normalize_length):
    """Value and gradient with padded targets: allclose(rtol 1e-5, atol
    1e-5)."""
    logits, targets = _loss_inputs()

    def jloss(x):
        return j_losses.label_smoothing_loss(x, jnp.asarray(targets), -1,
                                             0.1, normalize_length)
    ref, ref_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = t_losses.label_smoothing_loss(x, torch.from_numpy(targets), -1,
                                        0.1, normalize_length)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mean_in_frames", [False, True])
def test_ce_loss_matches_jax(mean_in_frames):
    """The loss, its gradient, the likelihood and hit sums and the frame
    count: allclose(rtol 1e-5, atol 1e-5), counts equal."""
    logits, targets = _loss_inputs(1)
    ref = j_losses.ce_loss(jnp.asarray(logits), jnp.asarray(targets), -1,
                           mean_in_frames)
    ref_g = jax.grad(lambda x: j_losses.ce_loss(
        x, jnp.asarray(targets), -1, mean_in_frames)[0])(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = t_losses.ce_loss(x, torch.from_numpy(targets), -1, mean_in_frames)
    got[0].backward()
    for g, r in zip((got[0],) + got[1], (ref[0],) + ref[1]):
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-5, atol=1e-5)
    assert [int(c) for c in got[2]] == [int(c) for c in ref[2]]
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-5)


def test_router_losses_and_balance_metrics_match_jax():
    """router_l1_loss and router_importance_loss (with and without
    lengths, gradients too), gshard_balance_loss, expert_importance_loss
    and balance_metrics on softmax router probabilities: allclose(rtol
    1e-5, atol 1e-5)."""
    rng = np.random.default_rng(2)
    probs = jax.nn.softmax(jnp.asarray(rng.standard_normal((3, 8, 5)),
                                       jnp.float32), -1)
    probs_np = np.asarray(probs)
    lens = np.array([8, 5, 2], np.int32)
    gate = rng.integers(0, 5, (3, 8)).astype(np.int32)
    mask = np.eye(5, dtype=np.float32)[gate]

    def close(got, ref):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    for name in ("router_l1_loss", "router_importance_loss"):
        for lengths in (lens, None):
            jl = None if lengths is None else jnp.asarray(lengths)
            ref, ref_g = jax.value_and_grad(
                lambda p: getattr(j_losses, name)(p, jl))(probs)
            x = torch.from_numpy(probs_np.copy()).requires_grad_(True)
            got = getattr(t_losses, name)(
                x, None if lengths is None else torch.from_numpy(lengths))
            got.backward()
            close(got.item(), ref)
            close(x.grad.numpy(), ref_g)
    tp = torch.from_numpy(probs_np)
    close(t_losses.gshard_balance_loss(tp, torch.from_numpy(mask), 5).item(),
          j_losses.gshard_balance_loss(probs, jnp.asarray(mask), 5))
    close(t_losses.expert_importance_loss(tp, 5).item(),
          j_losses.expert_importance_loss(probs, 5))
    ref = j_losses.balance_metrics(jnp.asarray(gate), 5)
    got = t_losses.balance_metrics(torch.from_numpy(gate), 5)
    assert sorted(got) == sorted(ref)
    for k in ref:
        close(got[k].item(), ref[k])


def test_moe_layer_scale_aux_loss_matches_jax():
    """MoELayerScaleAuxLoss: the annealed scales and the combined loss,
    metric sums and counts of two layers of two aux terms."""
    aux = [[(0.5, 1.5), (2.0, 0.25)], [(1.5, 2.5), (0.5, 0.75)]]
    for minimum in (None, [1.0, 0.2]):
        ref = j_losses.MoELayerScaleAuxLoss(2, [0.1, 0.3], minimum)
        got = t_losses.MoELayerScaleAuxLoss(2, [0.1, 0.3], minimum)
        assert got.adjust_aux_scale([1.6, 0.25]) == \
            ref.adjust_aux_scale([1.6, 0.25])
        r, g = ref(aux), got(aux)
        np.testing.assert_allclose(g[0], r[0], rtol=1e-12)
        assert g[1:] == r[1:]


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


def jax_spec_aug_draws(key, feat_len, D, num_t_mask=2, num_f_mask=2,
                       max_t=50, max_f=10):
    """The draws JAX's spec_augment takes from ``key`` (its own calls, in
    its order), as the port's spec_augment_draws returns them."""
    kt_s, kt_l, kf_s, kf_l = jax.random.split(key, 4)
    B = feat_len.shape[0]
    u = jax.random.uniform(kt_s, (B, num_t_mask))
    hi = jnp.maximum(jnp.asarray(feat_len)[:, None] - 1, 1)
    draws = {"t_start": (u * hi).astype(jnp.int32),
             "t_len": jax.random.randint(kt_l, (B, num_t_mask), 1,
                                         max(max_t, 2)),
             "f_start": jax.random.randint(kf_s, (B, num_f_mask), 0,
                                           max(D - 1, 1)),
             "f_len": jax.random.randint(kf_l, (B, num_f_mask), 1,
                                         max(max_f, 2))}
    return {k: torch.from_numpy(np.asarray(v, np.int32))
            for k, v in draws.items()}


def _setting_runs(monkeypatch, setting):
    """JAX's and the port's (loss, metrics, grads) of the CTC branch under
    ``setting`` on the small model: accum_steps through JAX's
    _accum_value_and_grad, spec_aug with the port handed the draws JAX
    takes from the same key."""
    tree = random_params(3)
    cfg = j_config(small_yaml())
    feat, lens, targets, tlens = _batch(5)
    kw = dict(embed_ctc_weight=0.3, **setting)
    jt = j_step.TrainConfig(**kw)
    key = jax.random.PRNGKey(11) if jt.spec_aug else None
    jp = jax.tree.map(jnp.asarray, tree)
    if jt.accum_steps > 1:
        def per_mb(p, mb, r):
            return j_step.loss_fn(p, cfg, jt, *mb[:4], rng=r)
        (loss, metrics), g = jax.jit(lambda p: j_step._accum_value_and_grad(
            per_mb, p, (feat, lens, targets, tlens), None,
            jt.accum_steps))(jp)
    else:
        (loss, metrics), g = jax.jit(jax.value_and_grad(
            lambda p: j_step.loss_fn(p, cfg, jt, feat, lens, targets, tlens,
                                     rng=key), has_aux=True))(jp)
    ref = (float(loss), {k: float(v) for k, v in metrics.items()},
           flatten_tree(jax.tree.map(np.asarray, g)))
    if jt.spec_aug:
        draws = jax_spec_aug_draws(jax.random.split(key)[1],
                                   lens, feat.shape[2])
        monkeypatch.setattr(t_masking, "spec_augment_draws",
                            lambda *a, **k: draws)
    (loss, metrics), g = t_step.value_and_grad(
        params_from_jax(tree), t_config(small_yaml()),
        t_step.TrainConfig(**kw), *map(torch.from_numpy,
                                       (feat, lens, targets, tlens)),
        generator=torch.Generator().manual_seed(0))
    got = (loss.item(), {k: v.item() for k, v in metrics.items()},
           {k: v.numpy() for k, v in g.items()})
    return got, ref


def _assert_grads_close(got, ref):
    """Each leaf's gradient within 1e-3 of that leaf's max|g| plus 1e-5 of
    the largest gradient (the criterion of
    test_loss_fn_and_grads_match_jax)."""
    assert sorted(got) == sorted(ref)
    top = max(np.abs(r).max() for r in ref.values())
    for k in ref:
        err = np.abs(got[k] - ref[k]).max()
        assert err <= 1e-3 * np.abs(ref[k]).max() + 1e-5 * top, (k, err)


@pytest.mark.parametrize("setting", [
    {"loss_type": "ce"}, {"spec_aug": True}, {"accum_steps": 2},
    {"remat": True}, {"router_l1_weight": 0.1},
    {"router_importance_weight": 0.1}])
def test_train_settings_match_jax(monkeypatch, setting):
    """Each TrainConfig setting of the CTC branch against the JAX loss_fn
    under the same setting: the CE loss with its likelihood and accuracy
    metrics (labels padded to the model's frames), SpecAugment given
    JAX's draws, two accumulated microbatches against JAX's
    _accum_value_and_grad, remat, and the router weights (which the
    branch does not read, in either package). The loss and every metric
    within rtol 1e-5, the gradients as in
    test_loss_fn_and_grads_match_jax."""
    got, ref = _setting_runs(monkeypatch, setting)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    assert sorted(got[1]) == sorted(ref[1])
    for k in ref[1]:
        np.testing.assert_allclose(got[1][k], ref[1][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _assert_grads_close(got[2], ref[2])


def test_accumulated_and_remat_steps_match_plain():
    """Two accumulated microbatches against the full batch (every CTC term
    is a batch mean) and remat against plain, on the port alone: the loss
    within rtol 1e-5 and the gradients as in
    test_loss_fn_and_grads_match_jax (remat recomputes the same
    arithmetic)."""
    tree = random_params(4)
    args = map(torch.from_numpy, _batch(6))
    args = list(args)
    runs = {}
    for name, kw in (("plain", {}), ("accum", {"accum_steps": 2}),
                     ("remat", {"remat": True, "attn_impl": "flash"}),
                     ("flash", {"attn_impl": "flash"})):
        (loss, _), g = t_step.value_and_grad(
            params_from_jax(tree), t_config(small_yaml()),
            t_step.TrainConfig(embed_ctc_weight=0.3, **kw), *args)
        runs[name] = (loss.item(), {k: v.numpy() for k, v in g.items()})
    for a, b in (("accum", "plain"), ("remat", "flash")):
        np.testing.assert_allclose(runs[a][0], runs[b][0], rtol=1e-5)
        _assert_grads_close(runs[a][1], runs[b][1])
    with pytest.raises(ValueError, match="not divisible by accum_steps 3"):
        t_step.value_and_grad(params_from_jax(tree), t_config(small_yaml()),
                              t_step.TrainConfig(accum_steps=3), *args)


def test_hier_recipe_and_domain_heads_match_jax():
    """One make_hier_train_step update with the domain/accent heads
    against the JAX step (the recipe a run with AED labels and heads
    takes), with SGD and a momentum trace (Adam would turn the noise of
    gradients that are zero in exact arithmetic into lr x sign): the loss,
    each metric and the gradient norm within rtol 1e-5; the parameters
    after the update within rtol 1e-4 of the largest value of each
    leaf."""
    from test_torch_hier_train import hier_batch, hier_trees
    jtree, cfg_j, cfg_t = hier_trees(heads=True)
    batch = hier_batch(heads=True)
    sgd = ("constant", {}, 0.05, "sgd", {"momentum": 0.9})
    jt = j_step.HierTrainConfig(ce_weight=0.5)
    jopt = j_lr.build_optimizer(*sgd, max_grad_norm=5.0)
    jp = jax.tree.map(jnp.asarray, jtree)
    jnew, _, jm = jax.jit(j_step.make_hier_train_step(
        cfg_j, jt, jopt, with_domain_acc=True))(jp, jopt.init(jp), *batch)
    tt = t_step.HierTrainConfig(ce_weight=0.5)
    opt = t_lr.build_optimizer(*sgd, max_grad_norm=5.0)
    params = params_from_jax(jtree)
    new, _, m = t_step.make_hier_train_step(
        cfg_t, tt, opt, with_domain_acc=True, device="cpu")(
            params, t_step.init_opt_state(opt, params), *batch)
    assert sorted(m) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    ref = flatten_tree(jax.tree.map(np.asarray, jnew))
    got = flatten_tree(params_to_numpy(new))
    for k in ref:
        tol = 1e-4 * max(np.abs(ref[k]).max(), 1e-3)
        assert np.abs(got[k] - ref[k]).max() <= tol, k


@pytest.mark.parametrize("proto", ["dfsmn_san_res",
                                   "conformer_aed"])
def test_other_families_refuse_to_train(proto):
    """The CTC step builds for a DFSMN or dense conformer proto; the hier
    AED recipe, which runs the MoE conformer's forward and taps, refuses
    them up front with a ValueError naming the proto (the JAX recipe
    fails inside its forward)."""
    raw = dict(small_yaml(), nnet_proto=proto)
    t_step.make_train_step(t_config(raw), t_step.TrainConfig(), None,
                           device="cpu")
    with pytest.raises(ValueError, match=proto):
        t_step.make_hier_train_step(t_config(raw), t_step.HierTrainConfig(),
                                    None, device="cpu")


def test_ctc_step_refuses_domain_heads():
    """The CTC step with the domain/accent ids on a proto without in-model
    heads (the small MoE conformer) takes them in the JAX positional
    order and does not read them, as the JAX loss_fn: its update equals
    the step's without them, bit for bit."""
    tree = random_params(6)
    feat, lens, targets, tlens = _batch(7)
    tt = t_step.TrainConfig(warmup_steps=10)
    opt = t_step.make_optimizer(tt)
    cfg = t_config(small_yaml())
    runs = []
    for heads in (False, True):
        params = params_from_jax(tree)
        step = t_step.make_train_step(cfg, tt, opt, with_domain_acc=heads,
                                      device="cpu")
        extra = (np.array([1, 0], np.int32), np.array([2, 3], np.int32)) \
            if heads else ()
        runs.append(step(params, t_step.init_opt_state(opt, params), feat,
                         lens, targets, tlens, *extra))
    (p0, _, m0), (p1, _, m1) = runs
    assert sorted(m0) == sorted(m1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    f0, f1 = flatten_tree(p0), flatten_tree(p1)
    assert all(torch.equal(f0[k], f1[k]) for k in f0)


@pytest.fixture
def tf32_on():
    """Both TF32 flags set for the test, restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_train_step_turns_tf32_off_for_fp32(monkeypatch, tf32_on,
                                                 dtype):
    """A float32 step built for CUDA runs full float32: make_train_step
    turns TF32 off for cuBLAS and cuDNN (whose convolutions default to
    it), as the engine does; bf16 compute leaves both flags alone."""
    monkeypatch.setattr(t_step, "resolve_device",
                        lambda device: torch.device("cuda"))
    tt = t_step.TrainConfig(compute_dtype=dtype)
    t_step.make_train_step(t_config(small_yaml()), tt,
                           t_step.make_optimizer(tt))
    want = dtype == "bfloat16"
    assert torch.backends.cuda.matmul.allow_tf32 is want
    assert torch.backends.cudnn.allow_tf32 is want
