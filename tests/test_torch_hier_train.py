"""The hier AED training recipe of the PyTorch port against the JAX
package, on the CPU: add_sos_eos, hier_aed_loss_fn's loss, metrics and
gradients (XLA and flash attention, with and without the domain/accent
heads), two make_hier_train_step updates, and gradient accumulation.

The model is the small hier MoE conformer of ``test_torch_model``
(2 embed and 3 MoE blocks, width 32, 4 experts) with three AED decoders
of one block (4 heads, 48 units) and the heads. Parameters and inputs
are numpy from a seed, handed to both packages; flash runs its plain
versions on the CPU. Tolerances are stated at each test."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.models import aed as j_aed
from m3asr_tpu.train import lr_scheduler as j_lr
from m3asr_tpu.train import step as j_step

from m3asr_tpu_torch.checkpoint import (flatten_tree, params_from_jax,
                                        params_to_numpy)
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.train import lr_scheduler as t_lr
from m3asr_tpu_torch.train import step as t_step

from test_torch_model import random_params, small_yaml

DECODERS = ("decoder", "decoder_1", "decoder_2")


def hier_yaml():
    raw = small_yaml()
    raw["model_conf"]["decoder_conf"] = {
        "attention_heads": 4, "linear_units": 48, "num_blocks": 1}
    return raw


def hier_trees(heads=False, seed=0):
    """(numpy tree {encoder, decoder, decoder_1, decoder_2[, heads]}, JAX
    config, port config)."""
    cfg = j_config(hier_yaml())
    tree = {"encoder": random_params(seed)}
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), 4)
    for k, name in zip(keys, DECODERS):
        tree[name] = j_aed.init(k, cfg.decoder_conf, 11, 32)
    if heads:
        tree.update(j_step.init_domain_acc_heads(keys[3], 24, 3, 4))
    return (jax.tree.map(np.asarray, tree), cfg, t_config(hier_yaml()))


def hier_batch(heads=False, seed=3):
    """feat, lens, CTC targets and lengths, AED targets and lengths
    [, domain ids, accent ids] of 4 utterances."""
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((4, 53, 20)).astype(np.float32)
    lens = np.array([53, 37, 45, 29], np.int32)
    targets = rng.integers(1, 10, (4, 5)).astype(np.int32)
    tlens = np.array([5, 3, 4, 2], np.int32)
    aed = rng.integers(1, 10, (4, 6)).astype(np.int32)
    alens = np.array([6, 2, 5, 3], np.int32)
    out = (feat, lens, targets, tlens, aed, alens)
    if heads:
        out += (np.array([0, 2, 1, 2], np.int32),
                np.array([3, 1, 0, 2], np.int32))
    return out


def _kw(heads):
    return dict(ce_weight=0.5, router_l1_weight=0.01,
                router_importance_weight=0.02,
                loss_scale=1e-4 if heads else 1.0)


@functools.lru_cache(maxsize=None)
def _jax_ref(heads, accum=1):
    """JAX's (loss, metrics, flat grads) of the recipe (XLA attention)."""
    tree, cfg, _ = hier_trees(heads)
    batch = hier_batch(heads)
    tcfg = j_step.HierTrainConfig(accum_steps=accum, **_kw(heads))

    def loss(p, mb, r=None):
        dom, acc = (mb[6], mb[7]) if heads else (None, None)
        return j_step.hier_aed_loss_fn(p, cfg, tcfg, *mb[:6],
                                       domain_targets=dom, acc_targets=acc)
    jp = jax.tree.map(jnp.asarray, tree)
    if accum > 1:
        (l, m), g = jax.jit(lambda p: j_step._accum_value_and_grad(
            loss, p, batch, None, accum))(jp)
    else:
        (l, m), g = jax.jit(jax.value_and_grad(
            lambda p: loss(p, batch), has_aux=True))(jp)
    return (float(l), {k: float(v) for k, v in m.items()},
            flatten_tree(jax.tree.map(np.asarray, g)))


def _port(heads, attn_impl="xla", accum=1):
    tree, _, cfg = hier_trees(heads)
    batch = [torch.from_numpy(a) for a in hier_batch(heads)]
    if not heads:
        batch += [None, None]
    tcfg = t_step.HierTrainConfig(accum_steps=accum, attn_impl=attn_impl,
                                  **_kw(heads))
    (l, m), g = t_step.hier_value_and_grad(
        params_from_jax(tree), cfg, tcfg, *batch[:6],
        domain_targets=batch[6], acc_targets=batch[7])
    return (l.item(), {k: v.item() for k, v in m.items()},
            {k: v.numpy() for k, v in g.items()})


def _assert_close(got, ref):
    """The loss and every metric within rtol 1e-5 (atol 1e-6); each leaf's
    gradient within 1e-3 of that leaf's max|g| plus 1e-5 of the largest
    gradient (float32 sums in another order through 5 blocks, three
    decoders and the CTC recursion)."""
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    assert sorted(got[1]) == sorted(ref[1])
    for k in ref[1]:
        np.testing.assert_allclose(got[1][k], ref[1][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert sorted(got[2]) == sorted(ref[2])
    top = max(np.abs(r).max() for r in ref[2].values())
    for k in ref[2]:
        err = np.abs(got[2][k] - ref[2][k]).max()
        assert err <= 1e-3 * np.abs(ref[2][k]).max() + 1e-5 * top, (k, err)


def test_add_sos_eos_matches_jax():
    ys = np.array([[3, 5, 7], [2, 4, 0], [6, 0, 0]], np.int32)
    lens = np.array([3, 2, 0], np.int32)
    ref = j_step.add_sos_eos_jnp(jnp.asarray(ys), jnp.asarray(lens), 8, 9,
                                 -1)
    got = t_step.add_sos_eos_t(torch.from_numpy(ys), torch.from_numpy(lens),
                               8, 9, -1)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("heads", [False, True])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_hier_loss_metrics_and_grads_match_jax(attn_impl, heads):
    """hier_aed_loss_fn with the router aux terms, embed CTC weight 0.3,
    and (heads) the domain/accent CE at weight 0.5 with loss_scale 1e-4,
    against jax.value_and_grad of the JAX recipe (XLA attention; the
    port's flash path is the same function). Every float leaf has a
    gradient: the decoders' sinusoid tables too."""
    got, ref = _port(heads, attn_impl), _jax_ref(heads)
    _assert_close(got, ref)
    assert "decoder/pos_enc/pe" in got[2]
    if heads:
        assert np.any(got[2]["domain_head/out/kernel"])
        assert np.any(got[2]["encoder/embed/blocks/self_attn/linear_q/"
                             "kernel"])


def test_hier_accumulation_matches_jax():
    """accum_steps=2 against JAX's _accum_value_and_grad on the same two
    microbatches, with the heads, as test_hier_loss_metrics_and_grads."""
    _assert_close(_port(True, "flash", accum=2), _jax_ref(True, accum=2))


def test_two_hier_updates_match_jax():
    """Two make_hier_train_step updates against the JAX step, with SGD
    and a momentum trace (the step's parameters then carry the gradients'
    own agreement; Adam's update of identical gradients is held by
    test_torch_train.py, and Adam turns the noise of gradients that are
    zero in exact arithmetic, such as the k biases', into lr x sign): the
    loss and gradient norm of each within rtol 1e-5, the parameters after
    each update within rtol 1e-4 of each leaf's largest value, and the
    decoders' sinusoid tables move, as JAX's do."""
    tree, cfg_j, cfg_t = hier_trees(seed=2)
    batch = hier_batch(seed=4)
    jt = j_step.HierTrainConfig(loss_scale=1.0)
    sgd = ("constant", {}, 0.05, "sgd", {"momentum": 0.9})
    jopt = j_lr.build_optimizer(*sgd, max_grad_norm=5.0)
    jstep = jax.jit(j_step.make_hier_train_step(cfg_j, jt, jopt))
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    tt = t_step.HierTrainConfig(loss_scale=1.0)
    opt = t_lr.build_optimizer(*sgd, max_grad_norm=5.0)
    step = t_step.make_hier_train_step(cfg_t, tt, opt, device="cpu")
    p = params_from_jax(tree)
    s = t_step.init_opt_state(opt, p)
    for _ in range(2):
        jp, js, jm = jstep(jp, js, *batch)
        p, s, m = step(p, s, *batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5)
        ref = flatten_tree(jax.tree.map(np.asarray, jp))
        got = flatten_tree(params_to_numpy(p))
        assert sorted(got) == sorted(ref)
        for k in ref:
            tol = 1e-4 * max(np.abs(ref[k]).max(), 1e-3)
            assert np.abs(got[k] - ref[k]).max() <= tol, k
    pe = got["decoder_1/pos_enc/pe"]
    assert not np.array_equal(pe, tree["decoder_1"]["pos_enc"]["pe"])


def test_domain_acc_heads_init_has_the_jax_tree():
    ref = j_step.init_domain_acc_heads(jax.random.PRNGKey(0), 24, 6, 8)
    got = t_step.init_domain_acc_heads(torch.Generator().manual_seed(0),
                                       24, 6, 8)
    assert {k: tuple(v.shape) for k, v in flatten_tree(got).items()} == \
        {k: np.shape(v) for k, v in flatten_tree(ref).items()}


class PinnedGates:
    """Records the top-1 expert of every token at every MoE block, or
    sends each block's tokens to a recorded run's experts (``replay``):
    the full batch's routing, split into the microbatches' rows."""

    def __init__(self, replay=None):
        self.replay, self.calls = replay, []

    def __enter__(self):
        from m3asr_tpu_torch.ops import moe
        self.moe, self.inner = moe, moe.softmax_top1_gate

        def gate(p, router_inputs, lengths):
            value, idx = self.inner(p, router_inputs, lengths)
            if self.replay is not None:
                idx = self.replay[len(self.calls)]
            self.calls.append(idx)
            return value, idx
        moe.softmax_top1_gate = gate
        return self

    def __exit__(self, *exc):
        self.moe.softmax_top1_gate = self.inner


def _f64_grads(accum, replay=None, **kw):
    """The port's float64 hier gradients (heads on) and its routing."""
    tree, _, cfg = hier_trees(heads=True)
    params = jax.tree.map(lambda a: torch.tensor(
        a, dtype=torch.float64 if a.dtype == np.float32 else None), tree)
    batch = [torch.from_numpy(a) for a in hier_batch(heads=True)]
    batch[0] = batch[0].double()
    tcfg = t_step.HierTrainConfig(accum_steps=accum, **kw)
    with PinnedGates(replay) as rec:
        _, g = t_step.hier_value_and_grad(
            params, cfg, tcfg, *batch[:6], domain_targets=batch[6],
            acc_targets=batch[7])
    return g, rec.calls


def _split(calls, n=2):
    """A full batch's routing as the microbatches' (each block's rows)."""
    rows = calls[0].shape[0] // n
    return [c[i * rows:(i + 1) * rows] for i in range(n) for c in calls]


@pytest.mark.parametrize("router_aux", [False, True])
def test_hier_split_is_exact_in_float64(router_aux):
    """The hier recipe with the heads, in float64 throughout (the loss
    heads' casts keep float64), on the small model's 3 MoE blocks: fewer
    than the taps' 6, so h6 = h12 = the last block's output (the clamped
    case). Routing pinned to the full batch's. Without the router aux
    terms every loss is a batch mean, and accum_steps=2 equals
    accum_steps=1 per leaf within 1e-9 of the leaf's max|g|. With them
    (L1 at 0.01, importance at 0.02), each microbatch normalizes its aux
    terms over its own tokens, as the JAX scan does: the accum_steps=2
    gradient equals accum_steps=1's of the batch-mean terms plus
    accum_steps=2's of the aux terms alone, within the same bound. A
    leaf whose gradient is zero in exact arithmetic (the k biases: the
    softmax ignores a shift) holds only rounding noise, so every bound
    also allows 1e-12 of the largest gradient."""
    aux = dict(router_l1_weight=0.01, router_importance_weight=0.02)
    g1, calls = _f64_grads(1, ce_weight=0.5)
    mb = _split(calls)
    if not router_aux:
        got, ref = _f64_grads(2, mb, ce_weight=0.5)[0], g1
    else:
        got = _f64_grads(2, mb, ce_weight=0.5, **aux)[0]
        only = _f64_grads(2, mb, ce_weight=0.0, loss_scale=0.0,
                          embed_ctc_weight=0.0, **aux)[0]
        ref = {k: g1[k] + only[k] for k in g1}
    assert sorted(got) == sorted(ref)
    assert all(v.dtype == torch.float64 for v in got.values())
    top = max(v.abs().max().item() for v in ref.values())
    for k in ref:
        err = (got[k] - ref[k]).abs().max().item()
        assert err <= 1e-9 * ref[k].abs().max().item() + 1e-12 * top, \
            (k, err)
