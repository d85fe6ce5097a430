"""BMUF training of the PyTorch port (train/bmuf.py and the Trainer's BMUF
mode) against the JAX package, on the CPU:

* ``bmuf_update``, ``BmufRecipe.sync`` (two syncs, then a STOP on a
  non-finite delta), ``split_expert_params`` and ``MoEBmufTrainer`` on
  the same numpy trees (a leading replica axis of 2 where stacked);
* the port's Trainer in BMUF mode (two replicas, a sync every three
  steps) with the port's step against the JAX Trainer with
  ``jax.vmap`` of the JAX step, over two epochs with validation: the
  logged scalars, the counters, the parameters and the ``bmuf`` entry of
  each checkpoint.

Tolerances: the tree arithmetic within rtol 1e-6 (float32, the same
formulas); the trainers as ``test_torch_trainer`` holds them (scalars
rtol 1e-5, parameters within rtol 1e-4 of each leaf's largest value)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import torch

from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.train import bmuf as j_bmuf
from m3asr_tpu.train import lr_scheduler as j_lr
from m3asr_tpu.train import step as j_step
from m3asr_tpu.train.trainer import Trainer as JTrainer

from m3asr_tpu_torch.checkpoint import (flatten_tree, params_from_jax,
                                        params_to_numpy)
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.train import bmuf as t_bmuf
from m3asr_tpu_torch.train import lr_scheduler as t_lr
from m3asr_tpu_torch.train import step as t_step
from m3asr_tpu_torch.train.trainer import Trainer

from test_torch_model import random_params, small_yaml
from test_torch_trainer import (SGD, STATE_KEYS, VALID, _assert_params_match,
                                _loader, _scalar_rows, make_batches)

M, BLR = 0.5, 0.9


def tree(seed, lead=()):
    """A numpy tree with expert leaves (w1, b1, w2; b2 None), a router
    and a shared linear, every array with the leading shape ``lead``."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(lead + shape).astype(np.float32)
    return {"blocks": [{"w1": a(2, 3, 4), "b1": a(2, 4), "w2": a(2, 4, 3),
                        "b2": None, "router": {"kernel": a(3, 2)}}
                       for _ in range(2)],
            "out": {"kernel": a(3, 5), "bias": a(5)}}


def to_t(t):
    return params_from_jax(t)


def to_j(t):
    return jax.tree.map(jnp.asarray, t)


def assert_trees_close(got, ref, rtol=1e-6):
    """A port tree (tensors) against a JAX tree, leaf for leaf."""
    ref = flatten_tree(jax.tree.map(np.asarray, ref))
    got = flatten_tree(params_to_numpy(got))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=1e-7,
                                   err_msg=k)


def test_bmuf_update_matches_jax():
    """Two bmuf_update calls from init_state (the second with momentum
    carried) and a mean_fn: new global, delta_prev and status equal
    JAX's; a non-finite local tree gives STOP."""
    g0, l1, l2 = tree(0), tree(1), tree(2)
    half = lambda x: 0.5 * x                 # noqa: E731
    js, ts = j_bmuf.init_state(to_j(g0)), t_bmuf.init_state(to_t(g0))
    for local in (l1, l2):
        js, jg, jstat = j_bmuf.bmuf_update(js, to_j(local), M, BLR, half)
        ts, tg, tstat = t_bmuf.bmuf_update(ts, to_t(local), M, BLR, half)
        assert tstat == int(jstat) == t_bmuf.SUCCESS
        assert_trees_close(tg, jg)
        assert_trees_close(ts.delta_prev, js.delta_prev)
    bad = tree(3)
    bad["out"]["bias"][1] = np.nan
    _, _, jstat = j_bmuf.bmuf_update(js, to_j(bad), M, BLR)
    _, _, tstat = t_bmuf.bmuf_update(ts, to_t(bad), M, BLR)
    assert tstat == int(jstat) == t_bmuf.STOP


def test_recipe_sync_and_stop_match_jax():
    """BmufRecipe on the same stacked tree (dp = 2): stack() of an
    unstacked tree, the initial global (the replicas' mean), two syncs
    (the replicas moved apart in between) whose new stacked trees and
    state equal JAX's, then a replica with a NaN: ok False, the stacked
    tree handed back as it was and the state unchanged, in both; the
    state_dicts equal."""
    base = tree(4)
    jr = j_bmuf.BmufRecipe(j_bmuf.BmufRecipe.stack(to_j(base), 2), 2,
                           block_momentum=M, block_lr=BLR)
    stacked = t_bmuf.BmufRecipe.stack(to_t(base), 2)
    assert_trees_close(stacked, j_bmuf.BmufRecipe.stack(to_j(base), 2))
    tr = t_bmuf.BmufRecipe(stacked, 2, block_momentum=M, block_lr=BLR)
    assert tr.dp == jr.dp == 2
    assert_trees_close(tr.state.global_params, jr.state.global_params)
    for seed in (5, 6):
        moved = tree(seed, lead=(2,))
        jnew, jok = jr.sync(to_j(moved))
        tnew, tok = tr.sync(to_t(moved))
        assert tok and jok
        assert_trees_close(tnew, jnew)
        assert_trees_close(tr.state.delta_prev, jr.state.delta_prev)
    bad = tree(7, lead=(2,))
    bad["blocks"][1]["w2"][1, 0, 0, 0] = np.nan
    before = flatten_tree(params_to_numpy(tr.state.global_params))
    jback, jok = jr.sync(to_j(bad))
    tback, tok = tr.sync(to_t(bad))
    assert not tok and not jok
    assert_trees_close(tback, jback)
    after = flatten_tree(params_to_numpy(tr.state.global_params))
    assert all(np.array_equal(after[k], v) for k, v in before.items())
    jd, td = jr.state_dict(), tr.state_dict()
    assert {k: td[k] for k in ("block_momentum", "block_lr",
                               "sync_period")} == \
        {k: jd[k] for k in ("block_momentum", "block_lr", "sync_period")}
    for k in ("global_params", "delta_prev"):
        assert_trees_close(td[k], jd[k])
    again = t_bmuf.BmufRecipe(stacked, 9)
    again.load_state_dict(jd)
    assert again.sync_period == 2 and again.block_momentum == M
    assert_trees_close(again.state.delta_prev, jr.state.delta_prev)


def test_moe_bmuf_trainer_matches_jax():
    """MoEBmufTrainer with different means for the expert weights (w1, b1,
    w2) and the shared ones: the expert masks and two update_and_sync
    results equal JAX's; a non-finite local tree returns it with STOP."""
    mean_dp, mean_world = (lambda x: 0.5 * x), (lambda x: 0.25 * x)
    base = tree(8)
    jt = j_bmuf.MoEBmufTrainer(to_j(base), M, BLR, mean_dp, mean_world)
    tt = t_bmuf.MoEBmufTrainer(to_t(base), M, BLR, mean_dp, mean_world)
    jmask = flatten_tree(jax.tree.map(bool, jt.expert_mask))
    tmask = flatten_tree(tt.expert_mask)
    assert tmask == jmask and 0 < sum(tmask.values()) < len(tmask)
    for seed in (9, 10):
        jg, jstat = jt.update_and_sync(to_j(tree(seed)))
        tg, tstat = tt.update_and_sync(to_t(tree(seed)))
        assert tstat == jstat == t_bmuf.SUCCESS
        assert_trees_close(tg, jg)
    bad = tree(11)
    bad["blocks"][0]["b1"][0, 0] = np.inf
    back, tstat = tt.update_and_sync(to_t(bad))
    _, jstat = jt.update_and_sync(to_j(bad))
    assert tstat == jstat == t_bmuf.STOP
    assert_trees_close(back, to_j(bad))


def _bmuf_trainers(path):
    """The JAX Trainer (jax.vmap of the JAX step, optax state stacked)
    and the port's (its step, its state stacked), BMUF recipes of two
    replicas syncing every three steps, from the same parameters."""
    params = random_params(5)
    cfg_j, cfg_t = j_config(small_yaml()), t_config(small_yaml())
    jopt = j_lr.build_optimizer(*SGD, max_grad_norm=5.0)
    topt = t_lr.build_optimizer(*SGD, max_grad_norm=5.0)
    jp = j_bmuf.BmufRecipe.stack(to_j(params), 2)
    jstep = jax.jit(jax.vmap(j_step.make_train_step(
        cfg_j, j_step.TrainConfig(), jopt)))
    tp = t_bmuf.BmufRecipe.stack(to_t(params), 2)
    tstep = t_step.make_train_step(cfg_t, t_step.TrainConfig(), topt,
                                   device="cpu")
    kw = dict(valid_loader=lambda: iter(VALID), log_period=1,
              save_period=3, max_epochs=2)
    jt = JTrainer(cfg_j, jp, jopt, jstep, make_loader=_loader(make_batches(4)),
                  save_dir=str(path / "jax"),
                  scalar_dir=str(path / "jax" / "scalars"),
                  bmuf=j_bmuf.BmufRecipe(jp, 3, block_momentum=M,
                                         block_lr=BLR),
                  opt_state=j_bmuf.BmufRecipe.stack(
                      jopt.init(to_j(params)), 2), **kw)
    tt = Trainer(cfg_t, tp, topt, tstep, make_loader=_loader(make_batches(4)),
                 save_dir=str(path / "torch"),
                 scalar_dir=str(path / "torch" / "scalars"),
                 bmuf=t_bmuf.BmufRecipe(tp, 3, block_momentum=M,
                                        block_lr=BLR),
                 opt_state=t_bmuf.BmufRecipe.stack(
                     t_step.init_opt_state(topt, to_t(params)), 2), **kw)
    jvalid = jax.jit(lambda p, *b: j_step.loss_fn(
        p, cfg_j, j_step.TrainConfig(), *b)[0])

    def tvalid(p, *b):
        with torch.no_grad():
            return t_step.loss_fn(p, cfg_t, t_step.TrainConfig(),
                                  *map(torch.as_tensor, b))[0].item()
    return (jt, jvalid), (tt, tvalid)


def test_bmuf_trainer_matches_jax_trainer(tmp_path):
    """Two epochs of four batches split over two replicas (one utterance
    each), a sync every three steps, validation on replica 0 after each
    epoch, a checkpoint every three steps: the scalar rows (tags and
    steps equal, losses and gradient norms (replica means) and
    validation losses within rtol 1e-5), the counters and recent
    checkpoints, the stacked parameters (rtol 1e-4 of each leaf's
    largest value), and checkpoint_{last,best}.pkl: their counters,
    parameters and bmuf entry (settings equal, global parameters and
    block momentum buffer within the same bound)."""
    (jt, jvalid), (tt, tvalid) = _bmuf_trainers(tmp_path)
    for t, valid in ((jt, jvalid), (tt, tvalid)):
        t.run(valid)
        for w in t.writers:
            w.close()
    assert tt.global_step == jt.global_step == 8
    for k in STATE_KEYS + ("recent_models",):
        assert getattr(tt, k) == getattr(jt, k), k
    np.testing.assert_allclose(tt.best_valid, jt.best_valid, rtol=1e-5)
    _assert_params_match(tt.params, jt.params)
    ref, got = (_scalar_rows(tmp_path / side) for side in ("jax", "torch"))
    assert [(r["step"], r["tag"]) for r in got] == \
        [(r["step"], r["tag"]) for r in ref]
    for g, r in zip(got, ref):
        if r["tag"] != "train/frames_per_s":
            np.testing.assert_allclose(g["value"], r["value"], rtol=1e-5,
                                       err_msg=f"{r['tag']} {r['step']}")
    for name in ("checkpoint_last.pkl", "checkpoint_best.pkl"):
        states = []
        for side in ("jax", "torch"):
            with open(tmp_path / side / name, "rb") as f:
                states.append(pickle.load(f))
        ref_state, state = states
        for k in STATE_KEYS:
            assert state[k] == ref_state[k], (name, k)
        _assert_params_match(params_from_jax(state["params"]),
                             ref_state["params"])
        rb, gb = ref_state["bmuf"], state["bmuf"]
        for k in ("block_momentum", "block_lr", "sync_period"):
            assert gb[k] == rb[k], (name, k)
        for k in ("global_params", "delta_prev"):
            _assert_params_match(params_from_jax(gb[k]), rb[k])
