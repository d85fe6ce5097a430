"""The training harness of the PyTorch port (train/trainer.py,
train/metrics.py) against the JAX package's, on the CPU: the port's
Trainer with the port's step against the JAX Trainer with the JAX step
from the same parameters (logged losses, validation and best-model
tracking, checkpoint timing and contents, a run stopped mid-epoch and
resumed, divergence recovery after JAX's test_divergence_recovery); the
loss falls and a resumed run with SpecAugment drawn per step equals, bit
for bit, one never stopped; the checkpoint layout; the scalar writers
(JAX's read_tb_scalars reads the port's TensorBoard event file).

The model is the small hier MoE conformer of ``test_torch_model`` (2
embed and 3 MoE blocks, width 32) with inputs from a numpy seed."""

import io
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.train import lr_scheduler as j_lr
from m3asr_tpu.train import metrics as j_metrics
from m3asr_tpu.train import step as j_step
from m3asr_tpu.train.trainer import Trainer as JTrainer

from m3asr_tpu_torch.checkpoint import (flatten_tree, params_from_jax,
                                        params_to_numpy)
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.train import lr_scheduler as t_lr
from m3asr_tpu_torch.train import metrics as t_metrics
from m3asr_tpu_torch.train import step as t_step
from m3asr_tpu_torch.train.trainer import Trainer

from test_torch_model import random_params, small_yaml


def make_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"data": rng.standard_normal((2, 31, 20)).astype(np.float32),
             "lens": np.array([31, 25], np.int32),
             "target": rng.integers(1, 11, (2, 3)).astype(np.int32),
             "target_lens": np.array([3, 2], np.int32)} for _ in range(n)]


def _setup(spec_aug=True):
    cfg = t_config(small_yaml())
    tcfg = t_step.TrainConfig(learning_rate=2e-3, warmup_steps=4,
                              spec_aug=spec_aug,
                              spec_aug_conf={"max_t": 5, "max_f": 3})
    opt = t_step.make_optimizer(tcfg)
    step = t_step.make_train_step(cfg, tcfg, opt, device="cpu")
    return cfg, tcfg, opt, step


def _trainer(path, batches, opt, step, cfg, stop_after=None, **kw):
    def loader(skip):
        for i, b in enumerate(batches[skip // 2:]):
            if stop_after is not None and i == stop_after:
                raise KeyboardInterrupt("stopped")
            yield b
    return Trainer(cfg, params_from_jax(random_params(5)), opt, step,
                   make_loader=loader, save_dir=str(path),
                   step_takes_rng=True, seed=3, **kw)


def test_training_reduces_loss_and_resume_equals_uninterrupted(tmp_path):
    """Two epochs over four batches with SpecAugment drawn per step: the
    loss of the first batch falls. A second run stopped after its third
    step (checkpoint every step) and resumed from checkpoint_last ends
    with parameters and Adam moments equal bit for bit to the first
    run's: the resume skips the consumed utterances, restores the
    optimizer state and draws the same masks (generators seeded from
    (seed, global_step))."""
    cfg, tcfg, opt, step = _setup()
    batches = make_batches(4)
    full = _trainer(tmp_path / "a", batches, opt, step, cfg, max_epochs=2,
                    log_period=1)
    vcfg = t_step.TrainConfig()
    args = [torch.from_numpy(batches[0][k]) for k in
            ("data", "lens", "target", "target_lens")]
    before = t_step.loss_fn(full.params, cfg, vcfg, *args)[0].item()
    full.run()
    after = t_step.loss_fn(full.params, cfg, vcfg, *args)[0].item()
    assert full.global_step == 8 and after < before

    cut = _trainer(tmp_path / "b", batches, opt, step, cfg, max_epochs=2,
                   log_period=1, stop_after=3)
    with pytest.raises(KeyboardInterrupt):
        cut.run()
    assert cut.global_step == 3
    resumed = _trainer(tmp_path / "b", batches, opt, step, cfg,
                       max_epochs=2, log_period=1)
    assert resumed.load_checkpoint("last")
    assert (resumed.global_step, resumed.resume_skip) == (3, 6)
    resumed.run()
    assert resumed.global_step == 8
    for got, ref in ((resumed.params, full.params),
                     (resumed.opt_state["mu"], full.opt_state["mu"]),
                     (resumed.opt_state["nu"], full.opt_state["nu"])):
        ref = flatten_tree(ref)
        for k, v in flatten_tree(got).items():
            assert torch.equal(v, ref[k]), k
    assert resumed.opt_state["count"] == full.opt_state["count"] == 8


# ---------------------------------------------------------------------------
# the port's Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

# SGD with a momentum trace: the restored optimizer state and the LR scale
# show in the parameters (Adam would turn the noise of gradients that are
# zero in exact arithmetic into lr x sign)
SGD = ("constant", {}, 0.05, "sgd", {"momentum": 0.9})
VALID = make_batches(2, seed=9)


@pytest.fixture(scope="module")
def steps():
    """(JAX train step, JAX valid step, port train step, port valid step)
    of the small model's CTC recipe with SGD, no random draws."""
    cfg_j, cfg_t = j_config(small_yaml()), t_config(small_yaml())
    jopt = j_lr.build_optimizer(*SGD, max_grad_norm=5.0)
    topt = t_lr.build_optimizer(*SGD, max_grad_norm=5.0)
    jcfg, tcfg = j_step.TrainConfig(), t_step.TrainConfig()
    jstep = jax.jit(j_step.make_train_step(cfg_j, jcfg, jopt))
    jvalid = jax.jit(lambda p, *b: j_step.loss_fn(p, cfg_j, jcfg, *b)[0])
    tstep = t_step.make_train_step(cfg_t, tcfg, topt, device="cpu")

    def tvalid(p, *b):
        with torch.no_grad():
            return t_step.loss_fn(p, cfg_t, tcfg,
                                  *map(torch.as_tensor, b))[0].item()
    return ((cfg_j, jopt, jstep, jvalid), (cfg_t, topt, tstep, tvalid))


def _loader(batches, cut_at=None):
    """make_loader over ``batches`` (two utterances a batch), skipping
    ``skip`` utterances; with ``cut_at``, the run stops when the
    ``cut_at``-th batch (counted over every epoch) is asked for."""
    served = [0]

    def make(skip):
        for b in batches[skip // 2:]:
            if served[0] == cut_at:
                raise KeyboardInterrupt("stopped")
            served[0] += 1
            yield b
    return make


def _pair_trainers(steps, path, step_wrap=lambda s, side: s, cut_at=None,
                   **kw):
    """The JAX Trainer (JAX step) and the port's (port step) from the same
    parameters, on the same batches, each writing under path/side."""
    tree = random_params(5)
    out = []
    for side, (cfg, opt, step, _), Cls, params in (
            ("jax", steps[0], JTrainer, jax.tree.map(jnp.asarray, tree)),
            ("torch", steps[1], Trainer, params_from_jax(tree))):
        out.append(Cls(cfg, params, opt, step_wrap(step, side),
                       make_loader=_loader(make_batches(4), cut_at),
                       valid_loader=lambda: iter(VALID),
                       save_dir=str(path / side),
                       scalar_dir=str(path / side / "scalars"), **kw))
    return out


def _run_pair(steps, trainers):
    for t, (_, _, _, valid) in zip(trainers, steps):
        t.run(valid)
        for w in t.writers:
            w.close()


def _assert_params_match(got, ref):
    """A port tree against a JAX tree: each leaf within rtol 1e-4 of that
    leaf's largest value."""
    ref = flatten_tree(jax.tree.map(np.asarray, ref))
    got = flatten_tree(params_to_numpy(got))
    assert sorted(got) == sorted(ref)
    for k in ref:
        tol = 1e-4 * max(np.abs(ref[k]).max(), 1e-3)
        assert np.abs(got[k] - ref[k]).max() <= tol, k


STATE_KEYS = ("epoch", "global_step", "resume_skip", "early_stop",
              "lr_scale")


def _assert_trainers_match(jt, tt):
    """Counters, LR scale and best validation loss (rtol 1e-5), the steps
    of the recent checkpoints, and the current and best parameters."""
    for k in STATE_KEYS + ("recent_models",):
        assert getattr(tt, k) == getattr(jt, k), k
    np.testing.assert_allclose(tt.best_valid, jt.best_valid, rtol=1e-5)
    _assert_params_match(tt.params, jt.params)
    _assert_params_match(tt.best_params, jt.best_params)


def _scalar_rows(path):
    with open(path / "scalars" / "scalars.jsonl") as f:
        return [json.loads(line) for line in f]


def test_trainer_matches_jax_trainer(steps, tmp_path):
    """Two epochs of four steps, validation after each, a checkpoint every
    three steps: the port's Trainer with its step against the JAX Trainer
    with the JAX step, from params_from_jax of the same tree. The scalar
    rows (tags and steps equal; losses, gradient norms and validation
    losses within rtol 1e-5), the counters, best validation loss and
    recent checkpoints, the parameters and best parameters (rtol 1e-4 of
    each leaf's largest value), and checkpoint_{last,best}.pkl: the same
    files with the same counters and parameters. Then a run of each cut
    when its eighth batch is asked for (mid-epoch, after the checkpoint of
    step 7) and resumed in a new Trainer: the same state loaded, and the
    end of the JAX resumed run's."""
    jt, tt = _pair_trainers(steps, tmp_path / "full", log_period=1,
                            save_period=3, max_epochs=2)
    _run_pair(steps, (jt, tt))
    assert jt.global_step == 8
    _assert_trainers_match(jt, tt)
    ref, got = (_scalar_rows(tmp_path / "full" / side)
                for side in ("jax", "torch"))
    assert [(r["step"], r["tag"]) for r in got] == \
        [(r["step"], r["tag"]) for r in ref]
    assert {"train/loss", "train/grad_norm", "valid/loss"} <= \
        {r["tag"] for r in got}
    for g, r in zip(got, ref):
        if r["tag"] != "train/frames_per_s":
            np.testing.assert_allclose(g["value"], r["value"], rtol=1e-5,
                                       err_msg=f"{r['tag']} {r['step']}")
    names = [sorted(f for f in os.listdir(tmp_path / "full" / side)
                    if f.endswith(".pkl")) for side in ("jax", "torch")]
    assert names[0] == names[1] and "checkpoint_best.pkl" in names[0]
    for name in names[0]:
        states = []
        for side in ("jax", "torch"):
            with open(tmp_path / "full" / side / name, "rb") as f:
                states.append(pickle.load(f))
        ref_state, state = states
        for k in STATE_KEYS:
            assert state[k] == ref_state[k], (name, k)
        np.testing.assert_allclose(state["best_valid"],
                                   ref_state["best_valid"], rtol=1e-5)
        for k in ("params", "best_params"):
            _assert_params_match(params_from_jax(state[k]), ref_state[k])

    cut = _pair_trainers(steps, tmp_path / "cut", log_period=1,
                         save_period=1, max_epochs=2, cut_at=7)
    for t, (_, _, _, valid) in zip(cut, steps):
        with pytest.raises(KeyboardInterrupt):
            t.run(valid)
    resumed = _pair_trainers(steps, tmp_path / "cut", log_period=1,
                             save_period=1, max_epochs=2)
    for t in resumed:
        assert t.load_checkpoint("last")
    jr, tr = resumed
    assert (tr.epoch, tr.global_step, tr.resume_skip) == \
        (jr.epoch, jr.global_step, jr.resume_skip) == (1, 7, 6)
    _assert_trainers_match(jr, tr)
    _run_pair(steps, resumed)
    assert jr.global_step == 8
    _assert_trainers_match(jr, tr)


def test_divergence_recovery(steps, tmp_path):
    """The real steps of both packages, their losses made non-finite at
    the second and the seventh call (after JAX's
    test_divergence_recovery), two epochs with validation: the port's
    Trainer against the JAX Trainer. Each call sees the same LR scale
    and a parameter tree of the same size (sum of |p|, rtol 1e-5): the
    first divergence reloads the initial parameters and halves the scale,
    the second reloads the parameters validated best after epoch 0 and
    their optimizer state and halves it again; the divergent steps are
    not counted; counters (the early-stop count reset by a better
    validation loss), best validation loss and the parameters after
    the run equal JAX's."""
    seen = {"jax": [], "torch": []}

    def exploding(step, side):
        get = j_lr.get_lr_scale if side == "jax" else t_lr.get_lr_scale

        def run(p, s, *batch):
            size = (sum(float(jnp.abs(v).sum()) for v in jax.tree.leaves(p))
                    if side == "jax" else
                    sum(v.abs().sum().item()
                        for v in flatten_tree(p).values()))
            seen[side].append((get(s), size))
            p, s, m = step(p, s, *batch)
            if len(seen[side]) in (2, 7):
                m = dict(m, loss=m["loss"] * float("nan"))
            return p, s, m
        return run

    jt, tt = _pair_trainers(steps, tmp_path, step_wrap=exploding,
                            max_epochs=2, early_stop_count=5)
    _run_pair(steps, (jt, tt))
    # two divergences, the early-stop count reset by epoch 1's better
    # validation loss
    assert (jt.global_step, jt.early_stop, jt.lr_scale) == (6, 0, 0.25)
    _assert_trainers_match(jt, tt)
    assert len(seen["torch"]) == len(seen["jax"]) == 8
    assert [s for s, _ in seen["torch"]] == [s for s, _ in seen["jax"]]
    np.testing.assert_allclose([n for _, n in seen["torch"]],
                               [n for _, n in seen["jax"]], rtol=1e-5)


def test_checkpoint_layout_and_refusals(tmp_path):
    """checkpoint_{last,best}.pkl hold the JAX trainer's keys with every
    tensor a numpy array; after a validation the best parameters are the
    current ones and are stored once. Orbax checkpoints are refused,
    naming why. A Trainer in BMUF mode adds the recipe's ``bmuf`` entry:
    its global parameters (the replicas' mean), a zero block momentum
    buffer and its settings."""
    cfg, _, opt, step = _setup(spec_aug=False)
    batches = make_batches(2)
    trainer = Trainer(cfg, params_from_jax(random_params(2)), opt, step,
                      make_loader=lambda skip: iter(batches),
                      valid_loader=lambda: iter(batches[:1]),
                      save_dir=str(tmp_path), max_epochs=1)
    trainer.run(lambda p, *b: t_step.loss_fn(
        p, cfg, t_step.TrainConfig(), *map(torch.as_tensor, b))[0].item())
    with open(tmp_path / "checkpoint_best.pkl", "rb") as f:
        state = pickle.load(f)
    assert sorted(state) == sorted(
        ["epoch", "global_step", "resume_skip", "best_valid", "early_stop",
         "lr_scale", "params", "best_params", "opt_state",
         "best_opt_state"])
    leaves = flatten_tree(state["params"])
    assert all(isinstance(v, np.ndarray) for v in leaves.values())
    best = flatten_tree(state["best_params"])
    assert all(best[k] is v for k, v in leaves.items())
    assert np.isfinite(state["best_valid"]) and state["global_step"] == 2
    assert os.path.exists(tmp_path / "checkpoint_last.pkl")
    with pytest.raises(ValueError, match="orbax"):
        Trainer(cfg, trainer.params, opt, step, lambda s: [],
                ckpt_format="orbax")
    from m3asr_tpu_torch.train.bmuf import BmufRecipe
    stacked = BmufRecipe.stack(trainer.params, 2)
    recipe = BmufRecipe(stacked, 3, block_momentum=0.5)
    bmuf = Trainer(cfg, stacked, opt, step, lambda s: [], bmuf=recipe,
                   opt_state=BmufRecipe.stack(trainer.opt_state, 2))
    entry = bmuf._gather_state()["bmuf"]
    assert (entry["sync_period"], entry["block_momentum"],
            entry["block_lr"]) == (3, 0.5, 1.0)
    flat = flatten_tree(trainer.params)
    for k, v in flatten_tree(entry["global_params"]).items():
        assert torch.equal(v, flat[k]), k
    assert all(not v.any()
               for v in flatten_tree(entry["delta_prev"]).values())


def test_checkpoint_pickler_writes_numpy_pickles():
    """CheckpointPickler, each tensor through the staging buffer, writes
    the bytes pickle gives the same tree of numpy arrays at protocol 5;
    a tensor held twice is stored once and loads as one array."""
    from m3asr_tpu_torch.train.trainer import CheckpointPickler
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    state = {"params": {"w": w, "n": torch.arange(4)}, "best": {"w": w},
             "count": 3, "lr_scale": 0.5, "e": torch.zeros(0)}
    wn = w.numpy()
    arrays = {"params": {"w": wn, "n": np.arange(4)},
              "best": {"w": wn}, "count": 3, "lr_scale": 0.5,
              "e": np.zeros(0, np.float32)}
    buf = io.BytesIO()
    CheckpointPickler(buf, torch.empty(64, dtype=torch.uint8)).dump(state)
    assert buf.getvalue() == pickle.dumps(arrays, protocol=5)
    got = pickle.loads(buf.getvalue())
    assert got["best"]["w"] is got["params"]["w"]
    np.testing.assert_array_equal(got["params"]["w"], wn)
    np.testing.assert_array_equal(got["params"]["n"], np.arange(4))


def test_scalar_writers_read_back_in_jax(tmp_path):
    """The port's TensorBoard event file, written by a Trainer, parses
    with JAX's read_tb_scalars (record CRCs checked) into the scalars of
    the JSONL file; an event record is byte-identical to the JAX
    writer's; MetricStat windows and totals equal JAX's."""
    cfg, _, opt, step = _setup(spec_aug=False)
    trainer = Trainer(cfg, params_from_jax(random_params(4)), opt, step,
                      make_loader=lambda skip: iter(make_batches(3)),
                      save_dir=str(tmp_path), max_epochs=1, log_period=1,
                      scalar_dir=str(tmp_path / "scalars"))
    trainer.run()
    for w in trainer.writers:
        w.close()
    events = [f for f in os.listdir(tmp_path / "scalars")
              if f.startswith("events.out.tfevents")]
    assert len(events) == 1
    tb = j_metrics.read_tb_scalars(str(tmp_path / "scalars" / events[0]))
    with open(tmp_path / "scalars" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [(s, t) for s, t, _ in tb] == [(r["step"], r["tag"])
                                          for r in rows]
    # frames/s is read from the clock once for each writer
    keep = [i for i, r in enumerate(rows) if "frames_per_s" not in r["tag"]]
    np.testing.assert_allclose([tb[i][2] for i in keep],
                               [rows[i]["value"] for i in keep], rtol=1e-6)
    assert {"train/loss", "train/ctc_loss", "train/grad_norm"} <= \
        {r["tag"] for r in rows}
    assert t_metrics._tb_event(1.5, 3, scalars=[("a/b", 0.25)]) == \
        j_metrics._tb_event(1.5, 3, scalars=[("a/b", 0.25)])
    ours, ref = t_metrics.MetricStat(["x", "y"]), j_metrics.MetricStat(
        ["x", "y"])
    for s in (ours, ref):
        s.update_stat([1.0, 2.0], [1, 2])
        s.update_stat([3.0, 5.0], [1, 1])
    assert ours.log_stat() == ref.log_stat()
    assert ours.summary_stat() == ref.summary_stat()
