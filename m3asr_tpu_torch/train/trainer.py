"""Training harness: epoch loop, validation, checkpoint and resume,
divergence recovery (port of ``m3asr_tpu/train/trainer.py``).

* the epoch loop over the threaded loader;
* periodic validation and best-model tracking, early stop;
* checkpoints ``checkpoint_{last,best,final}.pkl``: a pickle of
  ``{epoch, global_step, resume_skip, best_valid, early_stop, lr_scale,
  params, best_params, opt_state, best_opt_state}`` (and ``bmuf`` in BMUF
  mode) with every tensor as a numpy array (the port's tree layout), so a
  checkpoint does not depend on a device (:class:`CheckpointPickler`);
  resume puts them back on the step's device and skips ``resume_skip``
  utterances of the data stream;
* divergence recovery: a non-finite loss (or a BMUF STOP) reloads the
  best parameters and their optimizer state, halves the LR scale and
  counts toward early stop;
* BMUF mode (``bmuf``, a ``train.bmuf.BmufRecipe``): the parameters and
  the optimizer state carry a leading ``dp`` axis, the batch is split
  into ``dp`` equal slices, the step runs on each replica's slice of the
  trees (the JAX Trainer's ``jax.vmap(step)``), ``sync()`` runs every
  ``sync_period`` steps, the checkpoint carries the recipe's ``bmuf``
  entry, and validation runs on replica 0.

The per-step random draws (SpecAugment masks, dynamic chunk sizes) come
from a fresh CPU ``torch.Generator`` seeded from ``(seed, global_step)``,
so a resumed run draws what a run that was never stopped draws; in BMUF
mode each replica gets a generator seeded from that one's draws.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from m3asr_tpu_torch.train.bmuf import replica, restack
from m3asr_tpu_torch.train.lr_scheduler import set_lr_scale
from m3asr_tpu_torch.train.metrics import (MetricStat, ScalarWriter,
                                           TensorBoardWriter,
                                           ThroughputMeter, set_logger)
from m3asr_tpu_torch.train.step import init_opt_state


def step_generator(seed: int, global_step: int) -> torch.Generator:
    """The CPU generator of one training step."""
    return torch.Generator().manual_seed(
        ((int(seed) & 0xFFFFFFFF) << 32) | (int(global_step) & 0xFFFFFFFF))


def replica_generators(seed: int, global_step: int, dp: int):
    """One CPU generator per BMUF replica, seeded from the step
    generator's draws (the JAX Trainer splits the step's key over dp)."""
    seeds = torch.randint(0, 2 ** 62, (dp,),
                          generator=step_generator(seed, global_step))
    return [torch.Generator().manual_seed(int(x)) for x in seeds]


# the reconstructor of numpy's own protocol-5 pickles of an array
_FROMBUFFER = np.zeros(1, np.float32).__reduce_ex__(5)[0]


class CheckpointPickler(pickle.Pickler):
    """Protocol-5 pickler that writes each tensor as the numpy array of
    its values, with the opcodes numpy's own reduce gives (the file loads
    without torch). Each tensor is copied through ``staging`` (a uint8
    host buffer as large as the largest tensor) straight into the file,
    so the state is never held on the host whole. A tensor held in two
    places (the best parameters before they move) is written once:
    pickle's memo keeps the second a reference."""

    def __init__(self, f, staging: torch.Tensor):
        super().__init__(f, protocol=5)
        self.staging = staging

    def reducer_override(self, obj):
        if not torch.is_tensor(obj):
            return NotImplemented
        t = obj.detach()
        buf = self.staging[:t.numel() * t.element_size()]
        buf.view(t.dtype).copy_(t.reshape(-1))
        return (_FROMBUFFER, (pickle.PickleBuffer(buf.numpy()),
                              buf[:0].view(t.dtype).numpy().dtype,
                              tuple(t.shape), "C"))


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def to_device_tree(tree, device, memo: Optional[dict] = None):
    """A checkpoint's numpy tree as tensors on ``device``: an array held
    in two places becomes one tensor."""
    memo = {} if memo is None else memo
    if isinstance(tree, dict):
        return {k: to_device_tree(v, device, memo) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device_tree(v, device, memo) for v in tree]
    if isinstance(tree, np.ndarray):
        if id(tree) not in memo:
            memo[id(tree)] = torch.from_numpy(tree).to(device)
        return memo[id(tree)]
    return tree


class Trainer:
    def __init__(self, model_cfg, params, optimizer, train_step,
                 make_loader: Callable[[int], Iterable],
                 valid_loader: Optional[Callable[[], Iterable]] = None,
                 save_dir: str = "exp", log_period: int = 100,
                 save_period: Optional[int] = None,
                 max_epochs: int = 20, early_stop_count: int = 5,
                 keep_recent: int = 5, logger=None,
                 step_takes_rng: bool = False, seed: int = 0,
                 scalar_dir: Optional[str] = None,
                 batch_keys: Tuple[str, ...] = ("data", "lens", "target",
                                                "target_lens"),
                 ckpt_format: str = "pickle", bmuf=None,
                 opt_state=None, parallel=None):
        if ckpt_format != "pickle":
            raise ValueError(
                f"ckpt_format {ckpt_format!r}: orbax is a JAX library's "
                "format; the port writes pickles of numpy trees")
        self.model_cfg = model_cfg
        self.params = params
        self.optimizer = optimizer
        self.opt_state = (opt_state if opt_state is not None
                          else init_opt_state(optimizer, params))
        self.train_step = train_step
        self.make_loader = make_loader
        self.valid_loader = valid_loader
        self.save_dir = save_dir
        self.log_period = log_period
        self.save_period = save_period if save_period else log_period
        self.max_epochs = max_epochs
        self.early_stop_limit = early_stop_count
        self.keep_recent = keep_recent
        self.logger = logger or set_logger("m3asr.train")
        self.device = next(_tensors(params)).device

        self.epoch = 0
        self.global_step = 0
        self.resume_skip = 0
        self.best_valid = float("inf")
        self.best_params = params
        self.best_opt_state = self.opt_state
        self.early_stop = 0
        self.recent_models: list = []
        self.lr_scale = 1.0
        self.step_takes_rng = step_takes_rng
        self.seed = seed
        self.batch_keys = tuple(batch_keys)
        self.ckpt_format = ckpt_format
        self.bmuf = bmuf
        # a sharded run (train.parallel.Parallel): the trees are this
        # rank's blocks; checkpoints gather them (rank 0 writes) and a
        # resume cuts them again
        self.parallel = parallel
        self.rank0 = parallel is None or parallel.mesh.rank == 0
        self.writers = []
        if scalar_dir and self.rank0:
            self.writers = [
                ScalarWriter(os.path.join(scalar_dir, "scalars.jsonl")),
                TensorBoardWriter(scalar_dir)]

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def _ckpt_path(self, tag: str) -> str:
        return os.path.join(self.save_dir, f"checkpoint_{tag}.pkl")

    def _gather_state(self):
        trees = {"params": self.params, "best_params": self.best_params,
                 "opt_state": self.opt_state,
                 "best_opt_state": self.best_opt_state}
        bmuf = None if self.bmuf is None else self.bmuf.state_dict()
        par = self.parallel
        if par is not None:
            # every rank takes part; a tree held twice is gathered once
            memo = {}

            def whole(name, tree):
                if id(tree) not in memo:
                    memo[id(tree)] = (par.gather_params(tree)
                                      if "params" in name
                                      else par.gather_opt_state(tree))
                return memo[id(tree)]
            trees = {k: whole(k, v) for k, v in trees.items()}
            if bmuf is not None:
                bmuf = dict(bmuf, **{k: par.gather(bmuf[k], par.param_specs)
                                     for k in ("global_params",
                                               "delta_prev")})
        state = {
            "epoch": self.epoch,
            "global_step": self.global_step,
            "resume_skip": self.resume_skip,
            "best_valid": self.best_valid,
            "early_stop": self.early_stop,
            "lr_scale": self.lr_scale,
            **trees,
        }
        if bmuf is not None:
            state["bmuf"] = bmuf
        return state

    def _apply_state(self, state):
        self.epoch = int(state["epoch"])
        self.global_step = int(state["global_step"])
        self.resume_skip = int(state["resume_skip"])
        self.best_valid = float(state["best_valid"])
        self.early_stop = int(state["early_stop"])
        self.lr_scale = float(state.get("lr_scale", 1.0))
        trees = {"params": state["params"],
                 "best_params": state["best_params"],
                 "opt_state": state["opt_state"],
                 "best_opt_state": state.get("best_opt_state",
                                             state["opt_state"])}
        bmuf = state.get("bmuf")
        par = self.parallel
        if par is not None:
            # this rank's blocks of the whole trees (one cut per array)
            memo = {}

            def cut(name, tree):
                if id(tree) not in memo:
                    memo[id(tree)] = (par.shard_params(tree)
                                      if "params" in name
                                      else par.shard_opt_state(tree))
                return memo[id(tree)]
            trees = {k: cut(k, v) for k, v in trees.items()}
            if bmuf is not None:
                bmuf = dict(bmuf, **{k: par.shard(bmuf[k], par.param_specs)
                                     for k in ("global_params",
                                               "delta_prev")})
        memo = {}
        for k, v in trees.items():
            setattr(self, k, to_device_tree(v, self.device, memo))
        if self.bmuf is not None and bmuf is not None:
            self.bmuf.load_state_dict(bmuf)
            if self.bmuf.mesh is None:
                # one process takes every replica the checkpoint holds
                first = next(_tensors(self.params))
                self.bmuf.dp = int(first.shape[0])

    def save_checkpoint(self, tag: str = "last"):
        """Write ``checkpoint_{tag}.pkl`` (collective in a sharded run:
        every rank gathers, rank 0 writes)."""
        state = self._gather_state()
        if not self.rank0:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        path = self._ckpt_path(tag)
        # one host buffer for the save, pinned for a state on the card
        need = max(t.numel() * t.element_size() for t in _tensors(state))
        staging = torch.empty(need, dtype=torch.uint8,
                              pin_memory=self.device.type == "cuda")
        with open(path + ".tmp", "wb") as f:
            CheckpointPickler(f, staging).dump(state)
        os.replace(path + ".tmp", path)
        if tag == "last":
            self.recent_models.append(self.global_step)
            while len(self.recent_models) > self.keep_recent:
                self.recent_models.pop(0)

    def load_checkpoint(self, tag: str = "last") -> bool:
        path = self._ckpt_path(tag)
        if not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            state = pickle.load(f)
        self._apply_state(state)
        self.logger.info(
            f"resumed epoch={self.epoch} step={self.global_step} "
            f"skip={self.resume_skip}")
        return True

    # ------------------------------------------------------------------
    # divergence recovery
    # ------------------------------------------------------------------
    def _recover_from_divergence(self):
        self.logger.warning(
            "non-finite loss: reload best model, halve lr, early-stop "
            f"counter {self.early_stop + 1}/{self.early_stop_limit}")
        self.params = self.best_params
        self.lr_scale *= 0.5
        # the optimizer state saved with the best model, with the halved
        # LR scale folded in
        self.opt_state = set_lr_scale(self.best_opt_state, self.lr_scale)
        self.early_stop += 1

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------
    def _step(self, batch):
        """One training step on ``batch``: (params, opt_state, metrics). In
        BMUF mode the step runs on each replica's slice of the trees and
        of the batch (its leading axis split into dp equal parts), and the
        replicas' results are stacked again."""
        vals = tuple(batch[k] for k in self.batch_keys)
        if self.bmuf is None:
            kw = {}
            if self.step_takes_rng:
                kw["generator"] = step_generator(self.seed, self.global_step)
            return self.train_step(self.params, self.opt_state, *vals, **kw)
        dp = self.bmuf.dp
        for v in vals:
            if v.shape[0] % dp != 0:
                raise ValueError(f"batch {v.shape[0]} not divisible by "
                                 f"dp={dp} (use loader drop_last)")
        gens = (replica_generators(self.seed, self.global_step, dp)
                if self.step_takes_rng else None)
        outs = []
        for i, r in enumerate(self.bmuf.local_replicas()):
            n = vals[0].shape[0] // dp
            kw = {} if gens is None else {"generator": gens[r]}
            outs.append(self.train_step(
                replica(self.params, i), replica(self.opt_state, i),
                *(v[r * n:(r + 1) * n] for v in vals), **kw))
        metrics = {k: torch.stack([o[2][k] for o in outs])
                   for k in outs[0][2]}
        if self.bmuf.mesh is not None:
            # every rank logs (and checks) the replicas' mean
            metrics = {k: self.bmuf.mean(v.float())[None]
                       for k, v in metrics.items()}
        return (restack([o[0] for o in outs]),
                restack([o[1] for o in outs]), metrics)

    def train_one_epoch(self) -> Dict[str, float]:
        stat = None
        meter = ThroughputMeter()
        for i, batch in enumerate(self.make_loader(self.resume_skip)):
            self.params, self.opt_state, metrics = self._step(batch)
            tags = list(metrics)
            values = torch.stack([metrics[k].float().mean()
                                  for k in tags]).tolist()
            scalars = dict(zip(tags, values))
            loss = scalars["loss"]
            if not np.isfinite(loss):
                self._recover_from_divergence()
                if self.early_stop >= self.early_stop_limit:
                    raise RuntimeError("early stop: too many divergences")
                continue
            self.global_step += 1
            if self.bmuf is not None and \
                    self.global_step % self.bmuf.sync_period == 0:
                self.params, ok = self.bmuf.sync(self.params)
                if not ok:    # STOP: a non-finite delta
                    self._recover_from_divergence()
                    if self.early_stop >= self.early_stop_limit:
                        raise RuntimeError(
                            "early stop: too many divergences")
                    continue
            self.resume_skip += int(batch["data"].shape[0])
            if stat is None:
                # 'loss' leads the line; the rest alphabetical
                stat = MetricStat(["loss"] + sorted(k for k in scalars
                                                    if k != "loss"))
            stat.update_stat([scalars.get(t, 0.0) for t in stat.tags],
                             [1] * len(stat.tags))
            meter.update(int(np.sum(batch["lens"])))
            if (i + 1) % self.log_period == 0:
                avg = stat.log_stat()
                line = " ".join(f"{t} {v:.4f}"
                                for t, v in zip(stat.tags, avg))
                self.logger.info(
                    f"epoch {self.epoch} step {self.global_step} "
                    f"{line} {meter.rate():.0f} frames/s")
                for w in self.writers:
                    for tag, v in zip(stat.tags, avg):
                        w.add_scalar(f"train/{tag}", v, self.global_step)
                    w.add_scalar("train/frames_per_s", meter.rate(),
                                 self.global_step)
            if (i + 1) % self.save_period == 0:
                self.save_checkpoint("last")
        if stat is None:  # empty loader / every batch diverged
            return {}
        return dict(zip(stat.tags, stat.summary_stat()))

    def validate(self, valid_step) -> float:
        assert self.valid_loader is not None
        # BMUF: replica 0 (every replica right after a sync)
        params = (self.params if self.bmuf is None
                  else replica(self.params, 0))
        total, count = 0.0, 0
        for batch in self.valid_loader():
            loss = float(valid_step(params, batch["data"],
                                    batch["lens"], batch["target"],
                                    batch["target_lens"]))
            total += loss
            count += 1
        return total / max(count, 1)

    def run(self, valid_step=None):
        while self.epoch < self.max_epochs:
            summary = self.train_one_epoch()
            self.logger.info(f"epoch {self.epoch} done: {summary}")
            self.resume_skip = 0
            if valid_step is not None and self.valid_loader is not None:
                cv = self.validate(valid_step)
                self.logger.info(f"epoch {self.epoch} valid loss {cv:.4f}")
                for w in self.writers:
                    w.add_scalar("valid/loss", cv, self.global_step)
                if cv < self.best_valid:
                    self.best_valid = cv
                    self.best_params = self.params
                    self.best_opt_state = self.opt_state
                    self.early_stop = 0
                    self.save_checkpoint("best")
                else:
                    self.early_stop += 1
                    if self.early_stop >= self.early_stop_limit:
                        self.logger.info("early stopping")
                        break
            else:
                self.best_params = self.params
                self.best_opt_state = self.opt_state
            self.epoch += 1
            self.save_checkpoint("last")
        return self.params

