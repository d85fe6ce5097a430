"""Learning-rate schedule and optimizer (port of the ``warmup_noam`` /
Adam(W) subset of ``m3asr_tpu/train/lr_scheduler.py``).

:class:`Optimizer` is the optax chain the JAX ``build_optimizer`` makes,
written out on tensors so that its step count and rounding are optax's:

    clip_by_global_norm(max_grad_norm)       (when max_grad_norm > 0)
    adam | adamw(schedule)                   (scale_by_adam, decayed
                                              weights, -schedule(count))
    scale(lr_scale)                          (the runtime knob)

The schedule reads the update count *before* the update, starting at 0
(warmup_noam clamps it to 1); Adam's bias correction uses count + 1.
Schedules are evaluated on the host in float32, as optax evaluates them,
so a step needs no device sync. Parameters, gradients and moments are
flat ``{"a/b/c": tensor}`` dicts (``checkpoint.flatten_tree``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

_TODO = "ROADMAP Queue 1 item 11 (training: the rest)"


def warmup_noam_schedule(lr: float, warmup_steps: int = 25000,
                         min_lr: float = 1e-8, **_) -> Callable[[int], float]:
    """lr * sqrt(warmup) * min(step^-0.5, step * warmup^-1.5), step >= 1,
    floored at min_lr; float32 arithmetic as in the JAX package."""
    f32 = np.float32

    def fn(step: int) -> float:
        s = f32(max(int(step), 1))
        out = f32(lr * warmup_steps ** 0.5) * min(
            s ** f32(-0.5), s * f32(warmup_steps ** -1.5))
        return float(max(out, f32(min_lr)))
    return fn


SUPPORTED_SCHEDULER = {"warmup_noam": warmup_noam_schedule}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class Optimizer:
    """The JAX ``build_optimizer`` chain on flat dicts of tensors.

    ``init(params)`` -> state; ``update(grads, state, params)`` ->
    (updates, state); ``apply_updates(params, updates)`` -> new params.
    Weight decay reaches every parameter."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                 weight_decay: float = 0.0, max_grad_norm: float = -1.0):
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        return {"count": 0, "lr_scale": 1.0,
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(self, grads: Dict[str, torch.Tensor], state: Dict,
               params: Dict[str, torch.Tensor]):
        g = dict(grads)
        if self.max_grad_norm and self.max_grad_norm > 0:
            norm = global_norm(g.values())
            keep = norm < self.max_grad_norm
            g = {k: torch.where(keep, t, t / norm.to(t.dtype)
                                * self.max_grad_norm) for k, t in g.items()}
        count = state["count"] + 1
        f32 = np.float32
        # bias corrections in float32, as optax takes decay ** count
        c1 = float(f32(1) - f32(self.b1) ** f32(count))
        c2 = float(f32(1) - f32(self.b2) ** f32(count))
        lr = self.schedule(state["count"])
        mu, nu, updates = {}, {}, {}
        for k, t in g.items():
            mu[k] = (1 - self.b1) * t + self.b1 * state["mu"][k]
            nu[k] = (1 - self.b2) * t.square() + self.b2 * state["nu"][k]
            u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2 + self.eps_root)
                                + self.eps)
            if self.weight_decay > 0:
                u = u + self.weight_decay * params[k]
            updates[k] = (u * -lr) * state["lr_scale"]
        return updates, {"count": count, "lr_scale": state["lr_scale"],
                         "mu": mu, "nu": nu}

    @staticmethod
    def apply_updates(params: Dict[str, torch.Tensor],
                      updates: Dict[str, torch.Tensor]):
        return {k: (v + updates[k]).to(v.dtype) if k in updates else v
                for k, v in params.items()}


def set_lr_scale(state: Dict, value: float) -> Dict:
    """The state with the runtime LR multiplier set to ``value``."""
    return dict(state, lr_scale=float(value))


def build_optimizer(schedule_type: str, schedule_conf: Optional[dict],
                    lr: float, optim_type: str = "adam",
                    optim_conf: Optional[dict] = None,
                    max_grad_norm: float = -1.0, weight_decay: float = 0.0
                    ) -> Optimizer:
    """The JAX ``build_optimizer`` for ``warmup_noam`` with ``adam`` or
    ``adamw``: weight decay > 0 turns Adam into AdamW, and plain
    ``adamw`` takes optax's default decay of 1e-4. The JAX package's
    ``name_nodecay`` exemptions come with the trainer (ROADMAP Queue 1
    item 11)."""
    if schedule_type not in SUPPORTED_SCHEDULER:
        raise NotImplementedError(
            f"schedule {schedule_type!r} is not ported yet: {_TODO}")
    if optim_type not in ("adam", "adamw"):
        raise NotImplementedError(
            f"optimizer {optim_type!r} is not ported yet: {_TODO}")
    conf = dict(optim_conf or {})
    allowed = {"b1", "b2", "eps", "eps_root"}
    if optim_type == "adamw" and weight_decay <= 0:
        allowed.add("weight_decay")
        conf.setdefault("weight_decay", 1e-4)
    unknown = set(conf) - allowed
    if unknown:
        raise NotImplementedError(
            f"optim_conf {sorted(unknown)} is not ported yet: {_TODO}")
    if weight_decay > 0:
        conf["weight_decay"] = weight_decay
    return Optimizer(SUPPORTED_SCHEDULER[schedule_type](
        lr, **(schedule_conf or {})), max_grad_norm=max_grad_norm, **conf)
