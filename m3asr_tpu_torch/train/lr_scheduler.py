"""Learning-rate schedules and the optimizer (port of
``m3asr_tpu/train/lr_scheduler.py``).

The seven schedule families keep their names and semantics:

  constant        hold lr (floored at min_lr)
  period_adjust   multiply by lr_decay every decay_period steps
  cv_adjust       multiply by lr_decay every lr_decay_count steps (the step
                  counts validations without improvement)
  warmup_linear   linear up over warmup * total, linear down to total
  warmup_cosine   linear up, cosine down (half a cycle)
  warmup_plateau  linear up to t_step, hold to d_step, exponential decay to
                  1% at f_step
  warmup_noam     lr * warmup^0.5 * min(step^-0.5, step * warmup^-1.5)

Each is evaluated on the host in float32, in the JAX package's order of
operations (constants rounded to float32 where jnp rounds them), so a
step needs no device sync.

:class:`Optimizer` is the optax chain the JAX ``build_optimizer`` makes,
written out on tensors so that its step count and rounding are optax's:

    clip_by_global_norm(max_grad_norm)         (when max_grad_norm > 0)
    adam | adamw(schedule, mask) | sgd | adadelta
    scale(lr_scale)                            (the runtime knob)

The schedule reads the update count *before* the update, starting at 0;
Adam's bias correction uses count + 1. Parameters, gradients and moments
are flat ``{"a/b/c": tensor}`` dicts (``checkpoint.flatten_tree``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

f32 = np.float32


def _floor(out, min_lr: float) -> float:
    return float(max(f32(out), f32(min_lr)))


def constant_schedule(lr: float, min_lr: float = 1e-8, **_):
    return lambda step: _floor(lr, min_lr)


def _pow_int(base: float, n: int):
    """base ** n in float32 by repeated squaring, as jnp takes a float32
    power of an integer exponent (n >= 0)."""
    x, acc = f32(base), f32(1)
    while n:
        if n & 1:
            acc = f32(acc * x)
        x = f32(x * x)
        n >>= 1
    return acc


def _decayed(lr: float, lr_decay: float, n: int):
    """lr * lr_decay ** n in float32, as jnp computes it."""
    return f32(lr) * _pow_int(lr_decay, n)


def period_schedule(lr: float, decay_period: int = 10000,
                    lr_decay: float = 0.8, min_lr: float = 1e-8, **_):
    return lambda step: _floor(_decayed(lr, lr_decay,
                                        int(step) // decay_period), min_lr)


def cv_schedule(lr: float, lr_decay: float = 0.5, lr_decay_count: int = 10,
                min_lr: float = 1e-8, **_):
    """The step counts validations without improvement; resetting it is
    the caller's job."""
    return lambda step: _floor(_decayed(lr, lr_decay,
                                        int(step) // lr_decay_count), min_lr)


def _up(lr: float, step: int, w: int):
    return f32(lr) * f32(step) / f32(w)


def warmup_linear_schedule(lr: float, warmup: float = 0.02,
                           total_steps: int = 100000, min_lr: float = 1e-8,
                           **_):
    w = round(total_steps * warmup)

    def fn(step):
        step = int(step)
        if step <= w:
            return _floor(_up(lr, step, max(w, 1)), min_lr)
        return _floor(f32(lr) * f32(step - total_steps)
                      / f32(w - total_steps), min_lr)
    return fn


def warmup_cosine_schedule(lr: float, warmup: float = 0.02,
                           total_steps: int = 100000, min_lr: float = 1e-8,
                           **_):
    w = round(total_steps * warmup)

    def fn(step):
        step = int(step)
        if step <= w:
            return _floor(_up(lr, step, max(w, 1)), min_lr)
        progress = f32(step - w) / f32(max(total_steps - w, 1))
        cos = np.cos(f32(math.pi) * progress, dtype=f32)
        return _floor(f32(lr * 0.5) * (f32(1) + cos), min_lr)
    return fn


def warmup_plateau_schedule(lr: float, t_step: int = 1000,
                            d_step: int = 20000, f_step: int = 80000,
                            min_lr: float = 1e-8, **_):
    assert t_step < d_step < f_step
    decay = 0.01 ** (1.0 / (f_step - d_step))

    def fn(step):
        step = int(step)
        if step <= t_step:
            return _floor(_up(lr, step, t_step), min_lr)
        if step <= d_step:
            return _floor(lr, min_lr)
        return _floor(_decayed(lr, decay, min(step, f_step) - d_step),
                      min_lr)
    return fn


def warmup_noam_schedule(lr: float, warmup_steps: int = 25000,
                         min_lr: float = 1e-8, **_) -> Callable[[int], float]:
    """lr * sqrt(warmup) * min(step^-0.5, step * warmup^-1.5), step >= 1,
    floored at min_lr."""
    def fn(step: int) -> float:
        s = f32(max(int(step), 1))
        out = f32(lr * warmup_steps ** 0.5) * min(
            s ** f32(-0.5), s * f32(warmup_steps ** -1.5))
        return _floor(out, min_lr)
    return fn


SUPPORTED_SCHEDULER: Dict[str, Callable] = {
    "constant": constant_schedule,
    "cv_adjust": cv_schedule,
    "period_adjust": period_schedule,
    "warmup_linear": warmup_linear_schedule,
    "warmup_cosine": warmup_cosine_schedule,
    "warmup_plateau": warmup_plateau_schedule,
    "warmup_noam": warmup_noam_schedule,
}

OPTIMS = ("adam", "adamw", "sgd", "adadelta")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def _moment(g: torch.Tensor, prev: torch.Tensor, decay: float, order: int):
    """optax's update_moment: (1 - decay) * g^order + decay * prev."""
    return (1 - decay) * (g if order == 1 else g.square()) + decay * prev


class Optimizer:
    """The JAX ``build_optimizer`` chain on flat dicts of tensors.

    ``init(params)`` -> state; ``update(grads, state, params)`` ->
    (updates, state); ``apply_updates(params, updates)`` -> new params.

    kind "adam": Adam, AdamW when ``weight_decay > 0`` (decay on the
    leaves ``decay_mask`` marks True, every leaf without a mask); "sgd":
    optax.sgd (a trace with ``momentum``, Nesterov or not); "adadelta":
    optax.adadelta (``rho``, ``eps``, its own ``weight_decay`` on every
    leaf)."""

    def __init__(self, schedule: Callable[[int], float], kind: str = "adam",
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, weight_decay: float = 0.0,
                 max_grad_norm: float = -1.0,
                 decay_mask: Optional[Dict[str, bool]] = None,
                 momentum: Optional[float] = None, nesterov: bool = False,
                 rho: float = 0.9):
        self.schedule, self.kind = schedule, kind
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.weight_decay, self.decay_mask = weight_decay, decay_mask
        self.max_grad_norm = max_grad_norm
        self.momentum, self.nesterov, self.rho = momentum, nesterov, rho

    def _moments(self):
        if self.kind == "adam":
            return ("mu", "nu")
        if self.kind == "adadelta":
            return ("e_g", "e_x")
        return ("trace",) if self.momentum is not None else ()

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        state = {"count": 0, "lr_scale": 1.0}
        for name in self._moments():
            state[name] = {k: torch.zeros_like(v) for k, v in params.items()}
        return state

    def _decays(self, k: str) -> bool:
        return self.decay_mask is None or bool(self.decay_mask[k])

    def update(self, grads: Dict[str, torch.Tensor], state: Dict,
               params: Dict[str, torch.Tensor],
               norm: Optional[torch.Tensor] = None):
        """(updates, new state); ``norm``: the clipping norm when the
        gradient is not all in ``grads`` (a rank's blocks of a sharded
        one), else the global norm of ``grads``."""
        g = dict(grads)
        if self.max_grad_norm and self.max_grad_norm > 0:
            if norm is None:
                norm = global_norm(g.values())
            keep = norm < self.max_grad_norm
            g = {k: torch.where(keep, t, t / norm.to(t.dtype)
                                * self.max_grad_norm) for k, t in g.items()}
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        new = {"count": count, "lr_scale": state["lr_scale"]}
        moments = {name: {} for name in self._moments()}
        updates = {}
        if self.kind == "adam":
            # bias corrections in float32, as optax takes decay ** count
            c1 = float(f32(1) - f32(self.b1) ** f32(count))
            c2 = float(f32(1) - f32(self.b2) ** f32(count))
        for k, t in g.items():
            if self.kind == "adam":
                mu = moments["mu"][k] = _moment(t, state["mu"][k], self.b1, 1)
                nu = moments["nu"][k] = _moment(t, state["nu"][k], self.b2, 2)
                u = (mu / c1) / (torch.sqrt(nu / c2 + self.eps_root)
                                 + self.eps)
                if self.weight_decay > 0 and self._decays(k):
                    u = u + self.weight_decay * params[k]
            elif self.kind == "adadelta":
                if self.weight_decay:
                    t = t + self.weight_decay * params[k]
                e_g = moments["e_g"][k] = _moment(t, state["e_g"][k],
                                                  self.rho, 2)
                prev = state["e_x"][k]
                u = (torch.sqrt(prev + self.eps)
                     / torch.sqrt(e_g + self.eps)) * t
                moments["e_x"][k] = _moment(u, prev, self.rho, 2)
            elif self.momentum is not None:
                tr = moments["trace"][k] = t + self.momentum \
                    * state["trace"][k]
                u = t + self.momentum * tr if self.nesterov else tr
            else:
                u = t
            updates[k] = (u * -lr) * state["lr_scale"]
        new.update(moments)
        return updates, new

    @staticmethod
    def apply_updates(params: Dict[str, torch.Tensor],
                      updates: Dict[str, torch.Tensor]):
        return {k: (v + updates[k]).to(v.dtype) if k in updates else v
                for k, v in params.items()}


def set_lr_scale(state: Dict, value: float) -> Dict:
    """The state with the runtime LR multiplier set to ``value``."""
    return dict(state, lr_scale=float(value))


def get_lr_scale(state: Dict) -> float:
    """The runtime LR multiplier of an optimizer state."""
    return float(state.get("lr_scale", 1.0))


def nodecay_mask(params, name_nodecay: Sequence[str]):
    """A tree like ``params`` holding True where weight decay applies: the
    leaf's path ("a/b/c") contains none of the ``name_nodecay``
    substrings."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{path}{i}/") for i, v in enumerate(node)]
        keys = path[:-1]
        return not any(nd in keys for nd in name_nodecay)
    return walk(params, "")


def build_optimizer(schedule_type: str, schedule_conf: Optional[dict],
                    lr: float, optim_type: str = "adam",
                    optim_conf: Optional[dict] = None,
                    max_grad_norm: float = -1.0, weight_decay: float = 0.0,
                    name_nodecay: Optional[Sequence[str]] = None,
                    params=None) -> Optimizer:
    """The JAX ``build_optimizer``: weight decay > 0 turns adam and adamw
    into AdamW with ``weight_decay`` (masked by ``name_nodecay`` when both
    it and ``params`` are given); plain ``adamw`` takes optax's default
    decay of 1e-4; sgd and adadelta ignore ``weight_decay``. ``optim_conf``
    holds the optax optimizer's keyword arguments."""
    if schedule_type not in SUPPORTED_SCHEDULER:
        raise NotImplementedError(
            f"Not supported schedule type: {schedule_type}")
    if optim_type not in OPTIMS:
        raise NotImplementedError(f"Not supported optim type: {optim_type}")
    schedule = SUPPORTED_SCHEDULER[schedule_type](lr, **(schedule_conf or {}))
    conf = dict(optim_conf or {})
    kw = dict(schedule=schedule, max_grad_norm=max_grad_norm)
    if optim_type in ("adam", "adamw"):
        allowed = {"b1", "b2", "eps", "eps_root"}
        if weight_decay > 0:
            conf["weight_decay"] = weight_decay
            if name_nodecay and params is not None:
                from m3asr_tpu_torch.checkpoint import flatten_tree
                kw["decay_mask"] = flatten_tree(nodecay_mask(params,
                                                             name_nodecay))
        elif optim_type == "adamw":
            conf.setdefault("weight_decay", 1e-4)
        allowed.add("weight_decay")
        kind = "adam"
    elif optim_type == "sgd":
        allowed, kind = {"momentum", "nesterov"}, "sgd"
    else:
        allowed, kind = {"rho", "eps", "weight_decay"}, "adadelta"
        conf.setdefault("eps", 1e-6)
    unknown = set(conf) - allowed
    if unknown:
        raise TypeError(f"{optim_type} takes no {sorted(unknown)}")
    return Optimizer(kind=kind, **kw, **conf)
