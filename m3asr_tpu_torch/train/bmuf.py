"""Block-Momentum Update Filtering (BMUF) training (port of
``m3asr_tpu/train/bmuf.py``):

    delta      = mean_over_replicas(global_params - local_params)
    delta_prev = m * delta_prev + block_lr * (1 - m) * delta
    global    -= (1 + m) * delta_prev           (Nesterov block momentum)
    any non-finite delta  ->  STOP (the caller reloads the best model and
                              halves the LR)

Trees are the port's parameter trees (nested dicts and lists of tensors,
None leaves kept). In BMUF mode (:class:`BmufRecipe`) every tensor of the
parameters and the optimizer state carries a leading ``dp`` axis, one
slice a replica; each replica steps locally, and every ``sync_period``
steps :meth:`BmufRecipe.sync` averages the replicas, runs the update and
hands the new global parameters back to every replica. The mean across
processes is pluggable (``mean_fn``): the identity in one process, where
the replicas are the slices of the stacked tree.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from m3asr_tpu_torch.checkpoint import flatten_tree, to_torch

SUCCESS = 1
STOP = 0
EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def tree_map(fn, *trees):
    """fn over the tensor leaves of trees of the first tree's structure
    (dicts, lists, tuples); its None leaves stay None (the others may
    leave them out: a step's tree drops them), its other leaves (an
    optimizer's count and LR scale) are kept."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t.get(k) for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *(t[i] for t in trees))
                        for i in range(len(t0)))
    if torch.is_tensor(t0):
        return fn(*trees)
    return t0


def replica(tree, r: int):
    """Replica ``r``'s slice of a stacked tree (views)."""
    return tree_map(lambda t: t[r], tree)


def restack(trees):
    """The replicas' trees stacked along a new leading axis (a view of the
    one tree when there is one replica)."""
    if len(trees) == 1:
        return tree_map(lambda t: t.unsqueeze(0), trees[0])
    return tree_map(lambda *ts: torch.stack(ts), *trees)


class BmufState(NamedTuple):
    global_params: object     # the synced master copy
    delta_prev: object        # the block momentum buffer (same tree)


def init_state(params) -> BmufState:
    return BmufState(global_params=params,
                     delta_prev=tree_map(torch.zeros_like, params))


def _all_finite(tree) -> bool:
    return all(bool(torch.isfinite(t).all())
               for t in flatten_tree(tree).values())


def bmuf_update(state: BmufState, local_params, block_momentum: float,
                block_lr: float, mean_fn: Callable = lambda x: x
                ) -> Tuple[BmufState, object, int]:
    """One sync: (new_state, new_local_params, status), status SUCCESS, or
    STOP on any non-finite delta (the caller then keeps ``state``, as the
    reference's NaN guard does)."""
    delta = tree_map(lambda g, l: mean_fn(g - l), state.global_params,
                     local_params)
    m, blr = block_momentum, block_lr
    new_delta_prev = tree_map(lambda dp, d: m * dp + blr * (1.0 - m) * d,
                              state.delta_prev, delta)
    new_global = tree_map(lambda g, dp: g - (1.0 + m) * dp,
                          state.global_params, new_delta_prev)
    status = SUCCESS if _all_finite(delta) else STOP
    return BmufState(new_global, new_delta_prev), new_global, status


def is_expert_path(path: str) -> bool:
    return any(k in EXPERT_LEAVES for k in path.split("/"))


def split_expert_params(params):
    """Trees of bools like ``params``: (expert_mask, shared_mask), the
    expert weights (w1, b1, w2, b2) against everything else."""
    def walk(node, path, expert):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}{k}/", expert)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}{i}/", expert)
                              for i, v in enumerate(node))
        return None if node is None else is_expert_path(path[:-1]) == expert
    return walk(params, "", True), walk(params, "", False)


def _fill_like(src: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``src`` broadcast over ``like``'s leading replica axis, in a new
    tensor of ``like``'s dtype."""
    return torch.empty_like(like).copy_(src)


class BmufRecipe:
    """The BMUF training mode: ``dp`` replicas step locally on their slice
    of a stacked tree, and :meth:`sync` every ``sync_period`` steps runs
    the block-momentum update on the replicas' mean and sends the new
    global parameters to every replica. A non-finite delta returns
    ``ok=False`` with the state as it was (STOP): the Trainer then reloads
    the best model and halves the LR."""

    def __init__(self, stacked_params, sync_period: int,
                 block_momentum: float = 0.875, block_lr: float = 1.0,
                 mesh=None):
        self.sync_period = int(sync_period)
        self.block_momentum = float(block_momentum)
        self.block_lr = float(block_lr)
        first = next(iter(flatten_tree(stacked_params).values()))
        # replicas on ranks: each dp rank of ``mesh`` holds its own (a
        # leading axis of 1), and the mean runs over the dp ranks
        self.mesh = mesh if mesh is not None and mesh.shape["dp"] > 1 \
            else None
        self.dp = int(first.shape[0]) * (1 if self.mesh is None
                                         else self.mesh.shape["dp"])
        self.device = first.device
        self.state = init_state(tree_map(self.mean, stacked_params))

    def mean(self, stacked: torch.Tensor) -> torch.Tensor:
        """The mean over every replica of a stacked leaf."""
        if self.mesh is None:
            return stacked.mean(0)
        return self.mesh.all_reduce(stacked.sum(0), "dp") / self.dp

    def local_replicas(self):
        """The replicas this process steps: all of them in one process, a
        dp rank's own on ranks."""
        if self.mesh is None:
            return list(range(self.dp))
        return [self.mesh.coord("dp")]

    @staticmethod
    def stack(tree, dp: int):
        """``tree`` with every tensor repeated along a new leading ``dp``
        axis (one copy a replica; a view for one replica)."""
        if dp == 1:
            return tree_map(lambda t: t.unsqueeze(0), tree)
        return tree_map(lambda t: t.unsqueeze(0).expand(
            (dp,) + tuple(t.shape)).clone(), tree)

    def sync(self, stacked_params):
        """(new stacked params, ok); ok False -> divergence recovery, the
        state unchanged."""
        local_mean = tree_map(self.mean, stacked_params)
        new_state, new_global, status = bmuf_update(
            self.state, local_mean, self.block_momentum, self.block_lr)
        if status == STOP:
            return stacked_params, False
        self.state = new_state
        return tree_map(_fill_like, new_global, stacked_params), True

    def state_dict(self):
        return {"global_params": self.state.global_params,
                "delta_prev": self.state.delta_prev,
                "block_momentum": self.block_momentum,
                "block_lr": self.block_lr,
                "sync_period": self.sync_period}

    def load_state_dict(self, d):
        """Loads a :meth:`state_dict` (tensors, or the numpy arrays a
        checkpoint holds) onto this recipe's device."""
        self.state = BmufState(to_torch(d["global_params"], self.device),
                               to_torch(d["delta_prev"], self.device))
        self.block_momentum = float(d["block_momentum"])
        self.block_lr = float(d["block_lr"])
        self.sync_period = int(d.get("sync_period", self.sync_period))


class MoEBmufTrainer:
    """MoE-aware BMUF on an unstacked tree: the expert weights average
    with ``mean_dp`` (within the data-parallel group, where each expert
    shard lives), everything else with ``mean_world``."""

    def __init__(self, params, block_momentum: float = 0.875,
                 block_lr: float = 1.0, mean_dp: Callable = lambda x: x,
                 mean_world: Callable = lambda x: x):
        self.block_momentum = block_momentum
        self.block_lr = block_lr
        self.mean_dp = mean_dp
        self.mean_world = mean_world
        self.expert_mask, _ = split_expert_params(params)
        self.state = init_state(params)

    def update_and_sync(self, local_params):
        """(new global params, SUCCESS), or (local_params, STOP) with the
        state unchanged on a non-finite delta."""
        def mean(is_expert, g, l):
            return (self.mean_dp if is_expert else self.mean_world)(g - l)

        delta = _map_with_mask(mean, self.expert_mask,
                               self.state.global_params, local_params)
        if not _all_finite(delta):
            return local_params, STOP
        m, blr = self.block_momentum, self.block_lr
        new_dp = tree_map(lambda dp, d: m * dp + blr * (1 - m) * d,
                          self.state.delta_prev, delta)
        new_global = tree_map(lambda g, dp: g - (1 + m) * dp,
                              self.state.global_params, new_dp)
        self.state = BmufState(new_global, new_dp)
        return new_global, SUCCESS

    def state_dict(self):
        return {"global_params": self.state.global_params,
                "delta_prev": self.state.delta_prev,
                "block_momentum": self.block_momentum,
                "block_lr": self.block_lr}

    def load_state_dict(self, d):
        self.state = BmufState(d["global_params"], d["delta_prev"])
        self.block_momentum = d["block_momentum"]
        self.block_lr = d["block_lr"]


def _map_with_mask(fn, mask, *trees):
    """fn(mask leaf, *tensor leaves) over trees of one structure."""
    if isinstance(mask, dict):
        return {k: _map_with_mask(fn, mask[k], *(t[k] for t in trees))
                for k in mask}
    if isinstance(mask, (list, tuple)):
        return type(mask)(_map_with_mask(fn, mask[i], *(t[i] for t in trees))
                          for i in range(len(mask)))
    if mask is None:
        return None
    return fn(mask, *trees)
