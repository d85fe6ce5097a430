"""The rank mesh, the sharding layouts and the forward's collectives
(port of the serving half of ``m3asr_tpu/parallel/mesh.py``).

The JAX package runs one process over a ``(pp, dp, sp, ep, tp)`` device
mesh and lets GSPMD split the weights and insert the collectives. The
port runs one process per shard over ``torch.distributed``:

    mesh = make_mesh(dp=1, ep=2, tp=2)       # every rank, same order
    specs = param_sharding(mesh, params, tp=True)
    local = shard_tree(params, specs, mesh)  # this rank's slices
    with sharded(mesh):
        ... the forward, which all-reduces over "tp" / "ep" itself

Rank ``r`` sits where device ``r`` sits in the JAX package's
``reshape(pp, dp, sp, ep, tp)`` of its devices, so tp is the innermost
axis. The layout functions return, per leaf, the JAX PartitionSpec's
tuple of axis names (``None`` for a dimension that is not split), by the
JAX package's rules.

:func:`sharded` names the mesh of the forward that runs inside it
(thread-local). The helpers :func:`psum` and :func:`pmax` all-reduce
over the named axes of that mesh and are the identity without one, or
over an axis of size 1. Modules whose weights stay replicated run
inside ``sharded(None)``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

PIPE_AXIS, DATA_AXIS, SEQ_AXIS, EXPERT_AXIS, TENSOR_AXIS = \
    "pp", "dp", "sp", "ep", "tp"
AXES = (PIPE_AXIS, DATA_AXIS, SEQ_AXIS, EXPERT_AXIS, TENSOR_AXIS)
# the axis sets that get a process group of their own (sizes > 1 only):
# each axis, and ep x tp, over which one all-reduce combines a sharded
# expert stage
GROUP_AXES = tuple((a,) for a in AXES) + ((EXPERT_AXIS, TENSOR_AXIS),)


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """A ``(pp, dp, sp, ep, tp)`` layout of ``size`` ranks and this rank's
    place in it. ``groups`` maps an axis tuple of :data:`GROUP_AXES` to
    the process group of this rank's line along those axes (absent for a
    layout-only mesh, whose collectives raise)."""

    def __init__(self, shape: Dict[str, int], rank: int, groups=None):
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        self.size = int(np.prod(list(self.shape.values())))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(
            rank, tuple(self.shape.values())))))
        self.groups = groups

    def __repr__(self):
        shape = "x".join(f"{a}{n}" for a, n in self.shape.items() if n > 1)
        return f"Mesh({shape or 'single'}, rank {self.rank})"

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axes):
        """This rank's process group along ``axes``; None where the line
        is one rank (nothing to reduce)."""
        axes = tuple(a for a in AXES if a in _axes(axes)
                     and self.shape[a] > 1)
        if not axes:
            return None
        if self.groups is None:
            raise RuntimeError(f"{self!r} is a layout without process "
                               "groups: make_mesh() in an initialized "
                               "torch.distributed world")
        return self.groups[axes]

    def add_groups(self, axes_list) -> None:
        """Create the process groups of the axis sets in ``axes_list`` that
        this mesh lacks (collective: every rank of the world calls it with
        the same list, in the same order)."""
        import torch.distributed as dist
        n = self.size
        for axes in axes_list:
            axes = tuple(a for a in AXES if a in _axes(axes)
                         and self.shape[a] > 1)
            if not axes or axes in self.groups:
                continue
            for row in _lines(self.shape, axes):
                ranks = [int(r) for r in row]
                g = (dist.group.WORLD if len(ranks) == n
                     else dist.new_group(ranks))
                if self.rank in ranks:
                    self.groups[axes] = g

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """``t`` reduced over the ranks of its line along ``axes`` (sum or
        max), in float32, returned in t's dtype: every rank of the line
        gets the same bits."""
        g = self.group(axes)
        if g is None:
            return t
        import torch.distributed as dist
        buf = t.to(torch.float32, copy=True)
        dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=g)
        return buf.to(t.dtype)


def _lines(shape: Dict[str, int], axes: Tuple[str, ...]) -> np.ndarray:
    """Every line along ``axes``: (number of lines, ranks per line), the
    ranks of a line in mesh order, lines in mesh order."""
    grid = np.arange(int(np.prod(list(shape.values())))).reshape(
        tuple(shape.values()))
    idx = [AXES.index(a) for a in axes]
    rest = [i for i in range(len(AXES)) if i not in idx]
    n = int(np.prod([shape[a] for a in axes]))
    return grid.transpose(rest + idx).reshape(-1, n)


def make_mesh(dp: Optional[int] = None, ep: int = 1, tp: int = 1,
              sp: int = 1, pp: int = 1, world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """A ``(pp, dp, sp, ep, tp)`` mesh (``dp`` defaults to what the other
    axes leave) over the ranks of the default process group, with one
    ``new_group`` per line of each axis of :data:`GROUP_AXES` longer than
    one rank: every rank creates every group, in the same order. With
    ``world_size`` and ``rank`` given it is the layout alone, for that
    rank of that many, with no groups (no process group needed)."""
    import torch.distributed as dist
    layout_only = world_size is not None
    if layout_only:
        if rank is None:
            raise ValueError("a layout mesh needs rank with world_size")
        n = int(world_size)
    else:
        if not dist.is_initialized():
            raise RuntimeError(
                "make_mesh needs an initialized torch.distributed world "
                "(parallel.distributed.initialize, under python -m "
                "torch.distributed.run), or world_size= and rank= for a "
                "layout")
        n, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        if n % (ep * tp * sp * pp):
            raise ValueError(f"{n} ranks do not split into pp{pp} x sp{sp} "
                             f"x ep{ep} x tp{tp}")
        dp = n // (ep * tp * sp * pp)
    if pp * dp * sp * ep * tp != n:
        raise ValueError(f"mesh pp{pp} x dp{dp} x sp{sp} x ep{ep} x tp{tp} "
                         f"!= {n} ranks")
    shape = dict(pp=pp, dp=dp, sp=sp, ep=ep, tp=tp)
    if layout_only:
        return Mesh(shape, rank)
    groups = {}
    for axes in GROUP_AXES:
        if any(shape[a] == 1 for a in axes):
            continue
        for row in _lines(shape, axes):
            ranks = [int(r) for r in row]
            g = (dist.group.WORLD if len(ranks) == n
                 else dist.new_group(ranks))
            if rank in ranks:
                groups[axes] = g
    return Mesh(shape, rank, groups)


# ---------------------------------------------------------------------------
# layouts: the JAX package's PartitionSpecs as tuples of axis names
# ---------------------------------------------------------------------------

# expert-tensor leaf names, float and quantized twins (ops/quant.py:
# w{1,2}_q int8, w{1,2}_q4 packed nibbles, w1_q4c tp-chunked nibbles,
# w{1,2}_scale float32)
_EXPERT_LEAVES = ("w1", "b1", "w2", "b2", "w1_q", "w2_q",
                  "w1_q4", "w2_q4", "w1_q4c", "w2_q4c",
                  "w1_scale", "w2_scale")


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of nested dicts and lists (a
    path element is a dict key or a list index); None stays None."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return None if tree is None else fn(path, tree)


def _is_expert_path(keys) -> bool:
    return any(k in _EXPERT_LEAVES for k in keys)


def _stacked_blocks_path(keys) -> bool:
    """True for leaves of the stacked main block tree (leading L axis):
    under a ``blocks`` key with no list index after it (the DFSMN
    families keep blocks as a list: no L axis) and not in the embed
    sub-encoder."""
    if "blocks" not in keys or "embed" in keys:
        return False
    i = keys.index("blocks")
    return not any(isinstance(k, int) for k in keys[i + 1:])


def _ndim(leaf) -> int:
    return len(np.shape(leaf)) if not torch.is_tensor(leaf) \
        else leaf.dim()


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if torch.is_tensor(leaf) else np.shape(leaf)


def param_sharding(mesh: Mesh, params, tp: bool = False, pp: bool = False,
                   int4_scales: bool = False):
    """Per-leaf axis tuples for a conformer-family parameter tree (the
    JAX package's rules; ``int4_scales`` is accepted and unused there
    too: a scale's layout is read from its sibling weight's rank).

    tp=False: expert tensors over "ep", the rest replicated. tp=True
    adds Megatron tensor parallelism over "tp" in the stacked main
    blocks: expert w1/b1 columns and w2 rows (b2 whole), the attention's
    q/k/v/pos columns and pos_bias_u/v heads, linear_out's rows (bias
    whole), the dense FFNs' w_1 columns and w_2 rows; the conv module,
    norms, router and the embed sub-encoder stay replicated. pp=True
    also splits the main blocks' leading L axis over "pp"."""

    def spec(keys, leaf):
        ndim = _ndim(leaf)
        stacked = _stacked_blocks_path(keys)
        pp_lead = pp and stacked

        def pspec(*axes):
            if pp_lead:
                assert not axes or axes[0] is None, axes
                axes = (PIPE_AXIS,) + tuple(axes[1:])
            return tuple(axes)

        if _is_expert_path(keys):
            name = next((k for k in reversed(keys)
                         if k in _EXPERT_LEAVES), None)
            if name in ("w1", "w2", "w1_q", "w2_q"):   # (..., E, in, out)
                lead = (None,) * (ndim - 3)
                if not tp:
                    return pspec(*lead, EXPERT_AXIS)
                tail = ((None, TENSOR_AXIS) if name.startswith("w1")
                        else (TENSOR_AXIS, None))
                return pspec(*lead, EXPERT_AXIS, *tail)
            if name == "w1_q4c":        # (..., E, in, tp, chunk)
                lead = (None,) * (ndim - 4)
                if not tp:
                    return pspec(*lead, EXPERT_AXIS)
                return pspec(*lead, EXPERT_AXIS, None, TENSOR_AXIS, None)
            if name in ("w1_q4", "w2_q4"):
                lead = (None,) * (ndim - 3)
                if tp and name == "w2_q4" and \
                        _shape(leaf)[-2] % mesh.shape[TENSOR_AXIS] == 0:
                    # row parallel on the unpacked contraction rows
                    return pspec(*lead, EXPERT_AXIS, TENSOR_AXIS, None)
                return pspec(*lead, EXPERT_AXIS)
            if name in ("w1_scale", "w2_scale"):
                # per column (..., E, 1, out) or grouped (..., E, G, 1,
                # out): grouped iff one axis more than the sibling weight
                node = params
                for k in keys[:-1]:
                    node = node[k]
                sib = node.get(name[:2] + "_q4", node.get(name[:2] + "_q"))
                sib_nd = _ndim(sib) if sib is not None else None
                if sib is None:
                    sibc = node.get(name[:2] + "_q4c")
                    if sibc is not None:      # tp-chunked: one axis more
                        sib_nd = _ndim(sibc) - 1
                grouped = sib_nd is not None and ndim == sib_nd + 1
                lead = (None,) * (ndim - (4 if grouped else 3))
                tpn = mesh.shape[TENSOR_AXIS]
                if tp and not grouped and name == "w1_scale":
                    return pspec(*lead, EXPERT_AXIS, None, TENSOR_AXIS)
                if tp and grouped and name == "w1_scale" \
                        and _shape(leaf)[-1] % tpn == 0:
                    return pspec(*lead, EXPERT_AXIS, None, None,
                                 TENSOR_AXIS)
                if tp and grouped and name == "w2_scale" \
                        and _shape(leaf)[-3] % tpn == 0:
                    return pspec(*lead, EXPERT_AXIS, TENSOR_AXIS, None,
                                 None)
                return pspec(*lead, EXPERT_AXIS)
            lead = (None,) * (ndim - 2)           # b1/b2 (..., E, dim)
            if tp and "b1" in keys:
                return pspec(*lead, EXPERT_AXIS, TENSOR_AXIS)
            return pspec(*lead, EXPERT_AXIS)
        if not tp:
            return pspec()
        if "self_attn" in keys and stacked:
            if "linear_out" in keys:
                if "kernel" in keys:          # (L, d, d) row parallel
                    return pspec(None, TENSOR_AXIS, None)
                return pspec()                # bias added once
            if keys[-1] in ("pos_bias_u", "pos_bias_v"):  # (L, H, dk)
                return pspec(None, TENSOR_AXIS)
            if "kernel" in keys:              # q/k/v/pos (L, d, d)
                return pspec(None, None, TENSOR_AXIS)
            if "bias" in keys:                # (L, d) on the head dim
                return pspec(None, TENSOR_AXIS)
        if ("w_1" in keys or "w_2" in keys) and stacked:
            row = "w_2" in keys
            if "kernel" in keys:              # (L, d, h) / (L, h, d)
                return pspec(None, TENSOR_AXIS, None) if row \
                    else pspec(None, None, TENSOR_AXIS)
            if "bias" in keys:
                return pspec() if row else pspec(None, TENSOR_AXIS)
        return pspec()

    return _map_with_path(spec, params)


def moe_param_sharding(mesh: Mesh, params):
    """Expert tensors over "ep", the rest replicated
    (``param_sharding(tp=False, pp=False)``)."""
    return param_sharding(mesh, params)


def bmuf_stacked_sharding(mesh: Mesh, stacked_tree):
    """Trees with a leading dp replica axis (BMUF mode): dp on axis 0,
    the expert axis still over "ep"."""

    def spec(keys, leaf):
        if _is_expert_path(keys):
            if _ndim(leaf) - 1 >= 3:           # (dp, L, E, ...)
                return (DATA_AXIS, None, EXPERT_AXIS)
            return (DATA_AXIS, EXPERT_AXIS)
        return (DATA_AXIS,)

    return _map_with_path(spec, stacked_tree)


def batch_sharding(mesh: Mesh):
    return (DATA_AXIS,)


def feat_sharding(mesh: Mesh):
    """(B, T, D) features: batch over dp, time over sp."""
    return (DATA_AXIS, SEQ_AXIS)


def replicated(mesh: Mesh):
    return ()


def zero_sharding(mesh: Mesh, tree, base=None, tp: bool = False,
                  pp: bool = False, min_size: int = 2048):
    """ZeRO-1 layout of an optimizer-state tree: each leaf of at least
    ``min_size`` values gains "dp" on its first unsplit axis that dp
    divides, on top of ``base`` (default :func:`param_sharding`)."""
    dp = mesh.shape[DATA_AXIS]
    if base is None:
        base = param_sharding(mesh, tree, tp=tp, pp=pp)

    def walk(node, b):
        if isinstance(node, dict):
            return {k: walk(v, b[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, bv) for v, bv in zip(node, b)]
        if node is None:
            return None
        shape = _shape(node)
        if dp <= 1 or int(np.prod(shape)) < min_size:
            return b
        parts = list(b) + [None] * (len(shape) - len(b))
        for i, dim in enumerate(shape):
            if parts[i] is None and dim % dp == 0:
                parts[i] = DATA_AXIS
                return tuple(parts)
        return b

    return walk(tree, base)


def _slices(mesh: Mesh, shape, spec):
    """The index of this rank's block of a leaf of ``shape`` split by
    ``spec``."""
    idx = []
    for i, dim in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        if axes is None:
            idx.append(slice(None))
            continue
        n = mesh.axis_size(axes)
        if dim % n:
            raise ValueError(f"dimension {i} of size {dim} does not split "
                             f"over {axes} of {n}")
        c = 0
        for a in _axes(axes):
            c = c * mesh.shape[a] + mesh.coord(a)
        idx.append(slice(c * dim // n, (c + 1) * dim // n))
    return tuple(idx)


def shard_tree(tree, specs, mesh: Mesh):
    """This rank's block of every leaf (numpy array or tensor) of
    ``tree`` under ``specs`` (a tree of axis tuples), contiguous."""
    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, s) for v, s in zip(node, spec)]
        if node is None:
            return None
        block = node[_slices(mesh, _shape(node), spec)]
        return block.contiguous() if torch.is_tensor(block) \
            else np.ascontiguousarray(block)
    return walk(tree, specs)


def gather_tree(tree, specs, mesh: Mesh):
    """Inverse of :func:`shard_tree`, collectively: every rank calls it
    and gets the whole tree back as tensors on the CPU (each split axis
    all-gathered over its line; on the card's tensors through the card
    when the backend is NCCL)."""
    import torch.distributed as dist
    on_card = dist.get_backend() == "nccl"

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, s) for v, s in zip(node, spec)]
        if node is None:
            return None
        t = node if on_card else node.detach().cpu()
        for i, axes in enumerate(spec):
            for a in reversed(_axes(axes) if axes is not None else ()):
                g = mesh.group(a)
                if g is None:
                    continue
                parts = [torch.empty_like(t) for _ in range(
                    mesh.shape[a])]
                dist.all_gather(parts, t.contiguous(), group=g)
                t = torch.cat(parts, dim=i)
        return t.cpu()
    return walk(tree, specs)


# ---------------------------------------------------------------------------
# the forward's mesh and its collectives
# ---------------------------------------------------------------------------

_STATE = threading.local()


@contextlib.contextmanager
def sharded(mesh: Optional[Mesh]):
    """While active (in this thread), the forward's sharded layers reduce
    over ``mesh``; ``sharded(None)`` marks a replicated stretch."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def active_mesh() -> Optional[Mesh]:
    return getattr(_STATE, "mesh", None)


def axis_size(axes) -> int:
    """The active mesh's size over ``axes``; 1 without one."""
    mesh = active_mesh()
    return 1 if mesh is None else mesh.axis_size(axes)


def psum(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``t`` summed over the active mesh's ``axes`` (identity without).
    Under autograd the cotangent passes through unchanged
    (``collectives.reduce_from``: a row-split product leaving its
    region)."""
    mesh = active_mesh()
    if mesh is None:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        from m3asr_tpu_torch.parallel.collectives import reduce_from
        return reduce_from(mesh, t, axes)
    return mesh.all_reduce(t, axes)


def into(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``t`` entering a region split over the active mesh's ``axes``:
    unchanged, and under autograd its cotangent is summed over them
    (``collectives.copy_to``); the identity without a mesh."""
    mesh = active_mesh()
    if mesh is None or mesh.axis_size(axes) == 1:
        return t
    from m3asr_tpu_torch.parallel.collectives import copy_to
    return copy_to(mesh, t, axes)


def pmax(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``t``'s maximum over the active mesh's ``axes`` (identity
    without)."""
    mesh = active_mesh()
    return t if mesh is None else mesh.all_reduce(t, axes, op="max")
