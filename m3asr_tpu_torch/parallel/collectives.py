"""Collectives that autograd sees (the training half of the forward's
collectives in ``parallel/mesh.py``).

GSPMD differentiates the JAX package's sharded programs by itself. The
port's training forward issues each collective explicitly, as an
autograd ``Function`` over a line of the rank mesh:

* :func:`reduce_from`: sum forward, identity backward (a row-split
  product leaving its region; Megatron's "g");
* :func:`copy_to`: identity forward, sum backward (a replicated
  activation entering a column- or expert-split region; Megatron's "f");
* :func:`all_sum`: sum forward, sum backward (a partial statistic every
  rank then uses, whose uses are themselves partial: the router
  importance's per-expert sums over dp);
* :func:`gather`: all-gather along a dim forward, this rank's slice of
  the summed cotangent backward (keys and values under sp, the hidden
  leaving the sp region, an FSDP weight);
* :func:`send_next`: stage s's tensor to stage s + 1 (or, backward, a
  cotangent to stage s - 1), the GPipe hand-off over "pp", which
  ``parallel/pp.py`` calls from its own autograd function.

Sums run in float32 and come back in the input's dtype, as
``Mesh.all_reduce``. Each primitive takes the native op where the
backend has it for the tensor's device (NCCL; gloo on CPU tensors) and
otherwise, under gloo on the card, the all-reduce that gloo does take
there: a gather sums a zero buffer with each rank's part in its slot, a
hand-off is that gather over the stage line, read at the previous
stage. The
choice reads the backend and the device (:func:`native`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from m3asr_tpu_torch.parallel.mesh import Mesh, _axes


def native(t: torch.Tensor) -> bool:
    """Whether the process group takes all-gather, reduce-scatter and
    point-to-point ops on ``t``'s device: always under NCCL, on CPU
    tensors under gloo (whose CUDA support is all-reduce and broadcast)."""
    import torch.distributed as dist
    return dist.get_backend() == "nccl" or t.device.type == "cpu"


def _line_index(mesh: Mesh, axes) -> int:
    """This rank's index in its line along ``axes`` (mesh order)."""
    c = 0
    for a in _axes(axes):
        c = c * mesh.shape[a] + mesh.coord(a)
    return c


# ---------------------------------------------------------------------------
# primitives (no autograd)
# ---------------------------------------------------------------------------

def all_gather(mesh: Mesh, t: torch.Tensor, axes, dim: int
               ) -> torch.Tensor:
    """The line's parts of ``t`` concatenated along ``dim`` in mesh
    order."""
    import torch.distributed as dist
    g = mesh.group(axes)
    if g is None:
        return t
    n = mesh.axis_size(axes)
    t = t.contiguous()
    if native(t):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=g)
        return torch.cat(parts, dim=dim)
    buf = t.new_zeros((n,) + tuple(t.shape), dtype=torch.float32)
    buf[_line_index(mesh, axes)] = t
    dist.all_reduce(buf, group=g)
    return torch.cat(buf.to(t.dtype).unbind(0), dim=dim)


def reduce_scatter(mesh: Mesh, t: torch.Tensor, axes, dim: int
                   ) -> torch.Tensor:
    """``t`` summed over the line along ``axes`` (in float32), this
    rank's slice along ``dim`` (equal slices, mesh order)."""
    import torch.distributed as dist
    g = mesh.group(axes)
    if g is None:
        return t
    n, i = mesh.axis_size(axes), _line_index(mesh, axes)
    if native(t):
        parts = [p.to(torch.float32).contiguous()
                 for p in t.chunk(n, dim=dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=g)
        return out.to(t.dtype)
    return mesh.all_reduce(t, axes).chunk(n, dim=dim)[i].contiguous()


def send_next(mesh: Mesh, t: torch.Tensor, axis: str, back: bool = False
              ) -> torch.Tensor:
    """What stage s - 1 of this rank's line along ``axis`` holds as
    ``t`` (zeros on stage 0); with ``back``, what stage s + 1 holds
    (zeros on the last stage). Every stage of the line calls it."""
    import torch.distributed as dist
    g = mesh.group(axis)
    if g is None:
        return torch.zeros_like(t)
    n, s = mesh.shape[axis], mesh.coord(axis)
    src, dst = (s + 1, s - 1) if back else (s - 1, s + 1)
    t = t.contiguous()
    if native(t):
        ranks = dist.get_process_group_ranks(g)
        out = torch.zeros_like(t)
        ops = []
        if 0 <= dst < n:
            ops.append(dist.P2POp(dist.isend, t, ranks[dst], group=g))
        if 0 <= src < n:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src], group=g))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return out
    buf = t.new_zeros((n,) + tuple(t.shape), dtype=torch.float32)
    buf[s] = t
    dist.all_reduce(buf, group=g)
    return buf[src].to(t.dtype) if 0 <= src < n else torch.zeros_like(t)


# ---------------------------------------------------------------------------
# autograd functions
# ---------------------------------------------------------------------------

class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return mesh.all_reduce(t, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes), None, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_reduce(t, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(mesh, t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(ctx.mesh, g, ctx.axes, ctx.dim), None,
                None, None)


def _traced(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def reduce_from(mesh: Mesh, t: torch.Tensor, axes: Sequence[str]
                ) -> torch.Tensor:
    """Sum over ``axes``; the cotangent passes through unchanged."""
    if mesh.group(axes) is None:
        return t
    return _ReduceFrom.apply(t, mesh, axes) if _traced(t) \
        else mesh.all_reduce(t, axes)


def copy_to(mesh: Mesh, t: torch.Tensor, axes: Sequence[str]
            ) -> torch.Tensor:
    """``t`` unchanged; its cotangent is summed over ``axes``."""
    if mesh.group(axes) is None or not _traced(t):
        return t
    return _CopyTo.apply(t, mesh, axes)


def all_sum(mesh: Mesh, t: torch.Tensor, axes: Sequence[str]
            ) -> torch.Tensor:
    """Sum over ``axes``, and the cotangents summed over them too."""
    if mesh.group(axes) is None:
        return t
    return _AllSum.apply(t, mesh, axes) if _traced(t) \
        else mesh.all_reduce(t, axes)


def gather(mesh: Mesh, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """All-gather along ``dim``; the cotangent is summed over ``axes`` and
    this rank's slice of it kept."""
    if mesh.group(axes) is None:
        return t
    return _Gather.apply(t, mesh, axes, dim) if _traced(t) \
        else all_gather(mesh, t, axes, dim)
