"""Pipeline parallelism over the main block stack: GPipe over the "pp"
axis (port of ``m3asr_tpu/parallel/pp.py``).

Stage s holds blocks ``[s*L/S, (s+1)*L/S)`` (``param_sharding(pp=True)``
splits the stacked leaves' leading axis). The batch is cut into M
microbatches (a batch M does not divide is padded with length-0 rows,
cut from the output); the schedule runs S + M - 1 ticks, at tick t
stage s runs microbatch t - s and hands its output to stage s + 1
(``collectives.send_next``). The last stage's outputs reach every stage
(an all-reduce in which the other stages add zeros, as the JAX
schedule's closing psum).

The backward is the schedule reversed, written out in
:class:`_Pipeline` rather than left to autograd, so that every stage
issues its hand-offs in the same order: the cotangent of the output is
summed over "pp" first (each stage's loss is its 1/S share of the
step's loss, so the sum is the output's whole cotangent, taken once),
then at each tick a stage differentiates its saved microbatch and sends
the cotangent of its input back to stage s - 1. The stage's leaves get
the sum over its microbatches; the input's gradient lies on stage 0
and pos_emb's is this stage's part (the step sums both over "pp").
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch

from m3asr_tpu_torch.checkpoint import flatten_tree, unflatten_tree
from m3asr_tpu_torch.models.conformer import layer_view, num_layers
from m3asr_tpu_torch.parallel.collectives import send_next
from m3asr_tpu_torch.parallel.mesh import PIPE_AXIS, Mesh

# block_fn(layer_params, h, lengths, embed, mask, pos_emb) -> h
BlockFn = Callable

_STATE = threading.local()


@contextlib.contextmanager
def microbatches(n: int):
    """While active (in this thread), a pipelined forward cuts its batch
    into ``n`` microbatches (the JAX ``pipeline`` context's count)."""
    prev = getattr(_STATE, "n", None)
    _STATE.n = int(n)
    try:
        yield
    finally:
        _STATE.n = prev


def active_microbatches() -> int:
    """The active :func:`microbatches` count (2 without one, the JAX
    CLI's default)."""
    n = getattr(_STATE, "n", None)
    return 2 if n is None else n


def _pad_rows(t: Optional[torch.Tensor], n: int):
    if t is None or n == 0 or t.shape[0] == 1:
        return t
    return torch.cat([t, t.new_zeros((n,) + tuple(t.shape[1:]))])


def _mb(t: Optional[torch.Tensor], i: int, Bm: int):
    """Microbatch i of a batch-leading tensor (a leading 1 broadcasts)."""
    if t is None or t.shape[0] == 1:
        return t
    return t[i * Bm:(i + 1) * Bm]


class _Schedule:
    """The forward ticks of one stage, and (with ``keep``) each
    microbatch's graph for the backward."""

    def __init__(self, mesh: Mesh, block_fn: BlockFn, names, n_layers: int,
                 M: int, remat: bool):
        self.mesh, self.block_fn, self.names = mesh, block_fn, names
        self.n_layers, self.M, self.remat = n_layers, M, remat

    def stage(self, leaves, h, lengths, embed, mask, pos_emb):
        blocks = unflatten_tree(dict(zip(self.names, leaves)))
        for i in range(self.n_layers):
            p_i = layer_view(blocks, i)
            if self.remat:
                h = torch.utils.checkpoint.checkpoint(
                    self.block_fn, p_i, h, lengths, embed, mask, pos_emb,
                    use_reentrant=False)
            else:
                h = self.block_fn(p_i, h, lengths, embed, mask, pos_emb)
        return h

    def forward(self, x, lengths, embed, mask, pos_emb, leaves, keep):
        S, s = self.mesh.shape[PIPE_AXIS], self.mesh.coord(PIPE_AXIS)
        M, Bm = self.M, x.shape[0] // self.M
        ys = x.new_zeros((M, Bm) + tuple(x.shape[1:]))
        state = x.new_zeros((Bm,) + tuple(x.shape[1:]))
        saved = {}
        for t in range(S + M - 1):
            mb = t - s
            send = torch.zeros_like(state)
            if 0 <= mb < M:
                inp = _mb(x, mb, Bm) if s == 0 else state
                args = (_mb(lengths, mb, Bm), _mb(embed, mb, Bm),
                        _mb(mask, mb, Bm))
                if keep:
                    inp = inp.detach().requires_grad_(True)
                    with torch.enable_grad():
                        out = self.stage(leaves, inp, *args, pos_emb)
                    saved[mb] = (inp, out)
                else:
                    out = self.stage(leaves, inp, *args, pos_emb)
                send = out.detach()
                if s == S - 1:
                    ys[mb] = send
            state = send_next(self.mesh, send, PIPE_AXIS)
        if s != S - 1:
            ys.zero_()
        y = self.mesh.all_reduce(ys, PIPE_AXIS)
        return y.reshape((M * Bm,) + tuple(x.shape[1:])), saved


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, x, lengths, embed, mask, pos_emb,
                *leaves):
        leaves_d = [t.detach().requires_grad_(t.requires_grad)
                    for t in leaves]
        pos_d = pos_emb.detach().requires_grad_(pos_emb.requires_grad)
        y, saved = sched.forward(x, lengths, embed, mask, pos_d, leaves_d,
                                 keep=True)
        ctx.sched, ctx.saved = sched, saved
        ctx.leaves, ctx.pos = leaves_d, pos_d
        ctx.x_shape = x.shape
        return y

    @staticmethod
    def backward(ctx, g):
        sched = ctx.sched
        mesh, M = sched.mesh, sched.M
        S, s = mesh.shape[PIPE_AXIS], mesh.coord(PIPE_AXIS)
        g = mesh.all_reduce(g.contiguous(), PIPE_AXIS)
        Bm = g.shape[0] // M
        wrt = [t for t in ctx.leaves if t.requires_grad]
        if ctx.pos.requires_grad:
            wrt.append(ctx.pos)
        acc = [torch.zeros_like(t) for t in wrt]
        dx = g.new_zeros(ctx.x_shape)
        state = g.new_zeros((Bm,) + tuple(g.shape[1:]))
        for t in reversed(range(S + M - 1)):
            mb = t - s
            send = torch.zeros_like(state)
            if 0 <= mb < M:
                inp, out = ctx.saved.pop(mb)
                gout = _mb(g, mb, Bm) if s == S - 1 else state
                got = torch.autograd.grad(out, [inp] + wrt, gout,
                                          allow_unused=True)
                for a, gi in zip(acc, got[1:]):
                    if gi is not None:
                        a.add_(gi)
                if s == 0:
                    dx[mb * Bm:(mb + 1) * Bm] = got[0]
                else:
                    send = got[0]
            state = send_next(mesh, send, PIPE_AXIS, back=True)
        grads = iter(acc)
        leaf_grads = [next(grads) if t.requires_grad else None
                      for t in ctx.leaves]
        pos_grad = next(grads) if ctx.pos.requires_grad else None
        ctx.saved = ctx.leaves = ctx.pos = None
        return (None, dx, None, None, None, pos_grad, *leaf_grads)


def pipeline_blocks(mesh: Mesh, block_fn: BlockFn, stacked_blocks,
                    x: torch.Tensor, lengths: Optional[torch.Tensor],
                    pos_emb: torch.Tensor, embed: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None,
                    remat: bool = False) -> torch.Tensor:
    """Run ``block_fn`` over this stage's blocks (``stacked_blocks``, a
    tree of ``(L/S, ...)`` tensors) as a GPipe pipeline of the active
    :func:`microbatches` count of microbatches. Returns the full batch's
    output (B, T, D) on every stage. Differentiable in x, pos_emb and
    the blocks' leaves (under autograd); lengths, embed (the routers'
    detached feature) and mask are not. ``remat`` recomputes each block
    in the backward."""
    M = active_microbatches()
    B = x.shape[0]
    pad = -B % M
    x = _pad_rows(x, pad)
    if lengths is not None and pad:
        lengths = torch.cat([lengths, lengths.new_zeros(pad)])
    embed = _pad_rows(embed, pad)
    mask = _pad_rows(mask, pad)
    flat = flatten_tree(stacked_blocks)
    names = list(flat)
    sched = _Schedule(mesh, block_fn, names, num_layers(stacked_blocks),
                      M, remat)
    leaves = [flat[k] for k in names]
    traced = torch.is_grad_enabled() and (
        x.requires_grad or pos_emb.requires_grad
        or any(t.requires_grad for t in leaves))
    if traced:
        y = _Pipeline.apply(sched, x, lengths, embed, mask, pos_emb,
                            *leaves)
    else:
        y = sched.forward(x, lengths, embed, mask, pos_emb, leaves,
                          keep=False)[0]
    return y[:B]
