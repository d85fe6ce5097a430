"""Sequence parallelism of the main block stack (the counterpart of the
JAX package's ``activation_sharding`` / ``constrain_act`` /
``constrain_act_nosp``, ``m3asr_tpu/parallel/mesh.py:314-408``).

Under a mesh whose "sp" axis has more than one rank, the main blocks'
``(B, T', D)`` hidden is split over time: T' is padded to a multiple of
sp (the padded rows lie past every length, so they are masked as keys
and cut from the output) and each rank keeps its ``T'/sp`` rows.
Norms, FFNs and the MoE run on those rows (:func:`row_lengths` gives
the lengths that mask them); attention takes them as queries against
the gathered keys and values (key lengths global, the chunk mask's rows
this rank's: :func:`local_rows`); the conv module gathers the time axis
around its depthwise conv. The subsampling and the embed sub-encoder
run replicated, before :func:`split`; :func:`join` gathers the stack's
output. The split is plain slicing, so a replicated leaf's gradient is
partial on each sp rank and the step sums it over "sp".
"""

from __future__ import annotations

from typing import Optional

import torch

from m3asr_tpu_torch.parallel import collectives
from m3asr_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh, active_mesh


def active() -> Optional[Mesh]:
    """The active mesh when it splits time, else None."""
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.shape[SEQ_AXIS] > 1 else None


def offset(mesh: Mesh, local_T: int) -> int:
    """The global index of this rank's first row."""
    return mesh.coord(SEQ_AXIS) * local_T


def row_lengths(mesh: Mesh, lengths: Optional[torch.Tensor],
                local_T: int) -> Optional[torch.Tensor]:
    """The lengths that mask this rank's rows as ``lengths`` masks the
    global rows (a valid prefix stays a prefix)."""
    if lengths is None:
        return None
    return (lengths - offset(mesh, local_T)).clamp(0, local_T)


def local_rows(mesh: Mesh, mask: Optional[torch.Tensor], local_T: int
               ) -> Optional[torch.Tensor]:
    """This rank's query rows of a (B|1, 1, T, S) attend-mask."""
    if mask is None:
        return None
    off = offset(mesh, local_T)
    return mask[:, :, off:off + local_T]


def gather_time(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The whole time axis (dim 1) of a split (B, T/sp, ...) tensor."""
    return collectives.gather(mesh, x, SEQ_AXIS, 1)


def _pad_time(t: torch.Tensor, n: int, dim: int = 1) -> torch.Tensor:
    if n == 0:
        return t
    shape = list(t.shape)
    shape[dim] = n
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def split(mesh: Mesh, x: torch.Tensor, pos_emb: torch.Tensor,
          embed: Optional[torch.Tensor], mask: Optional[torch.Tensor]):
    """(x's rows, pos_emb (T_pad, D), embed's rows, mask (B|1, 1, T_pad,
    T_pad), T'): T' padded to a multiple of sp with zero rows (mask rows
    and columns False)."""
    T = x.shape[1]
    n = mesh.shape[SEQ_AXIS]
    pad = -T % n
    local_T = (T + pad) // n
    off = offset(mesh, local_T)

    def rows(t):
        return None if t is None else \
            _pad_time(t, pad)[:, off:off + local_T]

    if mask is not None and pad:
        mask = _pad_time(_pad_time(mask, pad, 2), pad, 3)
    return rows(x), _pad_time(pos_emb, pad, 0), rows(embed), mask, T


def join(mesh: Mesh, x: torch.Tensor, T: int, dim: int = 1
         ) -> torch.Tensor:
    """The gathered time axis (``dim``) of the stack's output, cut to
    T'."""
    full = collectives.gather(mesh, x, SEQ_AXIS, dim)
    return full.narrow(dim, 0, T)
