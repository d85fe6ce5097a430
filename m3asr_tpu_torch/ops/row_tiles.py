"""The row-tile front of the dense streamers K6 and K8, in plain PyTorch.

``csrc/row_tiles.cuh`` turns the gate vector of one call into tiles of
up to ``TILE_ROWS`` rows of one expert on the device, before the two
GEMMs of K6 (``csrc/moe_q4.cu``) and K8 (``csrc/moe_stream.cu``) run
over them. This module is its plain twin: the same int32 words from the
same gate vector, and the reader of those words. :func:`front_op`
registers each library's front as a custom operator at import
(``m3asr::moe_q4_row_tiles``, ``m3asr::moe_stream_row_tiles``: the device
front on a CUDA tensor, :func:`row_tiles_reference` on a CPU tensor).
``chip_smoke.py`` holds the device front against it; the CPU tests check
its invariants.

The words (``front_ints(N, E)`` of them):

* ``[0]`` the real tiles, ``[1]`` the rows of no expert (a gate outside
  ``[0, E)``); ``[2]``, ``[3]`` unused;
* ``[4, 4 + N)`` ``order``: the rows of expert 0, 1, ..., E - 1, each
  expert's in ascending row order, then the rows of no expert;
* three arrays of ``max_tiles(N, E)``: each real tile's expert, its first
  slot of ``order`` and its rows (1 .. ``TILE_ROWS``), experts in order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from m3asr_tpu_torch.ops.library import kernel_op
from m3asr_tpu_torch.ops.moe_runs import TILE as TILE_ROWS   # moe::TM

MAX_EXPERTS = 127       # FRONT_MAX_EXPERTS: the front's buckets less one
HEAD = 4


def max_tiles(n_rows: int, n_experts: int) -> int:
    """The static worst case of tiles: every tile holds a row, and an
    expert wastes less than one tile."""
    return min(n_rows, -(-n_rows // TILE_ROWS) + n_experts)


def front_ints(n_rows: int, n_experts: int) -> int:
    return HEAD + n_rows + 3 * max_tiles(n_rows, n_experts)


class RowTiles(NamedTuple):
    n_tiles: int
    n_none: int
    order: torch.Tensor       # (N,) rows by expert, then rows of no expert
    tile_e: torch.Tensor      # (n_tiles,) expert of each tile
    tile_slot: torch.Tensor   # (n_tiles,) first slot of order
    tile_rows: torch.Tensor   # (n_tiles,) rows of the tile


def row_tiles_reference(gate: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The front's int32 words for ``gate`` (any shape, flattened), on
    gate's device; words 2 and 3 are 0."""
    if not 1 <= n_experts <= MAX_EXPERTS:
        raise ValueError(f"the row-tile front takes 1..{MAX_EXPERTS} "
                         f"experts, got {n_experts}")
    g = gate.reshape(-1).long()
    n = g.numel()
    bucket = torch.where((g >= 0) & (g < n_experts), g,
                         torch.full_like(g, n_experts))
    order = torch.sort(bucket, stable=True).indices
    counts = torch.bincount(bucket, minlength=n_experts + 1)
    first = torch.cumsum(counts, 0) - counts
    tiles = -(-counts[:n_experts] // TILE_ROWS)
    tile_e = torch.repeat_interleave(torch.arange(n_experts,
                                                  device=g.device), tiles)
    # a tile's index within its expert's tiles
    within = torch.arange(tile_e.numel(), device=g.device) \
        - torch.repeat_interleave(torch.cumsum(tiles, 0) - tiles, tiles)
    tile_slot = first[tile_e] + TILE_ROWS * within
    tile_rows = torch.clamp(counts[tile_e] - TILE_ROWS * within,
                            max=TILE_ROWS)
    m = max_tiles(n, n_experts)
    words = torch.zeros(front_ints(n, n_experts), dtype=torch.int32,
                        device=g.device)
    nt = tile_e.numel()
    words[0], words[1] = nt, counts[n_experts]
    words[HEAD:HEAD + n] = order
    base = HEAD + n
    for i, a in enumerate((tile_e, tile_slot, tile_rows)):
        words[base + i * m:base + i * m + nt] = a
    return words


def read_front(words: torch.Tensor, n_rows: int, n_experts: int) -> RowTiles:
    """The front's words as a :class:`RowTiles` (only the words that the
    front writes: the real tiles' entries, not the rest of the arrays)."""
    m = max_tiles(n_rows, n_experts)
    nt, n_none = int(words[0]), int(words[1])
    base = HEAD + n_rows
    return RowTiles(nt, n_none, words[HEAD:base],
                    *(words[base + i * m:base + i * m + nt] for i in range(3)))


def front_op(prefix: str, library: str):
    """Register ``m3asr::<prefix>_row_tiles(gate, n_experts) -> words``:
    the front built into the kernel library ``kernels.<library>``. Its
    CUDA implementation launches the front alone (which the GEMMs' entry
    point does itself, on the words it is handed) on words filled with
    -1, a value no word the front writes takes, so a word it fails to
    write shows."""
    def cuda(gate: torch.Tensor, n_experts: int) -> torch.Tensor:
        from m3asr_tpu_torch import kernels
        lib = getattr(kernels, library).load()
        g = gate.reshape(-1).to(torch.int32).contiguous()
        n = g.numel()
        if not 1 <= n_experts <= MAX_EXPERTS:
            raise ValueError(f"the row-tile front takes 1..{MAX_EXPERTS} "
                             f"experts, got {n_experts}")
        words = torch.full((getattr(lib, f"{prefix}_front_ints")(
            n, n_experts),), -1, dtype=torch.int32, device=gate.device)
        err = getattr(lib, f"{prefix}_row_tiles")(
            g.data_ptr(), n, n_experts, words.data_ptr(),
            torch.cuda.current_stream(gate.device).cuda_stream)
        if err:
            raise RuntimeError(f"{prefix}_row_tiles launch failed: CUDA "
                               f"error {err}")
        return words

    def fake(gate: torch.Tensor, n_experts: int) -> torch.Tensor:
        return gate.new_empty((front_ints(gate.numel(), n_experts),),
                              dtype=torch.int32)
    return kernel_op(f"{prefix}_row_tiles",
                     "(Tensor gate, int n_experts) -> Tensor",
                     row_tiles_reference, cuda, fake)


moe_q4_row_tiles = front_op("moe_q4", "MOE_Q4")              # K6's front
moe_stream_row_tiles = front_op("moe_stream", "MOE_STREAM")  # K8's front
