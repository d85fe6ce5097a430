"""Top-1 expert FFN over per-expert token tiles, float weights (K1).

Port of ``m3asr_tpu/ops/pallas_moe_runs.py::moe_experts_pallas_runs``,
fmt ``"f"``. Three parts:

* :func:`runs_layout`: the device-side layout prep in torch ops. Tokens
  are stably sorted by expert and each expert's group is padded to a
  multiple of ``TILE`` rows; ``starts`` holds each expert's first tile and
  ``tile_e`` the expert of every tile. Nothing here syncs with the host:
  the tile count is the static worst case ``ceil((N + E(TILE-1))/TILE)``.
* :func:`moe_experts_runs_reference`: the plain PyTorch version, a loop
  over experts with tokens doing ``silu(x_e w1_e + b1_e) w2_e + b2_e`` in
  float32 with the kernel's roundings. The CPU path and the tests use it.
* :data:`runs_kernel`: the wrapper of ``csrc/moe_runs.cu``. On a CUDA
  tensor it launches the kernel (or raises); on a CPU tensor it takes the
  plain version. ``runs_kernel.launches`` counts wrapper calls that
  launched the kernel.

Weights are ``(E, d, h)`` / ``(E, h, d)``, or stacked ``(L, E, ...)`` with
a ``layer`` index; biases are this layer's ``(E, h)`` / ``(E, d)``. The
computation runs at the weight dtype and returns the activation dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from m3asr_tpu_torch.ops.common import swish

TILE = 32   # rows per token tile; the kernel's TM


class RunsLayout(NamedTuple):
    order: torch.Tensor    # (N,) stable sort permutation of the tokens
    slot: torch.Tensor     # (N,) padded-buffer row of sorted token i
    starts: torch.Tensor   # (E+1,) int32 first tile of each expert
    tile_e: torch.Tensor   # (n_tiles,) int32 expert owning each tile
    n_tiles: int           # static worst-case tile count


def runs_layout(flat_e: torch.Tensor, n_experts: int,
                tile: int = TILE) -> RunsLayout:
    """Tile layout of ``m3asr_tpu/ops/moe.py::_tile_layout`` plus the
    run starts, built on ``flat_e``'s device with no host sync."""
    N = flat_e.shape[0]
    dev = flat_e.device
    e64 = flat_e.long()
    # scatter_add, not bincount: CUDA bincount reads max() on the host
    counts = torch.zeros(n_experts, dtype=torch.long, device=dev)
    counts.scatter_add_(0, e64, torch.ones_like(e64))
    tcounts = (counts + tile - 1) // tile
    ends = torch.cumsum(tcounts, 0)
    starts = torch.cat([ends.new_zeros(1), ends]).to(torch.int32)
    n_tiles = (N + n_experts * (tile - 1) + tile - 1) // tile
    order = torch.argsort(e64, stable=True)
    sorted_e = e64[order]
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(N, device=dev) - offsets[sorted_e]
    slot = (ends - tcounts)[sorted_e] * tile + pos
    tile_e = torch.searchsorted(ends, torch.arange(n_tiles, device=dev),
                                right=True)
    tile_e = tile_e.clamp_(max=n_experts - 1).to(torch.int32)
    return RunsLayout(order, slot, starts, tile_e, n_tiles)


def _prepare(p, x: torch.Tensor, layer: Optional[int]):
    """Common argument handling: (x at the weight dtype, w1, w2 as
    (L*E|E, ., .), layer index, E)."""
    w1, w2 = p["w1"], p["w2"]
    if w1.dim() == 4:
        if layer is None:
            raise ValueError("stacked (L, E, ...) weights need `layer`")
        L, E = w1.shape[:2]
        if not 0 <= int(layer) < L:
            raise ValueError(f"layer {layer} out of range for {L} layers")
        w1 = w1.reshape((L * E,) + tuple(w1.shape[2:]))
        w2 = w2.reshape((L * E,) + tuple(w2.shape[2:]))
        layer = int(layer)
    else:
        E, layer = w1.shape[0], 0
    if x.dtype != w1.dtype:
        # compute at the weight dtype: cast the activations, never the
        # weights (pallas_moe_runs.py:392-401)
        x = x.to(w1.dtype)
    return x, w1, w2, layer, E


def _pad_tokens(x2: torch.Tensor, lay: RunsLayout, tile: int) -> torch.Tensor:
    x_pad = x2.new_zeros((lay.n_tiles * tile, x2.shape[1]))
    x_pad[lay.slot] = x2[lay.order]
    return x_pad


def _unpad(y_pad: torch.Tensor, lay: RunsLayout) -> torch.Tensor:
    out = torch.empty((lay.order.shape[0], y_pad.shape[1]),
                      dtype=y_pad.dtype, device=y_pad.device)
    out[lay.order] = y_pad[lay.slot]
    return out


def moe_experts_runs_reference(p, x: torch.Tensor, gate_idx: torch.Tensor,
                               layer: Optional[int] = None,
                               tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch version of K1: same layout, then a loop over the
    experts that have tokens, float32 arithmetic, the hidden rounded to
    the compute dtype as the kernel's scratch is. x: (B, T, d);
    gate_idx: (B, T). Returns (B, T, d) in x's dtype."""
    out_dtype = x.dtype
    x, w1, w2, layer, E = _prepare(p, x, layer)
    B, T, d = x.shape
    cdt = w1.dtype
    lay = runs_layout(gate_idx.reshape(B * T), E, tile)
    x_pad = _pad_tokens(x.reshape(B * T, d), lay, tile)
    y_pad = torch.zeros_like(x_pad)
    b1, b2 = p.get("b1"), p.get("b2")
    starts = lay.starts.tolist()
    for e in range(E):
        r0, r1 = starts[e] * tile, starts[e + 1] * tile
        if r1 == r0:
            continue                      # idle expert: no work, no reads
        h = x_pad[r0:r1].float() @ w1[layer * E + e].float()
        if b1 is not None:
            h = h + b1[e].float()
        h = swish(h).to(cdt).float()
        y = h @ w2[layer * E + e].float()
        if b2 is not None:
            y = y + b2[e].float()
        y_pad[r0:r1] = y.to(cdt)
    return _unpad(y_pad, lay).reshape(B, T, d).to(out_dtype)


class RunsKernel:
    """Wrapper of the CUDA kernel ``moe_runs_f`` (csrc/moe_runs.cu).

    ``launches`` grows by one per call that launched the kernel (two CUDA
    launches: GEMM1+bias+SiLU, then GEMM2+bias)."""

    _DTYPES = {torch.float32: 0, torch.bfloat16: 1}

    def __init__(self):
        self.launches = 0

    def __call__(self, p, x: torch.Tensor, gate_idx: torch.Tensor,
                 layer: Optional[int] = None) -> torch.Tensor:
        if x.device.type == "cpu":
            return moe_experts_runs_reference(p, x, gate_idx, layer)
        return self.launch(p, x, gate_idx, layer)

    def launch(self, p, x: torch.Tensor, gate_idx: torch.Tensor,
               layer: Optional[int] = None) -> torch.Tensor:
        """Run the kernel on CUDA tensors; raises on anything else."""
        from m3asr_tpu_torch import kernels
        if x.device.type != "cuda":
            raise ValueError(f"the runs kernel needs CUDA tensors, got "
                             f"x on {x.device}")
        out_dtype = x.dtype
        x, w1, w2, layer, E = _prepare(p, x, layer)
        b1, b2 = p.get("b1"), p.get("b2")
        B, T, d = x.shape
        h = w1.shape[-1]
        lib = kernels.MOE_RUNS.load()
        tile = lib.moe_runs_tile_rows()
        if tile != TILE:
            raise RuntimeError(f"kernel tile {tile} != layout tile {TILE}")
        if d % lib.moe_runs_col_block() or h % lib.moe_runs_col_block() \
                or d % lib.moe_runs_k_step() or h % lib.moe_runs_k_step():
            raise ValueError(
                f"runs kernel needs d={d} and h={h} to be multiples of "
                f"{lib.moe_runs_col_block()}")
        dt = self._DTYPES.get(w1.dtype)
        if dt is None:
            raise TypeError(f"runs kernel takes float32/bfloat16 weights, "
                            f"got {w1.dtype}")
        checks = [("w1", p["w1"], tuple(p["w1"].shape)),
                  ("w2", p["w2"], tuple(p["w1"].shape[:-2]) + (h, d)),
                  ("b1", b1, (E, h)), ("b2", b2, (E, d))]
        for name, t, shape in checks:
            if t is None:
                continue
            if t.device != x.device or t.dtype != w1.dtype:
                raise ValueError(f"{name}: {t.dtype} on {t.device}, want "
                                 f"{w1.dtype} on {x.device}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if gate_idx.device != x.device or tuple(gate_idx.shape) != (B, T):
            raise ValueError("gate_idx must be (B, T) on x's device")

        lay = runs_layout(gate_idx.reshape(B * T), E, tile)
        x_pad = _pad_tokens(x.reshape(B * T, d), lay, tile)
        hidden = torch.empty((lay.n_tiles * tile, h), dtype=w1.dtype,
                             device=x.device)
        y_pad = torch.empty_like(x_pad)
        err = lib.moe_runs_f(
            dt, x_pad.data_ptr(), w1.data_ptr(),
            None if b1 is None else b1.data_ptr(), w2.data_ptr(),
            None if b2 is None else b2.data_ptr(), lay.tile_e.data_ptr(),
            lay.starts.data_ptr(), lay.n_tiles, E, layer, d, h,
            hidden.data_ptr(), y_pad.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"moe_runs_f launch failed: CUDA error {err}")
        self.launches += 1
        return _unpad(y_pad, lay).reshape(B, T, d).to(out_dtype)


runs_kernel = RunsKernel()
