"""Top-1 expert FFN on packed int4 weights: the dense streamer for small
token counts (K6) and the tiled grouped GEMM (K7), each weight-only or
w4a8 (``act_quant``).

Port of ``m3asr_tpu/ops/pallas_moe_q4.py::moe_experts_pallas_q4``, the
dense streamer the JAX engine picks for int4 engines at <= 128
post-subsampling tokens. Same contract: the top-1 expert output of every
token, 0 for a token of no expert (gate index outside ``[0, E)``), with
no sort/pad layout. The CUDA kernel (``csrc/moe_q4.cu``) computes only
each expert's own rows, in tiles of up to 32 rows of one expert that its
row-tile front (``ops/row_tiles.py``) lists on the device, on K5's
tensor-core tiles; the plain version here computes the same rows in a
loop over the experts that have rows, with the arithmetic of
:func:`m3asr_tpu_torch.ops.moe_runs.expert_ffn_reference`.

K7 ports ``m3asr_tpu/ops/pallas_moe_q4.py::moe_experts_pallas_q4_tiled``,
the stage of explicit ``quant4_tiled`` / ``quant4_a8_tiled`` requests:
the ``_tile_layout`` of ``ops/moe.py`` (tokens sorted by expert, each
expert's group padded to a multiple of ``tile`` rows: 64 up to 768
tokens, else 128), one expert per tile from the tile->expert table, pad
rows zero and never gathered back. Its weight-only arithmetic is not
K5's: each weight is dequantized (nibble x group scale, in float32) and
rounded to x's dtype before one float32 sum over the contraction; its
w4a8 arithmetic is K5's, so the two agree bit for bit. The CUDA kernel
(``csrc/moe_q4_tiled.cu``) runs K5's tiles on 32-row slices of the
layout's tiles. The TPU kernel's ``memoize`` option (the unpacked expert
kept in VMEM across the sequential grid's tiles) has no counterpart:
CUDA blocks run in no order, so each builds the weights of the packed
slice it stages, and repeated reads come from L2.

Weights ``w1_q4`` ``(E, d, h/2)`` / ``w2_q4`` ``(E, h, d/2)``, or stacked
``(L, E, ...)`` with a ``layer`` index; scales and biases are this
layer's (``moe_runs`` module docstring). :data:`q4_kernel` (K6) and
:data:`q4_tiled_kernel` (K7) are the wrappers: the kernel on a CUDA
tensor (or it raises), the plain version on a CPU tensor; ``launches``
counts calls that launched the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from m3asr_tpu_torch.ops.moe_runs import (_pad_tokens, _prepare, _unpad,
                                          check_quant_args,
                                          expert_ffn_reference,
                                          layer_scales, runs_layout)
from m3asr_tpu_torch.ops.quant import unpack_int4
from m3asr_tpu_torch.ops.row_tiles import MAX_EXPERTS


def _q4_args(p, x: torch.Tensor, layer: Optional[int]):
    x, w1, w2, layer, E, fmt = _prepare(p, x, layer)
    if fmt != "q4":
        raise ValueError(f"the int4 dense kernel needs packed int4 weights "
                         f"(w1_q4/w2_q4), got {fmt!r} weights")
    return x, w1, w2, layer, E


def moe_experts_q4_reference(p, x: torch.Tensor, gate_idx: torch.Tensor,
                             layer: Optional[int] = None,
                             act_quant: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K6. x: (B, T, d); gate_idx: (B, T).
    Returns (B, T, d) in x's dtype."""
    x, w1, w2, layer, E = _q4_args(p, x, layer)
    s1, s2 = layer_scales(p, E)
    b1, b2 = p.get("b1"), p.get("b2")
    B, T, d = x.shape
    x2 = x.reshape(B * T, d)
    gate = gate_idx.reshape(B * T)
    out = torch.zeros_like(x2)
    for e in torch.unique(gate[(gate >= 0) & (gate < E)]).tolist():
        rows = (gate == e).nonzero()[:, 0]
        y = expert_ffn_reference(
            x2[rows], w1[layer * E + e], s1[e],
            None if b1 is None else b1[e], w2[layer * E + e], s2[e],
            None if b2 is None else b2[e], "q4", act_quant)
        out[rows] = y.to(x.dtype)
    return out.reshape(B, T, d)


class Q4Kernel:
    """Wrapper of ``moe_q4_dense`` (csrc/moe_q4.cu). ``launches`` grows by
    one per call that launched the kernel (three CUDA launches: the
    row-tile front and the two GEMMs; five with ``act_quant``)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, p, x: torch.Tensor, gate_idx: torch.Tensor,
                 layer: Optional[int] = None,
                 act_quant: bool = False) -> torch.Tensor:
        if x.device.type == "cpu":
            return moe_experts_q4_reference(p, x, gate_idx, layer,
                                            act_quant)
        return self.launch(p, x, gate_idx, layer, act_quant)

    def launch(self, p, x: torch.Tensor, gate_idx: torch.Tensor,
               layer: Optional[int] = None,
               act_quant: bool = False) -> torch.Tensor:
        """Run the kernel on CUDA tensors; raises on anything else."""
        from m3asr_tpu_torch import kernels
        if x.device.type != "cuda":
            raise ValueError(f"the int4 dense kernel needs CUDA tensors, "
                             f"got x on {x.device}")
        x, w1, w2, layer, E = _q4_args(p, x, layer)
        B, T, _ = x.shape
        if gate_idx.device != x.device or tuple(gate_idx.shape) != (B, T):
            raise ValueError("gate_idx must be (B, T) on x's device")
        if E > MAX_EXPERTS:
            raise ValueError(f"the int4 dense kernel takes at most "
                             f"{MAX_EXPERTS} experts, got {E}")
        lib = kernels.MOE_Q4.load()
        d, h, s1, s2 = check_quant_args(p, x, w1, w2, E, "q4",
                                        lib.moe_q4_col_block(),
                                        lib.moe_q4_k_step())
        N = B * T
        x2 = x.reshape(N, d).contiguous()
        gate = gate_idx.reshape(N).to(torch.int32).contiguous()
        b1, b2 = p.get("b1"), p.get("b2")

        def ptr(t):
            return None if t is None else t.data_ptr()

        # a8: the hidden stays float32 between the GEMMs (moe_runs.py)
        hidden = torch.empty((N, h), device=x.device,
                             dtype=torch.float32 if act_quant else x.dtype)
        xq = xs = hq = hs = None
        if act_quant:
            xq = torch.empty((N, d), dtype=torch.int8, device=x.device)
            hq = torch.empty((N, h), dtype=torch.int8, device=x.device)
            xs = torch.empty(N, dtype=torch.float32, device=x.device)
            hs = torch.empty(N, dtype=torch.float32, device=x.device)
        front = torch.empty(lib.moe_q4_front_ints(N, E), dtype=torch.int32,
                            device=x.device)
        out = torch.empty_like(x2)
        err = lib.moe_q4_dense(
            int(act_quant), x2.data_ptr(), gate.data_ptr(), N,
            w1.data_ptr(), s1.data_ptr(), s1.shape[1], ptr(b1),
            w2.data_ptr(), s2.data_ptr(), s2.shape[1], ptr(b2), E, layer,
            d, h, front.data_ptr(), hidden.data_ptr(), ptr(xq), ptr(xs),
            ptr(hq), ptr(hs), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"moe_q4_dense launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return out.reshape(B, T, d)


q4_kernel = Q4Kernel()   # K6


# ---------------------------------------------------------------------------
# K7: the tiled grouped GEMM
# ---------------------------------------------------------------------------

def tiled_tile(n_tokens: int) -> int:
    """K7's tile for ``n_tokens`` tokens (pallas_moe_q4.py:682-683): per-
    expert padding wastes up to E * (tile - 1) rows, so mid-size inputs
    take the smaller tile."""
    return 64 if n_tokens <= 768 else 128


def _q4_tiled_args(p, x: torch.Tensor, layer: Optional[int],
                   activation: str):
    """(x, w1, w2, layer, E, s1 (E, G1, h), s2 (E, G2, d)); raises on
    an activation other than swish and on scale groups that do not
    divide the contraction dims."""
    if activation not in ("swish", "silu"):
        raise NotImplementedError(
            f"activation {activation!r}: the tiled int4 kernel runs swish "
            "only; DFSMN's relu comes with ROADMAP Queue 1 item 10")
    x, w1, w2, layer, E = _q4_args(p, x, layer)
    s1, s2 = layer_scales(p, E)
    d, h = x.shape[-1], 2 * w1.shape[-1]
    if d % s1.shape[1] or h % s2.shape[1]:
        raise ValueError(f"scale group counts must divide the contraction "
                         f"dims: d={d} % g1={s1.shape[1]}, h={h} % "
                         f"g2={s2.shape[1]}")
    return x, w1, w2, layer, E, s1, s2


def _dequant_q4(w: torch.Tensor, s: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """K7's weight-only dequantization of one expert's packed (K, N/2)
    weights with its (G, N) scales: nibble x group scale in float32,
    rounded to ``dtype``."""
    q = unpack_int4(w, torch.float32)
    G = s.shape[0]
    return (q.reshape(G, -1, q.shape[-1]) * s[:, None, :]) \
        .reshape(q.shape).to(dtype)


def moe_experts_q4_tiled_reference(p, x: torch.Tensor,
                                   gate_idx: torch.Tensor,
                                   tile: Optional[int] = None,
                                   activation: str = "swish",
                                   upper_bound: Optional[float] = None,
                                   layer: Optional[int] = None,
                                   act_quant: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K7: the same layout, then a loop over the
    experts' tile runs with K7's arithmetic (module docstring);
    ``upper_bound`` clamps the hidden after the activation. x: (B, T,
    d); gate_idx: (B, T). Returns (B, T, d) in x's dtype."""
    x, w1, w2, layer, E, s1, s2 = _q4_tiled_args(p, x, layer, activation)
    B, T, d = x.shape
    tile = tile or tiled_tile(B * T)
    lay = runs_layout(gate_idx.reshape(B * T), E, tile)
    x_pad = _pad_tokens(x.reshape(B * T, d), lay, tile)
    y_pad = torch.zeros_like(x_pad)
    b1, b2 = p.get("b1"), p.get("b2")
    starts = lay.starts.tolist()
    for e in range(E):
        r0, r1 = starts[e] * tile, starts[e + 1] * tile
        if r1 == r0:
            continue                      # idle expert: no work, no reads
        we1, we2 = w1[layer * E + e], w2[layer * E + e]
        bias = (None if b1 is None else b1[e], None if b2 is None else b2[e])
        if act_quant:
            y = expert_ffn_reference(x_pad[r0:r1], we1, s1[e], bias[0], we2,
                                     s2[e], bias[1], "q4", True, upper_bound)
        else:
            y = expert_ffn_reference(
                x_pad[r0:r1], _dequant_q4(we1, s1[e], x.dtype), None,
                bias[0], _dequant_q4(we2, s2[e], x.dtype), None, bias[1],
                "f", False, upper_bound)
        y_pad[r0:r1] = y.to(x.dtype)
    return _unpad(y_pad, lay).reshape(B, T, d)


class Q4TiledKernel:
    """Wrapper of ``moe_q4_tiled`` (csrc/moe_q4_tiled.cu). ``launches``
    grows by one per call that launched the kernel (two CUDA launches;
    four with ``act_quant``)."""

    _DTYPES = {torch.float32: 0, torch.bfloat16: 1}

    def __init__(self):
        self.launches = 0

    def __call__(self, p, x: torch.Tensor, gate_idx: torch.Tensor,
                 tile: Optional[int] = None, activation: str = "swish",
                 upper_bound: Optional[float] = None,
                 layer: Optional[int] = None,
                 act_quant: bool = False) -> torch.Tensor:
        if x.device.type == "cpu":
            return moe_experts_q4_tiled_reference(
                p, x, gate_idx, tile, activation, upper_bound, layer,
                act_quant)
        return self.launch(p, x, gate_idx, tile, activation, upper_bound,
                           layer, act_quant)

    def launch(self, p, x: torch.Tensor, gate_idx: torch.Tensor,
               tile: Optional[int] = None, activation: str = "swish",
               upper_bound: Optional[float] = None,
               layer: Optional[int] = None,
               act_quant: bool = False) -> torch.Tensor:
        """Run the kernel on CUDA tensors; raises on anything else."""
        from m3asr_tpu_torch import kernels
        if x.device.type != "cuda":
            raise ValueError(f"the tiled int4 kernel needs CUDA tensors, "
                             f"got x on {x.device}")
        x, w1, w2, layer, E, _, _ = _q4_tiled_args(p, x, layer, activation)
        B, T, d = x.shape
        N = B * T
        if gate_idx.device != x.device or tuple(gate_idx.shape) != (B, T):
            raise ValueError("gate_idx must be (B, T) on x's device")
        lib = kernels.MOE_Q4_TILED.load()
        tile = tile or tiled_tile(N)
        if tile % lib.moe_q4_tiled_slice_rows():
            raise ValueError(f"tile {tile} must be a multiple of "
                             f"{lib.moe_q4_tiled_slice_rows()} rows")

        def f32(t):
            return None if t is None else t.float().contiguous()
        pk = dict(p, b1=f32(p.get("b1")), b2=f32(p.get("b2")))
        _, h, s1, s2 = check_quant_args(
            pk, x, w1, w2, E, "q4", lib.moe_q4_tiled_col_block(),
            lib.moe_q4_tiled_k_step(), act_dtypes=tuple(self._DTYPES),
            bias_dtype=torch.float32)
        lay = runs_layout(gate_idx.reshape(N), E, tile)
        x_pad = _pad_tokens(x.reshape(N, d), lay, tile)
        rows = lay.n_tiles * tile

        def ptr(t):
            return None if t is None else t.data_ptr()

        hidden = torch.empty((rows, h), device=x.device,
                             dtype=torch.float32 if act_quant else x.dtype)
        xq = xs = hq = hs = None
        if act_quant:
            xq = torch.empty((rows, d), dtype=torch.int8, device=x.device)
            hq = torch.empty((rows, h), dtype=torch.int8, device=x.device)
            xs = torch.empty(rows, dtype=torch.float32, device=x.device)
            hs = torch.empty(rows, dtype=torch.float32, device=x.device)
        y_pad = torch.empty_like(x_pad)
        err = lib.moe_q4_tiled(
            self._DTYPES[x.dtype], int(act_quant), x_pad.data_ptr(),
            w1.data_ptr(), s1.data_ptr(), s1.shape[1], ptr(pk["b1"]),
            w2.data_ptr(), s2.data_ptr(), s2.shape[1], ptr(pk["b2"]),
            lay.tile_e.data_ptr(), lay.starts.data_ptr(),
            lay.counts.data_ptr(), tile, lay.n_tiles, E, layer, d, h,
            int(upper_bound is not None),
            0.0 if upper_bound is None else float(upper_bound),
            hidden.data_ptr(), ptr(xq), ptr(xs), ptr(hq), ptr(hs),
            y_pad.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"moe_q4_tiled launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return _unpad(y_pad, lay).reshape(B, T, d)


q4_tiled_kernel = Q4TiledKernel()   # K7
