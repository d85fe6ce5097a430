"""Top-1 expert FFN over per-expert token tiles: K1 (float weights), K4
(int8 weights) and K5 (packed int4 weights), each quantized format
weight-only or with per-token int8 activations (``act_quant``: w8a8,
w4a8).

Port of ``m3asr_tpu/ops/pallas_moe_runs.py::moe_experts_pallas_runs``,
fmts ``"f"``, ``"q8"`` and ``"q4"``. Three parts:

* :func:`runs_layout`: the device-side layout prep in torch ops. Tokens
  are stably sorted by expert and each expert's group is padded to a
  multiple of ``TILE`` rows; ``starts`` holds each expert's first tile and
  ``tile_e`` the expert of every tile. Nothing here syncs with the host:
  the tile count is the static worst case ``ceil((N + E(TILE-1))/TILE)``.
* :func:`moe_experts_runs_reference`: the plain PyTorch version, a loop
  over the experts that have tokens, with the kernels' arithmetic
  (:func:`expert_ffn_reference`). The CPU path and the tests use it.
* :class:`RunsKernel`: the wrapper of ``csrc/moe_runs.cu``, one instance
  per weight format (:data:`runs_kernel`, :data:`runs_q8_kernel`,
  :data:`runs_q4_kernel`; :func:`runs_for` picks by the params). It calls
  the custom operator ``m3asr::moe_runs_f`` (K1) or ``m3asr::moe_runs_q``
  (K4/K5, with the a8 row quantization) (``ops/library.py``): on a CUDA
  tensor that launches the kernel (or raises); on a CPU tensor it takes
  the plain version. Each operator returns the output and the layout's
  tokens per expert (``RunsLayout.counts``). ``launches`` counts calls
  that launched it.

GEMM1's activation is SiLU (``activation="swish"``, the conformer
experts) or ReLU (``"relu"``, the DFSMN experts), with an optional clamp
``min(hidden, upper_bound)`` in float32 after it, before the hidden is
rounded or quantized. The kernels compile the clamp into their ReLU
instantiations only: a SiLU call with ``upper_bound`` raises on the card.

Weights are ``(E, d, h)`` / ``(E, h, d)`` (float), ``w*_q`` int8 of the
same shapes, or ``w*_q4`` packed int4 ``(E, d, h/2)`` / ``(E, h, d/2)``,
or any of them stacked ``(L, E, ...)`` with a ``layer`` index. Biases
are this layer's ``(E, h)`` / ``(E, d)``; scales this layer's ``(E, 1,
out)`` (int8, or int4 with per-column scales) or ``(E, G, 1, out)``
(int4 groups). Float weights compute at the weight dtype and return the
activation dtype; quantized weights compute at the activation dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from m3asr_tpu_torch.ops.common import activation_fn, activation_name
from m3asr_tpu_torch.ops.library import kernel_op
from m3asr_tpu_torch.ops.quant import unpack_int4

TILE = 32   # rows per token tile; the kernel's TM

# GEMM1's activation -> the kernels' code (csrc/expert_tiles.cuh Act)
ACT_CODES = {"swish": 1, "relu": 2}


def kernel_act(activation, upper_bound: Optional[float]):
    """(activation code, clamp flag, upper) of a kernel call; raises
    ValueError for a clamp with SiLU, which K1 and K4-K6 do not compile
    in."""
    name = activation_name(activation)
    if upper_bound is not None and name != "relu":
        raise ValueError(f"upper_bound with activation {name!r}: the expert "
                         "kernels clamp their ReLU hidden only")
    return (ACT_CODES[name], int(upper_bound is not None),
            0.0 if upper_bound is None else float(upper_bound))

# weight keys of each format, and the kernels' code for it
_WEIGHTS = {"f": ("w1", "w2"), "q8": ("w1_q", "w2_q"),
            "q4": ("w1_q4", "w2_q4")}
_FMT_CODE = {"q8": 1, "q4": 2}


class RunsLayout(NamedTuple):
    order: torch.Tensor    # (N,) stable sort permutation of the tokens
    slot: torch.Tensor     # (N,) padded-buffer row of sorted token i
    starts: torch.Tensor   # (E+1,) int32 first tile of each expert
    tile_e: torch.Tensor   # (n_tiles,) int32 expert owning each tile
    n_tiles: int           # static worst-case tile count
    counts: torch.Tensor   # (E,) int32 tokens of each expert


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
    return RunsLayout(order, slot, starts, tile_e, n_tiles,
                      counts.to(torch.int32))


def weight_format(p) -> str:
    """``"q4"``, ``"q8"`` or ``"f"``, from the expert weight keys."""
    if "w1_q4" in p:
        return "q4"
    if "w1_q" in p:
        return "q8"
    return "f"


def _prepare(p, x: torch.Tensor, layer: Optional[int]):
    """Common argument handling: (x at the compute dtype, w1, w2 as
    (L*E|E, ., .), layer index, E, weight format)."""
    fmt = weight_format(p)
    w1, w2 = (p[k] for k in _WEIGHTS[fmt])
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
    if fmt == "f" and x.dtype != w1.dtype:
        # compute at the weight dtype: cast the activations, never the
        # weights (pallas_moe_runs.py:392-401)
        x = x.to(w1.dtype)
    return x, w1, w2, layer, E, fmt


def layer_scales(p, E: int):
    """This layer's scales as float32 ``(E, G1, h)`` and ``(E, G2, d)``
    (views of ``(E, 1, out)`` or ``(E, G, 1, out)``)."""
    out = []
    for name in ("w1_scale", "w2_scale"):
        s = p[name]
        if s.dim() >= 5 or s.shape[0] != E:
            raise ValueError(
                f"{name} {tuple(s.shape)}: pass this layer's (E, [G,] 1, "
                "out) slice; only the weights may stay stacked")
        if s.dim() == 3:                       # per-column scales
            s = s[:, None]
        out.append(s.reshape(E, s.shape[1], s.shape[-1]))
    return tuple(out)


def quant_rows(a: torch.Tensor):
    """Per-row symmetric int8 quantization in float32
    (``pallas_moe_q4._quant_rows``): s = amax/127 (1 for a zero row),
    q = clip(round(a / s), -127, 127), rounding half to even.
    Returns (q as float32 integers, s (rows, 1))."""
    af = a.float()
    amax = af.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(af / s), -127.0, 127.0), s


def expert_ffn_reference(x: torch.Tensor, w1, s1, b1, w2, s2, b2,
                         fmt: str, act_quant: bool = False,
                         upper_bound: Optional[float] = None,
                         activation="swish") -> torch.Tensor:
    """One expert's FFN ``act(x w1 + b1) w2 + b2`` on its rows x (R, d),
    with the kernels' arithmetic; returns float32 (R, d).

    w1/w2 are this expert's weights in ``fmt``; s1/s2 its (G, out)
    float32 scales (None for float weights); b1/b2 its biases or None.
    Weight-only (and float): float32 sums of x times the integer (or
    float) weights, each scale group's partial sum times its scale row,
    the hidden rounded to x's dtype. ``act_quant``: x and the float32
    hidden quantized per row, the integer sums taken exactly (float64),
    rescaled in the JAX package's order: int8 ``(t * s_x) * s_w``, int4
    ``(sum_g t_g * s_w,g) * s_x``. ``activation``: ``"swish"`` or
    ``"relu"``; ``upper_bound`` clamps the float32 hidden after it (the
    DFSMN expert's clamp)."""
    cdt = x.dtype

    def values(w):
        if fmt == "q4":
            return unpack_int4(w, torch.float32)
        return w.float()

    def gemm(a, w, s):
        q = values(w)
        if s is None:
            return a @ q
        G = s.shape[0]
        gs = q.shape[0] // G
        tot = None
        for g in range(G):
            rs = slice(g * gs, (g + 1) * gs)
            part = (a[:, rs] @ q[rs]) * s[g]
            tot = part if tot is None else tot + part
        return tot

    def gemm_a8(a, w, s):
        aq, a_s = quant_rows(a)
        q = values(w).double()
        G = s.shape[0]
        if fmt == "q8":
            return ((aq.double() @ q).float() * a_s) * s[0]
        gs = q.shape[0] // G
        tot = None
        for g in range(G):
            rs = slice(g * gs, (g + 1) * gs)
            part = (aq[:, rs].double() @ q[rs]).float() * s[g]
            tot = part if tot is None else tot + part
        return tot * a_s

    mm = gemm_a8 if act_quant else gemm
    h = mm(x.float(), w1, s1)
    if b1 is not None:
        h = h + b1.float()
    h = activation_fn(activation)(h)
    if upper_bound is not None:
        h = torch.clamp(h, max=upper_bound)
    if not act_quant:
        h = h.to(cdt).float()
    y = mm(h, w2, s2)
    if b2 is not None:
        y = y + b2.float()
    return y


def _pad_tokens(x2: torch.Tensor, lay: RunsLayout, tile: int,
                fill: float = 0.0) -> torch.Tensor:
    x_pad = x2.new_full((lay.n_tiles * tile, x2.shape[1]), fill)
    x_pad[lay.slot] = x2[lay.order]
    return x_pad


def _unpad(y_pad: torch.Tensor, lay: RunsLayout) -> torch.Tensor:
    out = torch.empty((lay.order.shape[0], y_pad.shape[1]),
                      dtype=y_pad.dtype, device=y_pad.device)
    out[lay.order] = y_pad[lay.slot]
    return out


def moe_experts_runs_reference(p, x: torch.Tensor, gate_idx: torch.Tensor,
                               layer: Optional[int] = None,
                               act_quant: bool = False,
                               tile: int = TILE, activation="swish",
                               upper_bound: Optional[float] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version of K1/K4/K5: same layout, then a loop over
    the experts that have tokens (:func:`expert_ffn_reference`); the
    output is rounded to the compute dtype as the kernel's is. x: (B, T,
    d); gate_idx: (B, T). Returns (B, T, d) in x's dtype."""
    return _runs_reference(p, x, gate_idx, layer, act_quant, tile,
                           activation, upper_bound)[0]


def _runs_reference(p, x, gate_idx, layer=None, act_quant=False, tile=TILE,
                    activation="swish", upper_bound=None):
    """:func:`moe_experts_runs_reference`'s output and the layout's
    tokens per expert (E,) int32: the operators' CPU implementation."""
    out_dtype = x.dtype
    x, w1, w2, layer, E, fmt = _prepare(p, x, layer)
    if act_quant and fmt == "f":
        raise ValueError("act_quant needs int8/int4 expert weights")
    s1, s2 = layer_scales(p, E) if fmt != "f" else (None, None)
    B, T, d = x.shape
    lay = runs_layout(gate_idx.reshape(B * T), E, tile)
    x_pad = _pad_tokens(x.reshape(B * T, d), lay, tile)
    y_pad = torch.zeros_like(x_pad)
    b1, b2 = p.get("b1"), p.get("b2")
    starts = lay.starts.tolist()
    for e in range(E):
        r0, r1 = starts[e] * tile, starts[e + 1] * tile
        if r1 == r0:
            continue                      # idle expert: no work, no reads
        y = expert_ffn_reference(
            x_pad[r0:r1], w1[layer * E + e], None if s1 is None else s1[e],
            None if b1 is None else b1[e], w2[layer * E + e],
            None if s2 is None else s2[e], None if b2 is None else b2[e],
            fmt, act_quant, upper_bound, activation)
        y_pad[r0:r1] = y.to(x_pad.dtype)
    return _unpad(y_pad, lay).reshape(B, T, d).to(out_dtype), lay.counts


def check_quant_args(p, x, w1, w2, E: int, fmt: str, col_block: int,
                     k_step: int, act_dtypes=(torch.bfloat16,),
                     bias_dtype=torch.bfloat16):
    """Raise unless the quantized kernels take these arguments:
    activations of ``act_dtypes`` (bf16, the quantized engines' type,
    for K4-K6), int8 weights of ``fmt``'s shapes, float32 scale groups
    of a multiple of ``k_step`` rows (one group for int8), biases of
    ``bias_dtype``, all contiguous on x's device. Returns (d, h, s1, s2)
    with the scales as (E, G, out)."""
    d = x.shape[-1]
    h = w1.shape[-1] * (2 if fmt == "q4" else 1)
    if x.dtype not in act_dtypes:
        raise TypeError(f"this quantized expert kernel takes {act_dtypes} "
                        f"activations, got {x.dtype}")
    s1, s2 = layer_scales(p, E)
    check_quant_widths(fmt, d, h, s1.shape[1], s2.shape[1], col_block,
                       k_step)
    div = 2 if fmt == "q4" else 1
    checks = [("w1", w1, (w1.shape[0], d, h // div), torch.int8),
              ("w2", w2, (w1.shape[0], h, d // div), torch.int8),
              ("w1_scale", s1, (E, s1.shape[1], h), torch.float32),
              ("w2_scale", s2, (E, s2.shape[1], d), torch.float32),
              ("b1", p.get("b1"), (E, h), bias_dtype),
              ("b2", p.get("b2"), (E, d), bias_dtype)]
    for name, t, shape, dtype in checks:
        if t is None:
            continue
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, want "
                             f"{dtype} on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return d, h, s1, s2


def check_quant_widths(fmt: str, d: int, h: int, g1: int, g2: int,
                       col_block: int, k_step: int) -> None:
    """Raise ``ValueError`` unless the quantized kernels take model width
    ``d``, expert hidden width ``h`` and ``g1`` / ``g2`` scale groups over
    w1's d / w2's h rows: both widths multiples of the column block
    ``col_block``, each group a multiple of ``k_step`` rows that divides
    its contraction, and one group for int8 (``fmt`` "q8")."""
    if d <= 0 or h <= 0 or d % col_block or h % col_block:
        raise ValueError(f"d={d} and h={h} must be multiples of "
                         f"{col_block}")
    for name, G, k in (("w1_scale", g1, d), ("w2_scale", g2, h)):
        if G <= 0 or k % G or (k // G) % k_step:
            raise ValueError(f"{name}: {G} groups over {k} rows; a group "
                             f"must be a multiple of {k_step} rows")
        if fmt == "q8" and G != 1:
            raise ValueError(f"{name}: int8 weights take one scale group")


def check_f_widths(d: int, h: int, col_block: int) -> None:
    """Raise ``ValueError`` unless K1 takes model width ``d`` and expert
    hidden width ``h``: both multiples of its column block ``col_block``
    (``moe_runs_f_col_block()``, which its contraction steps divide)."""
    if d <= 0 or h <= 0 or d % col_block or h % col_block:
        raise ValueError(f"runs kernel needs d={d} and h={h} to be "
                         f"multiples of {col_block}")


class RunsKernel:
    """Wrapper of one weight format's kernel in ``csrc/moe_runs.cu``:
    ``moe_runs_f`` (K1, fmt "f") or ``moe_runs_q`` (K4 "q8", K5 "q4").

    ``launches`` grows by one per call that launched the kernel (two
    CUDA launches, GEMM1+bias+activation then GEMM2+bias; four with
    ``act_quant``, which quantizes x and the hidden first).

    :meth:`routed` also returns the layout's tokens per expert, (E,)
    int32 on x's device: the routing this call ran, which the layout
    materialises anyway (K1 reads it), so returning it costs no device
    work."""

    _DTYPES = {torch.float32: 0, torch.bfloat16: 1}

    def __init__(self, fmt: str):
        self.fmt = fmt
        self.launches = 0

    def __call__(self, p, x: torch.Tensor, gate_idx: torch.Tensor,
                 layer: Optional[int] = None, act_quant: bool = False,
                 activation="swish",
                 upper_bound: Optional[float] = None) -> torch.Tensor:
        """The operator of ``p``'s weight format: the kernel on a CUDA
        tensor, the plain version on a CPU tensor."""
        return self.routed(p, x, gate_idx, layer, act_quant, activation,
                           upper_bound)[0]

    def routed(self, p, x: torch.Tensor, gate_idx: torch.Tensor,
               layer: Optional[int] = None, act_quant: bool = False,
               activation="swish", upper_bound: Optional[float] = None):
        """:meth:`__call__`'s output and the tokens per expert (E,)
        int32 of the call's layout."""
        fmt = weight_format(p)
        if act_quant and fmt == "f":
            raise ValueError("act_quant needs int8/int4 expert weights")
        name = activation_name(activation)
        w1, w2 = (p[k] for k in _WEIGHTS[fmt])
        if fmt == "f":
            return moe_runs_f(x, gate_idx, w1, p.get("b1"), w2, p.get("b2"),
                              layer, name, upper_bound)
        return moe_runs_q(x, gate_idx, w1, p["w1_scale"], p.get("b1"), w2,
                          p["w2_scale"], p.get("b2"), fmt, layer, act_quant,
                          name, upper_bound)

    def launch(self, p, x: torch.Tensor, gate_idx: torch.Tensor,
               layer: Optional[int] = None, act_quant: bool = False,
               activation="swish",
               upper_bound: Optional[float] = None) -> torch.Tensor:
        """Run the kernel on CUDA tensors; raises on anything else."""
        if x.device.type != "cuda":
            raise ValueError(f"the runs kernel needs CUDA tensors, got "
                             f"x on {x.device}")
        if weight_format(p) != self.fmt:
            raise ValueError(f"the {self.fmt!r} runs kernel got "
                             f"{weight_format(p)!r} weights")
        return self(p, x, gate_idx, layer, act_quant, activation,
                    upper_bound)

    def _launch(self, p, x: torch.Tensor, gate_idx: torch.Tensor,
                layer: Optional[int], act_quant: bool, activation,
                upper_bound: Optional[float]) -> torch.Tensor:
        """The operators' CUDA implementation: checks, then the launch."""
        from m3asr_tpu_torch import kernels
        if x.device.type != "cuda":
            raise ValueError(f"the runs kernel needs CUDA tensors, got "
                             f"x on {x.device}")
        act = kernel_act(activation, upper_bound)
        out_dtype = x.dtype
        x, w1, w2, layer, E, fmt = _prepare(p, x, layer)
        if fmt != self.fmt:
            raise ValueError(f"the {self.fmt!r} runs kernel got {fmt!r} "
                             "weights")
        if act_quant and fmt == "f":
            raise ValueError("act_quant needs int8/int4 expert weights")
        B, T, d = x.shape
        if gate_idx.device != x.device or tuple(gate_idx.shape) != (B, T):
            raise ValueError("gate_idx must be (B, T) on x's device")
        lib = kernels.MOE_RUNS.load()
        tile = lib.moe_runs_tile_rows()
        if tile != TILE:
            raise RuntimeError(f"kernel tile {tile} != layout tile {TILE}")
        if fmt == "f":
            h = self._check_float(p, x, w1, E, lib.moe_runs_f_col_block())
        else:
            d, h, s1, s2 = check_quant_args(
                p, x, w1, w2, E, fmt, lib.moe_runs_col_block(),
                lib.moe_runs_k_step())
            for name, t in (("w1", w1), ("w2", w2)):   # 16-byte copies
                if t.data_ptr() % 16:
                    raise ValueError(f"{name} must start on a 16-byte "
                                     "boundary")
        b1, b2 = p.get("b1"), p.get("b2")

        def ptr(t):
            return None if t is None else t.data_ptr()

        lay = runs_layout(gate_idx.reshape(B * T), E, tile)
        x_pad = _pad_tokens(x.reshape(B * T, d), lay, tile)
        rows = lay.n_tiles * tile
        y_pad = torch.empty_like(x_pad)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if fmt == "f":
            hidden = torch.empty((rows, h), dtype=w1.dtype, device=x.device)
            err = lib.moe_runs_f_act(
                *act, self._DTYPES[w1.dtype], x_pad.data_ptr(), w1.data_ptr(),
                ptr(b1), w2.data_ptr(), ptr(b2), lay.tile_e.data_ptr(),
                lay.starts.data_ptr(), lay.counts.data_ptr(), lay.n_tiles,
                E, layer, d, h, hidden.data_ptr(), y_pad.data_ptr(),
                stream)
        else:
            # a8: the hidden stays float32 between the two GEMMs, as the
            # TPU kernel quantizes it from its float32 value
            hidden = torch.empty((rows, h), device=x.device,
                                 dtype=torch.float32 if act_quant
                                 else x.dtype)
            xq = xs = hq = hs = None
            if act_quant:
                xq = torch.empty((rows, d), dtype=torch.int8,
                                 device=x.device)
                hq = torch.empty((rows, h), dtype=torch.int8,
                                 device=x.device)
                xs = torch.empty(rows, dtype=torch.float32, device=x.device)
                hs = torch.empty(rows, dtype=torch.float32, device=x.device)
            err = lib.moe_runs_q_act(
                *act, _FMT_CODE[fmt], int(act_quant), x_pad.data_ptr(),
                w1.data_ptr(), s1.data_ptr(), s1.shape[1], ptr(b1),
                w2.data_ptr(), s2.data_ptr(), s2.shape[1], ptr(b2),
                lay.tile_e.data_ptr(), lay.starts.data_ptr(), lay.n_tiles,
                E, layer, d, h, hidden.data_ptr(), ptr(xq), ptr(xs),
                ptr(hq), ptr(hs), y_pad.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"moe_runs ({fmt}) launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return _unpad(y_pad, lay).reshape(B, T, d).to(out_dtype), lay.counts

    @staticmethod
    def _check_float(p, x, w1, E, col_block) -> int:
        """Raise unless K1 takes these float arguments; returns h."""
        d, h = x.shape[-1], w1.shape[-1]
        check_f_widths(d, h, col_block)
        if w1.dtype not in RunsKernel._DTYPES:
            raise TypeError(f"runs kernel takes float32/bfloat16 weights, "
                            f"got {w1.dtype}")
        checks = [("w1", p["w1"], tuple(p["w1"].shape)),
                  ("w2", p["w2"], tuple(p["w1"].shape[:-2]) + (h, d)),
                  ("b1", p.get("b1"), (E, h)), ("b2", p.get("b2"), (E, d))]
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
        for name in ("w1", "w2"):          # K1 copies them in 16-byte chunks
            if p[name].data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary")
        return h


runs_kernel = RunsKernel("f")        # K1
runs_q8_kernel = RunsKernel("q8")    # K4
runs_q4_kernel = RunsKernel("q4")    # K5
_BY_FMT = {"f": runs_kernel, "q8": runs_q8_kernel, "q4": runs_q4_kernel}


def _expert_tree(fmt: str, w1, s1, b1, w2, s2, b2):
    """The operators' tensors as the expert tree the wrappers take."""
    k1, k2 = _WEIGHTS[fmt]
    p = {k1: w1, k2: w2, "b1": b1, "b2": b2}
    if s1 is not None:
        p["w1_scale"], p["w2_scale"] = s1, s2
    return p


def _same_as_x(x: torch.Tensor, *_args) -> torch.Tensor:
    """Fake implementation: the output is x's shape and dtype."""
    return x.new_empty(x.shape)


def _same_as_x_counted(x: torch.Tensor, g, w1, *_args):
    """The runs operators' fake implementation: the output is x's shape
    and dtype, the counts (E,) int32 (w1 is (E, ...) or stacked (L, E,
    ...))."""
    E = w1.shape[1] if w1.dim() == 4 else w1.shape[0]
    return x.new_empty(x.shape), x.new_empty((E,), dtype=torch.int32)


_ACT_ARGS = "str activation, float? upper_bound"
# the output and the layout's tokens per expert (E,) int32
_RETURNS = "-> (Tensor, Tensor)"

moe_runs_f = kernel_op(
    "moe_runs_f",
    "(Tensor x, Tensor gate_idx, Tensor w1, Tensor? b1, Tensor w2, "
    f"Tensor? b2, int? layer, {_ACT_ARGS}) {_RETURNS}",
    lambda x, g, w1, b1, w2, b2, layer, act, ub: _runs_reference(
        _expert_tree("f", w1, None, b1, w2, None, b2), x, g, layer,
        activation=act, upper_bound=ub),
    lambda x, g, w1, b1, w2, b2, layer, act, ub: runs_kernel._launch(
        _expert_tree("f", w1, None, b1, w2, None, b2), x, g, layer, False,
        act, ub),
    _same_as_x_counted)

moe_runs_q = kernel_op(
    "moe_runs_q",
    "(Tensor x, Tensor gate_idx, Tensor w1, Tensor s1, Tensor? b1, "
    "Tensor w2, Tensor s2, Tensor? b2, str fmt, int? layer, bool act_quant, "
    f"{_ACT_ARGS}) {_RETURNS}",
    lambda x, g, w1, s1, b1, w2, s2, b2, fmt, layer, a8, act, ub:
        _runs_reference(
            _expert_tree(fmt, w1, s1, b1, w2, s2, b2), x, g, layer, a8,
            activation=act, upper_bound=ub),
    lambda x, g, w1, s1, b1, w2, s2, b2, fmt, layer, a8, act, ub:
        _BY_FMT[fmt]._launch(_expert_tree(fmt, w1, s1, b1, w2, s2, b2), x,
                             g, layer, a8, act, ub),
    _same_as_x_counted)


def runs_for(p) -> RunsKernel:
    """The run-length wrapper of ``p``'s weight format."""
    return _BY_FMT[weight_format(p)]
