"""Flash attention for the rel-pos conformer: K2 (forward) and K3
(backward), with their plain PyTorch versions (port of
``m3asr_tpu/ops/pallas_attention.py``).

The Transformer-XL scores fold into one contraction over a doubled head
width (``flash_rel_mha``)::

    q2 = [q + u ; q + w]  (B,H,T,2Dk)      k2 = [k ; pp]  (B,H,S,2Dk)
    scores = q2 @ k2^T * scale

* :func:`flash_attention_bhtd`: the forward, ``out`` in v's dtype and
  optionally the float32 LSE row statistic.
* :func:`flash_attention_bwd`: the FlashAttention-2 recompute backward,
  ``(dq2, dk2, dv)`` from the saved LSE; ``delta = rowsum(g * out)`` is
  computed here, outside the kernels.
* :class:`FlashAttentionFn`: the autograd pair (the JAX custom VJP,
  ``_trainable_flash``); :func:`flash_rel_mha` the drop-in for
  ``ops.attention.rel_mha``; :func:`flash_attn_mem` the DFSMN
  memory-slot attention (``models/dfsmn.attn_mem_layer``), forward and
  backward.

Masks, as in the JAX kernel: key ``c < lengths[b]``; with a ``window``
``(lo, hi)`` of int32 ``(B, T)``, also ``lo <= c < hi`` or ``c <
mem_cols``. Masked scores take the finite -1e30, so a row with no key
left is the uniform average of v (garbage, discarded by length
downstream, where the XLA path returns zeros).

Each function launches its CUDA kernel (``csrc/flash_attention.cu``) on
CUDA tensors, or raises, and takes its plain version on CPU tensors. The
forward runs through the custom operator ``m3asr::flash_fwd``
(``ops/library.py``), so that ``torch.export`` traces through it; the
backward (K3) stays behind :class:`FlashAttentionFn`. The
kernels take float32 or bfloat16 with ``(D2, Dk)`` of ``(128, 64)`` (the
flagship's MoE blocks), ``(256, 128)`` (its embed blocks) or ``(64, 64)``
(the DFSMN heads), forward and backward. Each launch gets its block's
tile height from :func:`flash_block_rows`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from m3asr_tpu_torch.ops.common import at_least_f32, linear
from m3asr_tpu_torch.ops.library import kernel_op

_NEG_INF = -1e30
WIDTHS = ((128, 64), (256, 128), (64, 64))   # (D2, Dk) the kernels take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FWD_ROWS = (16, 32, 64)                # tile heights K2 is built for
BWD_ROWS = (16, 32)                    # and K3's two kernels
MIN_BLOCKS = 128                       # a block for (nearly) each of 132 SMs

Window = Optional[Tuple[torch.Tensor, torch.Tensor]]


def window_from_mask(mask: torch.Tensor, T: int, S: int):
    """Encode a contiguous-run attend-mask as per-row key windows.

    mask: bool, True=attend, (T, S), (B, T, S) or (B, 1, T, S). Each row
    must be one contiguous run of True (chunk masks are). Returns (lo, hi)
    int32 (B, T) with the valid key range [lo, hi); rows with no True get
    the empty window [0, 0)."""
    if mask.dim() == 4:
        mask = mask[:, 0]
    if mask.dim() == 2:
        mask = mask[None]
    m = mask.to(torch.int32)
    any_row = mask.any(dim=-1)
    lo = torch.argmax(m, dim=-1)
    hi = S - torch.argmax(m.flip(-1), dim=-1)
    zero = torch.zeros((), dtype=lo.dtype, device=lo.device)
    return (torch.where(any_row, lo, zero).to(torch.int32),
            torch.where(any_row, hi, zero).to(torch.int32))


def flash_block_rows(B: int, H: int, T: int, max_rows: int = 64,
                     min_blocks: int = MIN_BLOCKS) -> int:
    """Rows (queries, or keys for K3's dK/dV kernel) of one block's tile:
    the tallest of 64, 32 and 16, at most ``max_rows``, whose grid of
    ``B * H * ceil(T / rows)`` blocks still reaches ``min_blocks``, else
    16. A block is 4 warps of 16-row MMA tiles; below 64 rows its warps
    share out each tile's keys."""
    if max_rows not in FWD_ROWS:
        raise ValueError(f"max_rows must be one of {FWD_ROWS}, got "
                         f"{max_rows}")
    for rows in (64, 32):
        if rows <= max_rows and B * H * -(-T // rows) >= min_blocks:
            return rows
    return 16


def launch_rows(q2: torch.Tensor, k2: torch.Tensor):
    """The tile heights the wrappers launch with by default: K2's (two
    blocks an SM for float32, whose tiles fit twice; one for bf16), and
    K3's dQ and dK/dV kernels' (one block an SM, at most 32 rows)."""
    B, H, T, _ = q2.shape
    S = k2.shape[2]
    fwd = flash_block_rows(B, H, T, min_blocks=MIN_BLOCKS * (
        2 if q2.dtype == torch.float32 else 1))
    return fwd, (flash_block_rows(B, H, T, 32), flash_block_rows(B, H, S, 32))


def _attend(B: int, T: int, S: int, lengths, window: Window, mem_cols: int,
            device) -> Optional[torch.Tensor]:
    """bool (B, 1, T, S) attend-mask of the kernels, or None (no mask)."""
    col = torch.arange(S, device=device)
    ok = None
    if lengths is not None:
        ok = (col[None, :] < lengths.to(device)[:, None])[:, None, None, :]
    if window is not None:
        lo, hi = (w.to(device)[:, :, None] for w in window)
        win = (col >= lo) & (col < hi)
        if mem_cols:
            win = win | (col < mem_cols)
        win = win[:, None]
        ok = win if ok is None else ok & win
    return None if ok is None else ok.expand(B, 1, T, S)


def _scores(q2, k2, lengths, scale, window, mem_cols):
    B, _, T, _ = q2.shape
    S = k2.shape[2]
    s = torch.matmul(at_least_f32(q2),
                     at_least_f32(k2).transpose(-1, -2)) * scale
    ok = _attend(B, T, S, lengths, window, mem_cols, q2.device)
    return s if ok is None else s.masked_fill(~ok, _NEG_INF)


def flash_attention_reference(q2, k2, v, lengths, scale: float,
                              window: Window = None, mem_cols: int = 0):
    """Plain version of K2: (out in v's dtype (B,H,T,Dk), lse float32
    (B,H,T,1)), with the kernel's arithmetic (p rounded to v's dtype
    before the p.v product, l summed from the unrounded p)."""
    s = _scores(q2, k2, lengths, scale, window, mem_cols)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(at_least_f32(p.to(v.dtype)), at_least_f32(v)) / l
    return out.to(v.dtype), m + torch.log(l)


def flash_attention_bwd_reference(q2, k2, v, g, lse, delta, lengths,
                                  scale: float, window: Window = None,
                                  mem_cols: int = 0):
    """Plain version of K3: (dq2, dk2, dv) in the inputs' dtypes, from the
    saved lse and delta (B,H,T,1), in float32 throughout."""
    p = torch.exp(_scores(q2, k2, lengths, scale, window, mem_cols) - lse)
    gf = at_least_f32(g)
    dp = torch.matmul(gf, at_least_f32(v).transpose(-1, -2))
    ds = p * (dp - delta) * scale
    dq2 = torch.matmul(ds, at_least_f32(k2))
    dk2 = torch.matmul(ds.transpose(-1, -2), at_least_f32(q2))
    dv = torch.matmul(p.transpose(-1, -2), gf)
    return dq2.to(q2.dtype), dk2.to(k2.dtype), dv.to(v.dtype)


class FlashKernels:
    """Wrapper of ``csrc/flash_attention.cu``. Each count grows by one per
    launch of its kernel: ``fwd_launches`` (K2), ``dq_launches`` and
    ``dkv_launches`` (the two kernels of K3)."""

    def __init__(self):
        self.fwd_launches = self.dq_launches = self.dkv_launches = 0

    @staticmethod
    def _check(q2, k2, v, lengths, window, rows, allowed):
        """Raise unless the kernels take these tensors, their (D2, Dk) (one
        of :data:`WIDTHS`) and each tile height in ``rows`` (one of
        ``allowed``); returns (dtype code, D2, Dk, lens, lo, hi) with the
        int32 masks contiguous."""
        if q2.dtype not in _DTYPES or not q2.dtype == k2.dtype == v.dtype:
            raise TypeError(f"flash attention takes float32 or bfloat16 "
                            f"q2/k2/v of one dtype, got {q2.dtype}, "
                            f"{k2.dtype}, {v.dtype}")
        B, H, T, D2 = q2.shape
        S, Dk = k2.shape[2], v.shape[3]
        if (D2, Dk) not in WIDTHS:
            raise ValueError(f"the flash attention kernels are built for "
                             f"(D2, Dk) in {WIDTHS}, got ({D2}, {Dk})")
        if tuple(k2.shape) != (B, H, S, D2) or tuple(v.shape) != (B, H, S,
                                                                  Dk):
            raise ValueError(f"k2 {tuple(k2.shape)} / v {tuple(v.shape)} do "
                             f"not match q2 {tuple(q2.shape)}")
        if T == 0 or S == 0:
            raise ValueError("flash attention needs T > 0 and S > 0")
        if not set(rows) <= set(allowed):
            raise ValueError(f"tile rows must be in {allowed}, got {rows}")
        if q2.device.type != "cuda":
            raise ValueError(f"the flash attention kernels need CUDA "
                             f"tensors, got q2 on {q2.device}")
        for t in (k2, v):
            if t.device != q2.device:
                raise ValueError("q2, k2 and v must be on one device")
        lens = lo = hi = None
        if lengths is not None:
            lens = lengths.to(q2.device, torch.int32).contiguous()
            if tuple(lens.shape) != (B,):
                raise ValueError(f"lengths {tuple(lens.shape)} != ({B},)")
        if window is not None:
            lo, hi = (w.to(q2.device, torch.int32).contiguous()
                      for w in window)
            if tuple(lo.shape) != (B, T) or tuple(hi.shape) != (B, T):
                raise ValueError(f"window bounds must be ({B}, {T})")
        return _DTYPES[q2.dtype], D2, Dk, lens, lo, hi

    @staticmethod
    def _raise_on(err: int, name: str):
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")

    def forward(self, q2, k2, v, lengths, scale: float, window: Window = None,
                mem_cols: int = 0, return_lse: bool = False,
                rows: Optional[int] = None):
        """K2 on CUDA tensors (``m3asr::flash_fwd``): out (B,H,T,Dk) and
        lse (B,H,T,1) or None. ``rows``: the block's query rows, by
        default :func:`launch_rows`. Raises on anything the kernel does
        not take, CPU tensors included."""
        if q2.device.type != "cuda":
            self._check(q2, k2, v, lengths, window,
                        () if rows is None else (rows,), FWD_ROWS)
        lo, hi = (None, None) if window is None else window
        out, lse = flash_fwd(q2, k2, v, lengths, lo, hi, float(scale),
                             int(mem_cols), return_lse, rows)
        return out, (lse if return_lse else None)

    def _forward(self, q2, k2, v, lengths, scale: float, window: Window,
                 mem_cols: int, return_lse: bool, rows: Optional[int]):
        """``m3asr::flash_fwd``'s CUDA implementation: checks, then the
        launch."""
        from m3asr_tpu_torch import kernels
        q2, k2, v = q2.contiguous(), k2.contiguous(), v.contiguous()
        B, H, T, _ = q2.shape
        S = k2.shape[2]
        if rows is None:
            rows = launch_rows(q2, k2)[0]
        code, D2, Dk, lens, lo, hi = self._check(q2, k2, v, lengths, window,
                                                 (rows,), FWD_ROWS)
        out = torch.empty((B, H, T, Dk), dtype=v.dtype, device=v.device)
        lse = (torch.empty((B, H, T, 1), dtype=torch.float32,
                           device=v.device) if return_lse else None)
        lib = kernels.FLASH.load()
        err = lib.flash_fwd(
            code, D2, Dk, q2.data_ptr(), k2.data_ptr(), v.data_ptr(),
            _ptr(lens), _ptr(lo), _ptr(hi), int(mem_cols), B, H, T, S,
            float(scale), rows, out.data_ptr(), _ptr(lse),
            torch.cuda.current_stream(q2.device).cuda_stream)
        self._raise_on(err, "flash_fwd")
        self.fwd_launches += 1
        return out, lse

    def backward(self, q2, k2, v, g, lse, delta, lengths, scale: float,
                 window: Window = None, mem_cols: int = 0,
                 rows: Optional[Tuple[int, int]] = None):
        """K3 on CUDA tensors: (dq2, dk2, dv). ``rows``: the dQ kernel's
        query rows and the dK/dV kernel's keys per block, by default
        :func:`launch_rows`."""
        from m3asr_tpu_torch import kernels
        q2, k2, v = q2.contiguous(), k2.contiguous(), v.contiguous()
        B, H, T, _ = q2.shape
        S = k2.shape[2]
        if rows is None:
            rows = launch_rows(q2, k2)[1]
        code, D2, Dk, lens, lo, hi = self._check(q2, k2, v, lengths, window,
                                                 rows, BWD_ROWS)
        g = g.to(v.dtype).contiguous()
        lse = lse.to(torch.float32).contiguous()
        delta = delta.to(torch.float32).contiguous()
        if tuple(g.shape) != (B, H, T, Dk) or lse.numel() != B * H * T \
                or delta.numel() != B * H * T:
            raise ValueError("g must be (B,H,T,Dk), lse and delta (B,H,T,1)")
        dq2 = torch.empty_like(q2)
        dk2 = torch.empty_like(k2)
        dv = torch.empty_like(v)
        lib = kernels.FLASH.load()
        stream = torch.cuda.current_stream(q2.device).cuda_stream
        args = (code, D2, Dk, q2.data_ptr(), k2.data_ptr(), v.data_ptr(),
                g.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(lens),
                _ptr(lo), _ptr(hi), int(mem_cols), B, H, T, S, float(scale))
        self._raise_on(lib.flash_bwd_dq(*args, rows[0], dq2.data_ptr(),
                                        stream), "flash_bwd_dq")
        self.dq_launches += 1
        self._raise_on(lib.flash_bwd_dkv(*args, rows[1], dk2.data_ptr(),
                                         dv.data_ptr(), stream),
                       "flash_bwd_dkv")
        self.dkv_launches += 1
        return dq2, dk2, dv


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


flash_kernels = FlashKernels()


def _flash_fwd_cpu(q2, k2, v, lengths, lo, hi, scale, mem_cols, return_lse,
                   rows):
    window = None if lo is None else (lo, hi)
    out, lse = flash_attention_reference(q2, k2, v, lengths, scale, window,
                                         mem_cols)
    return out, (lse if return_lse else lse.new_empty((0,)))


def _flash_fwd_cuda(q2, k2, v, lengths, lo, hi, scale, mem_cols, return_lse,
                    rows):
    window = None if lo is None else (lo, hi)
    out, lse = flash_kernels._forward(q2, k2, v, lengths, scale, window,
                                      mem_cols, return_lse, rows)
    return out, (lse if return_lse else
                 torch.empty((0,), dtype=torch.float32, device=v.device))


def _flash_fwd_fake(q2, k2, v, lengths, lo, hi, scale, mem_cols, return_lse,
                    rows):
    B, H, T, _ = q2.shape
    lse = (q2.new_empty((B, H, T, 1), dtype=torch.float32) if return_lse
           else q2.new_empty((0,), dtype=torch.float32))
    return v.new_empty((B, H, T, v.shape[3])), lse


# K2: (out (B,H,T,Dk) in v's dtype, lse float32 (B,H,T,1), or (0,)
# without return_lse)
flash_fwd = kernel_op(
    "flash_fwd",
    "(Tensor q2, Tensor k2, Tensor v, Tensor? lengths, Tensor? lo, "
    "Tensor? hi, float scale, int mem_cols, bool return_lse, int? rows) "
    "-> (Tensor, Tensor)",
    _flash_fwd_cpu, _flash_fwd_cuda, _flash_fwd_fake)


def flash_attention_bhtd(q2: torch.Tensor, k2: torch.Tensor, v: torch.Tensor,
                         lengths: Optional[torch.Tensor], scale: float,
                         window: Window = None, mem_cols: int = 0,
                         return_lse: bool = False):
    """q2 (B,H,T,D2), k2 (B,H,S,D2), v (B,H,S,Dk), lengths int (B,) or
    None. Returns out (B,H,T,Dk) in v's dtype, or (out, lse (B,H,T,1)
    float32) with ``return_lse``. K2 on CUDA, its plain version on the
    CPU (``m3asr::flash_fwd``)."""
    lo, hi = (None, None) if window is None else window
    out, lse = flash_fwd(q2, k2, v, lengths, lo, hi, float(scale),
                         int(mem_cols), return_lse, None)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q2, k2, v, out, lse, g, lengths, scale: float,
                        window: Window = None, mem_cols: int = 0):
    """Backward of :func:`flash_attention_bhtd` from its saved ``out`` and
    ``lse``: (dq2, dk2, dv) in the inputs' dtypes. K3 on CUDA, its plain
    version on the CPU."""
    delta = (at_least_f32(g) * at_least_f32(out)).sum(dim=-1, keepdim=True)
    if q2.device.type == "cpu":
        return flash_attention_bwd_reference(q2, k2, v, g, lse, delta,
                                             lengths, scale, window,
                                             mem_cols)
    return flash_kernels.backward(q2, k2, v, g, lse, delta, lengths, scale,
                                  window, mem_cols)


class FlashAttentionFn(torch.autograd.Function):
    """K2 forward with K3 backward (the JAX ``_trainable_flash`` custom
    VJP). The backward never differentiates through a forward: it calls
    :func:`flash_attention_bwd` on the saved tensors. Integer inputs
    (lengths, window bounds) get no gradient."""

    @staticmethod
    def forward(ctx, q2, k2, v, lengths, lo, hi, scale: float,
                mem_cols: int):
        window = None if lo is None else (lo, hi)
        out, lse = flash_attention_bhtd(q2, k2, v, lengths, scale, window,
                                        mem_cols, return_lse=True)
        ctx.save_for_backward(q2, k2, v, out, lse, lengths, lo, hi)
        ctx.scale, ctx.mem_cols = scale, mem_cols
        return out

    @staticmethod
    def backward(ctx, g):
        q2, k2, v, out, lse, lengths, lo, hi = ctx.saved_tensors
        window = None if lo is None else (lo, hi)
        dq2, dk2, dv = flash_attention_bwd(q2, k2, v, out, lse, g, lengths,
                                           ctx.scale, window, ctx.mem_cols)
        return dq2, dk2, dv, None, None, None, None, None


def flash_attention_trainable(q2, k2, v, lengths, scale: float,
                              window: Window = None, mem_cols: int = 0):
    """:func:`flash_attention_bhtd` that autograd can differentiate
    (through :class:`FlashAttentionFn`); without grad it skips the LSE."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q2, k2, v)):
        lo, hi = (None, None) if window is None else window
        return FlashAttentionFn.apply(q2, k2, v, lengths, lo, hi,
                                      float(scale), int(mem_cols))
    return flash_attention_bhtd(q2, k2, v, lengths, scale, window, mem_cols)


def flash_rel_mha(p, x: torch.Tensor, pos_emb: torch.Tensor,
                  lengths: Optional[torch.Tensor], num_heads: int,
                  mask: Optional[torch.Tensor] = None,
                  kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in for ``ops.attention.rel_mha`` on the flash kernels; same
    parameters. ``mask``: optional attend-mask with contiguous-run rows
    (``add_optional_chunk_mask``), encoded as per-row key windows. Rows
    that attend to nothing come back as garbage instead of the XLA path's
    zeros; both are discarded by length downstream. ``kv`` (B, S, D):
    the keys' and values' input when it is not x (sequence parallelism:
    x's T rows are this rank's queries, the windows S-long key ranges)."""
    h = num_heads
    B, T, D = x.shape
    d_k = D // h
    kv = x if kv is None else kv
    S = kv.shape[1]

    def heads(t):                                 # (b,T,D) -> (b,H,T,Dk)
        return t.reshape(t.shape[0], -1, h, d_k).transpose(1, 2)

    q = heads(linear(p["linear_q"], x))
    k = heads(linear(p["linear_k"], kv))
    v = heads(linear(p["linear_v"], kv))
    pp = heads(linear(p["linear_pos"], pos_emb[None]))         # (1,H,S,Dk)
    u = p["pos_bias_u"].to(x.dtype)[None, :, None, :]
    w = p["pos_bias_v"].to(x.dtype)[None, :, None, :]
    q2 = torch.cat([q + u, q + w], dim=-1)                     # (B,H,T,2Dk)
    # pp broadcast over the batch: its gradient sums over the batch
    k2 = torch.cat([k, pp.expand(B, -1, -1, -1)], dim=-1)
    window = None
    if mask is not None:
        lo, hi = window_from_mask(mask, T, S)
        window = (lo.expand(B, T), hi.expand(B, T))
    ctx = flash_attention_trainable(q2, k2, v, lengths, float(d_k) ** -0.5,
                                    window)
    return linear(p["linear_out"], ctx.transpose(1, 2).reshape(B, T, D))


def attn_mem_inputs(p, x: torch.Tensor, lengths: Optional[torch.Tensor],
                    num_heads: int, memory_num: int,
                    attn_mask: Optional[torch.Tensor] = None):
    """K2's arguments for the DFSMN memory-slot attention of x (B, T, D):
    (q (B,H,T,dk), k and v (B,H,M+T,dk) with the M memory slots
    PREPENDED, key lengths + M, the window (or None) and mem_cols).
    The softmax does not depend on the keys' order, so the valid keys
    stay a prefix of ``lengths + M``. ``attn_mask``: optional (T, T) bool
    over the frames with contiguous-run rows (chunk windows), encoded as
    per-row key windows shifted by M onto the prepended layout; the slots
    stay attendable to every row as the kernel's ``mem_cols`` prefix."""
    B, T, D = x.shape
    h = num_heads
    dk = D // h

    def heads(t):                                 # (B,T,D) -> (B,H,T,dk)
        return t.reshape(B, T, h, dk).transpose(1, 2)

    q = heads(linear(p["linear_query"], x))
    k = heads(linear(p["linear_key"], x))
    v = heads(linear(p["linear_value"], x))
    if memory_num > 0:
        km = p["key_memory"].to(x.dtype)[None].expand(B, -1, -1, -1)
        vm = p["value_memory"].to(x.dtype)[None].expand(B, -1, -1, -1)
        k = torch.cat([km, k], dim=2)
        v = torch.cat([vm, v], dim=2)
    if lengths is None:
        lens = torch.full((B,), T + memory_num, dtype=torch.int32,
                          device=x.device)
    else:
        lens = lengths.to(torch.int32) + memory_num
    window = None
    if attn_mask is not None:
        lo, hi = window_from_mask(attn_mask, T, T)
        window = (lo.expand(B, T) + memory_num, hi.expand(B, T) + memory_num)
    return (q, k, v, lens, window,
            memory_num if window is not None else 0)


def flash_attn_mem(p, x: torch.Tensor, lengths: Optional[torch.Tensor],
                   num_heads: int, memory_num: int,
                   attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The DFSMN memory-slot attention (``models/dfsmn.attn_mem_layer``)
    on K2, with the arguments of :func:`attn_mem_inputs`; under autograd
    its backward runs K3 (:class:`FlashAttentionFn`), and the gradients
    of the prepended slots flow back to ``key_memory`` and
    ``value_memory``. Rows that attend to nothing come back as garbage,
    as in :func:`flash_rel_mha`."""
    B, T, D = x.shape
    q, k, v, lens, window, mem_cols = attn_mem_inputs(
        p, x, lengths, num_heads, memory_num, attn_mask)
    ctx = flash_attention_trainable(q, k, v, lens,
                                    float(D // num_heads) ** -0.5, window,
                                    mem_cols=mem_cols)
    return linear(p["linear_out"], ctx.transpose(1, 2).reshape(B, T, D))
