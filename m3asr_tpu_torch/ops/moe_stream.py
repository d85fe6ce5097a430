"""Top-1 expert FFN on float32, bf16 or int8 expert weights with no
sort/pad layout (K8, the dense float/int8 streamer).

Port of ``m3asr_tpu/ops/pallas_moe.py::_call_stream``, reached there by
``moe_experts_dense_pallas`` (float weights ``w1``/``w2``) and
``moe_experts_pallas_q`` (int8 ``w1_q``/``w2_q`` with ``(E, 1, out)``
float32 scales): the stage of explicit ``pallas`` requests on float
engines and ``pallas`` / ``quant_pallas`` on int8 engines. Same
contract: the top-1 expert output of every token, 0 for a token of no
expert (gate index outside ``[0, E)``, the JAX wrapper's -1 padding),
no sort/pad layout, and experts with no tokens never read. The CUDA
kernel (``csrc/moe_stream.cu``) computes only each expert's own rows; the
plain version here does the same in a loop over the experts that have
rows.

Rounding points (the TPU kernel's): the weights in the compute type
(x's dtype) -- float weights cast to it, int8 weights as ``q.to(cdt) *
scale.to(cdt)`` with the scale and the product rounded to it; float32
sums; the float32 bias b1 (zeros when absent), SiLU in float32, the
hidden rounded to x's dtype; b2 added in float32 when present; the
output in x's dtype. This is not K4's arithmetic (exact integer sums
times float32 scales).

Weights are ``(E, d, h)`` / ``(E, h, d)`` (one layer; the model passes
per-layer views). :data:`stream_kernel` is the wrapper, through the
custom operator ``m3asr::moe_stream`` (``ops/library.py``;
``m3asr::moe_stream_row_tiles`` is its row-tile front alone): the kernel
on a CUDA tensor (or it raises), the plain version on a CPU tensor;
``launches`` counts calls that launched the kernel.
"""

from __future__ import annotations

import torch

from m3asr_tpu_torch.ops.library import kernel_op
from m3asr_tpu_torch.ops.moe_runs import _same_as_x, expert_ffn_reference
from m3asr_tpu_torch.ops.row_tiles import MAX_EXPERTS


def _weights(p, x: torch.Tensor):
    """(w1, w2, s1, s2, quantized): the expert weights as the kernel takes
    them, (E, d, h) / (E, h, d); float weights in x's dtype, int8
    weights with their scales as float32 (E, out)."""
    if "w1_q" in p:
        w1, w2 = p["w1_q"], p["w2_q"]
        if w1.dtype != torch.int8 or w1.dim() != 3:
            raise ValueError(f"the streamer takes (E, d, h) int8 weights, "
                             f"got {w1.dtype} {tuple(w1.shape)}")
        E = w1.shape[0]
        return (w1, w2, p["w1_scale"].reshape(E, -1).float(),
                p["w2_scale"].reshape(E, -1).float(), True)
    if "w1" not in p:
        raise ValueError("the streamer takes float (w1/w2) or int8 "
                         "(w1_q/w2_q) expert weights")
    w1, w2 = p["w1"].to(x.dtype), p["w2"].to(x.dtype)
    if w1.dim() != 3:
        raise ValueError(f"the streamer takes one layer's (E, d, h) "
                         f"weights, got {tuple(w1.shape)}")
    return w1, w2, None, None, False


def _deq(w: torch.Tensor, s, dtype: torch.dtype) -> torch.Tensor:
    """One expert's weights in the compute type: ``q.to(cdt) *
    s.to(cdt)`` for int8 (s: its (out,) scales), else as they are."""
    if s is None:
        return w
    return w.to(dtype) * s.to(dtype)


def moe_experts_dense_stream_reference(p, x: torch.Tensor,
                                       gate_idx: torch.Tensor
                                       ) -> torch.Tensor:
    """Plain PyTorch version of K8. x: (B, T, d); gate_idx: (B, T).
    Returns (B, T, d) in x's dtype."""
    w1, w2, s1, s2, quant = _weights(p, x)
    E = w1.shape[0]
    B, T, d = x.shape
    x2 = x.reshape(B * T, d)
    gate = gate_idx.reshape(B * T)
    b1, b2 = p.get("b1"), p.get("b2")
    out = torch.zeros_like(x2)
    for e in torch.unique(gate[(gate >= 0) & (gate < E)]).tolist():
        rows = (gate == e).nonzero()[:, 0]
        y = expert_ffn_reference(
            x2[rows], _deq(w1[e], None if s1 is None else s1[e], x.dtype),
            None, None if b1 is None else b1[e],
            _deq(w2[e], None if s2 is None else s2[e], x.dtype), None,
            None if b2 is None else b2[e], "f")
        out[rows] = y.to(x.dtype)
    return out.reshape(B, T, d)


class StreamKernel:
    """Wrapper of ``moe_stream`` (csrc/moe_stream.cu). ``launches`` grows
    by one per call that launched the kernel (three CUDA launches: the
    row-tile front, GEMM1+bias+SiLU, GEMM2+bias)."""

    _DTYPES = {torch.float32: 0, torch.bfloat16: 1}

    def __init__(self):
        self.launches = 0

    def __call__(self, p, x: torch.Tensor,
                 gate_idx: torch.Tensor) -> torch.Tensor:
        """``m3asr::moe_stream``: the kernel on a CUDA tensor, the plain
        version on a CPU tensor."""
        if "w1_q" in p:
            return moe_stream(x, gate_idx, p["w1_q"], p["w1_scale"],
                              p.get("b1"), p["w2_q"], p["w2_scale"],
                              p.get("b2"))
        if "w1" not in p:
            raise ValueError("the streamer takes float (w1/w2) or int8 "
                             "(w1_q/w2_q) expert weights")
        return moe_stream(x, gate_idx, p["w1"], None, p.get("b1"), p["w2"],
                          None, p.get("b2"))

    def launch(self, p, x: torch.Tensor,
               gate_idx: torch.Tensor) -> torch.Tensor:
        """Run the kernel on CUDA tensors; raises on anything else."""
        if x.device.type != "cuda":
            raise ValueError(f"the streamer kernel needs CUDA tensors, got "
                             f"x on {x.device}")
        return self(p, x, gate_idx)

    def _launch(self, p, x: torch.Tensor,
                gate_idx: torch.Tensor) -> torch.Tensor:
        """The operator's CUDA implementation: checks, then the launch."""
        from m3asr_tpu_torch import kernels
        if x.device.type != "cuda":
            raise ValueError(f"the streamer kernel needs CUDA tensors, got "
                             f"x on {x.device}")
        if x.dtype not in self._DTYPES:
            raise TypeError(f"the streamer takes float32 or bfloat16 "
                            f"activations, got {x.dtype}")
        B, T, d = x.shape
        N = B * T
        if gate_idx.device != x.device or tuple(gate_idx.shape) != (B, T):
            raise ValueError("gate_idx must be (B, T) on x's device")
        w1, w2, s1, s2, quant = _weights(p, x)
        E, h = w1.shape[0], w1.shape[-1]
        if E > MAX_EXPERTS:
            raise ValueError(f"the streamer takes at most {MAX_EXPERTS} "
                             f"experts, got {E}")
        lib = kernels.MOE_STREAM.load()
        col, k_step = lib.moe_stream_col_block(), lib.moe_stream_k_step()
        if d % col or h % col or d % k_step or h % k_step:
            raise ValueError(f"the streamer needs d={d} and h={h} to be "
                             f"multiples of {col}")

        def f32(t):
            return None if t is None else t.float().contiguous()
        b1, b2 = f32(p.get("b1")), f32(p.get("b2"))
        checks = [("w1", w1, (E, d, h)), ("w2", w2, (E, h, d)),
                  ("w1_scale", s1, (E, h)), ("w2_scale", s2, (E, d)),
                  ("b1", b1, (E, h)), ("b2", b2, (E, d))]
        for name, t, shape in checks:
            if t is None:
                continue
            if t.device != x.device or tuple(t.shape) != shape:
                raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}, "
                                 f"want {shape} on {x.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")

        def ptr(t):
            return None if t is None else t.data_ptr()

        x2 = x.reshape(N, d).contiguous()
        gate = gate_idx.reshape(N).to(torch.int32).contiguous()
        front = torch.empty(lib.moe_stream_front_ints(N, E),
                            dtype=torch.int32, device=x.device)
        hidden = torch.empty((N, h), dtype=x.dtype, device=x.device)
        out = torch.empty_like(x2)
        err = lib.moe_stream(
            self._DTYPES[x.dtype], int(quant), x2.data_ptr(),
            gate.data_ptr(), N, w1.data_ptr(), ptr(s1), ptr(b1),
            w2.data_ptr(), ptr(s2), ptr(b2), E, d, h, front.data_ptr(),
            hidden.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"moe_stream launch failed: CUDA error {err}")
        self.launches += 1
        return out.reshape(B, T, d)


stream_kernel = StreamKernel()   # K8


def _stream_tree(w1, s1, b1, w2, s2, b2):
    if s1 is None:
        return {"w1": w1, "w2": w2, "b1": b1, "b2": b2}
    return {"w1_q": w1, "w2_q": w2, "w1_scale": s1, "w2_scale": s2,
            "b1": b1, "b2": b2}


moe_stream = kernel_op(
    "moe_stream",
    "(Tensor x, Tensor gate_idx, Tensor w1, Tensor? s1, Tensor? b1, "
    "Tensor w2, Tensor? s2, Tensor? b2) -> Tensor",
    lambda x, g, *w: moe_experts_dense_stream_reference(_stream_tree(*w), x,
                                                        g),
    lambda x, g, *w: stream_kernel._launch(_stream_tree(*w), x, g),
    _same_as_x)
