"""Top-1 expert FFN on packed int4 weights at small token counts (K6),
weight-only or w4a8 (``act_quant``).

Port of ``m3asr_tpu/ops/pallas_moe_q4.py::moe_experts_pallas_q4``, the
dense streamer the JAX engine picks for int4 engines at <= 128
post-subsampling tokens. Same contract: the top-1 expert output of every
token, 0 for a token of no expert (gate index outside ``[0, E)``), with
no sort/pad layout. The CUDA kernel (``csrc/moe_q4.cu``) computes only
each expert's own rows; the plain version here does the same in a loop
over the experts that have rows, with the arithmetic of
:func:`m3asr_tpu_torch.ops.moe_runs.expert_ffn_reference`.

Weights ``w1_q4`` ``(E, d, h/2)`` / ``w2_q4`` ``(E, h, d/2)``, or stacked
``(L, E, ...)`` with a ``layer`` index; scales and biases are this
layer's (``moe_runs`` module docstring). :data:`q4_kernel` is the
wrapper: the kernel on a CUDA tensor (or it raises), the plain version
on a CPU tensor; ``launches`` counts calls that launched the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from m3asr_tpu_torch.ops.moe_runs import (_prepare, check_quant_args,
                                          expert_ffn_reference,
                                          layer_scales)


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
    one per call that launched the kernel (two CUDA launches; four with
    ``act_quant``)."""

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
        out = torch.empty_like(x2)
        err = lib.moe_q4_dense(
            int(act_quant), x2.data_ptr(), gate.data_ptr(), N,
            w1.data_ptr(), s1.data_ptr(), s1.shape[1], ptr(b1),
            w2.data_ptr(), s2.data_ptr(), s2.shape[1], ptr(b2), E, layer,
            d, h, hidden.data_ptr(), ptr(xq), ptr(xs), ptr(hq), ptr(hs),
            out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"moe_q4_dense launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return out.reshape(B, T, d)


q4_kernel = Q4Kernel()   # K6
