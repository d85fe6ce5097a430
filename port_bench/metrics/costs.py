"""The yardstick's arithmetic: the H100's peaks, and the operations and
bytes of the kernels and the model from shapes and valid lengths.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (989 TFLOP/s bf16,
3.35 TB/s HBM3), as ``chip_smoke.py`` states them. A kernel's least time
is the larger of its operations over the peak and its bytes over the
bandwidth, counting each input byte read once and each output byte
written once, at the valid lengths. A family's model counts live in
``flops_<family>.py`` beside this file.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
ELT = {"float32": 4, "bfloat16": 2}


def least_s(ops: float, nbytes: float, dtype: str) -> float:
    return max(ops / PEAK_OPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S)


def k1_cost(tokens: int, d: int, h: int, active: int, dtype: str):
    """K1 (``expert_tile_gemm``, both GEMMs of one MoE layer) on
    ``tokens`` routed tokens over ``active`` experts: (ops, bytes). Bytes:
    the active experts' w1, b1, w2 and b2, the tokens in and out, and
    one int32 expert index a token."""
    elt = ELT[dtype]
    weights = active * (2 * d * h + h + d) * elt
    return 4 * tokens * d * h, weights + 2 * tokens * d * elt + 4 * tokens


def k2_rel_cost(n: int, heads: int, dk: int, dtype: str):
    """K2's forward on one utterance's rel-pos self-attention at its n
    valid frames: q2 = [q+u; q+v] and k2 = [k; pos] of 2 dk, v and the
    output of dk, the float32 log-sum-exp per row. (ops, bytes)."""
    elt = ELT[dtype]
    ops = 2 * heads * n * n * (2 * dk + dk)
    nbytes = elt * heads * n * (2 * dk + 2 * dk + dk + dk) + 4 * heads * n
    return ops, nbytes
