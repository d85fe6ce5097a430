"""Elementwise and dense primitives (port of ``m3asr_tpu/ops/common.py``).

Parameters are plain dicts of tensors with the JAX package's layouts:
linear kernels are stored ``(in, out)``.
"""

from __future__ import annotations

import torch

# LayerNorm epsilon of the reference model zoo
LN_EPS = 1e-12


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """``y = x @ kernel + bias`` in x's dtype; kernel stored (in, out).

    A dense-quant node (``ops/quant.py::quantize_dense_params``) holds
    ``kernel_q`` int8 and ``kernel_scale`` float32 (per output column)
    instead: the weight is ``kernel_q * kernel_scale`` with both factors
    and the product in x's dtype, as the JAX package rounds it."""
    kq = p.get("kernel_q")
    if kq is not None:
        w = kq.to(x.dtype) * p["kernel_scale"].to(x.dtype)
    else:
        w = p["kernel"].to(x.dtype)
    y = torch.matmul(x, w)
    if p.get("bias") is not None:
        y = y + p["bias"].to(x.dtype)
    return y


def layer_norm(p, x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last dim, statistics in float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def scale_shift(p, x: torch.Tensor) -> torch.Tensor:
    """Per-channel affine: the folded inference form of BatchNorm1d."""
    return x * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    """Swish/SiLU = x * sigmoid(x)."""
    return x * torch.sigmoid(x)
