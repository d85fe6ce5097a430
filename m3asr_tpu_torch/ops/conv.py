"""Conformer convolution module (port of ``m3asr_tpu/ops/conv.py``).

Layout is (B, T, C) at the public functions; the depthwise kernel is
stored ``(K, C)``. BatchNorm arrives folded to scale/shift.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from m3asr_tpu_torch.ops.common import layer_norm, linear, scale_shift, swish
from m3asr_tpu_torch.ops.masking import masked_fill


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """GLU: split in half along ``dim``, a * sigmoid(b)."""
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)


def depthwise_conv1d(p, x: torch.Tensor, lorder: int = 0) -> torch.Tensor:
    """Depthwise 1-D conv over time. x: (B, T, C); kernel (K, C).

    lorder=0: SAME padding (K-1)//2 each side. lorder>0: the input is
    already left-padded (causal), so no padding here."""
    K, C = p["kernel"].shape
    pad = 0 if lorder > 0 else (K - 1) // 2
    w = p["kernel"].to(x.dtype).t().unsqueeze(1)        # (C, 1, K)
    bias = p.get("bias")
    y = F.conv1d(x.transpose(1, 2), w,
                 None if bias is None else bias.to(x.dtype),
                 padding=pad, groups=C)
    return y.transpose(1, 2)


def conv_module(p, x: torch.Tensor, lengths: Optional[torch.Tensor],
                use_layer_norm: bool = False, lorder: int = 0
                ) -> torch.Tensor:
    """Full conformer conv module. x: (B, T, C) -> (B, T, C)."""
    if lengths is not None:
        x = masked_fill(x, lengths, 0.0)
    if lorder > 0:
        # causal: left-pad before pointwise_conv1, as the reference does
        x = F.pad(x, (0, 0, lorder, 0))
    x = glu(linear(p["pointwise_conv1"], x), dim=-1)
    if lengths is not None and lorder == 0:
        # padding invariance: padded frames hold glu(pw1 bias) != 0 and
        # the depthwise conv would read them; zero them so a bucket-
        # padded batch equals an exact-length run
        x = masked_fill(x, lengths, 0.0)
    x = depthwise_conv1d(p["depthwise_conv"], x, lorder=lorder)
    if use_layer_norm:
        x = layer_norm(p["norm"], x)
    else:
        x = scale_shift(p["norm"], x)
    x = linear(p["pointwise_conv2"], swish(x))
    if lengths is not None:
        x = masked_fill(x, lengths, 0.0)
    return x
