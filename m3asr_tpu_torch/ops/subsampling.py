"""Conv2dSubsampling4 front end (port of ``m3asr_tpu/ops/subsampling.py``).

Conv kernels are stored HWIO ``(kh, kw, Cin, Cout)`` as in the JAX
package; the convolution itself runs NCHW inside ``F.conv2d``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from m3asr_tpu_torch.ops import masking
from m3asr_tpu_torch.ops.common import linear


def _conv2d_nchw(p, x: torch.Tensor) -> torch.Tensor:
    """Valid k x k stride-2 conv. x: (B, Cin, H, W); kernel HWIO."""
    w = p["kernel"].to(x.dtype).permute(3, 2, 0, 1)     # -> OIHW
    return F.conv2d(x, w, p["bias"].to(x.dtype), stride=2)


def _to_4d(x: torch.Tensor, in_ch: int) -> torch.Tensor:
    """(B, T, F) -> (B, in_ch, T, F // in_ch): the JAX package's channel
    grouping (in_ch leading within each frame), channel-first."""
    B, T, Fdim = x.shape
    return x.reshape(B, T, in_ch, Fdim // in_ch).permute(0, 2, 1, 3)


def conv2d_subsampling4(p, x: torch.Tensor,
                        lengths: Optional[torch.Tensor], in_ch: int = 1):
    """Two (k=3, s=2) convs + ReLU, per-frame flatten in (C, F') order,
    then Linear. Returns (y (B, T', odim), out_lengths)."""
    h = torch.relu(_conv2d_nchw(p["conv0"], _to_4d(x, in_ch)))
    h = torch.relu(_conv2d_nchw(p["conv1"], h))
    B, C, Tp, Fp = h.shape
    h = h.permute(0, 2, 1, 3).reshape(B, Tp, C * Fp)
    y = linear(p["out"], h)
    out_len = None if lengths is None else masking.subsampling4_length(lengths)
    return y, out_len
