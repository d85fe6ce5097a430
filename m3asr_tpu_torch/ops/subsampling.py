"""The encoders' input layers (port of ``m3asr_tpu/ops/subsampling.py``):
Conv2dSubsampling4 / 6 / 8 and LinearNoSubsampling, with their inits.

Conv kernels are stored HWIO ``(kh, kw, Cin, Cout)`` as in the JAX
package; the convolution itself runs NCHW inside ``F.conv2d``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from m3asr_tpu_torch.ops import masking
from m3asr_tpu_torch.ops.common import (init_layer_norm, init_linear,
                                        layer_norm, linear)


def _conv2d_nchw(p, x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Valid strided conv. x: (B, Cin, H, W); kernel HWIO."""
    w = p["kernel"].to(x.dtype).permute(3, 2, 0, 1)     # -> OIHW
    return F.conv2d(x, w, p["bias"].to(x.dtype), stride=stride)


def _to_4d(x: torch.Tensor, in_ch: int) -> torch.Tensor:
    """(B, T, F) -> (B, in_ch, T, F // in_ch): the JAX package's channel
    grouping (in_ch leading within each frame), channel-first."""
    B, T, Fdim = x.shape
    return x.reshape(B, T, in_ch, Fdim // in_ch).permute(0, 2, 1, 3)


def _conv_stack(p, x: torch.Tensor, strides, in_ch: int) -> torch.Tensor:
    """ReLU convs ``conv0``, ``conv1``, ... at ``strides``, the per-frame
    flatten in (C, F') order, then Linear ``out``."""
    h = _to_4d(x, in_ch)
    for i, s in enumerate(strides):
        h = torch.relu(_conv2d_nchw(p[f"conv{i}"], h, s))
    B, C, Tp, Fp = h.shape
    return linear(p["out"], h.permute(0, 2, 1, 3).reshape(B, Tp, C * Fp))


def conv2d_subsampling4(p, x: torch.Tensor,
                        lengths: Optional[torch.Tensor], in_ch: int = 1):
    """Two (k=3, s=2) convs + ReLU, per-frame flatten in (C, F') order,
    then Linear. Returns (y (B, T', odim), out_lengths)."""
    y = _conv_stack(p, x, (2, 2), in_ch)
    out_len = None if lengths is None else masking.subsampling4_length(lengths)
    return y, out_len


def conv2d_subsampling6(p, x: torch.Tensor,
                        lengths: Optional[torch.Tensor], in_ch: int = 1):
    """A (k=3, s=2) conv, then a (k=5, s=3) one; as conv2d_subsampling4
    otherwise."""
    y = _conv_stack(p, x, (2, 3), in_ch)
    out_len = None if lengths is None else masking.subsampling6_length(lengths)
    return y, out_len


def conv2d_subsampling8(p, x: torch.Tensor,
                        lengths: Optional[torch.Tensor], in_ch: int = 1):
    """Three (k=3, s=2) convs; as conv2d_subsampling4 otherwise."""
    y = _conv_stack(p, x, (2, 2, 2), in_ch)
    out_len = None if lengths is None else masking.subsampling8_length(lengths)
    return y, out_len


def linear_no_subsampling(p, x: torch.Tensor,
                          lengths: Optional[torch.Tensor]):
    """Linear + LayerNorm, no subsampling."""
    return layer_norm(p["norm"], linear(p["out"], x)), lengths


# ---------------------------------------------------------------------------
# inits: torch.nn.Conv2d's and nn.Linear's defaults (uniform in
# +-1/sqrt(fan_in)), drawn from a torch.Generator on its device
# ---------------------------------------------------------------------------

def _init_conv2d(g: torch.Generator, k: int, cin: int, cout: int, dtype):
    bound = 1.0 / math.sqrt(cin * k * k)

    def draw(shape):
        u = torch.rand(shape, generator=g, device=g.device)
        return ((u * 2 - 1) * bound).to(dtype)
    return {"kernel": draw((k, k, cin, cout)), "bias": draw((cout,))}


def _init_conv_stack(g, kernels, f_out: int, odim: int, in_ch: int, dtype):
    p = {f"conv{i}": _init_conv2d(g, k, in_ch if i == 0 else odim, odim,
                                  dtype) for i, k in enumerate(kernels)}
    p["out"] = init_linear(g, odim * f_out, odim, dtype=dtype)
    return p


def init_conv2d_subsampling4(g: torch.Generator, idim: int, odim: int,
                             in_ch: int = 1, dtype=torch.float32):
    """idim: the per-channel feature width (input_dim // in_ch)."""
    return _init_conv_stack(g, (3, 3), ((idim - 1) // 2 - 1) // 2, odim,
                            in_ch, dtype)


def init_conv2d_subsampling6(g: torch.Generator, idim: int, odim: int,
                             in_ch: int = 1, dtype=torch.float32):
    return _init_conv_stack(g, (3, 5), ((idim - 1) // 2 - 2) // 3, odim,
                            in_ch, dtype)


def init_conv2d_subsampling8(g: torch.Generator, idim: int, odim: int,
                             in_ch: int = 1, dtype=torch.float32):
    return _init_conv_stack(g, (3, 3, 3),
                            (((idim - 1) // 2 - 1) // 2 - 1) // 2, odim,
                            in_ch, dtype)


def init_linear_no_subsampling(g: torch.Generator, idim: int, odim: int,
                               dtype=torch.float32):
    """Linear (idim -> odim) and a unit LayerNorm. The JAX package has no
    init for this front end (its ``conformer.init`` asserts): the port
    draws one so that seeded synthetic engines of every input layer
    build."""
    return {"out": init_linear(g, idim, odim, dtype=dtype),
            "norm": init_layer_norm(odim, g.device, dtype)}
