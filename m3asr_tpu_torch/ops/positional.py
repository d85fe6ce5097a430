"""Positional encodings (port of ``m3asr_tpu/ops/positional.py``): the
relative-position form of the encoders, the absolute form of the AED
decoders and the abs_pos encoders, and none (no_pos)."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

MAX_LEN = 5000


def sinusoid_table(d_model: int, max_len: int = MAX_LEN,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """pe[p, 2i] = sin(p w_i), pe[p, 2i+1] = cos(p w_i),
    w_i = exp(-2i ln(10000) / d), built in float32 numpy as the JAX
    package builds it."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe).to(device=device, dtype=dtype)


def rel_positional_encoding(pe: torch.Tensor, x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x * sqrt(d) (B,T,D), pos_emb = pe[:T] (T,D)). The scale
    is rounded to x's dtype first, as the JAX package rounds it (bf16:
    22.625 for d=512), and filled on x's device: no host-to-device copy,
    so a CUDA graph can capture it."""
    d, T = x.shape[-1], x.shape[1]
    xscale = torch.full((), math.sqrt(d), dtype=x.dtype, device=x.device)
    return x * xscale, pe[:T].to(x.dtype)


def abs_positional_encoding(pe: torch.Tensor, x: torch.Tensor,
                            offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute sinusoid encoding: returns (x * sqrt(d) + pe[offset:offset+T]
    (B,T,D), that slice of pe (T,D)), the scale and the table rounded to
    x's dtype first, as the JAX package rounds them."""
    d, T = x.shape[-1], x.shape[1]
    xscale = torch.full((), math.sqrt(d), dtype=x.dtype, device=x.device)
    pos_emb = pe[offset:offset + T].to(x.dtype)
    return x * xscale + pos_emb[None], pos_emb


def no_pos(x: torch.Tensor, d_model: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """No positional encoding: x as it is, and zero rows (T, d_model) for
    pos_emb, as the JAX package's conformer front end gives a no_pos
    model (whose blocks run plain attention and never read them)."""
    return x, torch.zeros((x.shape[1], d_model), dtype=x.dtype,
                          device=x.device)
