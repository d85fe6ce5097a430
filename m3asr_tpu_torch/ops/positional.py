"""Positional encodings (port of ``m3asr_tpu/ops/positional.py``)."""

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
    """Returns (x * sqrt(d) (B,T,D), pos_emb = pe[:T] (T,D))."""
    d, T = x.shape[-1], x.shape[1]
    xscale = torch.tensor(math.sqrt(d), dtype=x.dtype, device=x.device)
    return x * xscale, pe[:T].to(x.dtype)
