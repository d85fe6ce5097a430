"""Length and padding masks (port of ``m3asr_tpu/ops/masking.py``)."""

from __future__ import annotations

import torch


def make_valid_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True at VALID positions: bool (B, max_len)."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def masked_fill(x: torch.Tensor, lengths: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """Fill time positions >= length with ``fill``; x is (B, T, ...)."""
    T = x.shape[1]
    valid = make_valid_mask(lengths, T).reshape(
        (x.shape[0], T) + (1,) * (x.dim() - 2))
    return torch.where(valid, x, torch.full((), fill, dtype=x.dtype,
                                            device=x.device))


def conv_subsampled_length(lengths, left_padding: int = 2, stride: int = 2):
    """Output length of a valid strided conv (floor division, as the
    JAX package: a length of 0 maps to a negative one)."""
    return (lengths - left_padding - 1) // stride + 1


def subsampling4_length(lengths):
    """Length arithmetic of Conv2dSubsampling4 (two k=3 s=2 convs).
    Works on tensors and Python ints alike."""
    return conv_subsampled_length(conv_subsampled_length(lengths, 2, 2), 2, 2)


SUBSAMPLED_LENGTH = {"conv2d": subsampling4_length}
