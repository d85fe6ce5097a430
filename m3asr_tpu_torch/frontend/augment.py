"""Spectrogram augmentation (training-time, host-side numpy).

Rebuilds loader/augment.py: spec_augmentation (time warp + time/freq
masks, arXiv 1904.08779), spec_substitute, and feature dither
(loader/ctc_aed_loader_domain_acc.py:38-62). The reference warps via
PIL BICUBIC resize (augment.py:32-77); we use torch's bicubic
interpolation (same kernel family) on the two segments.

The port's numpy copy of ``m3asr_tpu/frontend/augment.py``.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np


def spec_substitute(x: np.ndarray, max_t: int = 20, num_t_sub: int = 3,
                    rng: Optional[random.Random] = None) -> np.ndarray:
    """Replace `num_t_sub` random time spans with an earlier copy
    (augment.py _spec_substitute)."""
    rng = rng or random
    y = np.copy(x)
    max_frames = y.shape[0]
    for _ in range(num_t_sub):
        start = rng.randint(0, max_frames - 1)
        length = rng.randint(1, max_t)
        end = min(max_frames, start + length)
        pos = rng.randint(0, start) if start > 0 else 0
        y[start:end, :] = x[start - pos:end - pos, :]
    return y


def _bicubic_warp(x: np.ndarray, warp_point: int, shift: int) -> np.ndarray:
    """Warp time axis: stretch [0, warp_point] to [0, warp_point+shift],
    squeeze the rest — PIL-BICUBIC style via torch interpolate."""
    import torch
    import torch.nn.functional as F
    T, D = x.shape
    t = torch.from_numpy(x)[None, None]  # (1, 1, T, D)
    new_point = warp_point + shift
    if new_point <= 0 or new_point >= T:
        return x
    left = F.interpolate(t[:, :, :warp_point], size=(new_point, D),
                         mode="bicubic", align_corners=False)
    right = F.interpolate(t[:, :, warp_point:], size=(T - new_point, D),
                          mode="bicubic", align_corners=False)
    return torch.cat([left, right], dim=2)[0, 0].numpy()


def spec_augmentation(x: np.ndarray, warp_for_time: bool = False,
                      num_t_mask: int = 2, num_f_mask: int = 2,
                      max_t: int = 50, max_f: int = 10, max_w: int = 80,
                      rng: Optional[random.Random] = None) -> np.ndarray:
    """SpecAugment (augment.py _spec_augmentation): optional time warp,
    then `num_t_mask` time masks (width < max_t) and `num_f_mask`
    frequency masks (width < max_f), zero-filled."""
    rng = rng or random
    y = np.copy(x)
    max_frames, max_freq = y.shape
    if warp_for_time and max_frames > max_w * 2:
        center = rng.randrange(max_w, max_frames - max_w)
        warped = rng.randrange(center - max_w, center + max_w) + 1
        y = _bicubic_warp(y, center, warped - center)
    for _ in range(num_t_mask):
        start = rng.randint(0, max_frames - 1)
        length = rng.randint(1, max_t)
        end = min(max_frames, start + length)
        y[start:end, :] = 0
    for _ in range(num_f_mask):
        start = rng.randint(0, max_freq - 1)
        length = rng.randint(1, max_f)
        end = min(max_freq, start + length)
        y[:, start:end] = 0
    return y


def feature_dither(x: np.ndarray, dither: float,
                   rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Additive uniform dither (ctc_aed_loader_domain_acc.py:53-55)."""
    rng = rng or np.random
    a = rng.uniform(0, dither)
    return x + (rng.random_sample(x.shape) - 0.5) * a


class CollateFunc:
    """Per-utterance augmentation pipeline (CollateFunc,
    ctc_aed_loader_domain_acc.py:38-62): dither -> spec_sub -> spec_aug,
    training only."""

    def __init__(self, feature_dither: float = 0.0, spec_aug: bool = False,
                 spec_aug_conf: Optional[dict] = None,
                 spec_sub: bool = False,
                 spec_sub_conf: Optional[dict] = None):
        self.feature_dither = feature_dither
        self.spec_aug = spec_aug
        self.spec_aug_conf = spec_aug_conf or {}
        self.spec_sub = spec_sub
        self.spec_sub_conf = spec_sub_conf or {}

    def __call__(self, feat: np.ndarray, train_flag: bool) -> np.ndarray:
        if not train_flag:
            return feat
        if self.feature_dither != 0.0:
            feat = feature_dither(feat, self.feature_dither)
        if self.spec_sub:
            feat = spec_substitute(feat, **self.spec_sub_conf)
        if self.spec_aug:
            feat = spec_augmentation(feat, **self.spec_aug_conf)
        return feat
