"""Acoustic feature frontend.

Rebuilds the reference loader's FeatureTransform
(loader/ctc_aed_loader_domain_acc.py:14-35: Kaldi delta features +
CMVN via pykaldi) and splice (loader/utils.py:3-28) without the Kaldi
dependency. The math follows Kaldi's delta-features and apply-cmvn
definitions; the incomplete reference cmvn_plugin
(incomplete_plugin/cmvn_plugin/cmvn_plugin.cu:17-34) computes the same
(x - mean) * inv_std.

Host-side numpy (the reference runs this on the data-loader thread);
`apply_cmvn` also accepts tensors.

The port's numpy copy of ``m3asr_tpu/frontend/features.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _delta_coeffs(order: int, window: int):
    """Kaldi DeltaFeatures coefficients: scales[0] = [1]; each next
    order convolves with the centered ramp [-w..w] scaled by
    1/(2*sum_{j=1..w} j^2)."""
    scales = [np.array([1.0], np.float64)]
    normalizer = 2.0 * sum(j * j for j in range(1, window + 1))
    ramp = np.arange(-window, window + 1, dtype=np.float64) / normalizer
    for _ in range(order):
        prev = scales[-1]
        cur = np.zeros(len(prev) + 2 * window, np.float64)
        for off, r in enumerate(ramp):
            cur[off:off + len(prev)] += r * prev
        scales.append(cur)
    return scales


def compute_deltas(feat: np.ndarray, order: int = 2,
                   window: int = 2) -> np.ndarray:
    """(T, D) -> (T, D*(1+order)), Kaldi edge handling (clamp frame
    indices at the boundaries)."""
    T, D = feat.shape
    scales = _delta_coeffs(order, window)
    outs = []
    idx = np.arange(T)
    for k, scale in enumerate(scales):
        half = (len(scale) - 1) // 2
        acc = np.zeros((T, D), np.float64)
        for off in range(-half, half + 1):
            c = scale[off + half]
            if c == 0.0:
                continue
            src = np.clip(idx + off, 0, T - 1)
            acc += c * feat[src]
        outs.append(acc)
    return np.concatenate(outs, axis=1).astype(np.float32)


def read_kaldi_cmvn(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read Kaldi CMVN stats (text matrix '[ sum... count ; sumsq... 0 ]'
    or a JSON {means, istds}) -> (mean, istd)."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:2] == b"\x00B":
        from m3asr_tpu_torch.io.kaldi_io import read_kaldi_matrix
        stats = read_kaldi_matrix(path)
    else:
        txt = open(path).read().strip()
        if txt.startswith("{"):
            import json
            d = json.loads(txt)
            return (np.asarray(d["means"], np.float64),
                    np.asarray(d["istds"], np.float64))
        txt = txt.lstrip("[").rstrip("]").strip()
        rows = [r.strip() for r in txt.splitlines() if r.strip()]
        stats = np.array([[float(x) for x in r.rstrip("]").split()]
                          for r in rows], np.float64)
    assert stats.shape[0] == 2, stats.shape
    count = stats[0, -1]
    mean = stats[0, :-1] / count
    var = stats[1, :-1] / count - mean ** 2
    istd = 1.0 / np.sqrt(np.maximum(var, 1e-20))
    return mean, istd


def apply_cmvn(feat, mean, istd, norm_vars: bool = True):
    """(x - mean) [* istd] — works for numpy arrays or tensors."""
    out = feat - mean.astype(feat.dtype)
    if norm_vars:
        out = out * istd.astype(feat.dtype)
    return out


def splice(feats: np.ndarray, lctx: int, rctx: int,
           pad: bool = True) -> np.ndarray:
    """Frame context splicing (loader/utils.py:3-28): concat
    [x_{t-lctx}, ..., x_t, ..., x_{t+rctx}] per frame, zero-padded."""
    frames, dim = feats.shape
    length = frames if pad else frames - lctx - rctx
    assert length > 0
    padding = feats
    if pad:
        padding = np.concatenate([np.zeros((lctx, dim), np.float32), feats,
                                  np.zeros((rctx, dim), np.float32)], axis=0)
    spliced = np.zeros((length, (lctx + 1 + rctx) * dim), np.float32)
    for i in range(lctx + 1 + rctx):
        spliced[:, i * dim:(i + 1) * dim] = padding[i:i + length]
    return spliced


class FeatureTransform:
    """deltas -> CMVN, matching FeatureTransform.transform
    (ctc_aed_loader_domain_acc.py:30-35)."""

    def __init__(self, feat_dim: int, order: int = 2, window: int = 2,
                 cmvn_file: Optional[str] = None,
                 lctx: int = 0, rctx: int = 0):
        self.feat_dim = feat_dim
        self.delta_order = max(0, order)
        self.delta_window = max(0, window)
        self.lctx, self.rctx = max(0, lctx), max(0, rctx)
        self.mean = self.istd = None
        if cmvn_file is not None:
            self.mean, self.istd = read_kaldi_cmvn(cmvn_file)
            assert self.mean.shape[0] == self.dim, \
                (self.mean.shape, self.dim)

    @property
    def dim(self) -> int:
        return (1 + self.delta_order) * self.feat_dim

    @property
    def input_dim(self) -> int:
        """Final model input dim incl. splicing (loader input_dim
        property: feat_dim*(1+deltas)*(1+lctx+rctx))."""
        return self.dim * (1 + self.lctx + self.rctx)

    def transform(self, feat: np.ndarray) -> np.ndarray:
        if self.delta_order > 0:
            feat = compute_deltas(feat, self.delta_order, self.delta_window)
        if self.mean is not None:
            feat = apply_cmvn(feat, self.mean, self.istd)
        if self.lctx > 0 or self.rctx > 0:
            feat = splice(feat, self.lctx, self.rctx)
        return np.asarray(feat, np.float32)
