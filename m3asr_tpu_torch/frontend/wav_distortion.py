"""Waveform amplitude-domain distortion augmentation.

Rebuilds loader/wav_distortion.py: the db/amplitude helpers and the
poly / quad / max / fence / jag / gain_db distortion family, applied at
sample level with a per-sample probability. Vectorized numpy instead of
the reference's per-sample python loop.

The port's numpy copy of ``m3asr_tpu/frontend/wav_distortion.py``.
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


def db2amp(db: float) -> float:
    return 10 ** (db / 20)


def amp2db(amp) -> np.ndarray:
    return 20 * np.log10(amp)


def make_poly_distortion(conf: dict) -> Callable[[np.ndarray], np.ndarray]:
    """db-domain polynomial distortion f(x) = a*x^m*(1-x)^n + x applied
    to the normalized db magnitude."""
    a, m, n = conf["a"], conf["m"], conf["n"]

    def fn(x: np.ndarray) -> np.ndarray:
        abs_x = np.abs(x)
        small = abs_x < 1e-6
        safe = np.where(small, 1.0, abs_x)
        db_norm = np.clip(amp2db(safe) / 100 + 1, 0.0, None)
        db_norm = np.clip(a * db_norm ** m * (1 - db_norm) ** n + db_norm,
                          None, 1.0)
        amp = np.minimum(10 ** ((db_norm - 1) * 100 / 20), 0.9997)
        out = np.sign(x) * amp
        return np.where(small, x, out)

    return fn


def make_quad_distortion() -> Callable:
    return make_poly_distortion({"a": 1, "m": 1, "n": 1})


def make_max_distortion(conf: dict) -> Callable:
    """All non-zero samples snap to +-max_amp."""
    max_amp = db2amp(conf["max_db"]) if conf.get("max_db") else 0.997

    def fn(x: np.ndarray) -> np.ndarray:
        return np.sign(x) * np.where(x == 0, 0.0, max_amp)

    return fn


def make_amp_mask(db_mask: Optional[Sequence[Tuple[float, float]]] = None
                  ) -> List[Tuple[float, float]]:
    if db_mask is None:
        db_mask = [(-110, -95), (-90, -80), (-65, -60), (-50, -30), (-15, 0)]
    return [(db2amp(lo), db2amp(hi)) for lo, hi in db_mask]


DEFAULT_MASK = make_amp_mask()


def generate_amp_mask(mask_num: int,
                      rng: Optional[random.Random] = None
                      ) -> List[Tuple[float, float]]:
    """Random db-domain mask slots in [-100db, 0db]."""
    rng = rng or random
    a = [0.0] * (2 * mask_num)
    for i in range(1, 2 * mask_num):
        a[i] = a[i - 1] + rng.uniform(0.5, 1)
    max_val = a[-1]
    m = [(((a[2 * i] - max_val) / max_val) * 100,
          ((a[2 * i + 1] - max_val) / max_val) * 100)
         for i in range(mask_num)]
    return make_amp_mask(m)


def _in_mask(abs_x: np.ndarray, mask: List[Tuple[float, float]]) -> np.ndarray:
    hit = np.zeros(abs_x.shape, bool)
    for lo, hi in mask:
        hit |= (abs_x >= lo) & (abs_x <= hi)
    return hit


def make_fence_distortion(conf: dict,
                          rng: Optional[random.Random] = None) -> Callable:
    """Samples inside mask slots snap to max_amp; others zero out."""
    mask_number = conf["mask_number"]
    max_amp = db2amp(conf["max_db"])
    if mask_number <= 0:
        pos, neg = DEFAULT_MASK, make_amp_mask([(-50, 0)])
    else:
        pos, neg = (generate_amp_mask(mask_number, rng),
                    generate_amp_mask(mask_number, rng))

    def fn(x: np.ndarray) -> np.ndarray:
        out = np.where(x > 0, np.where(_in_mask(x, pos), max_amp, 0.0),
                       np.where(x < 0,
                                np.where(_in_mask(np.abs(x), neg),
                                         max_amp, 0.0), x))
        return out

    return fn


def make_jag_distortion(conf: dict,
                        rng: Optional[random.Random] = None) -> Callable:
    """Samples inside mask slots pass through; others zero out."""
    mask_number = conf["mask_number"]
    if mask_number <= 0:
        pos, neg = DEFAULT_MASK, make_amp_mask([(-50, 0)])
    else:
        pos, neg = (generate_amp_mask(mask_number, rng),
                    generate_amp_mask(mask_number, rng))

    def fn(x: np.ndarray) -> np.ndarray:
        keep = np.where(x > 0, _in_mask(x, pos),
                        np.where(x < 0, _in_mask(np.abs(x), neg), True))
        return np.where(keep, x, 0.0)

    return fn


def make_gain_db(conf: dict) -> Callable:
    gain = 10 ** (conf["db"] / 20)

    def fn(x: np.ndarray) -> np.ndarray:
        return np.minimum(0.997, x * gain)

    return fn


def distort(x: np.ndarray, func: Callable, rate: float = 0.8,
            rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Apply `func` to each sample with probability `rate`.
    x: (1, n_samples) waveform."""
    rng = rng or np.random
    sel = rng.uniform(0, 1, x.shape) < rate
    return np.where(sel, func(x), x)


def distort_wav_conf(x: np.ndarray, distort_type: str, distort_conf,
                     rate: float = 0.1,
                     rng: Optional[np.random.RandomState] = None
                     ) -> np.ndarray:
    makers = {
        "gain_db": lambda: (make_gain_db(distort_conf), 0.8),
        "max_distortion": lambda: (make_max_distortion(distort_conf), rate),
        "fence_distortion": lambda: (make_fence_distortion(distort_conf),
                                     rate),
        "jag_distortion": lambda: (make_jag_distortion(distort_conf), rate),
        "poly_distortion": lambda: (make_poly_distortion(distort_conf),
                                    rate),
        "quad_distortion": lambda: (make_quad_distortion(), rate),
    }
    if distort_type == "none_distortion":
        return x
    if distort_type not in makers:
        raise ValueError(f"unsupported distortion type: {distort_type}")
    func, r = makers[distort_type]()
    return distort(x, func, rate=r, rng=rng)
