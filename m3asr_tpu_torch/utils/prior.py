"""Class-prior handling for AM score debiasing (the port's copy of
``m3asr_tpu/utils/prior.py``): the prior file's first entry is dropped,
zero entries are smoothed to the smallest non-zero one, and the vector
is renormalised."""

from __future__ import annotations

import numpy as np


def read_prior(prior_file: str) -> np.ndarray:
    prior = np.loadtxt(prior_file)[1:]
    non_zero_min = prior[prior != 0].min()
    prior[prior == 0] = non_zero_min
    return prior / prior.sum()
