"""Seeded weights on the device, drawn by the benchmark itself.

A configuration's reference module gives the parameter tree as nested
dicts of ``(shape, init)`` leaves (``None`` for an absent one). Every drawn leaf is a view into one flat buffer in the served
dtype, ordered by its init so that each kind of leaf is one contiguous
run: the whole tree takes one ``uniform_`` call on a ``torch.Generator``
of the device, one scale-and-shift per kind, and one table per sinusoid
size. Program and reference read the same tensors.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.common import sinusoid


def _leaves(spec, path=()):
    if isinstance(spec, dict):
        for k, v in spec.items():
            yield from _leaves(v, path + (k,))
    elif spec is not None:
        yield path, spec


def _skeleton(spec):
    if isinstance(spec, dict):
        return {k: _skeleton(v) for k, v in spec.items()}
    return None


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def make(spec, seed: int, dtype: torch.dtype, device) -> dict:
    """The tree of ``spec`` drawn from ``seed`` on ``device`` in ``dtype``."""
    tree = _skeleton(spec)
    drawn = sorted(((init, path, shape) for path, (shape, init)
                    in _leaves(spec) if init[0] != "pe"),
                   key=lambda r: (r[0], str(r[1])))
    total = sum(math.prod(shape) for _, _, shape in drawn)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat.uniform_(-1.0, 1.0, generator=gen)
    off, run_start, run_init = 0, 0, None
    for init, path, shape in drawn + [(None, None, (0,))]:
        if init != run_init and run_init is not None:
            seg = flat[run_start:off]
            seg.mul_(run_init[-1])
            if run_init[0] == "c":
                seg.add_(run_init[1])
            run_start = off
        run_init = init
        if path is None:
            break
        n = math.prod(shape)
        _put(tree, path, flat[off:off + n].view(shape))
        off += n
    tables = {}
    for path, (shape, init) in _leaves(spec):
        if init[0] == "pe":
            d = init[1]
            if d not in tables:
                tables[d] = sinusoid(d, shape[0], device).to(dtype)
            _put(tree, path, tables[d])
    return tree
