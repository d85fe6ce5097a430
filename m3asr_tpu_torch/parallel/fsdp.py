"""FSDP's parameter gathers (the port of the JAX CLI's ``--fsdp``, whose
master parameters take ``zero_sharding``'s extra "dp" split and which
XLA all-gathers at their use sites).

A dp-split leaf exists whole only while it is used: a leaf of the main
block stack one layer at a time (:func:`layer_view` and
:func:`num_layers`, inside :func:`gathering`), any other leaf once per
step (:func:`gather_leaf`).
Both are differentiable: the whole layer's cotangent is summed over dp
and this rank keeps its slice, so each rank's gradient comes out in the
leaf's split layout, already summed over dp.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from m3asr_tpu_torch.parallel import collectives
from m3asr_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, active_mesh

_STATE = threading.local()


def dp_axis(spec) -> int:
    """The dimension a layout splits over "dp", or -1."""
    for i, axes in enumerate(spec):
        if axes == DATA_AXIS or (isinstance(axes, tuple)
                                 and DATA_AXIS in axes):
            return i
    return -1


def gather_leaf(mesh: Mesh, leaf: torch.Tensor, spec) -> torch.Tensor:
    """The whole of a leaf split over "dp" by ``spec`` (the leaf itself
    when it is not)."""
    a = dp_axis(spec)
    return leaf if a < 0 else collectives.gather(mesh, leaf, DATA_AXIS, a)


def _layer(mesh: Mesh, leaf: torch.Tensor, spec, i: int) -> torch.Tensor:
    a = dp_axis(spec)
    if a < 0:
        return leaf[i]
    if a > 0:
        return collectives.gather(mesh, leaf[i], DATA_AXIS, a - 1)
    # the layer axis itself is split: layer i lies on one dp rank, which
    # gives it to the others (an all-reduce of it and of zeros); the
    # summed cotangent reaches it alone
    per = leaf.shape[0]
    mine = mesh.coord(DATA_AXIS) == i // per
    row = leaf[i % per]
    return collectives.all_sum(mesh, row if mine else row * 0, DATA_AXIS)


@contextlib.contextmanager
def gathering(mesh: Mesh, block_specs):
    """While active (in this thread), :func:`layer_view` gathers each
    layer of a block stack laid out as ``block_specs`` (the main blocks'
    layout tree), wherever a mesh is active."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (mesh, block_specs)
    try:
        yield
    finally:
        _STATE.ctx = prev


def num_layers(tree, count) -> int:
    """The layer count of a stacked block tree: ``count(tree)`` (its
    first leaf's leading size) unless :func:`gathering` is active under a
    mesh and that leaf's layer axis is split over dp."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None or active_mesh() is None:
        return count(tree)
    mesh, spec = ctx
    node = tree
    while isinstance(node, dict):
        k = next(iter(node))
        node, spec = node[k], spec[k]
    n = node.shape[0]
    return n * mesh.shape[DATA_AXIS] if dp_axis(spec) == 0 else n


def layer_view(tree, i: int, view):
    """Layer i of a stacked block tree: ``view(tree, i)`` (plain
    indexing) unless :func:`gathering` is active under a mesh, where
    each dp-split leaf's layer is gathered."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None or active_mesh() is None:
        return view(tree, i)
    mesh, specs = ctx

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return _layer(mesh, node, spec, i)
    return walk(tree, specs)
