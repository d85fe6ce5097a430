"""The sharded training step over torch.distributed (the port of the
parallel half of the root ``train.py`` and ``m3asr_tpu/train/step.py``
under a mesh: dp/ep/tp/sp/pp, ZeRO-1, FSDP, BMUF replicas on ranks).

Each rank holds its shard of the parameter and optimizer trees as plain
tensors (:class:`Parallel` builds the layouts from the JAX package's
rules: ``param_sharding`` with tp/pp, ``zero_sharding``), every rank
loads the same global batch and takes its dp slice, and the forward
issues the collectives GSPMD would insert (``parallel/collectives``).
A sharded step gives the one-rank step's loss, gradient of every leaf
and updated tree on the same global batch:

* each microbatch of the global batch (``accum_steps``) is augmented
  whole (SpecAugment's masks from the step's generator) and then cut
  over dp; its means divide by the global counts
  (``losses.global_batch``), so the ranks' losses add up to the
  one-rank loss;
* under sp and pp every rank of a line computes the same loss on the
  gathered output, and backpropagates its 1/(sp*pp) share;
* a leaf's gradient is summed over the pp, dp and sp ranks that hold the
  same block of it (their gradients are partial) and averaged over the
  ep and tp ranks that do (each already holds the whole gradient, as
  Megatron's layers give it), in one float32 all-reduce per set of axes,
  so that every rank of the set holds the same bits;
* the clipping norm counts each element once: the sums of squares are
  added over the axes a leaf is split on;
* ZeRO-1: the moments take ``zero_sharding``'s extra dp split; a rank
  updates its slice of such a leaf and the slices are gathered back.
  FSDP: the parameters take it too, and are gathered where they are
  used (``parallel/fsdp.py``);
* BMUF (``bmuf=True``): a dp rank is one replica stepping on its own
  slice with local normalization; nothing is reduced over dp.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from m3asr_tpu_torch.checkpoint import flatten_tree, unflatten_tree
from m3asr_tpu_torch.parallel import collectives, fsdp
from m3asr_tpu_torch.parallel import mesh as pmesh
from m3asr_tpu_torch.parallel.distributed import shard_host_batch
from m3asr_tpu_torch.parallel.mesh import (DATA_AXIS, PIPE_AXIS, SEQ_AXIS,
                                           Mesh)
from m3asr_tpu_torch.train import losses

# a replicated leaf's gradient is partial over these axes (summed) and
# whole over the others (averaged)
PARTIAL_AXES = (PIPE_AXIS, DATA_AXIS, SEQ_AXIS)


def _flat_specs(tree, specs) -> Dict[str, tuple]:
    """{path: layout} of ``tree``'s leaves, as ``flatten_tree`` names
    them."""
    out = {}

    def walk(node, spec, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, spec[k], f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, spec[i], f"{prefix}{i}/")
        elif node is not None:
            out[prefix[:-1]] = tuple(spec)
    walk(tree, specs, "")
    return out


def split_axes(spec) -> tuple:
    """The mesh axes a layout splits a leaf over."""
    return tuple(a for axes in spec if axes is not None
                 for a in pmesh._axes(axes))


def local_shape(mesh: Mesh, shape, spec) -> tuple:
    """The shape of a rank's block of a leaf of ``shape`` under
    ``spec``."""
    return tuple(d // (mesh.axis_size(spec[i]) if i < len(spec)
                       and spec[i] is not None else 1)
                 for i, d in enumerate(shape))


@dataclasses.dataclass
class Parallel:
    """The layouts of one sharded training run over ``mesh``, built from
    the whole parameter tree (every rank builds the same):
    ``param_specs`` / ``moment_specs`` ({path: layout}) of the
    parameters and of the optimizer moments. ``tp``/``pp`` split the
    main blocks as ``param_sharding`` says; ``zero1`` gives the moments
    ``zero_sharding``'s dp split, ``fsdp`` the parameters too; ``bmuf``
    makes each dp rank an independent replica. Creates the process
    groups the step reduces over (collective)."""

    mesh: Mesh
    params: dataclasses.InitVar[object]
    tp: bool = False
    pp: bool = False
    zero1: bool = False
    fsdp: bool = False
    bmuf: bool = False
    pp_microbatches: int = 2
    zero_min_size: int = 2048

    def __post_init__(self, params):
        mesh = self.mesh
        base = pmesh.param_sharding(mesh, params, tp=self.tp, pp=self.pp)
        zero = pmesh.zero_sharding(mesh, params, base,
                                   min_size=self.zero_min_size)
        self.param_tree_specs = zero if self.fsdp else base
        self.param_specs = _flat_specs(params, self.param_tree_specs)
        self.moment_specs = _flat_specs(
            params, zero if (self.zero1 or self.fsdp) else base)
        self.shapes = {k: tuple(v.shape)
                       for k, v in flatten_tree(params).items()}
        # the main blocks' layout tree (FSDP gathers them layer by layer)
        enc = self.param_tree_specs.get("encoder", self.param_tree_specs)
        blocks = enc.get("blocks")
        self.block_specs = blocks if isinstance(blocks, dict) else None
        reduce_sets = {self.reduce_axes(s)[0] for s in
                       self.param_specs.values()}
        split_sets = {split_axes(s) for s in self.param_specs.values()}
        split_sets |= {split_axes(s) for s in self.moment_specs.values()}
        mesh.add_groups(sorted(reduce_sets | split_sets))

    # -- layouts ---------------------------------------------------------
    def reduce_axes(self, spec):
        """(axes a gradient laid out as ``spec`` is reduced over, the
        scale after the sum)."""
        split = set(split_axes(spec))
        partial = [a for a in PARTIAL_AXES if not (self.bmuf and a ==
                                                   DATA_AXIS)]
        axes = tuple(a for a in pmesh.AXES if a not in split
                     and self.mesh.shape[a] > 1
                     and (a in partial or a not in PARTIAL_AXES))
        whole = [self.mesh.shape[a] for a in axes if a not in PARTIAL_AXES]
        return axes, 1.0 / math.prod(whole)

    def zero_axis(self, name: str) -> int:
        """The dim over which a rank updates only its dp slice of leaf
        ``name`` (ZeRO-1 without FSDP), or -1."""
        p, m = self.param_specs[name], self.moment_specs[name]
        if fsdp.dp_axis(p) >= 0:
            return -1
        return fsdp.dp_axis(m)

    def shard(self, tree, specs: Dict[str, tuple]):
        """This rank's blocks of a tree (numpy arrays or tensors) whose
        leaves ``specs`` lays out by path."""
        flat = flatten_tree(tree)
        out = {}
        for k, v in flat.items():
            idx = pmesh._slices(self.mesh, tuple(v.shape), specs[k])
            block = v[idx]
            out[k] = block.contiguous() if torch.is_tensor(block) \
                else block.copy()
        return unflatten_tree(out)

    def gather(self, tree, specs: Dict[str, tuple]):
        """The whole tree, on the CPU, from every rank's blocks
        (collective)."""
        flat = flatten_tree(tree)
        return unflatten_tree(flatten_tree(pmesh.gather_tree(
            flat, {k: specs[k] for k in flat}, self.mesh)))

    def _run_specs(self, specs):
        """The layouts of the Trainer's trees: in BMUF mode they carry a
        leading replica axis, split over dp (``bmuf_stacked_sharding``)."""
        if not self.bmuf:
            return specs
        return {k: (DATA_AXIS,) + tuple(v) for k, v in specs.items()}

    def shard_params(self, tree):
        """This rank's blocks of the run's whole parameter tree (in BMUF
        mode the replicas' stacked tree)."""
        return self.shard(tree, self._run_specs(self.param_specs))

    def gather_params(self, tree):
        return self.gather(tree, self._run_specs(self.param_specs))

    def shard_opt_state(self, state):
        """The optimizer state's moments cut to this rank's blocks."""
        specs = self._run_specs(self.moment_specs)
        return {k: (flatten_tree(self.shard(v, specs))
                    if isinstance(v, dict) else v)
                for k, v in state.items()}

    def gather_opt_state(self, state):
        specs = self._run_specs(self.moment_specs)
        return {k: (flatten_tree(self.gather(v, specs))
                    if isinstance(v, dict) else v)
                for k, v in state.items()}

    def init_opt_state(self, optimizer, params):
        """The optimizer state of this rank's parameters, its moments in
        ``moment_specs``' blocks."""
        flat = {k: v for k, v in flatten_tree(params).items()
                if v.is_floating_point()}
        return optimizer.init({k: v.new_zeros(local_shape(
            self.mesh, self.shapes[k], self.moment_specs[k]))
            for k, v in flat.items()})

    # -- the step's pieces -------------------------------------------------
    def gather_unblocked(self, tree):
        """FSDP: every dp-split leaf outside the main block stack, whole
        (differentiably); the blocks stay split (``fsdp.gathering``)."""
        flat = flatten_tree(tree)
        blocks = set()
        if self.block_specs is not None:
            prefix = "encoder/blocks/" if "encoder" in tree else "blocks/"
            blocks = {k for k in flat if k.startswith(prefix)}
        return unflatten_tree({
            k: v if k in blocks else fsdp.gather_leaf(
                self.mesh, v, self.param_specs[k]) for k, v in flat.items()})

    def reduce_grads(self, grads: Dict[str, torch.Tensor]):
        """Every gradient summed / averaged over the ranks holding the same
        block (:meth:`reduce_axes`), in one float32 all-reduce per set of
        axes; returns a new dict."""
        groups: Dict[tuple, list] = {}
        for k in grads:
            groups.setdefault(self.reduce_axes(self.param_specs[k]),
                              []).append(k)
        out = dict(grads)
        for (axes, scale), names in sorted(groups.items()):
            if not axes:
                continue
            buf = torch.cat([grads[k].reshape(-1).float() for k in names])
            buf = self.mesh.all_reduce(buf, axes)
            if scale != 1.0:
                buf.mul_(scale)
            for k, part in zip(names, buf.split(
                    [grads[k].numel() for k in names])):
                out[k] = part.reshape(grads[k].shape).to(grads[k].dtype)
        return out

    def global_norm(self, grads: Dict[str, torch.Tensor],
                    specs: Dict[str, tuple]) -> torch.Tensor:
        """The norm of the whole gradient from each rank's blocks: each
        leaf's sum of squares added over the axes it is split on."""
        sums: Dict[tuple, torch.Tensor] = {}
        for k, g in grads.items():
            axes = split_axes(specs[k])
            s = g.float().square().sum()
            sums[axes] = s if axes not in sums else sums[axes] + s
        total = None
        for axes in sorted(sums):
            s = self.mesh.all_reduce(sums[axes], axes) if axes \
                else sums[axes]
            total = s if total is None else total + s
        return torch.sqrt(total)


def dp_rows(mesh: Mesh, batch):
    """This rank's dp slice of a batch tuple (None entries kept)."""
    B, dp = batch[0].shape[0], mesh.shape[DATA_AXIS]
    if B % dp:
        raise ValueError(f"a (micro)batch of {B} rows does not split over "
                         f"dp={dp}")
    return tuple(None if a is None else shard_host_batch(mesh, a)
                 for a in batch)


def make_sharded_step(par: Parallel, tcfg, optimizer, device,
                      loss_call: Callable, augment: Callable):
    """run(params, opt_state, batch, generator) -> (params, opt_state,
    metrics): the sharded counterpart of ``step._step_runner``'s run on
    this rank's blocks. ``batch`` is the global batch (tuple of arrays,
    None entries allowed; with ``par.bmuf`` this replica's slice);
    ``augment(feat, feat_len, generator)`` applies SpecAugment to a
    global microbatch's features; ``loss_call(tree, mb, generator)`` is
    the step's (loss, metrics) on this rank's rows of a microbatch."""
    from m3asr_tpu_torch.train.step import step_checks
    mesh = par.mesh
    dev, check = step_checks(tcfg, device)
    A = tcfg.accum_steps
    # the sp and pp ranks of a line compute the same loss: each
    # backpropagates its share
    share = 1.0 / (mesh.shape[SEQ_AXIS] * mesh.shape[PIPE_AXIS])

    def value_and_grad(params, batch, generator):
        flat = flatten_tree(params)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in flat.items() if v.is_floating_point()}
        names = list(leaves)
        B = batch[0].shape[0]
        if B % A:
            raise ValueError(f"batch {B} not divisible by accum_steps {A}")
        n = B // A
        loss = metrics = grads = None
        for i in range(A):
            mb = tuple(None if a is None else a[i * n:(i + 1) * n]
                       for a in batch)
            feat = augment(mb[0], mb[1], generator)
            mb = (feat,) + mb[1:]
            if not par.bmuf:
                mb = dp_rows(mesh, mb)
            tree = unflatten_tree({**flat, **leaves})
            gather_ctx = fsdp.gathering(mesh, par.block_specs) \
                if par.fsdp else contextlib.nullcontext()
            with pmesh.sharded(mesh), gather_ctx, losses.global_batch(
                    None if par.bmuf else mesh):
                if par.fsdp:
                    tree = par.gather_unblocked(tree)
                l_i, m_i = loss_call(tree, mb, generator)
                got = torch.autograd.grad(l_i * share,
                                          [leaves[k] for k in names],
                                          allow_unused=True)
            g_i = {k: torch.zeros_like(leaves[k]) if g is None else g
                   for k, g in zip(names, got)}
            l_i = l_i.detach()
            m_i = {k: v.detach() for k, v in m_i.items()}
            if loss is None:
                loss, metrics, grads = l_i, m_i, g_i
                continue
            loss = loss + l_i
            metrics = {k: metrics[k] + m_i[k] for k in metrics}
            for k, g in g_i.items():
                grads[k].add_(g)
        if A > 1:
            inv = 1.0 / A
            loss = loss * inv
            metrics = {k: v * inv for k, v in metrics.items()}
            grads = {k: g.mul_(inv) for k, g in grads.items()}
        return loss, metrics, grads

    def reduced(params, batch, generator):
        """(metrics, this rank's blocks of the whole gradient, its norm)."""
        check(params)
        batch = tuple(None if a is None else torch.as_tensor(a, device=dev)
                      for a in batch)
        _, metrics, grads = value_and_grad(params, batch, generator)
        if not par.bmuf and mesh.shape[DATA_AXIS] > 1:
            names = sorted(metrics)
            vals = mesh.all_reduce(torch.stack(
                [metrics[k].float() for k in names]), DATA_AXIS)
            metrics = dict(zip(names, vals.unbind(0)))
        grads = par.reduce_grads(grads)
        return metrics, grads, par.global_norm(grads, par.param_specs)

    def apply(params, opt_state, metrics, grads, norm):
        """The update of :func:`reduced`'s gradient: (params, opt_state,
        metrics)."""
        flat = flatten_tree(params)
        cur, g_upd = {}, {}
        for k in grads:
            a = par.zero_axis(k)
            if a < 0:
                cur[k], g_upd[k] = flat[k], grads[k]
            else:
                # this rank's dp slice of its block
                n = mesh.shape[DATA_AXIS]
                cur[k], g_upd[k] = (t.chunk(n, dim=a)[mesh.coord(DATA_AXIS)]
                                    for t in (flat[k], grads[k]))
        updates, opt_state = optimizer.update(g_upd, opt_state, cur,
                                              norm=norm)
        new = optimizer.apply_updates(cur, updates)
        for k in grads:
            a = par.zero_axis(k)
            flat[k] = new[k] if a < 0 else collectives.all_gather(
                mesh, new[k], DATA_AXIS, a)
        metrics["grad_norm"] = norm
        return unflatten_tree(flat), opt_state, metrics

    def run(params, opt_state, batch, generator):
        return apply(params, opt_state, *reduced(params, batch, generator))

    run.value_and_grad, run.apply = reduced, apply
    return run
