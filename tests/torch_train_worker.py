"""One rank of a gloo world that runs the port's sharded training steps
for tests/test_torch_train_parallel.py (pytest does not collect this
file).

    COORDINATOR_ADDRESS=file:///tmp/x/store WORLD_SIZE=4 RANK=r \\
        python tests/torch_train_worker.py WORK_DIR

WORK_DIR holds ``cases_{world}.json`` (a list of cases), each model's
``{model}.json`` (its YAML dict) and ``{model}.npz`` (the JAX package's
flat parameter paths) and ``batch.npz``. For each ``step`` case rank 0
writes ``{case}.npz``: the loss and metrics, the whole gradient
gathered from the ranks' blocks (``grad/...``), the whole tree after
one update (``p1/...``) and, for cases of 3 steps, after the third
(``p3/...``); every rank writes ``meta_{world}_{rank}.json``: its moment
blocks' shapes, and the leaves whose blocks differ in bits between ranks
that hold the same block. Imports only torch and the port; one CPU
thread a rank.
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from m3asr_tpu_torch.checkpoint import (flatten_tree,  # noqa: E402
                                        params_from_jax, unflatten_tree)
from m3asr_tpu_torch.config import model_config_from_dict  # noqa: E402
from m3asr_tpu_torch.parallel import distributed  # noqa: E402
from m3asr_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from m3asr_tpu_torch.train import lr_scheduler as t_lr  # noqa: E402
from m3asr_tpu_torch.train import step as t_step  # noqa: E402
from m3asr_tpu_torch.train.bmuf import BmufRecipe, replica  # noqa: E402
from m3asr_tpu_torch.train.parallel import Parallel, split_axes  # noqa

TIMEOUT_S = 120.0        # rendezvous and every collective
SGD = ("constant", {}, 0.05, "sgd", {"momentum": 0.9})


def load_model(work, name):
    with open(os.path.join(work, f"{name}.json")) as f:
        cfg = model_config_from_dict(json.load(f))
    with np.load(os.path.join(work, f"{name}.npz")) as z:
        params = params_from_jax(unflatten_tree(dict(z)))
    return cfg, params


def split_mismatches(par, tree, specs):
    """Leaves whose bits differ between ranks holding the same block."""
    import torch.distributed as dist
    mesh = par.mesh
    mine = {}
    for k, v in flatten_tree(tree).items():
        block = tuple((a, mesh.coord(a)) for a in split_axes(specs[k]))
        digest = hashlib.sha1(v.detach().contiguous().numpy().tobytes())
        mine[k] = (block, digest.hexdigest())
    every = [None] * mesh.size
    dist.all_gather_object(every, mine)
    bad = set()
    for k in mine:
        seen = {}
        for r in every:
            block, h = r[k]
            if seen.setdefault(block, h) != h:
                bad.add(k)
    return sorted(bad)


def run_step_case(work, case, batch, out, meta):
    cfg, params = load_model(work, case["model"])
    hier = case.get("hier", False)
    mesh = make_mesh(**case["mesh"])
    par = Parallel(mesh, params, **case.get("par", {}))
    opt = t_lr.build_optimizer(*SGD, max_grad_norm=5.0)
    tk = case.get("tcfg", {})
    if hier:
        step = t_step.make_hier_train_step(
            cfg, t_step.HierTrainConfig(**tk), opt, with_domain_acc=True,
            device="cpu", mesh=par)
        args = [batch[k] for k in ("feat", "lens", "tg", "tl", "aed",
                                   "alens", "dom", "acc")]
    else:
        step = t_step.make_train_step(cfg, t_step.TrainConfig(**tk), opt,
                                      device="cpu", mesh=par)
        args = [batch[k] for k in ("feat", "lens", "tg", "tl")]
    kw = {}
    if case.get("generator"):
        kw["generator"] = torch.Generator().manual_seed(7)
    local = par.shard_params(params)
    state = par.init_opt_state(opt, local)
    metrics, grads, norm = step.value_and_grad(local, *args, **dict(kw))
    res = {"loss": metrics["loss"], "norm": norm}
    res.update({f"m/{k}": v for k, v in metrics.items()})
    res.update({f"grad/{k}": v for k, v in flatten_tree(
        par.gather(grads, par.param_specs)).items()})
    if case.get("port_ref"):
        # the port's one-rank step on the same batch and generator
        if kw:
            kw["generator"] = torch.Generator().manual_seed(7)
        (loss, _), g = t_step.value_and_grad(
            params, cfg, t_step.TrainConfig(**tk),
            *map(torch.as_tensor, args), **kw)
        res["ref_loss"] = loss
        res.update({f"ref_grad/{k}": v for k, v in g.items()})
    bad = []
    for i in range(case.get("steps", 1)):
        if kw:
            kw["generator"] = torch.Generator().manual_seed(7 + i)
        local, state, m = step(local, state, *args, **kw)
        bad += split_mismatches(par, local, par.param_specs)
        if i in (0, 2):
            res.update({f"p{i + 1}/{k}": v for k, v in flatten_tree(
                par.gather_params(local)).items()})
    out[case["name"]] = res
    trace = state.get("trace", {})
    meta[case["name"]] = {
        "moments": {k: list(v.shape) for k, v in trace.items()},
        "moment_dp": {k: "dp" in split_axes(par.moment_specs[k])
                      for k in trace},
        "mismatch": sorted(set(bad))}


def run_bmuf_case(work, case, out, meta):
    """BMUF on ranks: each dp rank steps its replica on its slice, a sync
    every ``sync_period`` steps; rank 0 gets the replicas' stacked
    tree."""
    cfg, params = load_model(work, case["model"])
    mesh = make_mesh(**case["mesh"])
    par = Parallel(mesh, params, bmuf=True)
    opt = t_lr.build_optimizer(*SGD, max_grad_norm=-1)
    step = t_step.make_train_step(cfg, t_step.TrainConfig(), opt,
                                  device="cpu", mesh=par)
    local = par.shard(params, par.param_specs)
    state = BmufRecipe.stack(t_step.init_opt_state(opt, local), 1)
    stacked = BmufRecipe.stack(local, 1)
    recipe = BmufRecipe(stacked, case["sync_period"],
                        block_momentum=case["block_momentum"],
                        block_lr=case["block_lr"], mesh=mesh)
    with np.load(os.path.join(work, "bmuf_batch.npz")) as z:
        b = {k: z[k] for k in z.files}
    r = mesh.coord("dp")
    losses = []
    for i in range(b["feat"].shape[0]):
        p, s, m = step(replica(stacked, 0), replica(state, 0),
                       *(b[k][i, r] for k in ("feat", "lens", "tg", "tl")))
        stacked = BmufRecipe.stack(p, 1)
        state = BmufRecipe.stack(s, 1)
        losses.append(float(m["loss"]))
        if (i + 1) % recipe.sync_period == 0:
            stacked, ok = recipe.sync(stacked)
            assert ok
    whole = par.gather_params(stacked)
    out[case["name"]] = {f"p/{k}": v for k, v in
                         flatten_tree(whole).items()}
    meta[case["name"]] = {"losses": losses}


def main():
    work = sys.argv[1]
    if not distributed.initialize(timeout_s=TIMEOUT_S):
        raise SystemExit("no torch.distributed env")
    import torch.distributed as dist
    n, rank = dist.get_world_size(), dist.get_rank()
    with open(os.path.join(work, f"cases_{n}.json")) as f:
        cases = json.load(f)
    with np.load(os.path.join(work, "batch.npz")) as z:
        batch = {k: z[k] for k in z.files}
    out, meta = {}, {}
    for case in cases:
        if case["kind"] == "step":
            run_step_case(work, case, batch, out, meta)
        elif case["kind"] == "bmuf":
            run_bmuf_case(work, case, out, meta)
        elif case["kind"] == "dryrun":
            from m3asr_tpu_torch.parallel.dryrun import dryrun_multichip
            meta[case["name"]] = dryrun_multichip(n, "cpu")
    if rank == 0:
        for name, res in out.items():
            np.savez(os.path.join(work, f"{name}.npz"), **{
                k: np.asarray(v.detach() if torch.is_tensor(v) else v)
                for k, v in res.items()})
    with open(os.path.join(work, f"meta_{n}_{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
