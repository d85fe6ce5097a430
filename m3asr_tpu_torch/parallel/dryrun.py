"""``dryrun_multichip(n)``: tiny training steps over every parallel axis
in an n-rank world, then a sharded serving forward (the counterpart of
the JAX package's ``__graft_entry__.py::dryrun_multichip``).

Run it on every rank of an initialized world (``python -m
torch.distributed.run --nproc-per-node 4 -m m3asr_tpu_torch.parallel.dryrun
[--device cpu]``). Four steps on one global batch and one seeded tree:
(dp, ep, tp), (dp, sp, ep) with ZeRO-1, (pp, dp, ep) GPipe, (dp, ep)
with FSDP; their losses must agree (within 1e-3, the JAX dryrun's
bound). Then an ep x tp ``Engine`` forward equals the one-rank engine's
within 1e-4.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

NUM_EXPERTS = 8


def _raw() -> dict:
    return {"nnet_proto": "conformer_fmoe_localComm_catEmbed", "input_dim": 20, "output_dim": 31,
            "model_conf": {"encoder_conf": {
                "attention_dim": 32, "attention_heads": 4, "num_blocks": 2,
                "embed_conf": {"attention_dim": 32, "attention_heads": 4,
                               "linear_units": 32, "num_blocks": 1},
                "moe_conf": {"num_experts": NUM_EXPERTS,
                             "hidden_units": 64}}}}


def _params(cfg, device, seed: int = 0):
    """The tiny model's seeded tree, routers drawn normal x 0.5 so that
    tokens spread over the experts."""
    from m3asr_tpu_torch.checkpoint import flatten_tree, unflatten_tree
    from m3asr_tpu_torch.models.registry import get_family
    tree = get_family(cfg.nnet_proto).init(
        cfg, torch.Generator(device=device).manual_seed(seed))
    g = torch.Generator(device=device).manual_seed(seed + 1)
    flat = flatten_tree(tree)
    for k, v in flat.items():
        if "router" in k:
            flat[k] = 0.5 * torch.randn(v.shape, generator=g,
                                        device=device)
    return unflatten_tree(flat)


def _axes(n: int) -> Dict[str, dict]:
    """The four meshes' axis sizes for n ranks (the JAX dryrun's
    choice)."""
    tp = 2 if n % 2 == 0 else 1
    ep = next(d for d in (4, 2, 1)
              if (n // tp) % d == 0 and NUM_EXPERTS % d == 0)
    while ep > 1 and n // (tp * ep) < 2:
        ep //= 2
    sp = 2 if (n // tp) % 2 == 0 else 1
    ep2 = next(d for d in (4, 2, 1)
               if (n // sp) % d == 0 and NUM_EXPERTS % d == 0)
    while ep2 > 1 and n // (sp * ep2) < 2:
        ep2 //= 2
    cases = {"dp_ep_tp": dict(mesh=dict(dp=n // (ep * tp), ep=ep, tp=tp),
                              tp=tp > 1),
             "dp_sp_ep_zero1": dict(mesh=dict(dp=n // (ep2 * sp), sp=sp,
                                              ep=ep2), zero1=True)}
    if n % 2 == 0:
        ep3 = next(d for d in (2, 1)
                   if (n // 2) % d == 0 and NUM_EXPERTS % d == 0)
        cases["pp_dp_ep"] = dict(mesh=dict(pp=2, dp=n // (2 * ep3),
                                           ep=ep3), pp=True)
    cases["dp_ep_fsdp"] = dict(mesh=dict(dp=n // ep, ep=ep), fsdp=True)
    return cases


def dryrun_multichip(n: int, device: Optional[str] = None) -> dict:
    """The four steps and the serving check in this n-rank world; returns
    {case: (loss, grad_norm)} and the serving error."""
    import torch.distributed as dist

    from m3asr_tpu_torch.config import model_config_from_dict
    from m3asr_tpu_torch.device import resolve_device
    from m3asr_tpu_torch.parallel.mesh import make_mesh
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig
    from m3asr_tpu_torch.train.parallel import Parallel
    from m3asr_tpu_torch.train.step import (TrainConfig, make_optimizer,
                                            make_train_step)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"dryrun_multichip({n}) runs in a world of {n} "
                           "ranks: python -m torch.distributed.run "
                           f"--nproc-per-node {n} -m "
                           "m3asr_tpu_torch.parallel.dryrun")
    dev = resolve_device(device)
    rank0 = dist.get_rank() == 0
    cfg = model_config_from_dict(_raw())
    params0 = _params(cfg, dev)
    tcfg = TrainConfig(warmup_steps=10)
    optimizer = make_optimizer(tcfg)
    B = max(4, n)
    rng = np.random.RandomState(0)
    batch = (rng.randn(B, 40, 20).astype(np.float32),
             np.full(B, 40, np.int32),
             rng.randint(1, 31, (B, 6)).astype(np.int32),
             np.full(B, 6, np.int32))
    out = {}
    for name, c in _axes(n).items():
        mesh = make_mesh(**c["mesh"])
        par = Parallel(mesh, params0, tp=c.get("tp", False),
                       pp=c.get("pp", False), zero1=c.get("zero1", False),
                       fsdp=c.get("fsdp", False), zero_min_size=64)
        params = par.shard_params(params0)
        step = make_train_step(cfg, tcfg, optimizer, device=dev, mesh=par)
        _, _, m = step(params, par.init_opt_state(optimizer, params),
                       *batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        if not np.isfinite(loss):
            raise AssertionError(f"{name}: non-finite loss {loss}")
        out[name] = (loss, gn)
        if rank0:
            print(f"dryrun_multichip {name} OK: {mesh!r}, loss={loss:.4f}, "
                  f"grad_norm={gn:.4f}", flush=True)
    losses = [v[0] for v in out.values()]
    if max(losses) - min(losses) >= 1e-3:
        raise AssertionError(f"the shardings' losses disagree: {out}")
    if rank0:
        print(f"dryrun_multichip OK: dp/ep/tp/sp/pp/fsdp shardings agree, "
              f"loss={losses[0]:.4f}", flush=True)

    # serving: an ep x tp engine over the whole world against one rank's
    tp = 2 if n % 2 == 0 and n > 2 else 1
    ep = n // tp
    # the dense expert stage on both sides (the sharded engine's mesh
    # policy; the tiny widths are below the kernels' 64-wide tiles)
    ecfg = dict(bucket_lengths=(40,), bucket_batches=(2,), moe_impl="dense")
    feat, feat_len = batch[0][:2], batch[1][:2]
    single = Engine(cfg, params0, EngineConfig(**ecfg), device=dev,
                    cuda_graphs=False).infer(feat, feat_len)[0]
    got = Engine(cfg, params0, EngineConfig(ep=ep, tp=tp, **ecfg),
                 device=dev).infer(feat, feat_len)[0]
    err = float(np.abs(np.asarray(got) - np.asarray(single)).max())
    if not np.allclose(got, single, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"ep{ep} x tp{tp} engine differs from one "
                             f"rank's by {err:.3e}")
    if rank0:
        print(f"dryrun_multichip serving OK: ep={ep} tp={tp} engine "
              f"forward == one rank's (maxerr {err:.2e})", flush=True)
    out["serving_err"] = err
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    from m3asr_tpu_torch.parallel import distributed
    if not distributed.initialize():
        raise SystemExit("run under python -m torch.distributed.run "
                         "--nproc-per-node N")
    import torch.distributed as dist
    dryrun_multichip(dist.get_world_size(), args.device)


if __name__ == "__main__":
    main()
