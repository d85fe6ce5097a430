"""Multi-process initialization and the global mesh (port of
``m3asr_tpu/parallel/distributed.py``).

The JAX package turns N processes into one JAX runtime. The port runs
one rank per process over ``torch.distributed``, launched as

    python -m torch.distributed.run --nproc-per-node N -m m3asr_tpu_torch.infer ...

Env contract (the JAX package's, which is torch.distributed's):
``COORDINATOR_ADDRESS`` (``host:port``, or an init method such as
``file:///path``), or ``MASTER_ADDR`` plus ``MASTER_PORT`` (default
8476); ``WORLD_SIZE``; ``RANK``. Without them :func:`initialize` does
nothing.

Backend: NCCL when every local rank has a card of its own, gloo when
ranks share a card or there is none. Gloo all-reduces and broadcasts
tensors on the card through host memory; NCCL refuses two ranks on one
device. Under NCCL each rank takes ``cuda:LOCAL_RANK`` as its current
device; under gloo every rank runs on the current device.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import numpy as np
import torch

from m3asr_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh

log = logging.getLogger("m3asr_tpu_torch")

DEFAULT_PORT = "8476"


def pick_backend(local_world_size: int) -> str:
    """``nccl`` when each of ``local_world_size`` ranks on this host has
    a card of its own, else ``gloo``."""
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = 600.0) -> bool:
    """``torch.distributed.init_process_group`` from the arguments or the
    env contract; returns whether a process group is up. A no-op (False)
    for a single process with no env set, and when a group already
    exists (True). ``timeout_s`` bounds the rendezvous and every
    collective."""
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        addr = os.environ.get("COORDINATOR_ADDRESS")
        if addr is None and os.environ.get("MASTER_ADDR"):
            addr = (os.environ["MASTER_ADDR"] + ":"
                    + os.environ.get("MASTER_PORT", DEFAULT_PORT))
        coordinator_address = addr
    if num_processes is None:
        n = os.environ.get("WORLD_SIZE")
        num_processes = int(n) if n else None
    if process_id is None:
        r = os.environ.get("RANK")
        process_id = int(r) if r else None
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "torch.distributed needs an address, a world size and a rank: "
            f"got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r} (COORDINATOR_ADDRESS or MASTER_ADDR/"
            "MASTER_PORT, WORLD_SIZE, RANK)")
    local_n = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    backend = backend or pick_backend(local_n)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id)))
    method = coordinator_address if "://" in coordinator_address \
        else "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    log.info("torch.distributed: rank %d of %d, backend %s (%d local ranks, "
             "%d cards)", process_id, num_processes, backend, local_n,
             torch.cuda.device_count() if torch.cuda.is_available() else 0)
    return True


def rank() -> int:
    """This process's rank (0 without a process group)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(ep: int = 1) -> Mesh:
    """(dp, ep) mesh over all ranks: ep innermost (consecutive ranks, as a
    host's cards), dp across the rest."""
    return make_mesh(dp=None, ep=ep)


def process_local_batch(mesh: Mesh, global_batch: int) -> int:
    """Per-process batch of a dp-split global batch."""
    import torch.distributed as dist
    dp = mesh.shape[DATA_AXIS]
    if global_batch % dp:
        raise ValueError(f"batch {global_batch} does not split over dp={dp}")
    procs = dist.get_world_size() if dist.is_initialized() else 1
    return global_batch // dp * max(dp // procs, 1)


def shard_host_batch(mesh: Mesh, batch):
    """This rank's dp slice of every leaf (leading batch axis) of a host
    batch (dict or list of arrays)."""
    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [cut(v) for v in x]
        n = x.shape[0] // mesh.shape[DATA_AXIS]
        c = mesh.coord(DATA_AXIS)
        part = x[c * n:(c + 1) * n]
        return part if torch.is_tensor(part) else np.asarray(part)
    return cut(batch)
