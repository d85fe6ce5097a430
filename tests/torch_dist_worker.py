"""One rank of a gloo world that runs the port's ep/tp-sharded engines
for tests/test_torch_engine_ep.py (pytest does not collect this file).

    COORDINATOR_ADDRESS=file:///tmp/x/store WORLD_SIZE=4 RANK=r \\
        python tests/torch_dist_worker.py WORK_DIR

WORK_DIR holds ``cases_{world}.json`` (a list of cases), the models'
``{model}.yaml`` / ``{model}.npz`` (the JAX package's flat parameter
paths), ``feat.npy`` / ``lens.npy`` and, for the expert-parallel FFN
cases, ``ffn.npz``. Each rank writes ``out_{world}_{rank}.npz`` (every
case's outputs) and ``meta_{world}_{rank}.json`` (settings the engines
settled on, the warnings they logged, what the infer CLI printed).
Imports only torch and the port; one CPU thread a rank.
"""

import contextlib
import io
import json
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402

torch.set_num_threads(1)

from m3asr_tpu_torch import infer  # noqa: E402
from m3asr_tpu_torch.checkpoint import (params_from_jax,  # noqa: E402
                                        unflatten_tree)
from m3asr_tpu_torch.config import model_config_from_dict  # noqa: E402
from m3asr_tpu_torch.parallel import distributed  # noqa: E402
from m3asr_tpu_torch.parallel import ep as pep  # noqa: E402
from m3asr_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig  # noqa: E402

BUCKET = dict(bucket_lengths=(48,), bucket_batches=(2,))
TIMEOUT_S = 120.0        # rendezvous and every collective


class Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def load_model(work, name):
    with open(os.path.join(work, f"{name}.yaml")) as f:
        cfg = model_config_from_dict(yaml.safe_load(f))
    with np.load(os.path.join(work, f"{name}.npz")) as z:
        params = params_from_jax(unflatten_tree(dict(z)))
    return cfg, params


def run_case(work, case, feat, lens, out, meta):
    import torch.distributed as dist
    name, kind = case["name"], case["kind"]
    warned = Warnings()
    logging.getLogger("m3asr_tpu_torch").addHandler(warned)
    try:
        if kind == "ffn":
            with np.load(os.path.join(work, "ffn.npz")) as z:
                a = {k: torch.from_numpy(z[k]) for k in z.files}
            p = {k: a[k] for k in ("w1", "b1", "w2", "b2")}
            p["router"] = {"kernel": a["router"]}
            mesh = pmesh.make_mesh(dp=1, ep=dist.get_world_size())
            local = pmesh.shard_tree(p, pmesh.moe_param_sharding(mesh, p),
                                     mesh)
            ffn = pep.make_ep_moe_ffn(mesh, p["w1"].shape[0],
                                      impl=case["impl"])
            out[name] = ffn(local, a["x"], a["embed"], a["lengths"]).numpy()
            return
        if kind == "cli":
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                infer.main(["-p", os.path.join(work, case["engine"]), "-i",
                            os.path.join(work, "feat1.npy"), "-o",
                            os.path.join(work, case["ref"]), "--device",
                            "cpu"])
            meta[name] = {"stdout": buf.getvalue()}
            return
        cfg, params = load_model(work, case["model"])
        eng = Engine(cfg, params, EngineConfig(**case["settings"], **BUCKET),
                     device="cpu")
        out[name] = eng.infer(feat, lens)[0]
        meta[name] = {"attn_impl": eng.cfg.attn_impl,
                      "impl": eng.moe_impl_for(*BUCKET["bucket_batches"],
                                               *BUCKET["bucket_lengths"]),
                      "local_w1": {k: list(v.shape) for k, v in
                                   eng.params["blocks"]["feed_forward"]
                                   .items() if k.startswith("w1")}}
        if kind == "roundtrip":
            d = os.path.join(work, name)
            eng.save(d)
            dist.barrier()
            loaded = Engine.load(d, device="cpu")
            out[name + "__loaded"] = loaded.infer(feat, lens)[0]
            meta[name]["loaded_leaves"] = sorted(
                loaded.params["blocks"]["feed_forward"])
    finally:
        logging.getLogger("m3asr_tpu_torch").removeHandler(warned)
        meta.setdefault(name, {})["warnings"] = warned.messages


def main():
    work = sys.argv[1]
    if not distributed.initialize(timeout_s=TIMEOUT_S):
        raise SystemExit("no torch.distributed env")
    import torch.distributed as dist
    n, rank = dist.get_world_size(), dist.get_rank()
    with open(os.path.join(work, f"cases_{n}.json")) as f:
        cases = json.load(f)
    feat = np.load(os.path.join(work, "feat.npy"))
    lens = np.load(os.path.join(work, "lens.npy"))
    out, meta = {}, {}
    for case in cases:
        run_case(work, case, feat, lens, out, meta)
    np.savez(os.path.join(work, f"out_{n}_{rank}.npz"), **out)
    with open(os.path.join(work, f"meta_{n}_{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
