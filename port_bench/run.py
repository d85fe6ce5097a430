"""Runs one cell of the port's benchmark once, on the card of this
machine:

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It makes the cell's weights and traffic
from the seed, builds the system under test (``m3asr_tpu_torch``),
warms up the shapes the traffic uses (set-up), drives the window, then
checks a sample of what the window served against the plain reference
(``port_bench/reference/``) and prints one JSON line: with ``--trace
0`` the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a ``torch.profiler`` trace of the window and the
harness's spans. The compared numbers and their limits end standard
error and the JSON line. ``--control 1`` also runs the control (the
reference in float8 in the program's place) and reports its verdict.

Exits non-zero, printing no result, without a card, with fewer cards
than the cell asks for, without the program beside it, or when JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches():
    """Every cache a run may fill, at fixed paths inside the checkout."""
    base = os.path.join(ROOT, "port_bench", ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)
    import torch
    from port_bench.harness import bench
    try:
        spec = bench.benchmark(ROOT)
        wl = bench.workload(spec, args.workload)
    except (OSError, KeyError) as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"FAIL: the cell needs {wl['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import m3asr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the program is not beside the benchmark: {e}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from port_bench.harness import runner
    try:
        out = runner.run(wl, args.seed, args.seconds, bool(args.trace),
                         "cuda", start=START, control=bool(args.control),
                         root=ROOT, spec=spec)
        found = runner.loaded_forbidden()
        if found:
            raise runner.ForbiddenImport(f"loaded {found}")
    except runner.ForbiddenImport as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 4
    for line in out["lines"]:
        print(line, file=sys.stderr)
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
