"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the root of the
checkout names the cells; a configuration is ``configs/<config>.json``,
a mix ``mixes/<traffic>.json``, a cell's check limits
``limits/<workload>.json``, a per-layer metric's reader
``metrics/<metric>.py``, a family's reference ``reference/<family>.py``
and its model counts ``metrics/flops_<family>.py``, all under
``port_bench/``. Adding a cell adds files and entries; no file here
changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "configs", f"{name}.json"))


def mix(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "mixes", f"{name}.json"))


def limits(workload: str, bench_dir: str = BENCH_DIR) -> dict:
    """The cell's limits on the numbers ``harness/check.py`` compares."""
    return load_json(os.path.join(bench_dir, "limits",
                                  f"{workload}.json"))["limits"]


def reference(family: str):
    return importlib.import_module(f"port_bench.reference.{family}")


def _from_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counts(family: str, bench_dir: str = BENCH_DIR):
    return _from_file(os.path.join(bench_dir, "metrics",
                                   f"flops_{family}.py"), f"flops_{family}")


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """The per-layer metric's ``read(run)``."""
    return _from_file(os.path.join(bench_dir, "metrics", f"{metric}.py"),
                      "metric_" + metric.replace(".", "_")).read


def metrics_of(bench: dict, section: str, cell: str) -> list:
    """The entries of ``end_to_end`` or ``per_layer`` that cell reports:
    those that list it, and those with no list at all."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]
