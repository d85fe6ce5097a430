"""The runner's guards, and the extension of the benchmark by files
alone."""

import json
import os
import shutil
import subprocess
import sys
import types


from port_bench.harness import bench, runner

ROOT = bench.ROOT


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    assert "m3asr_tpu_torch" not in runner.loaded_forbidden()
    for name in ("jax.numpy", "m3asr_tpu.ops", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert runner.loaded_forbidden() == ["flax", "jax", "m3asr_tpu"]


def _run(args, cwd, env=None):
    e = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    e.update(env or {})
    return subprocess.run([sys.executable, "port_bench/run.py"] + args,
                          cwd=cwd, capture_output=True, text=True, env=e,
                          timeout=300)


ARGS = ["--workload", "asr18l32e-offline-mixed", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    r = _run(ARGS, ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    r = _run(ARGS, tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


EXTEND = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]    # the copy first, then the program
from port_bench.harness import bench, runner
from port_bench.tests import tiny
spec = bench.benchmark(sys.argv[1])
wl = bench.workload(spec, "added-cell")
cfg = bench.config(wl["config"])
assert cfg["note"] == "added"
out = runner.run(wl, 7, 0.5, True, "cpu", start=time.perf_counter(),
                 spec=spec, config=tiny.config("asr18l32e-bf16-flash"),
                 mix=bench.mix(wl["traffic"]))
assert bench.limits("added-cell") == tiny.LIMITS
print(json.dumps(out["result"]["metrics"]))
"""


def test_extension_by_files_alone(tmp_path):
    """A configuration, a mix and a per-layer metric dropped in as new
    files, with a new workloads entry, are found by name."""
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "port_bench"), root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = bench.benchmark()
    base = bench.config("asr18l32e-bf16-flash")
    base["note"] = "added"
    (root / "port_bench/configs/added-config.json").write_text(
        json.dumps(base))
    from port_bench.tests import tiny
    m = tiny.mix("offline-mixed")
    (root / "port_bench/mixes/added-mix.json").write_text(json.dumps(m))
    (root / "port_bench/limits/added-cell.json").write_text(
        json.dumps({"limits": tiny.LIMITS}))
    (root / "port_bench/metrics/calls_seen.added.py").write_text(
        "def read(run):\n    return float(len(run.res.calls))\n")
    spec["workloads"].append({"name": "added-cell", "config":
                              "added-config", "traffic": "added-mix",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "calls_seen.added", "unit": "calls",
                              "better": "higher", "source": "program_span",
                              "layer": "Engine", "moves": "audio_s_per_s",
                              "workloads": ["added-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = subprocess.run([sys.executable, "-c", EXTEND, str(root), ROOT], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["calls_seen.added"]["value"] >= 1
