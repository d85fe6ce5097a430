"""One run of one cell: set-up, the window, the check, the metrics.

``run`` returns the result line (a dict) and the compared numbers'
lines; ``port_bench/run.py`` prints them. Tests call it on the CPU with
a small configuration; a measured run is on ``cuda`` only.
"""

from __future__ import annotations

import sys
import time
import types

import torch

from port_bench.harness import bench, check, drivers
from port_bench.harness.trace import Spans, Tracer
from port_bench.metrics import costs
from port_bench.reference.common import Precision, exact_float32

FORBIDDEN = ("jax", "jaxlib", "flax", "m3asr_tpu")
# a traced run's window: the profiler's events of a longer one take
# minutes to read
TRACE_WINDOW_S = 10.0


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class ForbiddenImport(RuntimeError):
    pass


def cell_of(wl: dict, seed: int, device: str, config=None, mix=None):
    config = config or bench.config(wl["config"])
    mix = mix or bench.mix(wl["traffic"])
    fam = config["family"]
    return drivers.Cell(wl["name"], config, mix, seed, device,
                        bench.reference(fam), bench.counts(fam))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(wl: dict, seed: int, seconds: float, trace: bool, device: str,
        start: float, control: bool = False, root=bench.ROOT, spec=None,
        config=None, mix=None, limits=None):
    spec = spec or bench.benchmark(root)
    cell = cell_of(wl, seed, device, config, mix)
    spans = Spans()
    drv = drivers.DRIVERS[cell.mix["driver"]](cell, spans)
    drv.setup()
    _sync(device)
    setup_s = time.perf_counter() - start

    tracer = Tracer(trace, spans)
    with tracer:
        res = drv.window(min(seconds, TRACE_WINDOW_S) if trace else seconds,
                         tracer)
        t_read = time.perf_counter()
        tracer.close(res.t0, res.t1)
        read_s = time.perf_counter() - t_read
    found = loaded_forbidden()
    if found:
        raise ForbiddenImport(f"loaded {found} (the run may load neither "
                              "JAX nor the JAX package)")
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = drv.end_to_end(res)
    e2e["setup_s"] = setup_s
    attempted = sum(len(lens) for _, lens, _ in res.calls)
    notes = drv.notes(res) + [f"set-up {setup_s:.3f} s, peak {peak} bytes"]
    if trace:
        notes.append(f"read the trace in {read_s:.1f} s")
    drv.free()
    if cuda:
        torch.cuda.empty_cache()

    # the check, after the window and the program's state are gone
    limits = limits or bench.limits(wl["name"])
    exact_float32()
    t_check = time.perf_counter()
    with torch.inference_mode():
        pairs = list(drv.reference_pairs(res, Precision("float32")))
        numbers = check.compare(pairs, cell.device)
        ok = bool(res.kept) and check.verdict(numbers, limits)
        check_s = time.perf_counter() - t_check
        active = []
        if trace:
            # the experts each traced call's tokens route to, for K1's bytes
            t_route = time.perf_counter()
            active = drv.active_experts(res.calls, Precision("float32"))
            notes.append(f"routed the {len(active)} traced calls with the "
                         f"reference in {time.perf_counter() - t_route:.1f} s")
        lines = notes + [f"compared {len(pairs)} answers of {cell.name} (seed "
                 f"{seed}) with the float32 reference in {check_s:.1f} s"]
        lines += check.lines(numbers, limits)
        lines += [f"{k} {numbers[k]!r} (not compared)"
                  for k in check.NUMBERS if k not in limits]
        if control:
            low = Precision("fp8")
            ctrl = check.compare(
                [(ref.cpu().numpy(), ref_lo) for (_, ref), ref_lo in zip(
                    pairs, (r for _, r in drv.reference_pairs(res, low)))],
                cell.device)
            lines += check.lines(ctrl, limits, prefix="control ")
            lines += [f"control {k} {ctrl[k]!r} (not compared)"
                      for k in check.NUMBERS if k not in limits]
            ok = bool(res.kept) and check.verdict(ctrl, limits)
            numbers = ctrl

    run_ns = types.SimpleNamespace(cell=cell, res=res, trace=tracer.result,
                                   costs=costs, counts=cell.counts,
                                   dtype=cell.config["engine"]["dtype"],
                                   spans=spans, active=active)
    metrics = {}
    if not trace:
        for m in bench.metrics_of(spec, "end_to_end", cell.name):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in bench.metrics_of(spec, "per_layer", cell.name):
            v = bench.reader(m["name"])(run_ns)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": ok, "attempted": attempted, "failed": 0,
           "metrics": metrics, "device": dev}
    if trace:
        t = tracer.result
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        out["breakdown"] = {"device_ops": t.by_name(10),
                            "idle_gaps": t.idle_gaps(10)}
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    return {"result": out, "lines": lines}
