"""What the program's own tracer (``m3asr_tpu_torch/runtime/trace.py``)
recorded in a traced window, read against the device trace: the device's
idle time split by whether the program was waiting for the card
(``engine.sync``), and K1's roofline share over the routing the program
ran (the ``routing`` of each ``engine.infer`` span).

Each reader returns None where there is nothing to read: no trace, a
program without the tracer, or no span of the kind in the window.
"""

from __future__ import annotations

from port_bench.harness.trace import union
from port_bench.metrics import costs


def records(run):
    """The program's spans that overlap the traced window, or None."""
    if run.trace is None:
        return None
    try:
        from m3asr_tpu_torch.runtime import trace
    except ImportError:
        return None
    return trace.records(run.trace.t0, run.trace.t1)


def _overlap_ns(a, b) -> int:
    """Total length of the intersection of two sorted disjoint interval
    lists."""
    i = j = tot = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            tot += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_split(run):
    """(idle ns while the program was not in ``engine.sync``, idle ns
    while it was, window ns): each idle gap split at the spans' edges.
    None without ``engine.infer`` spans in the window."""
    recs = records(run)
    if not recs or not any(r.name == "engine.infer" for r in recs):
        return None
    t = run.trace
    window = t.t1 - t.t0
    if window <= 0:
        return None
    bounds = [[t.t0, t.t0]] + t.busy + [[t.t1, t.t1]]
    idle = [(a[1], b[0]) for a, b in zip(bounds, bounds[1:]) if b[0] > a[1]]
    syncs = union((max(r.start, t.t0), min(r.end, t.t1)) for r in recs
                  if r.name == "engine.sync" and r.end > t.t0
                  and r.start < t.t1)
    in_sync = _overlap_ns(idle, syncs)
    return sum(e - s for s, e in idle) - in_sync, in_sync, window


def k1_roofline(run):
    """``shares.k1_roofline`` with each call's active experts per MoE
    layer taken from the program's routing (the experts its valid tokens
    went to), over ``expert_tile_gemm``'s device time. None unless every
    ``engine.infer`` span of the window carries its routing."""
    recs = records(run)
    calls = [r for r in recs or () if r.name == "engine.infer"]
    if not calls or any("routing" not in r.meta for r in calls):
        return None
    dev = run.trace.kernel_s("expert_tile_gemm")
    if not dev:
        return None
    _, d, h, _ = run.counts.k1_layers(run.cell.model)
    least = 0.0
    for r in calls:
        tok = sum(run.counts.tokens(run.cell.model, n) for n in r.meta["lens"])
        for row in r.meta["routing"]:
            active = sum(1 for n in row if n)
            least += costs.least_s(*costs.k1_cost(tok, d, h, active,
                                                  run.dtype), run.dtype)
    return 100.0 * least / dev
