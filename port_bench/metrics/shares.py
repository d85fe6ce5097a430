"""What the per-layer metric readers share: shares of the H100's peak
and of a kernel's roofline, over the traced window, in percent. Each
returns None where the run has nothing to read (no trace, no call)."""

from __future__ import annotations

from port_bench.metrics import costs


def _calls(run):
    return run.res.calls if run.trace is not None else []


def model_ops(run) -> float:
    """The model operations the window's work needed: every utterance
    at its valid length."""
    return float(sum(run.counts.utterance(run.cell.model, n)
                     for _, lens, _ in run.res.calls for n in lens))


def mfu(run):
    if run.trace is None:
        return None
    ops = model_ops(run)
    if not ops:
        return None
    peak = costs.PEAK_OPS_PER_S[run.dtype]
    return 100.0 * ops / (peak * run.trace.window_s)


def idle(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def k1_roofline(run):
    """K1's least time over its device time (``expert_tile_gemm``): per
    MoE layer of each call, the valid tokens over the experts they route
    to (``run.active``: per call, per layer, from the reference's
    routing of the same weights and features)."""
    calls = _calls(run)
    dev = run.trace.kernel_s("expert_tile_gemm") if calls else 0.0
    if not dev or not run.active:
        return None
    _, d, h, _ = run.counts.k1_layers(run.cell.model)
    least = 0.0
    for (_, lens, _), active in zip(calls, run.active):
        tok = sum(run.counts.tokens(run.cell.model, n) for n in lens)
        least += sum(costs.least_s(*costs.k1_cost(tok, d, h, e, run.dtype),
                                   run.dtype) for e in active)
    return 100.0 * least / dev


def k2_roofline(run):
    """K2's least time over its device time (``flash_fwd_kernel``): per
    attention layer of each call, the operations and bytes of every
    utterance at its valid length, summed over the call's batch."""
    calls = _calls(run)
    dev = run.trace.kernel_s("flash_fwd_kernel") if calls else 0.0
    if not dev:
        return None
    least = 0.0
    for _, lens, _ in calls:
        toks = [run.counts.tokens(run.cell.model, n) for n in lens]
        for heads, dk in run.counts.k2_layers(run.cell.model):
            parts = [costs.k2_rel_cost(n, heads, dk, run.dtype)
                     for n in toks]
            least += costs.least_s(sum(p[0] for p in parts),
                                   sum(p[1] for p in parts), run.dtype)
    return 100.0 * least / dev


def pad(run):
    """Padded frames over bucket frames of the window's engine calls."""
    calls = run.res.calls
    if not calls:
        return None
    total = sum(b * t for _, _, (b, t) in calls)
    valid = sum(sum(lens) for _, lens, _ in calls)
    return 100.0 * (total - valid) / total
