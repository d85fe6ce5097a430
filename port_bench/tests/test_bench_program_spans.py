"""The readers of the program's own spans and routing
(``port_bench/metrics/program_spans.py``) on a synthetic device trace and
tracer buffer."""

import types

import pytest

from m3asr_tpu_torch.runtime import trace
from port_bench.harness import bench
from port_bench.harness.trace import Spans, Trace
from port_bench.metrics import shares
from port_bench.tests import tiny

MS = 1_000_000


@pytest.fixture
def tracer():
    trace.enable(False)
    trace.reset()
    trace.enable(True)
    yield trace
    trace.enable(False)
    trace.reset()


def _run(events, t0, t1, calls=(), active=()):
    model = tiny.flagship_model()
    return types.SimpleNamespace(
        trace=Trace(events, t0, t1, Spans()),
        res=types.SimpleNamespace(calls=list(calls)),
        cell=types.SimpleNamespace(model=model),
        counts=bench.counts("moe_conformer"), dtype="bfloat16",
        active=list(active))


def _read(name, run):
    return bench.reader(name)(run)


def test_host_and_sync_idle_sum_to_the_idle_share(tracer):
    events = [("k", 2 * MS, 9 * MS), ("k", 12 * MS, 15 * MS),
              ("copy", 14 * MS, 21 * MS), ("k", 33 * MS, 38 * MS)]
    for s, e in ((0, 11), (20, 25), (30, 39)):
        trace.record("engine.infer", s * MS, e * MS)
    for s, e in ((4, 10), (14, 24), (32, 38.5)):
        trace.record("engine.sync", int(s * MS), int(e * MS))
    run = _run(events, 0, 40 * MS)
    host = _read("host_idle_share.offline", run)
    sync = _read("sync_idle_share.offline", run)
    assert host + sync == pytest.approx(shares.idle(run), abs=1e-9)
    # idle in sync: [9, 10], [21, 24], [32, 33], [38, 38.5] of 40 ms
    assert sync == pytest.approx(100 * 5.5 / 40)


def test_a_gap_straddling_the_end_of_a_sync_is_split_at_its_edge(tracer):
    """The gap [10, 30] ms lies half in engine.sync: half goes to each
    share, whatever span holds its middle."""
    trace.record("engine.infer", 0, 40 * MS)
    trace.record("engine.sync", 5 * MS, 20 * MS)
    run = _run([("k", 0, 10 * MS), ("k", 30 * MS, 40 * MS)], 0, 40 * MS)
    assert _read("sync_idle_share.offline", run) == pytest.approx(25.0)
    assert _read("host_idle_share.offline", run) == pytest.approx(25.0)


def test_k1_from_the_programs_routing_equals_the_reference_share(tracer):
    lens = [[300, 211], [280, 280, 150]]
    routing = [[[7, 0, 3, 62], [0, 0, 72, 0]],
               [[40, 40, 40, 37], [157, 0, 0, 0]]]
    calls, active = [], []
    for j, (ls, rt) in enumerate(zip(lens, routing)):
        trace.record("engine.infer", (10 * j + 1) * MS, (10 * j + 8) * MS,
                     lens=ls, routing=rt)
        calls.append((list(range(len(ls))), ls, (4, 320)))
        active.append([sum(1 for n in row if n) for row in rt])
    events = [("void expert_tile_gemm<bf16>(...)", (10 * j + 2) * MS,
               (10 * j + 3) * MS) for j in range(2)]
    run = _run(events, 0, 20 * MS, calls, active)
    got = _read("k1_roofline_prog.offline", run)
    assert got is not None and got == pytest.approx(shares.k1_roofline(run))
    # a call without routing (another stage, a loaded program): nothing
    trace.record("engine.infer", 18 * MS, 19 * MS, lens=[300])
    assert _read("k1_roofline_prog.offline", run) is None


def test_without_program_spans_nothing_is_read(tracer):
    run = _run([("k", 0, 10 * MS)], 0, 40 * MS)
    for name in ("host_idle_share.offline", "sync_idle_share.offline",
                 "k1_roofline_prog.offline"):
        assert _read(name, run) is None
    run.trace = None
    assert _read("host_idle_share.offline", run) is None
