"""The port's tracer (``runtime/trace.py``) and the routing counter of
the run-length expert stages, on the CPU.

An engine call with the tracer off records nothing and opens no
profiler range, and answers bit for bit as with it on. With it on, the
call's spans nest under one ``engine.infer`` span in the order prepare,
stage, replay, sync, copy_out, and agree within 1 ms with the ranges of
the same names in a CPU ``torch.profiler`` trace after the clock-marker
offset a trace's reader takes; the ranges are host operations, not
user annotations (which the profiler would mirror onto the device);
under a running profiler the tracer is on by itself. The routing counter equals a
histogram of the model's own gate indices over the valid positions, on a
batch padded in rows and frames; the runs operators' second output is
the layout's tokens per expert.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.ops import moe as t_moe
from m3asr_tpu_torch.ops.library import OPS
from m3asr_tpu_torch.ops.moe_runs import runs_layout
from m3asr_tpu_torch.ops.quant import quantize_moe_params
from m3asr_tpu_torch.runtime import trace
from m3asr_tpu_torch.runtime.batching import MicroBatcher
from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

from test_torch_outputs import random_params, small_yaml

# a profiler range taken on both clocks, as a trace's reader aligns them
CLOCK_MARK = "clock-mark"
CHILDREN = ["engine.prepare", "engine.stage", "engine.replay", "engine.sync",
            "engine.copy_out"]
# a batch padded in rows (3 of 4) and in frames (60, 41, 17 of 64)
LENS = np.array([60, 41, 17], np.int32)


@pytest.fixture(scope="module")
def engine():
    return Engine(t_config(small_yaml()), random_params(3),
                  EngineConfig(bucket_lengths=(64,), bucket_batches=(4,)),
                  device="cpu")


@pytest.fixture
def fresh():
    """The process's tracer, off and empty before and after the test."""
    trace.enable(False)
    trace.reset()
    yield trace.TRACER
    trace.enable(False)
    trace.reset()


def _feat(seed=0, T=60):
    return np.random.default_rng(seed).standard_normal((len(LENS), T, 20)) \
        .astype(np.float32)


def test_off_records_nothing_and_answers_as_on(engine, fresh, monkeypatch):
    opened = []
    monkeypatch.setattr(trace, "profiler_range",
                        lambda name: opened.append(name))
    feat = _feat()
    off = engine.infer(feat, LENS)
    assert not trace.on() and trace.span("x") is trace.NULL
    assert trace.records() == [] and trace.counters() == {} and not opened
    monkeypatch.undo()
    trace.enable(True)
    on = engine.infer(feat, LENS)
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(trace.records()) == 1 + len(CHILDREN)


def test_spans_nest_in_order_and_meet_the_profilers_events(engine, fresh,
                                                           tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function
    assert not trace.on()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.on()                     # on by itself
        with record_function("warm-up"):       # the first one sets up
            pass
        mark = time.time_ns()
        with record_function(CLOCK_MARK):
            pass
        engine.infer(_feat(1), LENS)
    assert not trace.on()
    recs = trace.records()
    (call,) = [r for r in recs if r.name == "engine.infer"]
    kids = sorted((r for r in recs if r is not call), key=lambda r: r.start)
    assert [r.name for r in kids] == CHILDREN
    assert all(r.parent == call.id and r.root == call.id for r in kids)
    assert call.parent == 0 and call.root == call.id
    for a, b in zip(kids, kids[1:]):
        assert a.end <= b.start
    assert call.start <= kids[0].start and kids[-1].end <= call.end
    assert call.meta["bucket"] == [4, 64] and call.meta["B"] == 3
    assert call.meta["lens"] == LENS.tolist()
    events = {}
    offset = None
    for e in prof.profiler.kineto_results.events():
        if e.name() == CLOCK_MARK and offset is None:
            offset = e.start_ns() - mark
        events.setdefault(e.name(), (e.start_ns(), e.end_ns()))
    assert offset is not None
    for r in [call] + kids:
        s, e = events[r.name]
        assert abs(s - offset - r.start) < 1_000_000, r.name
        assert abs(e - offset - r.end) < 1_000_000, r.name
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats = {e.get("cat") for e in json.loads(path.read_text())["traceEvents"]
            if e.get("name") in CHILDREN + ["engine.infer"]}
    assert cats == {"cpu_op"}


def _gates(monkeypatch):
    """Record every top-1 gate's (gate_idx, lengths) of the forwards."""
    got = []
    gate = t_moe.softmax_top1_gate

    def recording(p, router_inputs, lengths):
        value, idx = gate(p, router_inputs, lengths)
        got.append((idx.clone(), lengths.clone()))
        return value, idx
    monkeypatch.setattr(t_moe, "softmax_top1_gate", recording)
    return got


def test_routing_is_the_models_own_over_valid_positions(engine, fresh,
                                                        monkeypatch):
    gates = _gates(monkeypatch)
    trace.enable(True)
    engine.infer(_feat(2), LENS)
    engine.infer(_feat(3), LENS)
    calls = [r for r in trace.records() if r.name == "engine.infer"]
    E = 4
    assert len(gates) == 2 * len(calls[0].meta["routing"])
    want = []
    for idx, lens in gates:
        valid = torch.arange(idx.shape[1])[None, :] < lens[:, None]
        want.append(torch.bincount(idx[valid].long(), minlength=E).tolist())
    n = len(gates) // 2
    assert calls[0].meta["routing"].tolist() == want[:n]
    assert calls[1].meta["routing"].tolist() == want[n:]
    tokens = sum(max(0, ((int(t) - 1) // 2 - 1) // 2) for t in LENS)
    for call in calls:
        assert call.meta["routing"].sum(axis=1).tolist() == [tokens] * n
    total = (np.array(want[:n]) + np.array(want[n:])).tolist()
    assert trace.routing() == total


def test_stages_other_than_runs_report_no_routing(fresh):
    eng = Engine(t_config(small_yaml()), random_params(3),
                 EngineConfig(bucket_lengths=(64,), bucket_batches=(4,),
                              moe_impl="dense"), device="cpu")
    trace.enable(True)
    eng.infer(_feat(4), LENS)
    (call,) = [r for r in trace.records() if r.name == "engine.infer"]
    assert "routing" not in call.meta and trace.routing() == []


def _experts(E=4, D=64, H=128, seed=5):
    rng = np.random.default_rng(seed)
    p = {"w1": rng.standard_normal((E, D, H)) * 0.05,
         "b1": rng.standard_normal((E, H)) * 0.1,
         "w2": rng.standard_normal((E, H, D)) * 0.05,
         "b2": rng.standard_normal((E, D)) * 0.1}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("fmt", ["f", "q8", "q4"])
def test_runs_operators_return_the_layouts_counts(fmt):
    E = 4
    f = _experts(E)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 9, 64)).astype(np.float32))
    gate = torch.from_numpy(rng.integers(0, E, (2, 9)).astype(np.int32))
    gate[1, 5:] = 0
    if fmt == "f":
        t = {k: torch.from_numpy(v) for k, v in f.items()}
        out = OPS["moe_runs_f"](x, gate, t["w1"], t["b1"], t["w2"], t["b2"],
                                None, "swish", None)
    else:
        q = {k: torch.as_tensor(v) for k, v in quantize_moe_params(
            f, bits=8 if fmt == "q8" else 4).items()}
        w1, w2 = ("w1_q", "w2_q") if fmt == "q8" else ("w1_q4", "w2_q4")
        out = OPS["moe_runs_q"](x.bfloat16(), gate, q[w1], q["w1_scale"],
                                q["b1"].bfloat16(), q[w2], q["w2_scale"],
                                q["b2"].bfloat16(), fmt, None, False,
                                "swish", None)
    counts = out[1]
    assert counts.dtype == torch.int32 and counts.shape == (E,)
    assert torch.equal(counts, runs_layout(gate.reshape(-1), E).counts)
    assert counts.tolist() == np.bincount(gate.reshape(-1).numpy(),
                                          minlength=E).tolist()


def test_micro_batcher_waits_are_listed_by_their_dispatch(engine, fresh):
    trace.enable(True)
    b = MicroBatcher(engine.infer, window_ms=200.0, max_batch=2)
    feat = _feat(7)
    try:
        ths = [threading.Thread(target=b.infer, args=(feat[j, :LENS[j]],))
               for j in range(2)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ths)
    finally:
        b.close()
    recs = trace.records()
    waits = [r for r in recs if r.name == "batcher.wait"]
    calls = [r for r in recs if r.name == "engine.infer"]
    assert len(waits) == 2 and len(calls) == 1
    assert sorted(calls[0].meta["waits"]) == sorted(r.id for r in waits)
    assert all(r.end <= calls[0].start for r in waits)


def test_self_time_and_the_bounded_buffer():
    t = trace.Tracer(capacity=3)
    t.enable(True)
    with t.span("a"):
        time.sleep(0.002)
        with t.span("b"):
            time.sleep(0.004)
    stats = trace.span_stats(t.records())
    assert stats["a"]["count"] == 1
    a, b = stats["a"], stats["b"]
    assert a["total_ms"] >= 6 and b["total_ms"] >= 4
    assert a["self_ms_p50"] == pytest.approx(a["total_ms"] - b["total_ms"])
    for i in range(3):
        t.record("c", i, i + 1)
    assert t.dropped == 2 and [r.name for r in t.records()] == ["c"] * 3
    assert [r.start for r in t.records(2, 2)] == [1, 2]
    t.enable(False)
    t.count("n")
    assert t.counters() == {} and t.record("d", 0, 1) == 0


def test_routing_totals_restart_at_a_new_shape_and_roots_are_kept():
    t = trace.Tracer()
    t.enable(True)
    t.add_routing([[1, 2], [3, 4]])
    t.add_routing([[1, 0], [0, 1]])
    assert t.routing() == [[2, 2], [3, 5]]
    t.add_routing([[5, 6, 7]])              # another engine's forward
    assert t.routing() == [[5, 6, 7]]
    assert t.last_root() is None
    with t.span("outer"):
        with t.span("inner"):
            pass
        assert t.last_root() is None        # an inner span is no root
    assert t.last_root().name == "outer"
    t.count("engine.captures")
    assert t.counters() == {"engine.captures": 1}
