"""The port's server and bucket tuner against the JAX package's, on the
CPU.

Server: one engine directory (the small hier MoE conformer of
``tests/test_torch_outputs.py``, weights from a numpy seed) served in
process by ``m3asr_tpu_torch.serve`` (``--device cpu``) and by the root
``serve.py`` (JAX), each through its ``make_handler`` on a loopback
``socketserver``; the same offline (greedy, and beam with hotwords and an
ARPA LM), stream (greedy and beam partials, two concurrent streams) and
stats requests go to both. Hypotheses, lengths and emission times must be
equal; n-best scores within 1e-4 (float32 logits within 1e-5 of each
other, the native decoder's float32 sums). Every response also equals
the port's engine and host decode called directly.

Tuner: ``tune_lengths`` / ``tune_report`` on the same explicit cost table
give the JAX package's ladder and report; the port's own points are the
card's.
"""

import argparse
import json
import socket
import socketserver
import threading

import numpy as np
import pytest

import serve as j_serve
from m3asr_tpu.runtime import bucket_tuner as j_tuner

from m3asr_tpu_torch import serve as t_serve
from m3asr_tpu_torch import tune_buckets
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.decode import native
from m3asr_tpu_torch.decode.ctc import ContextTrie
from m3asr_tpu_torch.runtime import bucket_tuner as t_tuner
from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

from test_torch_decode import ARPA
from test_torch_outputs import random_params, small_yaml

C = 4


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(port server, JAX server, the port's runtime state, its LM), each
    listening on 127.0.0.1 on a port of its own."""
    d = tmp_path_factory.mktemp("engine")
    Engine(t_config(small_yaml()), random_params(21),
           EngineConfig(bucket_lengths=(128,), bucket_batches=(1, 2)),
           device="cpu").save(str(d))
    arpa = d / "lm.arpa"
    # the small model's vocabulary is 32 units: reuse ids 1-7 of ARPA
    arpa.write_text(ARPA)
    argv = ["-p", str(d), "--lm", str(arpa), "--stream_slots", "2",
            "--stream_topk", "6", "--beam_size", "4"]
    t_args = t_serve.parser().parse_args(argv + ["--device", "cpu"])
    # the root serve.py's flags, as its argument parser sets them
    j_args = argparse.Namespace(
        plan_name=str(d), host="127.0.0.1", port=0, beam_size=4,
        warmup=False, batch_window_ms=5.0, max_batch=8, stream_slots=2,
        stream_topk=6, stream_window_ms=2.0, lm=str(arpa), lm_weight=0.5,
        units=None, drain_secs=1.0)
    t_state = t_serve._build_runtime(t_args)
    t_lm = t_serve.load_lm(t_args)
    j_state = j_serve._build_runtime(j_args)
    from m3asr_tpu.decode.lm import NgramLM
    j_lm = NgramLM(str(arpa))
    out = []
    for handler in (t_serve.make_handler(t_state, 4, lm=t_lm),
                    j_serve.make_handler(j_state, 4, lm=j_lm)):
        srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), handler)
        srv.daemon_threads = True
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        out.append(srv)
    yield out[0], out[1], t_state, t_lm
    for srv in out:
        srv.shutdown()
        srv.server_close()
    for state in (t_state, j_state):
        state["batcher"].close()


def client(srv, reqs):
    with socket.create_connection(srv.server_address) as sock:
        f = sock.makefile("rwb")
        out = []
        for r in reqs:
            f.write((json.dumps(r) + "\n").encode())
            f.flush()
            out.append(json.loads(f.readline()))
        return out


def same(got, ref):
    """Two responses: equal but for latency, n-best scores within
    1e-4."""
    got, ref = dict(got), dict(ref)
    for r in (got, ref):
        r.pop("latency_ms", None)
    gn, rn = got.pop("nbest", []), ref.pop("nbest", [])
    assert got == ref
    assert [dict(n, score=0) for n in gn] == [dict(n, score=0) for n in rn]
    np.testing.assert_allclose([n["score"] for n in gn],
                               [n["score"] for n in rn], rtol=0, atol=1e-4)


def feat(seed, T):
    return np.random.default_rng(seed).standard_normal((T, 20)) \
        .astype(np.float32)


def test_offline_requests_match_jax_and_direct_decoding(servers):
    port_srv, jax_srv, state, lm = servers
    fa, fb = feat(1, 90), feat(2, 120)
    eng = state["engine"]
    out, out_len = eng.infer(fb[None], np.array([120]))
    greedy = native.ctc_greedy_search(out, out_len)[0]
    ctx = [greedy[1:3], [5, 6]]
    reqs = [{"id": "a", "feat": fa.tolist()},
            {"id": "a2", "feat": fa.tolist(), "timestamps": True,
             "confidence": True},
            {"id": "b", "feat": fb.tolist(), "decode": "beam",
             "beam_size": 4, "context": ctx, "nbest": 3,
             "timestamps": True},
            {"id": "c", "feat": fb.tolist(), "decode": "beam", "lm": False}]
    got, ref = client(port_srv, reqs), client(jax_srv, reqs)
    for g, r in zip(got, ref):
        assert "error" not in g, g
        same(g, r)
    # the engine and the host decode called directly
    oa, la = eng.infer(fa[None], np.array([90]))
    assert got[0]["hyp"] == native.ctc_greedy_search(oa, la)[0]
    assert got[0]["out_len"] == int(la[0])
    lp = out[0] - out[0].max(-1, keepdims=True)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    hyps = native.ctc_prefix_beam_search_ext(
        lp, int(out_len[0]), 4, context=ContextTrie(ctx, 3.0), lm=lm)
    assert got[2]["hyp"] == list(hyps[0].tokens)
    assert got[2]["times"] == list(hyps[0].times)
    assert [n["hyp"] for n in got[2]["nbest"]] == \
        [list(h.tokens) for h in hyps[:3]]


def stream_reqs(f, decode):
    reqs = [{"stream": "start", "chunk_size": C, "num_left_chunks": 2,
             "decode": decode, "beam_size": 4, "timestamps": True}]
    for a, b in ((0, 23), (23, 30), (30, 71), (71, f.shape[0])):
        reqs.append({"stream": "chunk", "feat": f[a:b].tolist()})
    return reqs + [{"stream": "end"}]


def test_streams_match_jax_and_direct_decoding(servers):
    """Two concurrent streams (greedy and beam partials) on each server;
    then the same pieces through the port's own batcher and host decode,
    one stream at a time; and the stats request."""
    port_srv, jax_srv, state, lm = servers
    fs = [feat(3, 95), feat(4, 77)]
    got, ref = [None, None], [None, None]

    def run(srv, out, j, decode):
        out[j] = client(srv, stream_reqs(fs[j], decode))
    ths = [threading.Thread(target=run, args=(srv, out, j, d))
           for srv, out in ((port_srv, got), (jax_srv, ref))
           for j, d in enumerate(("greedy", "beam"))]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    for g, r in zip(got, ref):
        assert len(g) == len(r) == 6
        for a, b in zip(g, r):
            assert "error" not in a, a
            same(a, b)
    # every frame of the subsampled length, the tail's included
    assert got[1][-1]["final"]
    assert got[1][-1]["out_frames"] == ((77 - 1) // 2 - 1) // 2
    pool = state["stream_pool"]
    for j, decode in enumerate(("greedy", "beam")):
        sess = pool.acquire((C, 2))
        beam = (native.make_beam_state(4, lm=lm) if decode == "beam"
                else None)
        dec = t_serve._StreamDecode(sess, beam_state=beam)
        want = []
        for r in stream_reqs(fs[j], decode)[1:-1]:
            dec.update(sess.push(np.asarray(r["feat"], np.float32)[None]))
            want.append(dec.result())
        dec.update(sess.finish())
        want.append(dec.result())
        pool.release((C, 2), sess)
        assert [(r.get("partial", r.get("hyp")), r["times"])
                for r in got[j][1:]] == [(t, tm) for t, tm in want]
    stats = client(port_srv, [{"stats": True}])[0]
    assert stats["served"] >= 4
    sb = stats["stream_batchers"][str((C, 2))]
    assert sb["slots"] == 2 and sb["slots_free"] == 2
    assert sum(sb["tick_batch_sizes"]) > 0


@pytest.mark.parametrize("on", [False, True], ids=["tracer_off",
                                                   "tracer_on"])
def test_stats_report_spans_and_routing_while_tracing(servers, on):
    """With the tracer on (``--trace``), the stats request adds each span's
    count, total and self-time percentiles, the routing and the counters
    counted since it turned on; with it off, none of them."""
    from m3asr_tpu_torch.runtime import trace
    port_srv = servers[0]
    trace.reset()
    trace.enable(on)
    try:
        got = client(port_srv, [{"id": "t", "feat": feat(8, 50).tolist()}])
        assert "error" not in got[0], got[0]
        client(port_srv, stream_reqs(feat(9, 77), "greedy"))
        # the CPU captures no CUDA graph: one count stands in for one
        trace.count("engine.captures")
        stats = client(port_srv, [{"stats": True}])[0]
    finally:
        trace.enable(False)
        trace.reset()
    assert stats["served"] >= 1
    if not on:
        assert not {"spans", "routing", "counters"} & set(stats)
        return
    assert stats["counters"] == {"engine.captures": 1}
    spans = stats["spans"]
    assert {"engine.infer", "engine.prepare", "engine.stage",
            "engine.replay", "engine.sync", "engine.copy_out",
            "batcher.wait", "stream.tick"} <= set(spans)
    assert spans["engine.infer"]["count"] == spans["batcher.wait"]["count"] \
        == 1
    for v in spans.values():
        assert v["total_ms"] >= v["self_ms_p95"] >= v["self_ms_p50"] >= 0
    assert spans["engine.infer"]["total_ms"] >= \
        spans["engine.replay"]["total_ms"]
    # one request of 50 frames: 11 valid tokens in each expert call
    assert stats["routing"] and all(sum(row) == ((50 - 1) // 2 - 1) // 2
                                    for row in stats["routing"])


def test_stream_errors(servers):
    port_srv = servers[0]
    got = client(port_srv, [{"stream": "chunk", "feat": [[0.0] * 20]},
                            {"stream": "start", "chunk_size": C},
                            {"stream": "start"}, {"stream": "bogus"},
                            {"stream": "end"}])
    assert "error" in got[0] and got[1]["ok"] and "error" in got[2]
    assert "error" in got[3] and got[4]["final"] and got[4]["hyp"] == []


def test_stream_params_undo_fused_and_dense_quant_weights():
    """A fuse_qkv + dense_quant engine streams on the defused,
    dequantized twin of its weights: q/k/v split back exactly, dense
    kernels as bf16(q * s)."""
    tree = random_params(22)
    eng = Engine(t_config(small_yaml()), tree,
                 EngineConfig(dtype="int8", fuse_qkv=True, dense_quant=True),
                 device="cpu")
    p = t_serve.stream_params(eng)
    attn = p["blocks"]["self_attn"]
    assert "linear_qkv" not in attn and "kernel" in attn["linear_q"]
    assert "kernel_q" not in p["blocks"]["feed_forward_macaron"]["w_1"]
    assert t_serve._stream_moe_impl(eng, 8) == "quant"
    plain = Engine(t_config(small_yaml()), tree, EngineConfig(),
                   device="cpu")
    ref = plain.params["blocks"]["self_attn"]
    for n in ("linear_q", "linear_k", "linear_v"):
        w, r = attn[n]["kernel"].float(), ref[n]["kernel"]
        assert w.shape == r.shape
        assert (w - r).abs().max() <= 0.02 * r.abs().max()  # int8 steps
        assert (attn[n]["bias"].float() - ref[n]["bias"]).abs().max() \
            <= 0.01 * ref[n]["bias"].abs().max()            # bf16 bias
    assert t_serve._stream_moe_impl(plain, 8) == "runs_f"
    assert t_serve._stream_moe_impl(plain, 9) == "runs_f"


@pytest.mark.parametrize("warmup", [False, True])
def test_warmup_builds_the_default_stream_batcher(tmp_path, warmup):
    """--warmup builds the default (chunk 16, left 2) stream batcher (on
    the card: captures its graph) before serving; without it the first
    stream start builds it. Either way the pool's session runs on it."""
    Engine(t_config(small_yaml()), random_params(23),
           EngineConfig(bucket_lengths=(64,), bucket_batches=(1,)),
           device="cpu").save(str(tmp_path))
    args = t_serve.parser().parse_args(
        ["-p", str(tmp_path), "--device", "cpu", "--stream_slots", "2"]
        + (["--warmup"] if warmup else []))
    state = t_serve._build_runtime(args)
    try:
        built = dict(state["stream_batchers"])
        assert list(built) == ([t_serve.DEFAULT_STREAM_KEY] if warmup
                               else [])
        sess = state["stream_pool"].acquire(t_serve.DEFAULT_STREAM_KEY)
        b = state["stream_batchers"][t_serve.DEFAULT_STREAM_KEY]
        assert sess.batcher is b
        if warmup:
            assert built[t_serve.DEFAULT_STREAM_KEY] is b
    finally:
        state["batcher"].close()
        for b in state["stream_batchers"].values():
            b.close()


def test_tune_lengths_matches_jax_on_a_cost_table():
    rng = np.random.RandomState(1)
    lengths = np.concatenate([rng.randint(1030, 1150, 500),
                              rng.randint(150, 260, 50),
                              rng.randint(5500, 6100, 5)])
    table = {206: 9.5, 1000: 13.0, 2048: 16.4, 6144: 41.0}
    for k in (1, 3, 6):
        got = t_tuner.tune_lengths(lengths, k, cost_table=table)
        assert got == j_tuner.tune_lengths(lengths, k, cost_table=table)
        assert got[-1] >= lengths.max()
    got = t_tuner.tune_report(lengths, 6, cost_table=table)
    ref = j_tuner.tune_report(lengths, 6, cost_table=table)
    assert got == ref
    assert t_tuner.expected_cost(lengths, got["ladder"], table) == \
        j_tuner.expected_cost(lengths, got["ladder"], table)


def test_tune_buckets_cli(tmp_path, capsys):
    lens = tmp_path / "lens.txt"
    lens.write_text("".join(f"u{i} {n}\n" for i, n in
                            enumerate([100, 130, 700, 710, 2000, 2050])))
    args = tune_buckets.parser().parse_args(
        ["--lengths_file", str(lens), "--k", "2", "--cost", "128=1",
         "--cost", "2176=9", "--batches", "1,4"])
    tune_buckets.main(args)
    rep, buckets = capsys.readouterr().out.strip().split("\n")
    ladder = json.loads(rep)["ladder"]
    assert ladder == list(j_tuner.tune_lengths(
        [100, 130, 700, 710, 2000, 2050], 2,
        cost_table={128: 1.0, 2176: 9.0}))
    assert buckets == "--buckets " + ",".join(
        f"{b}x{t}" for b in (1, 4) for t in ladder)
    # --ark reads the lengths from a Kaldi archive (or its scp index)
    from m3asr_tpu_torch.io.kaldi_io import ArkWriter
    rows = [100, 130, 700]
    with ArkWriter(str(tmp_path / "f.ark"), str(tmp_path / "f.scp")) as w:
        for i, n in enumerate(rows):
            w.write(f"u{i}", np.zeros((n, 3), np.float32))
    for spec in ("ark:" + str(tmp_path / "f.ark"), str(tmp_path / "f.ark"),
                 "scp:" + str(tmp_path / "f.scp"), str(tmp_path / "f.scp")):
        assert tune_buckets.read_lengths(tune_buckets.parser().parse_args(
            ["--ark", spec])) == rows


def test_tuner_points_are_the_cards():
    """The port's cost curves pass through its own measured points (one
    quadratic through three per mode) and stay positive over the
    ladder's range; no mode is missing. The float and int4 curves rise;
    int8 and w8a8 dip (their 1x206 bucket runs the plain quant stage),
    and the tuner then picks a longer bucket for short utterances."""
    assert set(t_tuner.MODE_POINTS) == {"float32", "bfloat16", "int8",
                                        "w8a8", "int4", "w4a8"}
    for mode, points in t_tuner.MODE_POINTS.items():
        assert sorted(points) == [206, 2048, 6144]
        for frames, ms in points.items():
            assert abs(float(t_tuner.default_cost(frames, mode)) - ms) \
                <= 1e-6 * ms
        curve = t_tuner.default_cost(np.arange(0, 6145, 16), mode)
        assert (curve > 0).all(), mode
        assert (np.diff(curve) > 0).all() == (mode not in ("int8", "w8a8"))
    lengths = np.append(np.full(100, 200), 2000)
    assert t_tuner.tune_lengths(lengths, 2, mode="float32") == (256, 2048)
    assert t_tuner.tune_lengths(lengths, 2, mode="w8a8")[0] >= 1024
