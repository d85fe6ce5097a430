"""The port's recognizer and server on an ep/tp-sharded engine dir, on
gloo ranks, against the JAX package's on the same dir, on the CPU.

The hier MoE conformer of tests/test_engine_ep.py (d=32, 4 heads, 2 MoE
blocks of 8 experts, hidden 48, V=9, 16 features) with three random AED
decoders goes through the port's build as three dirs: unsharded, ep2 x
tp2 (fp32) and ep2 with ``attn_impl="flash"`` (the plain flash version
on the CPU). Two worlds of tests/torch_serve_worker.py run at once under
a ``file://`` store, one thread a rank: 4 ranks on the ep2 x tp2 dir
(recognize greedy, beam and beam past the largest bucket, ``infer_long``
led from rank 0, and the server: offline requests and two streams from
several threads at once, then one at a time, malformed requests, a
RELOAD, STOP) and 2 ranks
on the flash dir (greedy and hier rescore, the refusals of a world that
does not fit the dir, then a rank-0 error that must end every rank).
While they run, the JAX package's root ``recognize.py``, ``Engine`` and
server run the same on the sharded dirs over the virtual CPU devices,
and the port's recognizer on the unsharded dir in this process; and one
process (``torch_dist_worker.py --build``) builds an exported ep2 x tp2
dir (``build --export``, bucket 2x64: every rank's program) and its
twin without ``exported/``, on which the 4 ranks then recognize (greedy)
and serve the offline requests.

Held: transcripts and stats equal, line for line; the server's answers
equal but for latency, n-best scores within 1e-4 (as
tests/test_torch_serve.py); ``infer_long`` allclose(rtol 1e-5, atol
1e-3); every answer given at once equal to its one-at-a-time twin.
"""

import argparse
import contextlib
import io
import json
import os
import struct
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
import yaml

import recognize as j_recognize
import serve as j_serve
from golden import torch_ref as G
from m3asr_tpu.runtime.engine import Engine as JEngine

from m3asr_tpu_torch import build as t_build
from m3asr_tpu_torch import recognize as t_recognize
from m3asr_tpu_torch.io.kaldi_io import ArkWriter

from test_op_parity import allclose
from test_torch_engine_ep import golden_model
from test_torch_serve import client, same

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_serve_worker.py")
BUILD_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "torch_dist_worker.py")
JOIN_S = 240              # a world's whole run
FAIL_S = 30               # a rank-0 error to the last rank's exit
V, C = 9, 4               # vocabulary; stream chunk (output frames)
DECODERS = ("decoder", "decoder_1", "decoder_2")
BUCKETS = "1x64,2x64"


def raw_yaml():
    return {"nnet_proto": "conformer_aed_fmoe_localComm_catEmbed_domain_acc"
                          "_hier",
            "input_dim": 16, "output_dim": V,
            "model_conf": {
                "encoder_conf": {
                    "attention_dim": 32, "attention_heads": 4,
                    "num_blocks": 2,
                    "embed_conf": {"attention_dim": 24, "attention_heads": 4,
                                   "linear_units": 32, "num_blocks": 1},
                    "moe_conf": {"num_experts": 8, "hidden_units": 48}},
                "decoder_conf": {"attention_heads": 4, "linear_units": 48,
                                 "num_blocks": 1}}}


def recognize_argv(work, engine, inp, flags):
    argv = ["-p", str(work / engine), "-i", str(work / inp), "--feat_dim",
            "16", "--batch_size", "2"]
    if inp == "feats.ark":
        argv += ["-l", str(work / "labels.ark")]
    return argv + flags


# world size -> (case name, engine dir, input, recognize flags)
RECOGNIZE = {
    4: (("greedy", "ep2tp2", "feats.ark", ["-d", "greedy"]),
        ("beam", "ep2tp2", "feats.ark", ["-d", "beam", "-b", "4"]),
        ("long_beam", "ep2tp2", "long.ark", ["-d", "beam", "-b", "4",
                                             "--long_overlap", "16"])),
    2: (("flash_greedy", "ep2flash", "feats.ark", ["-d", "greedy"]),
        ("flash_hier_rescore", "ep2flash", "feats.ark",
         ["-d", "rescore", "-b", "4", "--hier_rescore"])),
}
FLOWS = [(n, c) for n in RECOGNIZE for c in RECOGNIZE[n]]
SERVE_ARGV = ["--stream_slots", "2", "--stream_topk", "4", "--beam_size",
              "4", "--batch_window_ms", "20"]


def feats(seed, T):
    return np.random.default_rng(seed).standard_normal((T, 16)) \
        .astype(np.float32)


def requests():
    """Four offline requests (one past the largest bucket: infer_long)
    and two streams (greedy and beam partials) in uneven pieces."""
    fa, fb, fc, fl = feats(1, 40), feats(2, 60), feats(3, 52), feats(4, 150)
    offline = [{"id": "a", "feat": fa.tolist()},
               {"id": "b", "feat": fb.tolist(), "decode": "beam",
                "beam_size": 4, "nbest": 2},
               {"id": "c", "feat": fc.tolist(), "timestamps": True,
                "confidence": True},
               {"id": "long", "feat": fl.tolist()}]
    streams = []
    for seed, T, decode in ((5, 61, "greedy"), (6, 47, "beam")):
        f = feats(seed, T)
        s = [{"stream": "start", "chunk_size": C, "num_left_chunks": 2,
              "decode": decode, "beam_size": 4, "timestamps": True}]
        for a, b in ((0, 19), (19, 30), (30, T)):
            s.append({"stream": "chunk", "feat": f[a:b].tolist()})
        streams.append(s + [{"stream": "end"}])
    return {"offline": offline, "streams": streams}


def write_inputs(work):
    rng = np.random.RandomState(0)
    with ArkWriter(str(work / "feats.ark")) as w:
        for i in range(3):
            w.write(f"utt{i}", rng.randn(30 + 12 * i, 16).astype(np.float32))
    with ArkWriter(str(work / "long.ark")) as w:
        w.write("uttL", rng.randn(150, 16).astype(np.float32))
        w.write("uttS", rng.randn(40, 16).astype(np.float32))
    with open(work / "labels.ark", "wb") as f:
        for i, lab in enumerate(([1, 2], [3], [2, 2, 4])):
            f.write(f"utt{i} ".encode() + b"\x00B\x04"
                    + struct.pack("<i", len(lab)))
            for x in lab:
                f.write(b"\x04" + struct.pack("<i", x))
    np.save(work / "long.npy", feats(7, 170))
    with open(work / "requests.json", "w") as f:
        json.dump(requests(), f)


def build_dirs(work):
    sd = {f"encoder.{k}": v for k, v in golden_model().state_dict().items()}
    for i, name in enumerate(DECODERS):
        dec = G.randomize_(G.TransformerDecoder(
            V, 32, attention_heads=4, linear_units=48, num_blocks=1),
            seed=70 + i)
        sd.update({f"{name}.{k}": v for k, v in dec.state_dict().items()})
    torch.save(sd, work / "ckpt.pt")
    with open(work / "cfg.yaml", "w") as f:
        yaml.safe_dump(raw_yaml(), f)
    for name, flags in (("unsharded", []), ("ep2tp2", ["--ep", "2", "--tp",
                                                       "2"]),
                        ("ep2flash", ["--ep", "2", "--attn_impl", "flash"])):
        t_build.main(["-c", str(work / "cfg.yaml"), "-m",
                      str(work / "ckpt.pt"), "-o", str(work / name),
                      "--buckets", BUCKETS, "--skip-warmup", "--device",
                      "cpu"] + flags)


def cases(work):
    out = {n: [{"kind": "recognize", "name": name,
                "argv": recognize_argv(work, d, inp, flags)}
               for name, d, inp, flags in RECOGNIZE[n]] for n in RECOGNIZE}
    out[4] += [{"kind": "infer_long", "name": "infer_long",
                "dir": str(work / "ep2tp2"),
                "feat": str(work / "long.npy")},
               {"kind": "serve", "name": "serve",
                "argv": ["-p", str(work / "ep2tp2")] + SERVE_ARGV,
                "requests": str(work / "requests.json")}]
    # the exported ep2 x tp2 dir and its eager twin (built beside the
    # world: each case waits for it)
    for d in ("x_ep2tp2", "x_ep2tp2_plain"):
        out[4] += [{"kind": "recognize", "name": d + "_greedy",
                    "wait": str(work / "exports_done"),
                    "argv": recognize_argv(work, d, "feats.ark",
                                           ["-d", "greedy"])},
                   {"kind": "serve", "name": d + "_serve", "brief": True,
                    "argv": ["-p", str(work / d)] + SERVE_ARGV,
                    "requests": str(work / "requests.json")}]
    out[2] += [{"kind": "refused", "name": "refused",
                "unsharded": recognize_argv(work, "unsharded", "feats.ark",
                                            ["-d", "greedy"]),
                "wrong_size": str(work / "ep2tp2")},
               {"kind": "recognize", "name": "fail", "fail": True,
                "argv": recognize_argv(work, "ep2flash", "long.ark",
                                       ["-d", "attention"])}]
    return out


def start_worlds(work):
    """Both worlds' processes, each read from its start by a thread of
    its own that records (output, returncode or "timeout", the wall
    clock at its exit) in ``logs[(world, rank)]``: (threads, logs)."""
    logs, threads = {}, []

    def wait(n, r, p):
        try:
            out = p.communicate(timeout=JOIN_S)[0]
            logs[(n, r)] = (out, p.returncode, time.time())
        except subprocess.TimeoutExpired:
            p.kill()
            logs[(n, r)] = (p.communicate()[0], "timeout", time.time())
    for n, cs in cases(work).items():
        with open(work / f"cases_{n}.json", "w") as f:
            json.dump(cs, f)
        for r in range(n):
            env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(r),
                       COORDINATOR_ADDRESS=f"file://{work}/store_{n}",
                       OMP_NUM_THREADS="1")
            for v in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE"):
                env.pop(v, None)
            p = subprocess.Popen([sys.executable, WORKER, str(work)],
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            threads.append(threading.Thread(target=wait, args=(n, r, p)))
            threads[-1].start()
    return threads, logs


def _lines(fn, *a):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        fn(*a)
    stats = json.loads(err.getvalue().strip().splitlines()[-1])
    return ([l for l in out.getvalue().splitlines() if l.strip()],
            {k: stats.get(k) for k in ("utts", "frames", "cer")})


def jax_recognize(argv):
    cache = jax.config.jax_compilation_cache_dir
    try:
        return _lines(j_recognize.main, t_recognize.parse_args(argv))
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)


def jax_server_answers(work):
    """The root server on the ep2 x tp2 dir: every conversation one at a
    time."""
    import socketserver
    args = argparse.Namespace(
        plan_name=str(work / "ep2tp2"), host="127.0.0.1", port=0,
        beam_size=4, warmup=False, batch_window_ms=20.0, max_batch=8,
        stream_slots=2, stream_topk=4, stream_window_ms=2.0, lm=None,
        lm_weight=0.5, units=None, drain_secs=1.0)
    state = j_serve._build_runtime(args)
    srv = socketserver.ThreadingTCPServer(
        ("127.0.0.1", 0), j_serve.make_handler(state, 4))
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        reqs = requests()
        return [client(srv, c) for c in
                [[r] for r in reqs["offline"]] + reqs["streams"]]
    finally:
        srv.shutdown()
        srv.server_close()
        state["batcher"].close()


def start_export_build(work):
    """``build --export --ep 2 --tp 2`` of the exported dir, in a process
    of its own; its output and returncode."""
    with open(work / "builds.json", "w") as f:
        json.dump({"args": ["-c", str(work / "cfg.yaml"), "-m",
                            str(work / "ckpt.pt"), "--buckets", "2x64",
                            "--device", "cpu", "--export"],
                   "builds": [{"name": "x_ep2tp2",
                               "flags": ["--ep", "2", "--tp", "2"]}],
                   "mixes": []}, f)
    return subprocess.Popen(
        [sys.executable, BUILD_WORKER, "--build", str(work)],
        env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve_ranks")
    write_inputs(work)
    build_dirs(work)
    build_proc = start_export_build(work)
    threads, logs = start_worlds(work)
    try:          # the references run while the ranks do
        refs = {"jax": {}, "port": {}}
        for n, (name, d, inp, flags) in FLOWS:
            refs["jax"][name] = jax_recognize(recognize_argv(work, d, inp,
                                                             flags))
            refs["port"][name] = _lines(t_recognize.main, recognize_argv(
                work, "unsharded", inp, flags) + ["--device", "cpu"])
        refs["infer_long"] = JEngine.load(str(work / "ep2tp2")).infer_long(
            np.load(work / "long.npy"))
        refs["serve"] = jax_server_answers(work)
    finally:
        for t in threads:
            t.join()
        try:
            logs["build"] = (build_proc.communicate(timeout=JOIN_S)[0],
                             build_proc.returncode)
        except subprocess.TimeoutExpired:
            build_proc.kill()
            logs["build"] = build_proc.communicate()[0], "timeout"
    ranks = {}
    for n, r in [k for k in logs if k != "build"]:
        path = work / f"rank_{n}_{r}.json"
        ranks[(n, r)] = json.loads(path.read_text()) if path.exists() \
            else {}
    return work, refs, ranks, logs


@pytest.mark.parametrize("flow", FLOWS, ids=lambda f: f[1][0])
def test_recognize_on_ranks_equals_jax_and_one_process(worlds, flow):
    """Rank 0's transcripts and stats equal the JAX recognizer's on the
    same sharded dir and the port's one-process run on the unsharded
    dir; only rank 0 writes, and every follower returned on STOP."""
    work, refs, ranks, logs = worlds
    n, (name, _, inp, _) = flow
    got = ranks[(n, 0)][name]
    assert (got["lines"], got["stats"]) == tuple(refs["jax"][name])
    assert (got["lines"], got["stats"]) == tuple(refs["port"][name])
    assert len(got["lines"]) == {"feats.ark": 3, "long.ark": 2}[inp]
    for r in range(1, n):
        f = ranks[(n, r)][name]
        assert f["stdout"] == ""
        assert f["counts"]["STOP"] == 1 and f["counts"]["INFER"] >= 2


def test_infer_long_on_ranks_matches_jax(worlds):
    """infer_long led from rank 0 (every window an INFER the followers
    ran) against the JAX sharded engine."""
    work, refs, ranks, _ = worlds
    got = np.load(work / "infer_long.npy")
    ref, ref_len = refs["infer_long"][:2]
    assert got.shape == np.asarray(ref).shape
    allclose(got[0, :ref_len[0]], np.asarray(ref)[0, :ref_len[0]])
    windows = ranks[(4, 0)]["infer_long"]["calls"]["INFER"]
    assert windows >= 3
    for r in (1, 2, 3):
        assert ranks[(4, r)]["infer_long"]["counts"]["INFER"] == windows


def test_serve_on_ranks_matches_jax(worlds):
    """Every answer rank 0's server gave one at a time (offline greedy,
    beam n-best, timestamps and confidence, a request past the largest
    bucket, two streams) equals the JAX server's on the same dir."""
    _, refs, ranks, _ = worlds
    got = ranks[(4, 0)]["serve"]["alone"]
    assert len(got) == len(refs["serve"]) == 6
    for g, r in zip(got, refs["serve"]):
        assert len(g) == len(r)
        for a, b in zip(g, r):
            assert "error" not in a, a
            same(a, b)


def test_serve_on_ranks_at_once_equals_one_at_a_time(worlds):
    """The requests and stream chunks sent from six threads at once
    (batched by the micro-batcher and the stream batcher, every call
    through the leader's lock) answer as they do one at a time."""
    _, _, ranks, _ = worlds
    s = ranks[(4, 0)]["serve"]
    for g, a in zip(s["together"], s["alone"]):
        for x, y in zip(g, a):
            assert "error" not in x, x
            same(x, y)
    calls = s["calls"]
    assert calls["STREAM_OPEN"] == 2 and calls["STREAM_TICK"] > 0
    assert calls["STREAM_RESET"] > 0 and calls["STOP"] == 1


def test_malformed_requests_are_refused_and_serving_goes_on(worlds):
    """A request of the wrong feature width (in a bucket and past the
    largest), a stream start of chunk_size 0 or num_left_chunks -1 and a
    stream chunk of the wrong width are answered with an error before
    any call reaches the ranks; the good request or stream that follows
    each on its connection answers as it did before, and every rank
    serves on (the reload after them is followed, every rank exits 0)."""
    _, _, ranks, _ = worlds
    s = ranks[(4, 0)]["serve"]
    bad = s["malformed"]
    assert [len(c) for c in bad] == [2, 2, 6, 6, 2]
    for conv in bad[:4]:
        assert "error" in conv[0], conv[0]
    assert "feat must be (B, T, 16)" in bad[0][0]["error"]
    assert "chunk_size must be >= 1" in bad[2][0]["error"]
    assert "num_left_chunks >= 0" in bad[3][0]["error"]
    assert "ok" in bad[4][0] and "error" in bad[4][1], bad[4]
    for conv in bad[:2]:
        same(conv[1], s["alone"][0][0])
    for conv in bad[2:4]:
        for x, y in zip(conv[1:], s["alone"][4]):
            same(x, y)
    for r in (1, 2, 3):
        assert ranks[(4, r)]["serve"]["counts"]["STOP"] == 1


def test_stream_caches_hold_local_heads(worlds):
    """Under tp=2 the main blocks' K/V caches hold 2 of the 4 heads on
    every rank; the replicated embed sub-encoder's hold all 4."""
    _, _, ranks, _ = worlds
    s = ranks[(4, 0)]["serve"]
    # rank 0 before and after the reload; the followers' after it
    for caches in [s["caches"], s["caches_reloaded"]] + [
            ranks[(4, r)]["serve"]["caches"] for r in (1, 2, 3)]:
        shapes = caches[str((C, 2))]
        # offsets, att, cnn of the main blocks, then the embed's
        assert shapes[1] == [2, 2, 2, 2 * C, 16]
        assert shapes[4] == [1, 2, 4, 2 * C, 12]


def test_reload_is_followed(worlds):
    """RELOAD: every follower rebuilt its runtime at rank 0's; the first
    request and stream answer as before, and every follower returned on
    STOP."""
    _, _, ranks, _ = worlds
    s = ranks[(4, 0)]["serve"]
    assert s["calls"]["RELOAD"] == 1
    # the first offline request and the first stream (conversation 4)
    for g, a in zip(s["reloaded"], (s["alone"][0], s["alone"][4])):
        for x, y in zip(g, a):
            same(x, y)
    for r in (1, 2, 3):
        counts = ranks[(4, r)]["serve"]["counts"]
        assert counts["RELOAD"] == 1 and counts["STOP"] == 1
        assert {k: v for k, v in counts.items() if k != "RELOAD"} == {
            k: v for k, v in s["calls"].items() if k != "RELOAD"}


def test_every_rank_exits_zero_after_stop(worlds):
    _, _, ranks, logs = worlds
    for r in range(4):
        out, rc, _ = logs[(4, r)]
        assert rc == 0, f"rank {r}: {rc}\n{out[-3000:]}"


def test_world_that_does_not_fit_the_dir_raises(worlds):
    """On 2 ranks: the unsharded dir and the ep2 x tp2 dir (4 shards)
    raise on every rank, before any call."""
    _, _, ranks, _ = worlds
    for r in range(2):
        msgs = ranks[(2, r)]["refused"]
        assert "this engine is unsharded" in msgs["unsharded"]
        assert "needs a world of 4 ranks, not 2" in msgs["wrong_size"]


def test_rank0_error_ends_every_rank(worlds):
    """A rank-0 error (attention decoding past the largest bucket exits
    inside the loop) sends STOP with failed: every rank of the world
    exits non-zero within FAIL_S seconds of it, rank 0 with its error,
    the follower on the STOP."""
    work, _, _, logs = worlds
    t0 = float((work / "fail_t0_2").read_text())
    for r in range(2):
        out, rc, end = logs[(2, r)]
        assert rc not in (0, "timeout"), f"rank {r}: {rc}\n{out[-3000:]}"
        assert end - t0 < FAIL_S, (r, end - t0)
    assert "standalone attention decode" in logs[(2, 0)][0]
    assert "rank 0 stopped the world after an error" in logs[(2, 1)][0]


def test_exported_sharded_dir_on_ranks_answers_as_unexported(worlds):
    """build --export --ep 2 --tp 2 (one process), then recognize and
    serve on 4 ranks through the leader and follower loops: every rank
    runs its loaded program of the bucket (none on the twin without
    exported/), and rank 0's transcripts, stats and server answers equal
    the twin's."""
    _, _, ranks, logs = worlds
    assert logs["build"][1] == 0, logs["build"][0][-3000:]
    for kind in ("greedy", "serve"):
        for r in range(4):
            assert ranks[(4, r)][f"x_ep2tp2_{kind}"]["loaded"] == [[2, 64]]
            assert ranks[(4, r)][f"x_ep2tp2_plain_{kind}"]["loaded"] == []
    got, ref = ranks[(4, 0)]["x_ep2tp2_greedy"], \
        ranks[(4, 0)]["x_ep2tp2_plain_greedy"]
    assert (got["lines"], got["stats"]) == (ref["lines"], ref["stats"])
    assert len(got["lines"]) == 3
    got, ref = ranks[(4, 0)]["x_ep2tp2_serve"]["alone"], \
        ranks[(4, 0)]["x_ep2tp2_plain_serve"]["alone"]
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert "error" not in g[0], g
        same(g[0], r[0])
