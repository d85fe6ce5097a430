"""One rank of a gloo world that runs the port's recognizer and server on
an ep/tp engine dir, for tests/test_torch_serve_ranks.py (pytest does not
collect this file).

    COORDINATOR_ADDRESS=file:///tmp/x/store WORLD_SIZE=4 RANK=r \\
        python tests/torch_serve_worker.py WORK_DIR

WORK_DIR holds ``cases_{world}.json``, a list of cases, each run by every
rank in order through the port's own entry points:

* ``recognize``: ``recognize.main(argv)``; rank 0 keeps its transcript
  lines and stats, the others their follower loop's op counts and what
  they printed. With ``fail`` the case is the world's last and ends every
  rank with an error: rank 0 writes ``fail_t0_{world}`` (the wall clock)
  first.
* ``infer_long``: ``Engine.load`` on every rank, rank 0 leading
  ``infer_long`` on ``feat``, the followers in ``follow``; rank 0 saves
  the output as ``{name}.npy``.
* ``serve``: ``serve._build_runtime`` on every rank; rank 0 leads it
  behind a loopback listener and sends the requests of ``requests``
  (offline requests and streams, all at once from one thread each, then
  one at a time), then malformed requests (:func:`bad_requests`), reloads
  the runtime (RELOAD) and sends the first request and stream again; the
  followers run ``serve.follow_runtime``.
  Every rank records its stream batchers' state shapes.
* ``refused``: ``recognize.main`` on the unsharded dir ``unsharded`` and
  ``Engine.load`` of the dir ``wrong_size``; each must raise on every
  rank (the messages are kept).

Each rank rewrites ``rank_{world}_{rank}.json`` after every case.
Imports only torch and the port; one CPU thread a rank.
"""

import contextlib
import io
import json
import os
import socket
import socketserver
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from m3asr_tpu_torch import recognize  # noqa: E402
from m3asr_tpu_torch import serve as t_serve  # noqa: E402
from m3asr_tpu_torch.parallel import distributed, follow  # noqa: E402
from m3asr_tpu_torch.runtime.engine import Engine  # noqa: E402

TIMEOUT_S = 60.0         # rendezvous and every collective of the forward


def client(port, reqs):
    """One connection's requests, in order; the answers without their
    latency."""
    with socket.create_connection(("127.0.0.1", port)) as sock:
        f = sock.makefile("rwb")
        out = []
        for r in reqs:
            f.write((json.dumps(r) + "\n").encode())
            f.flush()
            got = json.loads(f.readline())
            got.pop("latency_ms", None)
            out.append(got)
        return out


def at_once(port, conversations):
    """Every conversation on its own connection and thread, all at
    once."""
    out = [None] * len(conversations)

    def run(i):
        out[i] = client(port, conversations[i])
    ths = [threading.Thread(target=run, args=(i,))
           for i in range(len(conversations))]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    return out


def cache_shapes(runtime):
    """{key: the shapes of each stream batcher's state tensors}."""
    return {str(k): [list(t.shape) for t in b._prog.inputs[2:]]
            for k, b in runtime["stream_batchers"].items()}


def recognize_case(work, case, n, rank, res):
    if case.get("fail") and rank == 0:
        with open(os.path.join(work, f"fail_t0_{n}"), "w") as f:
            f.write(repr(time.time()))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        got = recognize.main(case["argv"] + ["--device", "cpu"])
    if rank == 0:
        res[case["name"]] = {
            "lines": [l for l in out.getvalue().splitlines() if l.strip()],
            "stats": {k: got.get(k) for k in ("utts", "frames", "cer")}}
    else:
        res[case["name"]] = {"counts": got, "stdout": out.getvalue()}


def infer_long_case(work, case, n, rank, res):
    world = follow.join_world()
    eng = Engine.load(case["dir"], device="cpu")
    if rank:
        res[case["name"]] = {"counts": follow.follow(world, eng)}
        return
    leader = follow.Leader(world)
    eng.lead(leader)
    try:
        out = eng.infer_long(np.load(case["feat"]))
    except BaseException:
        leader.stop(failed=True)
        raise
    leader.stop()
    np.save(os.path.join(work, case["name"] + ".npy"), out[0])
    res[case["name"]] = {"calls": leader.calls}


def bad_requests(reqs):
    """Conversations of malformed requests, each followed by a good one
    on the same connection: a request of the wrong feature width (in a
    bucket, then past the largest), a stream start of chunk_size 0 and
    one of num_left_chunks -1, then a stream chunk of the wrong width."""
    width = len(reqs["offline"][0]["feat"][0])
    wide = np.zeros((40, width + 4), np.float32).tolist()
    stream = reqs["streams"][0]
    return [[{"id": "w", "feat": wide}, reqs["offline"][0]],
            [{"id": "wl", "feat": np.zeros((150, width + 4)).tolist()},
             reqs["offline"][0]],
            [dict(stream[0], chunk_size=0)] + stream,
            [dict(stream[0], num_left_chunks=-1)] + stream,
            [stream[0], {"stream": "chunk", "feat": wide}]]


def serve_case(work, case, n, rank, res):
    args = t_serve.parser().parse_args(case["argv"] + ["--device", "cpu"])
    world = follow.join_world()
    state = t_serve._build_runtime(args, follower=rank > 0)
    follow.check_world(world, state["engine"])
    if rank:
        counts = t_serve.follow_runtime(world, state, args)
        res[case["name"]] = {"counts": counts,
                             "caches": cache_shapes(state)}
        return
    with open(case["requests"]) as f:
        reqs = json.load(f)
    convs = [[r] for r in reqs["offline"]] + reqs["streams"]
    leader = follow.Leader(world)
    t_serve.lead_runtime(state, leader)
    srv = socketserver.ThreadingTCPServer(
        ("127.0.0.1", 0), t_serve.make_handler(state, 4))
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    try:
        together = at_once(port, convs)
        alone = [client(port, c) for c in convs]
        malformed = [client(port, c) for c in bad_requests(reqs)]
        caches = cache_shapes(state)
        t_serve.reload_runtime(state, args, leader)
        reloaded = [client(port, c) for c in (convs[0], reqs["streams"][0])]
    except BaseException:
        leader.stop(failed=True)
        raise
    finally:
        srv.shutdown()
        srv.server_close()
    leader.stop()
    res[case["name"]] = {"together": together, "alone": alone,
                         "malformed": malformed,
                         "reloaded": reloaded, "caches": caches,
                         "caches_reloaded": cache_shapes(state),
                         "calls": leader.calls}


def refused_case(work, case, n, rank, res):
    """What a world that does not fit the dir raises on this rank."""
    msgs = {}
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            recognize.main(case["unsharded"] + ["--device", "cpu"])
    except RuntimeError as e:
        msgs["unsharded"] = str(e)
    try:
        Engine.load(case["wrong_size"], device="cpu")
    except RuntimeError as e:
        msgs["wrong_size"] = str(e)
    res[case["name"]] = msgs


CASES = {"recognize": recognize_case, "infer_long": infer_long_case,
         "serve": serve_case, "refused": refused_case}


def main():
    work = sys.argv[1]
    if not distributed.initialize(timeout_s=TIMEOUT_S):
        raise SystemExit("no torch.distributed env")
    import torch.distributed as dist
    n, rank = dist.get_world_size(), dist.get_rank()
    with open(os.path.join(work, f"cases_{n}.json")) as f:
        cases = json.load(f)
    res = {}
    for case in cases:
        t0 = time.perf_counter()
        CASES[case["kind"]](work, case, n, rank, res)
        res[case["name"]]["seconds"] = time.perf_counter() - t0
        with open(os.path.join(work, f"rank_{n}_{rank}.json"), "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
