"""The control channel of the port's sharded serving loops
(``parallel/follow.py``) and the stream forward under a one-rank mesh,
on the CPU in one process.

The channel's unit tests pass the leader's broadcasts to a follower loop
through an in-process pipe in place of the gloo group: each op's header
round trip, the refusal of an unknown op, every op reaching the
follower's engine and mirror batchers with its payload intact, STOP and
STOP after an error, a stale runtime's calls refused after RELOAD, and a
failed call breaking the leader. The stream forward of the small hier
MoE conformer of tests/test_torch_outputs.py under a mesh of one rank
must be bit-equal to the forward without one (no mesh: full heads, no
collective). The multi-rank loops are tests/test_torch_serve_ranks.py's.
"""

import queue
import threading

import numpy as np
import pytest
import torch

from m3asr_tpu_torch.checkpoint import to_torch
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.models import streaming as t_stream
from m3asr_tpu_torch.parallel import follow
from m3asr_tpu_torch.parallel import mesh as pmesh
from m3asr_tpu_torch.runtime import streaming_session as t_session
from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

from test_torch_outputs import random_params, small_yaml

FIELDS = {follow.INFER: (2, 48, 16, 3),
          follow.STREAM_OPEN: (16, 2),
          follow.STREAM_RESET: (16, 2, 3),
          follow.STREAM_TICK: (16, 2, 8, 67, 80),
          follow.RELOAD: (),
          follow.STOP: (1,)}


class Pipe:
    """One end of an in-process channel with World's interface: rank 0
    sends, rank 1 receives (shapes and dtypes checked)."""

    def __init__(self, rank, q):
        self.rank, self.size, self.q = rank, 2, q

    def send(self, t):
        self.q.put(t.clone())

    def recv(self, shape, dtype):
        t = self.q.get(timeout=10)
        assert tuple(t.shape) == tuple(shape) and t.dtype == dtype
        return t


class FakeEngine:
    def __init__(self, name):
        self.name, self.calls = name, []

    def infer(self, feat, feat_len, out_mode=None):
        self.calls.append((feat.copy(), feat_len.copy(), out_mode))


class FakeMirror:
    def __init__(self, key):
        self.key, self.ticks, self.resets = key, [], []

    def mirror_tick(self, windows, mask):
        self.ticks.append((windows.copy(), mask.copy()))

    def mirror_reset(self, slots):
        self.resets.append(list(slots))


def pipe():
    q = queue.Queue()
    return Pipe(0, q), Pipe(1, q)


@pytest.mark.parametrize("op", sorted(FIELDS), ids=lambda o: follow.OPS[o])
def test_header_round_trip(op):
    h = follow.encode(op, *FIELDS[op])
    assert h.shape == (follow.HEADER_LEN,) and h.dtype == torch.int64
    got, fields = follow.decode(h)
    assert got == op
    assert fields == FIELDS[op] + (0,) * (follow.HEADER_LEN - 1
                                          - len(FIELDS[op]))


def test_unknown_op_refused():
    for bad in (0, 7, -1, 99):
        with pytest.raises(ValueError, match="unknown control op"):
            follow.encode(bad)
        h = follow.encode(follow.STOP)
        h[0] = bad
        with pytest.raises(ValueError, match="unknown control op"):
            follow.decode(h)
    with pytest.raises(ValueError, match="fields"):
        follow.encode(follow.INFER, *range(follow.HEADER_LEN))
    # a follower receiving one raises, whatever it was doing
    lead, foll = pipe()
    h = follow.encode(follow.STOP)
    h[0] = 42
    lead.send(h)
    with pytest.raises(ValueError, match="unknown control op 42"):
        follow.follow(foll, FakeEngine("e"))


def test_every_op_reaches_the_follower():
    """INFER (the request, its lengths and the out_mode), STREAM_OPEN,
    STREAM_TICK (windows and mask), STREAM_RESET (the slots), RELOAD
    (the runtime swapped: later calls reach the new engine and
    batchers), then STOP: the loop returns its op counts."""
    lead, foll = pipe()
    leader = follow.Leader(lead)
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((2, 5, 3)).astype(np.float32)
    lens = np.array([5, 3], np.int32)
    windows = rng.standard_normal((2, 7, 3)).astype(np.float32)
    mask = np.array([True, False])
    ran = []
    with leader.infer(feat, lens, 2):                 # "argmax"
        ran.append("infer")
    with leader.call(follow.STREAM_OPEN, (4, 2)):
        ran.append("open")
    with leader.call(follow.STREAM_TICK, (4, 2) + windows.shape,
                     (torch.from_numpy(windows),
                      torch.from_numpy(mask.astype(np.uint8)))):
        ran.append("tick")
    with leader.call(follow.STREAM_RESET, (4, 2, 2),
                     (torch.tensor([1, 0]),)):
        ran.append("reset")
    with leader.reload():
        ran.append("reload")
    with leader.infer(feat[:1], lens[:1], 0):
        ran.append("infer")
    leader.stop()
    assert ran == ["infer", "open", "tick", "reset", "reload", "infer"]

    first, second = FakeEngine("first"), FakeEngine("second")
    mirrors = {}
    counts = follow.follow(
        foll, first, mirrors, lambda c, l: FakeMirror((c, l)),
        lambda: (second, {}, None))
    assert counts == {"INFER": 2, "STREAM_OPEN": 1, "STREAM_RESET": 1,
                      "STREAM_TICK": 1, "RELOAD": 1, "STOP": 1}
    assert counts == leader.calls
    (f, l, mode), = first.calls
    np.testing.assert_array_equal(f, feat)
    np.testing.assert_array_equal(l, lens)
    assert mode == "argmax"
    (f, l, mode), = second.calls
    np.testing.assert_array_equal(f, feat[:1])
    assert mode == "logits"
    m = mirrors[(4, 2)]
    (w, k), = m.ticks
    np.testing.assert_array_equal(w, windows)
    np.testing.assert_array_equal(k, mask)
    assert m.resets == [[1, 0]]
    with pytest.raises(RuntimeError, match="sent STOP"):
        with leader.call(follow.STREAM_OPEN, (4, 2)):
            pass


def test_stop_after_an_error_raises_on_the_followers():
    lead, foll = pipe()
    follow.Leader(lead).stop(failed=True)
    with pytest.raises(RuntimeError, match="stopped the world after an "
                                           "error"):
        follow.follow(foll, FakeEngine("e"))


def test_stale_runtime_and_broken_leader():
    """After RELOAD a call of the runtime led before is refused and sends
    nothing; a failed local call breaks the leader: later calls raise,
    and STOP goes out with failed."""
    lead, foll = pipe()
    broken = []
    leader = follow.Leader(lead)
    leader.on_broken = broken.append
    old = leader.generation
    with leader.reload():
        pass
    foll.recv((follow.HEADER_LEN,), torch.int64)             # RELOAD
    feat, lens = np.zeros((1, 2, 3), np.float32), np.array([2], np.int32)
    with pytest.raises(RuntimeError, match="replaced by a reload"):
        with leader.infer(feat, lens, 0, generation=old):
            pass
    assert lead.q.empty() and not broken
    with pytest.raises(ZeroDivisionError):
        with leader.infer(feat, lens, 0, generation=leader.generation):
            1 / 0
    assert len(broken) == 1 and isinstance(leader.broken, ZeroDivisionError)
    with pytest.raises(follow.LeaderBroken):
        with leader.call(follow.STREAM_OPEN, (4, 2)):
            pass
    leader.stop()
    with pytest.raises(RuntimeError, match="after an error"):
        follow.follow(foll, FakeEngine("e"))   # INFER, then STOP failed


def test_deferred_reset_across_a_stale_tick_wakes_its_waiters():
    """A slot reset asked for during a tick (deferred after it) of a
    batcher whose runtime a RELOAD made stale: the tick and the deferred
    reset both raise on the stale generation, yet the push waiting on
    that tick wakes with the error, the tick thread lives on (a second
    push raises as well), and nothing goes out after the RELOAD."""
    from m3asr_tpu_torch.runtime.streaming_batch import StreamBatcher
    lead, _ = pipe()
    leader = follow.Leader(lead)
    cfg = t_config(small_yaml()).encoder_conf
    b = StreamBatcher(to_torch(random_params(5)), cfg, input_dim=20,
                      chunk_size=4, num_left_chunks=2, slots=2, moe=True)
    b.lead(leader, (4, 2))
    with leader.reload():
        pass
    lead.q.get_nowait()                                       # RELOAD
    tick = b._tick

    def tick_with_reset(windows, mask):
        b.reset_slot(1)                  # during the tick: deferred
        return tick(windows, mask)
    b._tick = tick_with_reset
    slot = b.open_slot()
    window = np.zeros((1, b.window_frames, 20), np.float32)
    errors = []

    def push():
        try:
            b.push(slot, window)
        except RuntimeError as e:
            errors.append(str(e))
    for _ in range(2):
        th = threading.Thread(target=push, daemon=True)
        th.start()
        th.join(timeout=20)
        assert not th.is_alive(), "the push never woke"
    assert len(errors) == 2 and all("replaced by a reload" in e
                                    for e in errors)
    assert b._deferred_resets == {1} and lead.q.empty()
    assert leader.broken is None
    b.close()


def test_leader_is_rank_zero_and_leads_sharded_engines_only():
    with pytest.raises(ValueError, match="rank 0"):
        follow.Leader(Pipe(1, queue.Queue()))
    eng = Engine(t_config(small_yaml()), random_params(3),
                 EngineConfig(bucket_lengths=(32,), bucket_batches=(1,)),
                 device="cpu")
    with pytest.raises(ValueError, match="sharded"):
        eng.lead(follow.Leader(Pipe(0, queue.Queue())))
    follow.check_world(None, eng)
    follow.check_world(follow.World(0, 1), eng)
    with pytest.raises(RuntimeError, match="this engine is unsharded"):
        follow.check_world(follow.World(0, 2), eng)


def test_stream_forward_under_one_rank_mesh_is_bit_equal():
    """forward_chunk_moe under a mesh of one rank (every axis of size 1:
    no collective, all heads) equals the forward without a mesh bit for
    bit over four chunks of two batched streams, caches included; the
    caches hold all heads (``local_heads`` of the whole tree)."""
    cfg = t_config(small_yaml()).encoder_conf
    params = to_torch(random_params(5))
    mesh = pmesh.make_mesh(dp=1, world_size=1, rank=0)
    assert t_stream.local_heads(params["blocks"]) == cfg.attention_heads
    feat = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 4 * 4 * 4 + 3, 20)).astype(np.float32))

    def run(m):
        st = t_session.state_tensors(cfg, True, 2, 8, True, torch.float32,
                                     torch.device("cpu"), params)
        assert st[1].shape[2] == cfg.attention_heads
        state, e_state = t_stream.StreamState(*st[:3]), \
            t_stream.StreamState(*st[3:])
        outs = []
        with pmesh.sharded(m):
            for i in range(4):
                w = feat[:, 16 * i:16 * i + 19]
                o, state, e_state = t_stream.forward_chunk_moe(
                    params, cfg, w, state, e_state, moe_impl="dense")
                outs.append(o)
        return torch.cat(outs, 1), state.tensors() + e_state.tensors()

    ref, ref_st = run(None)
    got, got_st = run(mesh)
    assert torch.equal(got, ref)
    for a, b in zip(got_st, ref_st):
        assert torch.equal(a, b)
