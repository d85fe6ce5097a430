"""The yardstick's arithmetic against hand counts at one shape, the
model counts against the products the plain reference runs
(``torch.utils.flop_counter``), and K1's roofline over the experts the
tokens route to."""

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.harness import bench, drivers, runner, traffic, weights
from port_bench.harness.trace import Spans
from port_bench.metrics import costs, shares
from port_bench.reference.common import Precision
from port_bench.tests import tiny


def test_peaks():
    assert costs.PEAK_OPS_PER_S["bfloat16"] == 989e12
    assert costs.HBM_BYTES_PER_S == 3.35e12


def test_k1_by_hand():
    # 1,000 tokens, d 512, h 1024, 32 experts, bf16: 4 * 1000 * 512 * 1024
    # operations; bytes 32 * (2 * 512 * 1024 + 1024 + 512) * 2 weights,
    # 2 * 1000 * 512 * 2 tokens in and out, 4 * 1000 expert indices
    ops, nbytes = costs.k1_cost(1000, 512, 1024, 32, "bfloat16")
    assert ops == 2_097_152_000
    assert nbytes == 67_207_168 + 2_048_000 + 4_000
    least = costs.least_s(ops, nbytes, "bfloat16")
    assert least == pytest.approx(69_259_168 / 3.35e12)   # bytes bound


def test_k2_by_hand():
    # rel-pos: 100 frames, 8 heads of 64: 2 * 8 * 100^2 * 192 operations;
    # q2, k2 (128 each), v, out (64 each) in bf16, lse float32
    ops, nbytes = costs.k2_rel_cost(100, 8, 64, "bfloat16")
    assert ops == 30_720_000
    assert nbytes == 2 * 8 * 100 * 384 + 4 * 8 * 100


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_flagship_counts_match_the_reference():
    raw = tiny.flagship_model()
    ref, cnt = bench.reference("moe_conformer"), bench.counts("moe_conformer")
    p = weights.make(ref.layout(raw), 1, torch.float32, "cpu")
    T = 173
    feat = torch.randn(T, 40)
    routes = []
    n = _counted(lambda: ref.forward(p, raw, feat, routes=routes))
    # the reference's expert products run over each expert's rows padded
    # with zero rows to the fullest expert's count: the model's operations
    # and those of the padding rows
    _, d, h, E = cnt.k1_layers(raw)
    pad = sum(E * int(torch.bincount(r, minlength=E).max()) - len(r)
              for r in routes)
    assert cnt.utterance(raw, T) + pad * 2 * 2 * d * h == n


def test_k1_layers():
    raw = tiny.flagship_model()
    assert bench.counts("moe_conformer").k1_layers(raw) == (2, 32, 64, 4)


def test_k2_layers():
    # the embed encoder's 1 block of 2 heads, then 2 blocks of 4, d 32
    assert bench.counts("moe_conformer").k2_layers(tiny.flagship_model()) \
        == [(2, 16), (4, 8), (4, 8)]


class _Trace:
    def kernel_s(self, *parts):
        return 1e-3


def test_k1_roofline_counts_the_experts_routed_to():
    raw = tiny.flagship_model()
    # two calls of two utterances of 173 frames; per MoE layer, the first
    # call's tokens reach 1 and 3 experts, the second's 4 and 2
    calls = [([0, 1], [173, 173], (4, 256)), ([2, 3], [173, 173], (4, 256))]
    run = types.SimpleNamespace(
        trace=_Trace(), res=types.SimpleNamespace(calls=calls),
        active=[[1, 3], [4, 2]], counts=bench.counts("moe_conformer"),
        cell=types.SimpleNamespace(model=raw), dtype="bfloat16")
    tok = 2 * bench.counts("moe_conformer").sub4(173)
    want = sum(costs.least_s(*costs.k1_cost(tok, 32, 64, e, "bfloat16"),
                             "bfloat16") for e in (1, 3, 4, 2))
    assert shares.k1_roofline(run) == pytest.approx(100 * want / 1e-3)
    run.active = []                     # no routing read: no number
    assert shares.k1_roofline(run) is None


def test_active_experts_are_the_reference_routing():
    wl = {"name": "tiny", "config": "asr18l32e-bf16-flash",
          "traffic": "offline-mixed", "chips": 1}
    cell = runner.cell_of(wl, 5, "cpu", tiny.config(wl["config"]),
                          tiny.mix(wl["traffic"]))
    drv = drivers.Offline(cell, Spans())
    drv.lengths, batches = traffic.offline_corpus(cell.mix, cell.seed)
    drv.features = traffic.Features(cell.seed, cell.idim)
    drv.params = drivers.make_params(cell)
    calls = [([int(u) for u in b], drv.lengths[b].tolist(), None)
             for b in batches[:3]]
    got = drv.active_experts(calls, Precision())
    for (ids, lens, _), active in zip(calls, got):
        hit = [set(), set()]
        for u, T in zip(ids, lens):
            routes = []
            cell.reference.forward(
                drv.params, cell.model,
                torch.from_numpy(drv.features.utterance(u, T)),
                routes=routes)
            for layer, r in enumerate(routes):
                hit[layer] |= set(r.tolist())
        assert active == [len(h) for h in hit]
