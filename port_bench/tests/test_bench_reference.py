"""The plain reference against the port's plain path (its CPU engine,
whose kernel stages run their plain PyTorch versions), at tiny sizes:
the same tree, the same features, float32. The tree the benchmark draws
has the layout of the port's own ``init``."""

import copy

import numpy as np
import pytest
import torch

from port_bench.harness import weights
from port_bench.reference import moe_conformer
from port_bench.tests import tiny

TOL = 1e-5          # float32, summation order only


def _port_model(raw):
    from m3asr_tpu_torch.config import model_config_from_dict
    return model_config_from_dict(copy.deepcopy(raw))


def _shapes(tree):
    from m3asr_tpu_torch.checkpoint import flatten_tree
    return {k: tuple(v.shape) for k, v in flatten_tree(tree).items()}


def test_layout_is_the_ports():
    from m3asr_tpu_torch.models.registry import get_family
    raw = tiny.flagship_model()
    mc = _port_model(raw)
    port = get_family(mc.nnet_proto).init(mc, torch.Generator().manual_seed(0))
    ours = weights.make(moe_conformer.layout(raw), 5, torch.float32, "cpu")
    assert _shapes(ours) == _shapes(port)


@pytest.mark.parametrize("lens", [(200, 137, 90), (41, 400, 300)])
def test_offline_forward_matches_the_port(lens):
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig
    raw = tiny.flagship_model()
    params = weights.make(moe_conformer.layout(raw), 11, torch.float32,
                          "cpu")
    eng = Engine(_port_model(raw), params, EngineConfig(dtype="float32"),
                 device="cpu")
    lens = np.array(lens, np.int32)
    feat = np.random.default_rng(0).standard_normal(
        (len(lens), int(lens.max()), 40)).astype(np.float32)
    out, out_len = eng.infer(feat, lens)
    for i, n in enumerate(lens):
        ref = moe_conformer.forward(params, raw,
                                    torch.from_numpy(feat[i, :n]))
        got = torch.from_numpy(out[i, :out_len[i]])
        assert got.shape == ref.shape
        assert (got - ref).abs().max().item() <= TOL * ref.abs().max().item()


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys
    code = ("import sys; import port_bench.reference.moe_conformer; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('m3asr_tpu_torch', 'm3asr_tpu', 'jax')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    import os
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("kind", ["float32", "fp8"])
def test_batched_experts_are_each_experts_own(kind):
    """The batched expert product against one expert at a time, each
    expert's operands rounded alone."""
    from port_bench.reference.common import Precision, swish, top1_experts
    g = torch.Generator().manual_seed(0)
    E, d, h, N = 4, 16, 32, 37
    p = {"router": {"kernel": torch.randn(2 * d, E, generator=g)},
         "w1": torch.randn(E, d, h, generator=g),
         "b1": torch.randn(E, h, generator=g),
         "w2": torch.randn(E, h, d, generator=g),
         "b2": torch.randn(E, d, generator=g)}
    x = torch.randn(N, d, generator=g)
    router_in = torch.cat([torch.randn(N, d, generator=g), x], -1)
    prec = Precision(kind)
    y, idx = top1_experts(p, x, router_in, prec, swish)
    logits = prec.q(router_in) @ prec.q(p["router"]["kernel"])
    assert torch.equal(idx, logits.argmax(-1))
    gate = torch.softmax(logits, -1)
    for e in range(E):
        rows = (idx == e).nonzero(as_tuple=True)[0]
        if not len(rows):
            continue
        hh = swish(prec.q(x[rows]) @ prec.q(p["w1"][e]) + p["b1"][e])
        want = (prec.q(hh) @ prec.q(p["w2"][e]) + p["b2"][e]) \
            * gate[rows, e:e + 1]
        assert torch.allclose(y[rows], want, rtol=1e-5, atol=1e-5)
