"""A run with the timed path broken underneath comes out not correct at
the cells' own limits, and the control (the reference in float8 in the
program's place) comes out not correct at the float32 limits of the tiny
sizes. On the CPU: the harness's look for a card is skipped
(``runner.run`` is called with ``device="cpu"``) and the rest of a run
is driven as on the card, on the tiny configurations of ``tiny.py``."""

import time

import numpy as np
import pytest

from port_bench.harness import bench, runner
from port_bench.tests import tiny

CELLS = [w["name"] for w in bench.benchmark()["workloads"]]


def _run(cell, control=False, own_limits=False, seed=2147483661):
    spec = bench.benchmark()
    wl = bench.workload(spec, cell)
    out = runner.run(wl, seed, 0.5, False, "cpu",
                     start=time.perf_counter(), spec=spec, control=control,
                     config=tiny.config(wl["config"]),
                     mix=tiny.mix(wl["traffic"]),
                     limits=bench.limits(cell) if own_limits
                     else tiny.LIMITS)
    return out["result"]


def _half_left_out(out):
    out = np.array(out, copy=True)
    out[out.shape[0] // 2:] = 0.0
    return out


def _altered(out):
    return np.ascontiguousarray(out[:, ::-1])   # each answer's frames reversed


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_at_the_cells_limits(cell):
    assert _run(cell, own_limits=True)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    assert not _run(cell, control=True)["correct"]


@pytest.mark.parametrize("fault", [_half_left_out, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    from m3asr_tpu_torch.runtime.engine import Engine
    inner = Engine.infer

    def infer(self, feat, feat_len, out_mode=None):
        out = inner(self, feat, feat_len, out_mode)
        return (fault(out[0]),) + tuple(out[1:])
    monkeypatch.setattr(Engine, "infer", infer)
    assert not _run(cell, own_limits=True)["correct"]
