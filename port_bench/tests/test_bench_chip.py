"""On the card (``python -m pytest port_bench/tests -m chip``): each
cell's control, the float32 reference rounded to float8 in the
program's place, comes out not correct on three seeds at the cell's own
size, and a sound run of the same cell comes out correct. Skips where
there is no card, deciding inside each test."""

import json
import os
import subprocess
import sys

import pytest

from port_bench.harness import bench

ROOT = bench.ROOT
CELLS = [w["name"] for w in bench.benchmark()["workloads"]]
SEEDS = (2147483701, 2147483702, 2147483703)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _run(cell, seed, control):
    r = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "10", "--trace", "0", "--control",
         str(int(control))], cwd=ROOT, capture_output=True, text=True,
        timeout=1500, env=dict(os.environ))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    assert _run(cell, SEEDS[0], control=False)["correct"]
    for seed in SEEDS:
        assert not _run(cell, seed, control=True)["correct"]
