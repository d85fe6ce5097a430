"""The benchmark's tests: ``python -m pytest port_bench/tests -q``.
Tests marked ``chip`` need an NVIDIA card and skip without one; each
decides that inside itself."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card (skips without one)")
