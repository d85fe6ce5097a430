"""The device's idle share of the traced window (offline cells): one less
the union of the profiler's device events over the window, in %."""

from port_bench.metrics import shares


def read(run):
    return shares.idle(run)
