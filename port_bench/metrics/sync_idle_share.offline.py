"""Device idle time in the traced window during which the program was
waiting for the card in ``engine.sync`` (its own spans), over the
window, in %: gaps inside the replayed graph and its copies."""

from port_bench.metrics import program_spans


def read(run):
    split = program_spans.idle_split(run)
    return None if split is None else 100.0 * split[1] / split[2]
