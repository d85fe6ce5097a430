"""Device idle time in the traced window during which the program was
not waiting for the card in ``engine.sync`` (its own spans), over the
window, in %: idle that the host caused."""

from port_bench.metrics import program_spans


def read(run):
    split = program_spans.idle_split(run)
    return None if split is None else 100.0 * split[0] / split[2]
