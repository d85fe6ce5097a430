"""The whole step's share of the H100's bf16 peak over the traced window
of the offline cell(s): the model operations of the work done (its valid
frames, from the configuration's shapes) over peak x window, in %."""

from port_bench.metrics import shares


def read(run):
    return shares.mfu(run)
