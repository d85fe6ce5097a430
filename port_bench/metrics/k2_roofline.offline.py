"""K2's share of its roofline in the offline cells: the least time of
the flash attention's calls at the valid lengths over
``flash_fwd_kernel``'s device time in the traced window, in %."""

from port_bench.metrics import shares


def read(run):
    return shares.k2_roofline(run)
