"""K1's share of its roofline in the offline cells: the least time of
its calls (bytes of the active experts' weights and of the tokens in and
out at 3.35 TB/s, or operations at the bf16 peak, the larger) over
``expert_tile_gemm``'s device time in the traced window, in %."""

from port_bench.metrics import shares


def read(run):
    return shares.k1_roofline(run)
