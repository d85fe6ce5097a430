"""K1's share of its roofline in the offline cells, over the routing the
program ran: ``k1_roofline.offline``'s least time with each call's
active experts per MoE layer from the routing counter in its
``engine.infer`` span, over ``expert_tile_gemm``'s device time in the
traced window, in %."""

from port_bench.metrics import program_spans


def read(run):
    return program_spans.k1_roofline(run)
