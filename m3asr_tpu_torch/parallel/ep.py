"""Explicit expert-parallel MoE dispatch over the "ep" ranks (port of
``m3asr_tpu/parallel/ep.py``).

Tokens are replicated over the ep ranks; each rank runs only its
contiguous expert slice ``[r*E_local, (r+1)*E_local)`` on the tokens
routed to it, every other token goes to a zero dummy expert appended to
the slice (static shapes), and one all-reduce over "ep" combines the
outputs: a (B, T, d) all-reduce a layer instead of two token
all-to-alls.
"""

from __future__ import annotations

import torch

from m3asr_tpu_torch.ops.common import swish
from m3asr_tpu_torch.ops.moe import (_ragged_dot, _tile_layout,
                                     softmax_top1_gate)
from m3asr_tpu_torch.parallel.mesh import EXPERT_AXIS, Mesh, active_mesh


def _with_dummy(w1, b1, w2, b2):
    """The slice plus one zero expert at index E_local."""
    def pad(a):
        return torch.cat([a, a.new_zeros((1,) + a.shape[1:])], dim=0)
    return pad(w1), pad(b1), pad(w2), pad(b2)


def _local_experts_ragged(w1, b1, w2, b2, x, local_idx, is_local):
    """x (N, d) through experts ``local_idx`` in [0, E_local] (E_local the
    zero dummy), as grouped products over the tokens sorted by expert;
    non-local rows come out 0."""
    E_local = w1.shape[0]
    w1p, b1p, w2p, b2p = _with_dummy(w1, b1, w2, b2)
    order = torch.argsort(local_idx, stable=True)
    sx, se = x[order], local_idx[order].long()
    sizes = torch.bincount(local_idx.long(), minlength=E_local + 1).tolist()
    h = swish(_ragged_dot(sx, w1p, sizes) + b1p[se])
    y = _ragged_dot(h, w2p, sizes) + b2p[se]
    out = torch.zeros_like(x)
    out[order] = y
    return torch.where(is_local[:, None], out, torch.zeros_like(out))


def _local_experts_tiled(w1, b1, w2, b2, x, local_idx, is_local,
                         tile: int = 128):
    """The tiled (megablocks-style) grouped GEMM on the slice plus the
    dummy: each expert's tokens padded to whole tiles of one expert."""
    E_local = w1.shape[0]
    w1p, b1p, w2p, b2p = _with_dummy(w1, b1, w2, b2)
    N, d = x.shape
    order, slot, n_tiles, tile_e = _tile_layout(local_idx, N, E_local + 1,
                                                tile)
    te = tile_e.long()
    x_pad = x.new_zeros((n_tiles * tile, d))
    x_pad[slot.long()] = x[order.long()]
    xt = x_pad.reshape(n_tiles, tile, d)
    h = swish(torch.bmm(xt, w1p[te]) + b1p[te][:, None, :])
    y = torch.bmm(h, w2p[te]) + b2p[te][:, None, :]
    out = torch.zeros_like(x)
    out[order.long()] = y.reshape(n_tiles * tile, d)[slot.long()]
    return torch.where(is_local[:, None], out, torch.zeros_like(out))


def moe_experts_ep(p_shard, x: torch.Tensor, gate_idx: torch.Tensor,
                   num_experts_total: int, mesh: Mesh = None,
                   axis_name: str = EXPERT_AXIS,
                   impl: str = "ragged") -> torch.Tensor:
    """``p_shard`` holds this rank's expert slice (E_local, ...); x (B, T,
    d) and gate_idx (B, T) are the same on every rank of the line.
    Returns the all-reduced expert output (default mesh: the active
    one)."""
    mesh = mesh or active_mesh()
    E_local = p_shard["w1"].shape[0]
    if E_local * mesh.axis_size(axis_name) != num_experts_total:
        raise ValueError(f"{E_local} local experts x {axis_name} ranks != "
                         f"{num_experts_total}")
    B, T, d = x.shape
    flat_e = gate_idx.reshape(-1).to(torch.int32)
    pidx = mesh.coord(axis_name)
    is_local = torch.div(flat_e, E_local, rounding_mode="floor") == pidx
    local_idx = torch.where(is_local, flat_e - pidx * E_local,
                            torch.full_like(flat_e, E_local))
    local_fn = (_local_experts_tiled if impl == "tiled"
                else _local_experts_ragged)
    out = local_fn(*(p_shard[k].to(x.dtype) for k in ("w1", "b1", "w2",
                                                      "b2")),
                   x.reshape(-1, d), local_idx, is_local)
    return mesh.all_reduce(out, axis_name).reshape(B, T, d)


def make_ep_moe_ffn(mesh: Mesh, num_experts_total: int,
                    axis_name: str = EXPERT_AXIS, impl: str = "ragged"):
    """``ffn(p, x, embed, lengths)`` with ``ops.moe.moe_ffn``'s contract,
    where p holds this rank's expert slice (``moe_param_sharding``
    layout) and the whole router. impl: ``ragged`` or ``tiled`` (at
    large token counts)."""
    def ffn(p, x, embed, lengths):
        router_inputs = torch.cat([embed, x], dim=-1) \
            if embed is not None else x
        gate_value, gate_idx = softmax_top1_gate(p["router"],
                                                 router_inputs, lengths)
        y = moe_experts_ep(p, x, gate_idx, num_experts_total, mesh,
                           axis_name, impl)
        return y * gate_value
    return ffn
