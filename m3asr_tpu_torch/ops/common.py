"""Elementwise and dense primitives (port of ``m3asr_tpu/ops/common.py``).

Parameters are plain dicts of tensors with the JAX package's layouts:
linear kernels are stored ``(in, out)``.
"""

from __future__ import annotations

import math

import torch

from m3asr_tpu_torch.parallel import mesh as pmesh

# LayerNorm epsilon of the reference model zoo
LN_EPS = 1e-12


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """``y = x @ kernel + bias`` in x's dtype; kernel stored (in, out).

    A dense-quant node (``ops/quant.py::quantize_dense_params``) holds
    ``kernel_q`` int8 and ``kernel_scale`` float32 (per output column)
    instead: the weight is ``kernel_q * kernel_scale`` with both factors
    and the product in x's dtype, as the JAX package rounds it."""
    kq = p.get("kernel_q")
    if kq is not None:
        w = kq.to(x.dtype) * p["kernel_scale"].to(x.dtype)
    else:
        w = p["kernel"].to(x.dtype)
    y = torch.matmul(x, w)
    if p.get("bias") is not None:
        y = y + p["bias"].to(x.dtype)
    return y


def row_parallel_linear(p, x: torch.Tensor) -> torch.Tensor:
    """:func:`linear` whose kernel rows (and x's last dim) may be split
    over the active mesh's "tp" ranks (``parallel/mesh.py``): the partial
    products are summed over "tp", then the bias is added once. Without
    a tp mesh it is :func:`linear`."""
    if pmesh.axis_size("tp") == 1:
        return linear(p, x)
    y = pmesh.psum(linear({k: v for k, v in p.items() if k != "bias"}, x),
                   "tp")
    return y if p.get("bias") is None else y + p["bias"].to(x.dtype)


def layer_norm(p, x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last dim, statistics in float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def scale_shift(p, x: torch.Tensor) -> torch.Tensor:
    """Per-channel affine: the folded inference form of BatchNorm1d."""
    return x * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    """Swish/SiLU = x * sigmoid(x)."""
    return x * torch.sigmoid(x)


# the expert FFNs' activations by name: swish for the conformer experts,
# relu for the DFSMN experts
ACTIVATIONS = {"swish": swish, "silu": swish, "relu": torch.relu}


def activation_name(activation) -> str:
    """The name of an expert activation given by name or as one of the
    functions of :data:`ACTIVATIONS`; raises ValueError otherwise."""
    if isinstance(activation, str):
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; choose "
                             f"one of {sorted(ACTIVATIONS)}")
        return "swish" if activation == "silu" else activation
    for name, fn in ACTIVATIONS.items():
        if activation is fn:
            return name
    raise ValueError(f"unknown activation {activation!r}; choose one of "
                     f"{sorted(ACTIVATIONS)}")


def activation_fn(activation):
    """The function of an expert activation given by name or function."""
    return ACTIVATIONS[activation_name(activation)]


_ACTIVATIONS = {
    "hardtanh": torch.nn.functional.hardtanh,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "selu": torch.nn.functional.selu,
    "swish": swish,
    "silu": swish,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
}


def get_activation(name: str):
    """The activation registry of the model zoo, by name (KeyError for an
    unknown one)."""
    return _ACTIVATIONS[name]


def dump_tensor(x: torch.Tensor, name: str = "") -> torch.Tensor:
    """Debug identity that prints the tensor's shape, sum and values."""
    print(f"{name} shape={tuple(x.shape)} sum={x.sum().item()}\n{x}")
    return x


def init_linear(generator: torch.Generator, d_in: int, d_out: int,
                bias: bool = True, dtype: torch.dtype = torch.float32):
    """torch.nn.Linear's default init (uniform in +-1/sqrt(d_in)), kernel
    stored (in, out), drawn on ``generator``'s device."""
    bound = 1.0 / math.sqrt(d_in)

    def draw(shape):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return ((u * 2 - 1) * bound).to(dtype)

    p = {"kernel": draw((d_in, d_out))}
    if bias:
        p["bias"] = draw((d_out,))
    return p


def init_layer_norm(d: int, device=None, dtype: torch.dtype = torch.float32):
    return {"scale": torch.ones((d,), device=device, dtype=dtype),
            "bias": torch.zeros((d,), device=device, dtype=dtype)}


# ---------------------------------------------------------------------------
# the model zoo's other norms; statistics in float32, the result in x's
# dtype
# ---------------------------------------------------------------------------

def group_norm(p, x: torch.Tensor, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last dim: ``num_groups`` groups of C/num_groups
    channels, biased variance."""
    *lead, C = x.shape
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} "
                         "groups")
    xg = x.float().reshape(*lead, num_groups, C // num_groups)
    mean = xg.mean(dim=-1, keepdim=True)
    var = (xg - mean).square().mean(dim=-1, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(*lead, C)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def mask_batch_norm(p, x: torch.Tensor, valid_mask: torch.Tensor,
                    train: bool = False, eps: float = 1e-8,
                    momentum: float = 0.99):
    """BatchNorm with statistics over the valid frames only. x: (N, D)
    flat frames; valid_mask: (N,) bool; p: {"scale", "bias",
    "running_mean", "running_var"}. Returns (y, the new running stats).

    Train mode takes the masked batch mean and the unbiased (n - 1)
    variance, and updates the running stats as ``old * momentum + batch
    * (1 - momentum)``; eval mode normalizes with the running stats and
    returns them as they are."""
    xf = x.float()
    m = valid_mask.float()[:, None]
    if train:
        n = m.sum().clamp(min=1.0)
        mean = (xf * m).sum(dim=0, keepdim=True) / n
        var = ((xf - mean).square() * m).sum(dim=0, keepdim=True) \
            / (n - 1.0).clamp(min=1.0)
        new_mean = p["running_mean"] * momentum + mean[0] * (1 - momentum)
        new_var = p["running_var"] * momentum + var[0] * (1 - momentum)
    else:
        mean = p["running_mean"][None].float()
        var = p["running_var"][None].float()
        new_mean, new_var = p["running_mean"], p["running_var"]
    y = (xf - mean) / torch.sqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype), {"running_mean": new_mean, "running_var": new_var}


def varlen_instance_norm_2d(p, x: torch.Tensor, lengths: torch.Tensor,
                            eps: float = 1e-8,
                            affine: bool = False) -> torch.Tensor:
    """InstanceNorm2d over each utterance's valid frames, as the
    reference computes it: for x (B, C, T, F), sums over (channel, valid
    time) for each feature column, divided by ``lengths * F`` bins (the
    reference's count); the padded frames are zeroed first."""
    B, C, T, F = x.shape
    valid = (torch.arange(T, device=x.device)[None]
             < lengths.reshape(-1, 1)).float()
    m = valid[:, None, :, None]
    num_bins = (lengths.float() * F).reshape(B, 1, 1, 1)
    xm = x.float() * m
    mean = xm.sum(dim=(1, 2), keepdim=True) / num_bins
    var = ((xm - mean).square() * m).sum(dim=(1, 2), keepdim=True) \
        / num_bins
    y = (xm - mean) / torch.sqrt(var + eps)
    if affine:
        y = y * p["scale"].float().reshape(1, -1, 1, 1) \
            + p["bias"].float().reshape(1, -1, 1, 1)
    return y.to(x.dtype)
