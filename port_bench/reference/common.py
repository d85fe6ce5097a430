"""Plain PyTorch pieces shared by the reference forwards.

Everything here computes in float32 with TF32 off (:func:`exact_float32`),
or, for the control, with every matrix product's operands rounded to a
lower precision first (:class:`Precision`). Nothing here imports the
program under test: these are the model's equations written out again.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# float8 e4m3's largest finite value: a tensor is scaled so that its
# largest magnitude lands there before it is rounded
FP8_MAX = 448.0


def exact_float32() -> None:
    """Full float32 matrix products and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """Where the reference rounds the operands of its products.

    ``float32``: nowhere (the reference). ``fp8``: each operand of every
    matrix product, convolution and attention product is scaled by its
    largest magnitude, rounded to float8 e4m3 and scaled back, and the
    product accumulates in float32: the control, the reference computed
    one step of precision below the bfloat16 that the configurations
    state."""

    KINDS = ("float32", "fp8")

    def __init__(self, kind: str = "float32"):
        if kind not in self.KINDS:
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, t: torch.Tensor, lead: bool = False) -> torch.Tensor:
        """t's rounded operand; with ``lead``, each slice t[i] is scaled
        by its own largest magnitude, as if rounded alone."""
        t = t.float()
        if self.kind == "float32":
            return t
        if lead:
            amax = t.abs().flatten(1).amax(1).reshape((-1,) + (1,) *
                                                       (t.dim() - 1))
        else:
            amax = t.abs().amax()
        s = amax.clamp(min=1e-30) / FP8_MAX
        return (t / s).to(torch.float8_e4m3fn).float() * s


def linear(p, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """x @ kernel (+ bias); kernels are stored (in, out)."""
    y = torch.matmul(prec.q(x), prec.q(p["kernel"]))
    if p.get("bias") is not None:
        y = y + p["bias"].float()
    return y


def layer_norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"].float() \
        + p["bias"].float()


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def sinusoid(d: int, n: int, device) -> torch.Tensor:
    """pe[p, 2i] = sin(p w_i), pe[p, 2i+1] = cos(p w_i),
    w_i = exp(-2i ln(10000) / d), in float32."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def top1_experts(p, x: torch.Tensor, router_in: torch.Tensor,
                 prec: Precision, activation):
    """A top-1 softmax-gated expert FFN over the rows of x (N, d), its
    own routing worked out from ``router_in`` (N, d_r): the expert
    ``act(x w1_e + b1_e) w2_e (+ b2_e)`` of each row's highest router
    logit, times that expert's softmax probability. The experts run as
    one batched product: each expert's rows, gathered and padded with
    zero rows to the fullest expert's count, each expert's operands
    rounded as its own. Returns (y (N, d), expert index per row)."""
    logits = torch.matmul(prec.q(router_in), prec.q(p["router"]["kernel"]))
    if p["router"].get("bias") is not None:
        logits = logits + p["router"]["bias"].float()
    gate = torch.softmax(logits, dim=-1)
    idx = torch.argmax(logits, dim=-1)
    E = p["w1"].shape[0]
    counts = torch.bincount(idx, minlength=E)
    order = torch.argsort(idx, stable=True)
    e = idx[order]
    slot = torch.arange(len(idx), device=x.device) \
        - (torch.cumsum(counts, 0) - counts)[e]
    xs = x.new_zeros((E, int(counts.max()), x.shape[1]))
    xs[e, slot] = x[order].float()
    h = torch.bmm(prec.q(xs, lead=True), prec.q(p["w1"], lead=True))
    if p.get("b1") is not None:
        h = h + p["b1"].float()[:, None]
    # the padding rows back to zero, so that they round nothing
    valid = torch.arange(xs.shape[1], device=x.device) < counts[:, None]
    h = activation(h) * valid[..., None]
    o = torch.bmm(prec.q(h, lead=True), prec.q(p["w2"], lead=True))
    if p.get("b2") is not None:
        o = o + p["b2"].float()[:, None]
    y = torch.empty_like(x, dtype=torch.float32)
    y[order] = o[e, slot]
    return y * gate.gather(-1, idx[:, None]), idx


def depthwise(x: torch.Tensor, kernel: torch.Tensor, bias, left: int,
              right: int, prec: Precision) -> torch.Tensor:
    """Depthwise conv over time of x (B, T, C) with a (K, C) kernel,
    ``left`` / ``right`` zero frames padded around."""
    C = x.shape[-1]
    w = prec.q(kernel).t().unsqueeze(1)                     # (C, 1, K)
    y = F.conv1d(F.pad(prec.q(x).transpose(1, 2), (left, right)), w,
                 None if bias is None else bias.float(), groups=C)
    return y.transpose(1, 2)

