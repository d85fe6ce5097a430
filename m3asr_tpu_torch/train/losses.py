"""Training losses (port of ``m3asr_tpu/train/losses.py``): CTC, label
smoothing, frame-level CE, and the MoE router regularizers and balance
metrics. All loss math runs in float32.

The JAX package takes ``optax.ctc_loss``: raw logits, a log-softmax
inside, and impossible transitions weighted by a finite log-epsilon of
-1e5 rather than -inf, so an alignment that cannot exist (more labels,
with the blanks repeats need, than frames) still gets a finite loss of
about 1e5 and a finite gradient. :func:`ctc_loss` takes PyTorch's CTC for
every feasible sequence (the same sum; paths through a -1e5 transition
weigh exp(-1e5) = 0 in float32) and optax's recursion, written out here,
for the infeasible ones, where PyTorch's loss is infinite.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from m3asr_tpu_torch.ops.common import at_least_f32
from m3asr_tpu_torch.ops.masking import make_valid_mask

LOG_EPSILON = -1e5        # optax.ctc_loss's log_epsilon

# The data-parallel step's normalizers: while ``global_batch(mesh)`` is
# active (in this thread), a rank holds its slice of the global batch,
# every mean divides by the count of the whole batch (summed over
# "dp"), and a loss that squares a mean returns its 1/dp share; the
# shares of the ranks add up to the one-rank loss.
_STATE = threading.local()


@contextlib.contextmanager
def global_batch(mesh):
    """Normalize over the global batch of ``mesh``'s "dp" ranks (a mesh
    with one dp rank, or None: the local batch, as without it)."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh if mesh is not None and \
        mesh.shape["dp"] > 1 else None
    try:
        yield
    finally:
        _STATE.mesh = prev


def global_count(n):
    """``n`` (an int or a count tensor) summed over the dp ranks of the
    active :func:`global_batch`, as float32; ``n`` itself without one."""
    mesh = getattr(_STATE, "mesh", None)
    if mesh is None:
        return n
    if not torch.is_tensor(n):
        import torch.distributed as dist
        n = torch.tensor(float(n), device="cuda" if dist.get_backend()
                         == "nccl" else "cpu")
    return mesh.all_reduce(n.to(torch.float32), "dp")


def _mean(t: torch.Tensor) -> torch.Tensor:
    """``t.mean()`` over the global batch."""
    if getattr(_STATE, "mesh", None) is None:
        return t.mean()
    return t.sum() / global_count(t.numel()).to(t.device)


def _ctc_optax(logp: torch.Tensor, logit_lens: torch.Tensor,
               labels: torch.Tensor, label_lens: torch.Tensor,
               blank: int) -> torch.Tensor:
    """optax's CTC forward recursion on log-probs (B, T, K): per-sequence
    loss (B,), differentiable by autograd. Labels are read as optax reads
    them, padding included: a padded id out of [0, K) emits log-prob 0."""
    B, T, K = logp.shape
    N = labels.shape[1]
    repeat = torch.zeros((B, N), dtype=logp.dtype, device=logp.device)
    repeat[:, :-1] = (labels[:, :-1] == labels[:, 1:]).to(logp.dtype)
    in_range = (labels >= 0) & (labels < K)
    emit = torch.gather(logp, 2, labels.clamp(0, K - 1).long()[:, None, :]
                        .expand(B, T, N))
    emit = torch.where(in_range[:, None, :], emit, torch.zeros_like(emit))
    lp_phi = logp[:, :, blank]

    def add_to_phi(phi, score):           # phi[:, 1:] (+)= score, log space
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)], 1)

    phi = torch.full((B, N + 1), LOG_EPSILON, dtype=logp.dtype,
                     device=logp.device)
    phi[:, 0] = 0.0
    em = torch.full((B, N), LOG_EPSILON, dtype=logp.dtype, device=logp.device)
    for t in range(T):
        pad = (t >= logit_lens).to(logp.dtype)[:, None]
        e_t, p_t = emit[:, t], lp_phi[:, t, None]
        prev_phi = add_to_phi(phi, em + LOG_EPSILON * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e_t, em + e_t)
        next_phi = add_to_phi(prev_phi + p_t,
                              em + p_t + LOG_EPSILON * (1.0 - repeat))
        em = pad * em + (1.0 - pad) * next_emit
        phi = pad * phi + (1.0 - pad) * next_phi
    last = add_to_phi(phi, em)
    return -torch.gather(last, 1, label_lens.long()[:, None])[:, 0]


def ctc_loss(logits: torch.Tensor, logit_lens: torch.Tensor,
             targets: torch.Tensor, target_lens: torch.Tensor,
             blank_idx: int = 0) -> torch.Tensor:
    """Mean-over-batch CTC loss of ``optax.ctc_loss``. logits (B, T, V)
    unnormalized (the log-softmax runs here, in float32); targets (B, U)
    padded with any id past each length."""
    B, T, V = logits.shape
    U = targets.shape[1]
    logp = torch.log_softmax(at_least_f32(logits), dim=-1)
    in_lens = logit_lens.long().clamp(0, T)
    tl = target_lens.long()
    valid = torch.arange(U, device=targets.device)[None, :] < tl[:, None]
    tg = torch.where(valid, targets.long(), torch.zeros_like(targets.long()))
    per_seq = F.ctc_loss(logp.transpose(0, 1), tg, in_lens, tl,
                         blank=blank_idx, reduction="none",
                         zero_infinity=True)
    # frames a valid alignment needs: one per label, plus a blank between
    # each pair of equal neighbours
    pairs = (tg[:, 1:] == tg[:, :-1]) & valid[:, 1:]
    needed = tl + pairs.sum(dim=1)
    infeasible = in_lens < needed
    if bool(infeasible.any()):
        idx = infeasible.nonzero()[:, 0]
        per_seq = per_seq.index_put(
            (idx,), _ctc_optax(logp[idx], in_lens[idx], targets[idx],
                               tl[idx], blank_idx))
    return _mean(per_seq)


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         padding_idx: int, smoothing: float = 0.1,
                         normalize_length: bool = False) -> torch.Tensor:
    """KL-divergence label smoothing loss; positions where ``targets ==
    padding_idx`` are left out; the sum is divided by the batch (default)
    or by the number of valid tokens."""
    V = logits.shape[-1]
    logp = torch.log_softmax(at_least_f32(logits), dim=-1)
    confidence = 1.0 - smoothing
    low = smoothing / (V - 1)
    valid = targets != padding_idx
    tgt = torch.where(valid, targets, torch.zeros_like(targets)).long()
    onehot = F.one_hot(tgt, V).to(logp.dtype)
    true_dist = low * (1.0 - onehot) + confidence * onehot
    kl = (true_dist * (torch.log(true_dist + 1e-38) - logp)).sum(-1)
    kl = torch.where(valid, kl, torch.zeros_like(kl))
    denom = valid.sum() if normalize_length else logits.shape[0]
    return kl.sum() / global_count(denom)


def ce_loss(logits: torch.Tensor, targets: torch.Tensor, padding_idx: int,
            mean_in_frames: bool = False):
    """Frame-level CE with likelihood and hit metrics. logits (B, T, V);
    targets (B, T) with ``padding_idx`` at ignored frames. Returns (loss,
    (loss_sum, likely, hit), (frames, frames, frames))."""
    V = logits.shape[-1]
    flat = at_least_f32(logits.reshape(-1, V))
    tgt = targets.reshape(-1).long()
    valid = tgt != padding_idx
    safe_tgt = torch.where(valid, tgt, torch.zeros_like(tgt))
    logp = torch.log_softmax(flat, dim=-1)
    prob = torch.exp(logp)
    nll = -torch.gather(logp, 1, safe_tgt[:, None])[:, 0]
    zero = torch.zeros_like(nll)
    loss = torch.where(valid, nll, zero).sum()
    frames = global_count(valid.sum())
    true_prob = torch.gather(prob, 1, safe_tgt[:, None])[:, 0]
    likely = torch.where(valid, true_prob, zero).sum()
    hit = (valid & (torch.argmax(prob, dim=-1) == tgt)).sum()
    metrics = (loss, likely, hit)
    counts = (frames, frames, frames)
    if mean_in_frames:
        loss = loss / frames.clamp(min=1)
    return loss, metrics, counts


class MoELayerScaleAuxLoss:
    """Aux-loss combiner with dynamic scale annealing: scale_i goes toward
    0 as the aux metric approaches its target minimum."""

    def __init__(self, num_aux: int, aux_scale, loss_minimum=None):
        assert len(aux_scale) == num_aux
        if loss_minimum is not None:
            assert len(loss_minimum) == num_aux
        self.max_aux_scale = list(aux_scale)
        self.aux_scale = list(aux_scale)
        self.loss_minimum = loss_minimum

    def adjust_aux_scale(self, aux_metric):
        if self.loss_minimum is None:
            return self.aux_scale
        for i in range(len(aux_metric)):
            delta = (aux_metric[i] - self.loss_minimum[i]) \
                / self.loss_minimum[i] * 3
            self.aux_scale[i] = self.max_aux_scale[i] * min(delta, 1.0)
        return self.aux_scale

    def __call__(self, aux_loss):
        """aux_loss: per layer, per aux type, (loss_value, loss_metric).
        Returns (loss, metric sums, counts)."""
        num_aux = len(aux_loss[0])
        total = 0.0
        sums = [0.0] * num_aux
        for per_layer in aux_loss:
            for j in range(num_aux):
                val, item = per_layer[j]
                total = total + self.aux_scale[j] * val
                sums[j] += float(item)
        return total, tuple(sums), tuple(1 for _ in range(num_aux))


def gshard_balance_loss(router_probs: torch.Tensor, expert_mask: torch.Tensor,
                        num_experts: int) -> torch.Tensor:
    """GShard load-balance loss: mean(f_e * p_e) * E^2, f_e the dispatch
    fraction and p_e the mean router probability. Inputs (..., E)."""
    probs = at_least_f32(router_probs.reshape(-1, router_probs.shape[-1]))
    mask = expert_mask.reshape(-1, expert_mask.shape[-1]).float()
    return (mask.mean(0) * probs.mean(0)).mean() * num_experts * num_experts


def expert_importance_loss(router_probs: torch.Tensor,
                           num_experts: int) -> torch.Tensor:
    """E * sum(mean_gate^2)."""
    mean_gate = at_least_f32(
        router_probs.reshape(-1, router_probs.shape[-1])).mean(0)
    return (mean_gate * mean_gate).sum() * num_experts


def balance_metrics(gate_idx: torch.Tensor, num_experts: int):
    """Per-expert load statistics of the token counts: coefficient of
    variation, Lmax/Lmin and Lmax/Lmean."""
    c_e = torch.bincount(gate_idx.reshape(-1).long(),
                         minlength=num_experts)[:num_experts].float()
    mean = c_e.mean()
    return {
        "coefficient-variation": c_e.std(unbiased=False) / (mean + 1e-10),
        "Lmax-over-Lmin": (c_e.max() + 1) / (c_e.min() + 1),
        "Lmax-over-Lmean": c_e.max() / (mean + 1e-10),
    }


def router_l1_loss(router_probs: torch.Tensor,
                   lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Sparse L1: the mean over valid tokens of each router row's L1 norm
    over its L2 norm. router_probs (B, T, E)."""
    p = at_least_f32(router_probs)
    ratio = p.abs().sum(-1) / torch.sqrt(p.square().sum(-1) + 1e-12)
    if lengths is None:
        return ratio.mean()
    valid = make_valid_mask(lengths, p.shape[1])
    ratio = torch.where(valid, ratio, torch.zeros_like(ratio))
    return ratio.sum() / global_count(valid.sum()).clamp(min=1)


def router_importance_loss(router_probs: torch.Tensor,
                           lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """CV^2 of the per-expert importance (the summed router mass over the
    valid tokens). router_probs (B, T, E)."""
    p = at_least_f32(router_probs)
    if lengths is not None:
        p = p * make_valid_mask(lengths, p.shape[1])[..., None]
    importance = p.sum((0, 1))
    mesh = getattr(_STATE, "mesh", None)
    if mesh is not None:
        # the global importance, and this rank's share of the loss
        from m3asr_tpu_torch.parallel.collectives import all_sum
        importance = all_sum(mesh, importance, "dp")
    mean = importance.mean()
    loss = importance.var(unbiased=False) / (mean * mean + 1e-10)
    return loss if mesh is None else loss / mesh.shape["dp"]
