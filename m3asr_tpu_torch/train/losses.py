"""Training losses (port of the CTC loss of ``m3asr_tpu/train/losses.py``).

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

import torch
import torch.nn.functional as F

LOG_EPSILON = -1e5        # optax.ctc_loss's log_epsilon


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
    logp = torch.log_softmax(logits.float(), dim=-1)
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
    return per_seq.mean()
