"""Length, padding and chunk masks (port of ``m3asr_tpu/ops/masking.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True at PADDED positions: bool (B, max_len)."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] >= lengths[:, None]


def make_valid_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True at VALID positions: bool (B, max_len)."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def masked_fill(x: torch.Tensor, lengths: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """Fill time positions >= length with ``fill``; x is (B, T, ...)."""
    T = x.shape[1]
    valid = make_valid_mask(lengths, T).reshape(
        (x.shape[0], T) + (1,) * (x.dim() - 2))
    return torch.where(valid, x, torch.full((), fill, dtype=x.dtype,
                                            device=x.device))


def conv_subsampled_length(lengths, left_padding: int = 2, stride: int = 2):
    """Output length of a valid strided conv (floor division, as the
    JAX package: a length of 0 maps to a negative one)."""
    return (lengths - left_padding - 1) // stride + 1


def subsampling4_length(lengths):
    """Length arithmetic of Conv2dSubsampling4 (two k=3 s=2 convs).
    Works on tensors and Python ints alike."""
    return conv_subsampled_length(conv_subsampled_length(lengths, 2, 2), 2, 2)


def subsampling6_length(lengths):
    """Conv2dSubsampling6: a k=3 s=2 conv, then a k=5 s=3 one."""
    return conv_subsampled_length(conv_subsampled_length(lengths, 2, 2), 4, 3)


def subsampling8_length(lengths):
    """Conv2dSubsampling8: three k=3 s=2 convs."""
    return conv_subsampled_length(subsampling4_length(lengths), 2, 2)


# output length of each encoder front; "linear" (no subsampling) is the
# DFSMN families' and LinearNoSubsampling's
SUBSAMPLED_LENGTH = {"conv2d": subsampling4_length,
                     "conv2d6": subsampling6_length,
                     "conv2d8": subsampling8_length,
                     "linear": lambda lengths: lengths}


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """Lower-triangular causal mask (size, size), True = attend."""
    i = torch.arange(size, device=device)
    return i[None, :] <= i[:, None]


def subsequent_chunk_mask(size: int, chunk_size: int,
                          num_left_chunks: int = -1,
                          device=None) -> torch.Tensor:
    """Chunked streaming mask (size, size), True = attend: each frame
    sees the frames up to the end of its chunk and, with
    ``num_left_chunks >= 0``, that many chunks before its own."""
    pos = torch.arange(size, device=device)
    chunk = pos // chunk_size
    ending = torch.clamp((chunk[:, None] + 1) * chunk_size, max=size)
    allowed = pos[None, :] < ending
    if num_left_chunks >= 0:
        start = torch.clamp((chunk[:, None] - num_left_chunks) * chunk_size,
                            min=0)
        allowed = allowed & (pos[None, :] >= start)
    return allowed


def dynamic_chunk_mask(generator: torch.Generator, size: int,
                       use_dynamic_left_chunk: bool = False,
                       device=None) -> torch.Tensor:
    """Random dynamic-chunk training mask (size, size): chunk size drawn
    uniform in [1, size); above size // 2 it means full context, else it
    folds to [1, 25]; optionally the number of left chunks is drawn too.
    The draws come from ``generator`` (a CPU generator: the mask's shape
    is decided on the host), so they differ from ``jax.random``'s."""
    cs = int(torch.randint(1, max(size, 2), (), generator=generator))
    full = cs > size // 2
    cs = size if full else cs % 25 + 1
    nleft = -1
    if use_dynamic_left_chunk and not full:
        max_left = max((size - 1) // cs, 1)
        nleft = int(torch.randint(0, max_left, (), generator=generator))
    return subsequent_chunk_mask(size, cs, nleft, device)


def add_optional_chunk_mask(lengths: torch.Tensor, max_len: int,
                            use_dynamic_chunk: bool,
                            use_dynamic_left_chunk: bool,
                            decoding_chunk_size: int,
                            static_chunk_size: int,
                            num_decoding_left_chunks: int,
                            generator: Optional[torch.Generator] = None
                            ) -> Optional[torch.Tensor]:
    """(B, 1, T, T) attend-mask of the chunk pattern and key validity, or
    None when no chunking applies (the attention ops mask by length).
    decoding_chunk_size: 0 = training (random dynamic chunk, needs
    ``generator``), < 0 = full context, > 0 = fixed decode chunk."""
    dev = lengths.device
    if use_dynamic_chunk:
        if decoding_chunk_size < 0:
            chunk = torch.ones((max_len, max_len), dtype=torch.bool,
                               device=dev)
        elif decoding_chunk_size > 0:
            chunk = subsequent_chunk_mask(max_len, decoding_chunk_size,
                                          num_decoding_left_chunks, dev)
        else:
            if generator is None:
                raise ValueError("dynamic-chunk training needs a generator")
            chunk = dynamic_chunk_mask(generator, max_len,
                                       use_dynamic_left_chunk, dev)
    elif static_chunk_size > 0:
        chunk = subsequent_chunk_mask(max_len, static_chunk_size,
                                      num_decoding_left_chunks, dev)
    else:
        return None
    valid = make_valid_mask(lengths, max_len)                # (B, T)
    return (chunk[None] & valid[:, None, :])[:, None]        # (B,1,T,T)


def mask_finished_scores(score: torch.Tensor,
                         flag: torch.Tensor) -> torch.Tensor:
    """Beam-search finish masking: a finished hypothesis keeps exactly one
    live branch, candidate 0 at score 0 and the others at -inf, so it
    rides along unchanged while unfinished ones expand.
    score: (N, beam) candidate scores; flag: (N, 1) bool finished."""
    first = torch.arange(score.shape[-1], device=score.device)[None, :] == 0
    score = score.masked_fill(flag & ~first, float("-inf"))
    return score.masked_fill(flag & first, 0.0)


def mask_finished_preds(pred: torch.Tensor, flag: torch.Tensor,
                        eos: int) -> torch.Tensor:
    """Beam-search finish masking: every candidate of a finished
    hypothesis becomes eos. pred: (N, beam) ints; flag: (N, 1) bool."""
    return pred.masked_fill(flag, eos)


def spec_augment_draws(generator: torch.Generator, feat_len: torch.Tensor,
                       D: int, num_t_mask: int = 2, num_f_mask: int = 2,
                       max_t: int = 50, max_f: int = 10):
    """The random draws of :func:`spec_augment` for a batch of lengths
    ``feat_len`` (B,) and ``D`` feature bins, from a CPU generator, on
    feat_len's device: ``t_start`` in [0, max(len - 1, 1)), ``t_len`` in
    [1, max(max_t, 2)), ``f_start`` in [0, max(D - 1, 1)), ``f_len`` in
    [1, max(max_f, 2)), each int32 (B, num masks)."""
    B = feat_len.shape[0]
    dev = feat_len.device
    u = torch.rand((B, num_t_mask), generator=generator)
    t_len = torch.randint(1, max(max_t, 2), (B, num_t_mask),
                          generator=generator)
    f_start = torch.randint(0, max(D - 1, 1), (B, num_f_mask),
                            generator=generator)
    f_len = torch.randint(1, max(max_f, 2), (B, num_f_mask),
                          generator=generator)
    hi = (feat_len.to(torch.int32)[:, None] - 1).clamp(min=1)
    t_start = (u.to(dev) * hi).to(torch.int32)
    return {"t_start": t_start, "t_len": t_len.to(dev, torch.int32),
            "f_start": f_start.to(dev, torch.int32),
            "f_len": f_len.to(dev, torch.int32)}


def apply_spec_augment(feat: torch.Tensor, feat_len: torch.Tensor,
                       draws) -> torch.Tensor:
    """Zero the time and frequency masks of ``draws`` in feat (B, T, D),
    in its dtype: a time mask ends at the utterance's length, a frequency
    mask at D."""
    B, T, D = feat.shape
    t_start = draws["t_start"]
    t_end = torch.minimum(t_start + draws["t_len"],
                          feat_len.to(torch.int32)[:, None])
    t_idx = torch.arange(T, device=feat.device)[None, :, None]
    t_hit = ((t_idx >= t_start[:, None, :])
             & (t_idx < t_end[:, None, :])).any(-1)             # (B, T)
    f_start = draws["f_start"]
    f_end = (f_start + draws["f_len"]).clamp(max=D)
    f_idx = torch.arange(D, device=feat.device)[None, :, None]
    f_hit = ((f_idx >= f_start[:, None, :])
             & (f_idx < f_end[:, None, :])).any(-1)             # (B, D)
    keep = ~(t_hit[:, :, None] | f_hit[:, None, :])
    return feat * keep.to(feat.dtype)


def spec_augment(generator: torch.Generator, feat: torch.Tensor,
                 feat_len: torch.Tensor, num_t_mask: int = 2,
                 num_f_mask: int = 2, max_t: int = 50,
                 max_f: int = 10) -> torch.Tensor:
    """Batched SpecAugment on the device (port of
    ``m3asr_tpu/ops/masking.py::spec_augment``): ``num_t_mask`` time masks
    starting within each utterance's valid length and ``num_f_mask``
    frequency masks, zero-filled. The draws come from ``generator`` (a CPU
    ``torch.Generator``), so their numbers differ from ``jax.random``'s;
    their bounds are the JAX function's. feat (B, T, D), feat_len (B,)."""
    return apply_spec_augment(feat, feat_len, spec_augment_draws(
        generator, feat_len, feat.shape[2], num_t_mask, num_f_mask, max_t,
        max_f))
