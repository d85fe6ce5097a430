"""Inference CLI of the PyTorch port.

    python -m m3asr_tpu_torch.infer -p engine_dir -i feat.npy
        [-o ref_out.npy] [-d none|greedy|beam] [-b beam_size]
        [--device cuda|cpu]

Loads an engine directory, runs the encoder twice (the first builds the
bucket's program, on the card its CUDA graph; the second is timed and
ends in a device synchronisation), prints output statistics, optionally
CTC-decodes, and compares against a saved reference output with the
reference's allclose(rtol=1e-5, atol=1e-3). Engines built with
``--decode_output argmax`` / ``topk`` / ``beam`` decode from their
on-device outputs: greedy from the ids (or the top-1 candidates), the
prefix beam search over the top-K candidates, or the engine's own beam
search's best hypothesis. An engine dir built with ``--export`` serves
its buckets from the exported programs for this device
(``Engine.load``); the run prints which.

An ep/tp-sharded engine dir (``build --ep/--tp``) runs on ep*tp ranks:

    python -m torch.distributed.run --nproc-per-node N \
        -m m3asr_tpu_torch.infer -p engine_dir -i feat.npy

Every rank reads the same input and runs its shard; only rank 0 prints
(``parallel/distributed.py`` picks the backend: gloo when the ranks
share one card). Without the torch.distributed env it runs as one
process.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="m3asr_tpu_torch --- inference to get AM scores")
    p.add_argument("-p", "--plan_name", required=True,
                   help="engine directory")
    p.add_argument("-i", "--input_file", required=True,
                   help="input feat.npy, (T, F) or (B, T, F)")
    p.add_argument("-o", "--compare_output_file",
                   help="reference output .npy to compare against")
    p.add_argument("-d", "--decode", default="none",
                   choices=["none", "greedy", "beam"], help="CTC decode")
    p.add_argument("-b", "--beam_size", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="device to run on (cuda or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from m3asr_tpu_torch.decode.ctc import (ctc_greedy_from_ids,
                                            ctc_greedy_search,
                                            ctc_prefix_beam_search,
                                            ctc_prefix_beam_search_sparse)
    from m3asr_tpu_torch.parallel import distributed
    from m3asr_tpu_torch.runtime.engine import Engine

    distributed.initialize()
    if distributed.rank() == 0:
        say = print
    else:
        def say(*a, **k):
            pass
    feat = np.load(args.input_file)
    if feat.ndim == 2:
        feat = feat[None]
    feat_len = np.array([feat.shape[1]] * feat.shape[0], np.int32)
    engine = Engine.load(args.plan_name, device=args.device)

    engine.infer(feat, feat_len)                 # warm-up (and capture)
    t1 = time.perf_counter()
    res = engine.infer(feat, feat_len)           # ends in a D2H copy
    t2 = time.perf_counter()
    out, out_lens = res[0], res[1]
    dmode = engine.cfg.decode_output
    aux = res[2] if dmode in ("argmax", "topk") else None
    say("time=" + str((t2 - t1) * 1000) + "ms")
    if engine.loaded_buckets:
        say("exported programs run: " + ", ".join(
            f"{b}x{t}" for b, t in sorted(engine.loaded_buckets)))
    say("outputs.shape:" + str(out.shape))
    say("outputs.sum:" + str(out.sum()))
    say(out)

    if dmode == "beam" and args.decode != "none":
        # the search ran in the engine: (n-best ids, out_len, hyp lens,
        # scores), best first
        hyp_lens = res[2]
        hyps = [out[b, 0, :hyp_lens[b, 0]].tolist()
                for b in range(out.shape[0])]
    elif args.decode == "greedy":
        if dmode == "argmax":
            hyps = ctc_greedy_from_ids(out, out_lens)
        elif dmode == "topk":
            hyps = ctc_greedy_from_ids(aux[..., 0], out_lens)
        else:
            hyps = ctc_greedy_search(out, out_lens)
    elif args.decode == "beam":
        if dmode == "argmax":
            raise SystemExit("beam decode needs an engine built with "
                             "--decode_output topk, beam or logits, not "
                             "argmax")
        if dmode == "topk":
            hyps = [ctc_prefix_beam_search_sparse(
                        out[b], aux[b], int(out_lens[b]),
                        args.beam_size)[0][0]
                    for b in range(out.shape[0])]
        else:
            m = out.max(-1, keepdims=True)
            lp = out - m - np.log(np.exp(out - m).sum(-1, keepdims=True))
            hyps = [ctc_prefix_beam_search(lp[b], int(out_lens[b]),
                                           args.beam_size)[0][0]
                    for b in range(out.shape[0])]
    else:
        hyps = []
    for b, h in enumerate(hyps):
        say(f"utt{b} hyp: {list(h)}")

    if args.compare_output_file:
        cmp_out = np.load(args.compare_output_file)
        say(f"compare_output={args.compare_output_file}, "
              f"dtype={cmp_out.dtype}, shape={cmp_out.shape}")
        say("output.sum:" + str(cmp_out.sum()))
        if cmp_out.shape == out.shape:
            ok = np.allclose(cmp_out, out, rtol=1e-5, atol=1e-3)
            say("allclose(rtol=1e-05, atol=1e-03): " + str(ok))


if __name__ == "__main__":
    main()
