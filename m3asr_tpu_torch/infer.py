"""Inference CLI of the PyTorch port.

    python -m m3asr_tpu_torch.infer -p engine_dir -i feat.npy
        [-o ref_out.npy] [-d none|greedy|beam] [-b beam_size]
        [--device cuda|cpu]

Loads an engine directory, runs the encoder twice (the second run is
timed, ending in a device synchronisation), prints output statistics,
optionally CTC-decodes, and compares against a saved reference output
with the reference's allclose(rtol=1e-5, atol=1e-3).
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
    from m3asr_tpu_torch.decode.ctc import (ctc_greedy_search,
                                            ctc_prefix_beam_search)
    from m3asr_tpu_torch.runtime.engine import Engine

    feat = np.load(args.input_file)
    if feat.ndim == 2:
        feat = feat[None]
    feat_len = np.array([feat.shape[1]] * feat.shape[0], np.int32)
    engine = Engine.load(args.plan_name, device=args.device)

    engine.infer(feat, feat_len)                 # warm-up
    t1 = time.perf_counter()
    out, out_lens = engine.infer(feat, feat_len)  # ends in a D2H copy
    t2 = time.perf_counter()
    print("time=" + str((t2 - t1) * 1000) + "ms")
    print("outputs.shape:" + str(out.shape))
    print("outputs.sum:" + str(out.sum()))
    print(out)

    if args.decode == "greedy":
        hyps = ctc_greedy_search(out, out_lens)
    elif args.decode == "beam":
        m = out.max(-1, keepdims=True)
        lp = out - m - np.log(np.exp(out - m).sum(-1, keepdims=True))
        hyps = [ctc_prefix_beam_search(lp[b], int(out_lens[b]),
                                       args.beam_size)[0][0]
                for b in range(out.shape[0])]
    else:
        hyps = []
    for b, h in enumerate(hyps):
        print(f"utt{b} hyp: {list(h)}")

    if args.compare_output_file:
        cmp_out = np.load(args.compare_output_file)
        print(f"compare_output={args.compare_output_file}, "
              f"dtype={cmp_out.dtype}, shape={cmp_out.shape}")
        print("output.sum:" + str(cmp_out.sum()))
        if cmp_out.shape == out.shape:
            ok = np.allclose(cmp_out, out, rtol=1e-5, atol=1e-3)
            print("allclose(rtol=1e-05, atol=1e-03): " + str(ok))


if __name__ == "__main__":
    main()
