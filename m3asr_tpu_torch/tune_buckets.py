"""Tune the engine's bucket ladder from a corpus length histogram (port
of ``scripts/tune_buckets.py``):

    python -m m3asr_tpu_torch.tune_buckets --lengths_file lens.txt --k 6

Prints a JSON report and the ``--buckets`` string of
``python -m m3asr_tpu_torch.build``. Lengths are input frames (before
subsampling), one per line (the last column, so ``feat-to-len`` output
works). ``--cost L=ms`` pairs (measured replay times) replace the card's
built-in curve of ``--mode``.
"""

import argparse
import json


def read_lengths(args):
    if args.ark:
        raise NotImplementedError(
            "--ark needs the Kaldi reader, which is not ported yet "
            "(ROADMAP Queue 1 item 10); pass --lengths_file")
    if not args.lengths_file:
        raise SystemExit("need --lengths_file")
    with open(args.lengths_file) as f:
        return [int(line.split()[-1]) for line in f if line.strip()]


def main(args):
    from m3asr_tpu_torch.runtime.bucket_tuner import tune_report
    cost_table = None
    if args.cost:
        cost_table = {}
        for pair in args.cost:
            frames, ms = pair.split("=")
            cost_table[int(frames)] = float(ms)
    rep = tune_report(read_lengths(args), args.k, align=args.align,
                      cost_table=cost_table, mode=args.mode)
    print(json.dumps(rep))
    batches = [int(b) for b in args.batches.split(",")]
    print("--buckets " + ",".join(f"{b}x{t}" for b in batches
                                  for t in rep["ladder"]))


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lengths_file",
                   help="one frame count per line (the last column)")
    p.add_argument("--ark", help="Kaldi rspecifier (not ported yet)")
    p.add_argument("--k", type=int, default=6, help="number of lengths")
    p.add_argument("--align", type=int, default=128)
    p.add_argument("--batches", default="1,2,4,8")
    p.add_argument("--cost", action="append",
                   help="L=ms measured points replacing the built-in curve")
    p.add_argument("--mode", default="float32",
                   choices=["float32", "bfloat16", "int8", "w8a8", "int4",
                            "w4a8"],
                   help="serving mode whose measured curve to use "
                        "(bucket_tuner.MODE_POINTS; ignored with --cost)")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
