"""End-to-end recognition CLI of the PyTorch port: Kaldi features (or a
wav scp) -> transcripts (port of the root ``recognize.py``).

    python -m m3asr_tpu_torch.recognize -p engine_dir -i feats.ark
        [-l labels.ark] [-d greedy|beam|rescore|attention] [-b beam]
        [--cmvn stats] [--raw_wav] [--device cuda|cpu] ...

Features stream through the port's ``DataLoader`` (Kaldi ark/scp, or
fbank from a wav scp with ``--raw_wav``; deltas, CMVN, splice) into the
engine's bucket programs (on the card, CUDA graphs); utterances longer
than the largest bucket go through ``Engine.infer_long``. Then CTC greedy
(optionally with emission frames), the host prefix beam search (native
C++ when it builds; ``--lm`` shallow fusion and ``--context_file``
hotwords on the extended search; sparse over a ``topk`` engine's
candidates), the engine's own on-device beam, AED rescoring of the CTC
n-best (``-d rescore``, with ``--hier_rescore`` the three hier decoders
on the engine's taps) or standalone AED beam search (``-d attention``).
The decoders come from the engine dir's ``decoders.npz`` and run on the
engine's device in float32. Transcripts go to stdout (``--units`` maps
ids to symbols); a JSON line of stats goes to stderr: utterances,
frames, wall seconds and real-time factor (after the engine load, 10 ms
a frame), CER with ``-l``, and the wall time split into the loader's
wait, the engine, the host search, the AED decoders (with the memories'
copies to the device counted apart) and the attention decode's steps.

Runs on the card unless ``--device cpu``; ``main(argv)`` runs in process
and returns the stats.

An ep/tp-sharded engine dir (``build --ep/--tp``) runs on ep*tp ranks:

    python -m torch.distributed.run --nproc-per-node N \
        -m m3asr_tpu_torch.recognize -p engine_dir -i feats.ark ...

Every rank parses the same arguments, loads its shard and applies the
same engine settings (the taps or the hidden for ``-d rescore`` /
``attention``); rank 0 then reads the data, sends each engine call
through a ``parallel/follow.Leader`` to the other ranks' follower loops,
runs the host searches and the AED decoders (loaded on rank 0 only) and
writes the transcripts and stats, and sends STOP at the end (with
``failed`` after an error, on which the followers exit non-zero too).
``main`` returns the stats on rank 0 and the follower's op counts on the
other ranks.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="m3asr_tpu_torch --- recognize Kaldi features")
    p.add_argument("-p", "--plan_name", required=True,
                   help="engine directory")
    p.add_argument("-i", "--input_rspec", required=True,
                   help="feature ark/scp (or wav scp with --raw_wav)")
    p.add_argument("--raw_wav", action="store_true",
                   help="input is a wav scp; fbank features on the host "
                   "(frontend/fbank.py)")
    p.add_argument("-l", "--label_rspec", required=False,
                   help="reference labels (int-vector ark) for CER")
    p.add_argument("-d", "--decode", default="greedy",
                   choices=["greedy", "beam", "rescore", "attention"])
    p.add_argument("-b", "--beam_size", type=int, default=10)
    p.add_argument("--ctc_weight", type=float, default=0.5)
    p.add_argument("--hier_rescore", action="store_true",
                   help="rescore with the three hier decoders "
                   "(decoder/decoder_1/decoder_2 on h_final/h6/h12), "
                   "averaged")
    p.add_argument("--reverse_weight", type=float, default=-1.0,
                   help="R2L decoder weight in rescoring; < 0: the model "
                   "config's reverse_weight")
    p.add_argument("--timestamps", action="store_true",
                   help="emit tok:frame pairs (greedy/beam; frames are "
                   "post-subsampling)")
    p.add_argument("--context_file", required=False,
                   help="hotword phrases, one per line as space-separated "
                   "token ids (-d beam/rescore)")
    p.add_argument("--context_bonus", type=float, default=3.0,
                   help="log-prob bonus per matched hotword token")
    p.add_argument("--lm", required=False,
                   help="ARPA n-gram LM for shallow fusion (-d "
                   "beam/rescore)")
    p.add_argument("--lm_weight", type=float, default=0.5)
    p.add_argument("--units", required=False,
                   help="symbol table ('sym id' per line): ARPA words to "
                   "ids, and transcripts as symbols")
    p.add_argument("--feat_dim", type=int, default=40)
    p.add_argument("--add_deltas", type=int, default=0)
    p.add_argument("--cmvn", dest="cmvn_file", required=False)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--long_overlap", type=int, default=None,
                   help="input-frame overlap of long-form windows "
                   "(default 64 x the subsampling factor)")
    p.add_argument("--device", default="cuda",
                   help="device to run on (cuda or cpu)")
    return p.parse_args(argv)


class _Split:
    """Wall seconds per part of the run."""

    def __init__(self):
        self.s = {k: 0.0 for k in ("loader", "engine", "search", "aed",
                                   "memory_h2d")}

    def timed(self, part, fn, *a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            self.s[part] += time.perf_counter() - t0


def _memories(engine, arrays, split):
    """The engine's numpy memories (taps or hidden of one utterance, or a
    batch) on its device in float32, the copy timed apart."""
    import torch

    def copy():
        out = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            engine.device) for a in arrays]
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        return out
    return split.timed("memory_h2d", copy)


def _rescore(nbests, res, out_lens, engine, decoders, args, hier, deep,
             split):
    """AED (hier) rescoring of the CTC n-bests; ``deep`` is the index of
    the hidden/taps in the engine's tuple."""
    from m3asr_tpu_torch.models.aed import (attention_rescoring,
                                            hier_attention_rescoring)
    cfg = engine.model_cfg
    rw = (args.reverse_weight if args.reverse_weight >= 0
          else cfg.reverse_weight)
    hyps = []
    for b, nb in enumerate(nbests):
        if hier:
            taps = _memories(engine, [h[b:b + 1] for h in
                                      res[deep:deep + 3]], split)
            hyp, _ = split.timed("aed", hier_attention_rescoring,
                                 decoders, cfg.decoder_conf, nb, taps,
                                 int(out_lens[b]), sos=cfg.sos, eos=cfg.eos,
                                 ignore_id=0, ctc_weight=args.ctc_weight,
                                 reverse_weight=rw)
        else:
            mem, = _memories(engine, [res[deep][b:b + 1]], split)
            hyp, _ = split.timed("aed", attention_rescoring,
                                 decoders["decoder"], cfg.decoder_conf, nb,
                                 mem, int(out_lens[b]), sos=cfg.sos,
                                 eos=cfg.eos, ignore_id=0,
                                 ctc_weight=args.ctc_weight,
                                 reverse_weight=rw)
        hyps.append(hyp)
    return hyps


def _pad_stack(rows, time_axis=0):
    mx = max(r.shape[time_axis] for r in rows)
    return np.stack([np.pad(r, tuple(
        (0, mx - r.shape[time_axis]) if a == time_axis else (0, 0)
        for a in range(r.ndim))) for r in rows])


def _infer_long(engine, batch, args):
    """Long-form: each utterance through infer_long (stitched windows),
    the results padded into one batch tuple as infer returns it."""
    rs = [engine.infer_long(batch["data"][i][:int(li)], int(li),
                            overlap=args.long_overlap)
          for i, li in enumerate(batch["lens"])]
    olens = np.asarray([int(r[1][0]) for r in rs], np.int32)
    if engine.cfg.decode_output == "beam":
        # (ids (B, beam, T'), out_len, hyp_lens, scores) [+ taps]
        res = (_pad_stack([r[0][0] for r in rs], time_axis=1), olens,
               np.concatenate([r[2] for r in rs]),
               np.concatenate([r[3] for r in rs]))
        tail0 = 4
    else:
        res = (_pad_stack([r[0][0] for r in rs]), olens)
        tail0 = 2
    # frame-aligned extras (sparse aux, taps, hidden)
    return res + tuple(_pad_stack([np.asarray(r[j])[0] for r in rs])
                       for j in range(tail0, len(rs[0])))


def _log_softmax(out):
    m = out.max(-1, keepdims=True)
    return out - m - np.log(np.exp(out - m).sum(-1, keepdims=True))


def _decode(args, engine, decoders, hier, res, context, lm, split, stats):
    """The hypotheses (and emission frames, or None) of one batch."""
    from m3asr_tpu_torch.decode import ctc, native
    out, out_lens = res[0], res[1]
    mode = engine.cfg.decode_output
    sparse = mode in ("argmax", "topk")
    aux = res[2] if sparse else None
    deep = 4 if mode == "beam" else 3 if sparse else 2
    times = None
    if args.decode == "attention":
        # standalone AED beam search over the encoder hidden; no CTC
        from m3asr_tpu_torch.models.aed import attention_search_decode
        cfg = engine.model_cfg
        mem, = _memories(engine, [res[deep]], split)
        hyps = split.timed("aed", attention_search_decode,
                           decoders["decoder"], cfg.decoder_conf, mem,
                           out_lens, beam_size=args.beam_size, sos=cfg.sos,
                           eos=cfg.eos, stats=stats)
    elif mode == "beam" and args.decode in ("greedy", "beam", "rescore"):
        # the prefix beam search ran in the engine: res carries the
        # (B, beam, T') n-best ids and (B, beam) lens and scores
        if args.timestamps:
            sys.exit("the on-device beam emits token ids only; "
                     "build with --decode_output topk for "
                     "timestamped beam decoding")
        if context is not None or lm is not None:
            sys.exit("hotword/LM fusion is a host-side search "
                     "feature; build with --decode_output topk to "
                     "combine it with sparse on-device candidates")
        hyp_lens, scores = np.asarray(res[2]), np.asarray(res[3])
        if args.decode == "rescore":
            nbests = [[(tuple(int(t) for t in out[b, j, :hyp_lens[b, j]]),
                        float(scores[b, j]))
                       for j in range(out.shape[1])
                       if np.isfinite(scores[b, j])]
                      for b in range(out.shape[0])]
            hyps = _rescore(nbests, res, out_lens, engine, decoders, args,
                            hier, deep, split)
        else:
            # greedy on a beam engine serves the best hypothesis
            hyps = [[int(t) for t in out[b, 0, :hyp_lens[b, 0]]]
                    for b in range(out.shape[0])]
    elif args.decode == "greedy":
        if sparse:
            # the top-1 of the top-K rows is the argmax
            ids = out if mode == "argmax" else aux[..., 0]
            best = aux if mode == "argmax" else out[..., 0]
            if args.timestamps:
                ghyps = split.timed("search", ctc.ctc_greedy_times_from_ids,
                                    ids, best, out_lens)
                times = [list(h.times) for h in ghyps]
                hyps = [list(h.tokens) for h in ghyps]
            else:
                hyps = split.timed("search", ctc.ctc_greedy_from_ids, ids,
                                   out_lens)
        elif args.timestamps:
            ghyps = split.timed("search", ctc.ctc_greedy_search_times, out,
                                out_lens)
            times = [list(h.times) for h in ghyps]
            hyps = [list(h.tokens) for h in ghyps]
        else:
            hyps = split.timed("search", native.ctc_greedy_search, out,
                               out_lens)
    elif mode == "argmax":
        sys.exit("-d beam/rescore needs per-frame candidates: build "
                 "the engine with --decode_output topk (or "
                 "logits/log_softmax), not argmax")
    elif mode == "topk":
        if args.beam_size > out.shape[-1]:
            sys.exit(f"beam_size {args.beam_size} > engine "
                     f"decode_topk {out.shape[-1]}; rebuild with a "
                     "larger --decode_topk for exact beam search")
        # sparse beam straight over the device-selected candidates
        nbests = split.timed(
            "search", native.ctc_prefix_beam_search_sparse_batch, out, aux,
            out_lens, args.beam_size, context=context, lm=lm,
            lm_weight=args.lm_weight)
        if args.timestamps and args.decode == "beam":
            times = [list(nb[0].times) for nb in nbests]
        if args.decode == "rescore":
            nbests = [[(h.tokens, h.score) for h in nb] for nb in nbests]
            hyps = _rescore(nbests, res, out_lens, engine, decoders, args,
                            hier, deep, split)
        else:
            hyps = [list(nb[0][0]) for nb in nbests]
    else:
        lp = split.timed("search", _log_softmax, out)
        if (args.timestamps and args.decode == "beam") \
                or context is not None or lm is not None:
            # extended beam: emission frames and/or LM-fused,
            # context-biased n-best scores, which -d rescore re-ranks
            nbests = split.timed(
                "search", native.ctc_prefix_beam_search_ext_batch, lp,
                out_lens, args.beam_size, context=context, lm=lm,
                lm_weight=args.lm_weight)
            times = [list(nb[0].times) for nb in nbests]
            if args.decode == "rescore":
                nbests = [[(h.tokens, h.score) for h in nb]
                          for nb in nbests]
        else:
            nbests = split.timed("search",
                                 native.ctc_prefix_beam_search_batch, lp,
                                 out_lens, args.beam_size)
        if args.decode == "rescore":
            hyps = _rescore(nbests, res, out_lens, engine, decoders, args,
                            hier, deep, split)
        else:
            hyps = [list(nb[0][0]) for nb in nbests]
    return hyps, times


def main(argv=None):
    args = parse_args(argv)
    import os
    from m3asr_tpu_torch import checkpoint as ckpt
    from m3asr_tpu_torch.parallel import follow
    from m3asr_tpu_torch.runtime.engine import Engine

    world = follow.join_world()
    lead = world is None or world.rank == 0

    context = None
    if args.context_file:
        from m3asr_tpu_torch.decode.ctc import ContextTrie
        if args.decode not in ("beam", "rescore"):
            sys.exit("--context_file biasing needs -d beam/rescore")
        with open(args.context_file) as fh:
            phrases = [[int(t) for t in line.split()]
                       for line in fh if line.strip()]
        context = ContextTrie(phrases, bonus=args.context_bonus) \
            if lead else None
    lm = None
    id2sym = None
    if args.units or args.lm:
        from m3asr_tpu_torch.decode.lm import NgramLM, read_symbol_table
        symtab = read_symbol_table(args.units) if args.units else None
        if symtab is not None:
            id2sym = {v: k for k, v in symtab.items()}
        if args.lm:
            if args.decode not in ("beam", "rescore"):
                sys.exit("--lm shallow fusion needs -d beam/rescore")
            lm = NgramLM(args.lm, symtab) if lead else None

    engine = Engine.load(args.plan_name, device=args.device)
    follow.check_world(world, engine)
    decoders = None
    hier = False
    if args.decode in ("rescore", "attention"):
        path = os.path.join(args.plan_name, ckpt.DECODERS_FILE)
        if not os.path.exists(path):
            sys.exit(f"{args.decode} decoding needs decoders.npz in the "
                     "engine dir (build from an AED checkpoint)")
        if lead:
            decoders = ckpt.load_decoders(args.plan_name, engine.device)
            names = set(decoders)
        else:                      # the followers read the names alone
            with np.load(path) as z:
                names = {k.split("/")[0] for k in z.files}
        hier = (args.decode == "rescore" and args.hier_rescore
                and any(k in names for k in ("decoder_1", "decoder_2")))
        # before the first bucket program is built: the programs read
        # these settings when they are made (on every rank: the
        # followers' programs must have rank 0's outputs)
        if hier:
            engine.cfg.return_taps = True
        else:
            engine.cfg.return_hidden = True
    if not lead:
        return follow.follow(world, engine)
    if world is None:
        return _recognize(args, engine, decoders, hier, context, lm, id2sym)
    leader = follow.Leader(world)
    engine.lead(leader)
    try:
        out = _recognize(args, engine, decoders, hier, context, lm, id2sym)
    except BaseException:
        leader.stop(failed=True)
        raise
    leader.stop()
    return out


def _recognize(args, engine, decoders, hier, context, lm, id2sym):
    """The recognition loop (rank 0's on ranks): returns the stats."""
    from m3asr_tpu_torch.io.loader import DataLoader
    from m3asr_tpu_torch.utils.text import cer
    loader = DataLoader(
        args.input_rspec, args.label_rspec,
        loader_conf={"feat_dim": args.feat_dim,
                     "add_deltas": args.add_deltas,
                     "cmvn_file": args.cmvn_file,
                     "batch_size": args.batch_size,
                     "raw_wav": args.raw_wav,
                     "feature_extraction_conf": {
                         "mel_bins": args.feat_dim,
                         "frame_length": 25, "frame_shift": 10}})

    split = _Split()
    stats = {}
    hyps_all, refs_all = [], []
    t0 = time.perf_counter()
    frames = 0
    max_bucket = engine.buckets.lengths[-1]
    batches = loader(output_keys=True)

    def sym(t):
        return id2sym.get(t, str(t)) if id2sym else str(t)

    while True:
        batch = split.timed("loader", next, batches, None)
        if batch is None:
            break
        if int(np.max(batch["lens"])) > max_bucket:
            # long-form: utterances beyond the largest bucket decode
            # through windowed center-cut stitching
            if args.decode == "attention":
                sys.exit(f"utterance longer than the max bucket "
                         f"({max_bucket}): standalone attention decode "
                         "is not defined over stitched windows; use "
                         "-d greedy/beam (or rescore on a taps engine)")
            if args.decode == "rescore" and not (
                    engine.cfg.return_taps or engine.cfg.return_hidden):
                sys.exit("long-form rescoring needs the stitched "
                         "decoder memories: build the engine with "
                         "--return_taps (hier) or --return_hidden")
            res = split.timed("engine", _infer_long, engine, batch, args)
        else:
            res = split.timed("engine", engine.infer, batch["data"],
                              batch["lens"])
        frames += int(np.sum(batch["lens"]))
        hyps, times = _decode(args, engine, decoders, hier, res, context,
                              lm, split, stats)
        for bi, (key, h) in enumerate(zip(batch["keys"], hyps)):
            if args.timestamps and args.decode in ("greedy", "beam"):
                # tok:frame pairs; frames are post-subsampling indices
                print(f"{key} " + " ".join(
                    f"{sym(t)}:{f}" for t, f in zip(h, times[bi])))
            else:
                print(f"{key} {' '.join(sym(t) for t in h)}")
            hyps_all.append(h)
        if "target" in batch:
            for i in range(len(hyps)):
                refs_all.append(
                    list(batch["target"][i][: batch["target_lens"][i]]))
    dt = time.perf_counter() - t0
    out = {"utts": len(hyps_all), "frames": frames, "wall_s": round(dt, 2),
           "rtf": round(dt / max(frames * 0.01, 1e-9), 5)}
    if refs_all:
        out["cer"] = round(cer(refs_all, hyps_all), 5)
    out["split_s"] = {k: round(v, 4) for k, v in split.s.items()}
    if "steps" in stats:
        out["aed_steps"] = stats["steps"]
    print(json.dumps(out), file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
