"""Engine-building CLI of the PyTorch port.

    python -m m3asr_tpu_torch.build -c config.yaml -m ckpt.pt -o engine_dir
        [-prior prior.txt] [-cmvn stats] [-f | --int8 | --int4 [--act_quant]]
        [--dense_quant] [--fuse_qkv] [--moe_impl NAME]
        [--attn_impl xla|flash] [--buckets 1x256,4x1024] [--strict]
        [--decode_output logits|log_softmax|argmax|topk|beam]
        [--decode_topk K] [--skip-warmup] [--device cuda|cpu]
        [--ep N] [--tp M] [--export [--export_platforms cuda,cpu]]

Reads a reference YAML config (a hier MoE conformer, dense conformer or
DFSMN proto) and PyTorch checkpoint, converts the weights with the
proto's family's converter (``models/registry.py``), and writes an engine
directory in the JAX package's format.
The AED decoders a checkpoint holds (``decoder``, ``decoder_1``,
``decoder_2``) are converted too and written to ``decoders.npz`` in the
JAX flat format, for attention rescoring and decoding
(``python -m m3asr_tpu_torch.recognize``); their keys count as consumed
under ``--strict``.
``--int8`` / ``--int4`` write a bf16 engine with quantized expert
weights (int4 in 128-row scale groups); ``--act_quant`` adds per-token
int8 activations in the experts (w8a8 / w4a8). ``--dense_quant`` stores
the dense (non-expert) kernels as int8 with per-column scales;
``--fuse_qkv`` folds each self-attention's q/k/v projections into one.
``--moe_impl`` bakes an explicit expert stage into ``engine.json`` (the
JAX engine's names, e.g. ``pallas`` or ``tiled``). ``--attn_impl flash``
bakes the flash attention kernel (K2) into ``engine.json``.
``--decode_output`` picks what the engine returns (``argmax`` ids,
``topk`` candidates with ``--decode_topk`` K, or the on-device ``beam``
search of width K; see ``Engine.infer``). Before it saves, the engine
warms every bucket up (``Engine.warmup``): on the card that builds the
kernels and captures each bucket's CUDA graph, so a bucket that cannot
be captured fails the build. ``--skip-warmup`` leaves that out.
Without ``-m`` the weights are random (seed 0). ``-cmvn`` is accepted
and not read, as by the JAX ``build.py`` (the recognizer takes
``--cmvn``). ``--export`` also writes each bucket's model forward as a
``torch.export`` program for each device of ``--export_platforms``
(default: the build device) to ``exported/{B}x{T}.{device}.pt2``
(``Engine.export_bucket``; the weights stay in ``params.npz``), which
``Engine.load`` (and so ``infer -p``) runs instead of tracing the model
code; a bucket whose expert stage reads the host cannot be exported and
fails the build.

``--ep N`` / ``--tp M`` write the dir of an expert- / tensor-parallel
engine (the JAX ``build.py``'s engine.json): the whole tree, int4 w1
repacked for tp (``w1_q4c``), ``ep``/``tp`` in engine.json. The build
itself is one process and does not warm up (the buckets run on the
ranks); serve the dir on N x M ranks (``infer``, ``recognize``,
``serve``). The JAX engine's refusals hold: only the moe_conformer
family shards, ``--fuse_qkv`` and ``--dense_quant`` do not, and tp with
``--attn_impl flash`` serves xla. With ``--export`` the build writes
every rank's program of each bucket,
``exported/{B}x{T}.{device}.r{rank}of{ep}x{tp}.pt2``: one process
traces them in turn, each from that rank's shard of the tree (the rank's
experts and its share of the biases are fixed in its program; the
all-reduces are ``m3asr::mesh_all_reduce`` operators, which run nothing
while tracing). Each rank of ``infer`` / ``recognize`` / ``serve`` on
the dir loads its own programs (``Engine.load``); a program recorded for
another rank or mesh shape is not run (a warning, and the bucket is
traced from the model code).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="m3asr_tpu_torch --- build an inference engine")
    p.add_argument("-m", "--load_path", help="PyTorch checkpoint (.pt)")
    p.add_argument("-o", "--output", required=True,
                   help="output engine directory")
    p.add_argument("-c", "--config", required=True, help="YAML config")
    p.add_argument("-prior", "--prior_file", help="prior file")
    p.add_argument("-f", "--bf16", action="store_true",
                   help="bfloat16 engine")
    p.add_argument("--buckets", help="comma list of BxL buckets, "
                   "e.g. 1x256,4x1024")
    p.add_argument("--strict", action="store_true",
                   help="fail if any checkpoint key is not consumed")
    p.add_argument("--device", default="cuda",
                   help="device the engine is built on (cuda or cpu)")
    p.add_argument("--attn_impl", default="xla", choices=("xla", "flash"),
                   help="attention: plain PyTorch (xla) or the flash "
                   "kernel (flash)")
    p.add_argument("--decode_output", default="logits",
                   choices=("logits", "log_softmax", "argmax", "topk",
                            "beam"),
                   help="engine output: logits, log_softmax, per-frame "
                   "argmax ids, top-K candidates, or the on-device CTC "
                   "prefix beam search")
    p.add_argument("--decode_topk", type=int, default=8,
                   help="K of --decode_output topk; the beam width of beam")
    p.add_argument("--skip-warmup", action="store_true",
                   help="save without warming the buckets up (no graph "
                   "capture)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel ranks: experts split over ep ranks")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks: Megatron column/row splits "
                   "over tp ranks (composes with --ep)")
    p.add_argument("--int8", action="store_true",
                   help="int8 expert weights (bf16 activations)")
    p.add_argument("--int4", action="store_true",
                   help="packed int4 expert weights, 128-row scale groups")
    p.add_argument("--act_quant", action="store_true",
                   help="with --int8/--int4: per-token int8 activations "
                   "in the experts (w8a8 / w4a8)")
    p.add_argument("--dense_quant", action="store_true",
                   help="int8 weight-only dense (non-expert) kernels too")
    p.add_argument("--fuse_qkv", action="store_true",
                   help="one fused (D, 3D) q/k/v projection and one "
                   "rel-pos score product per attention layer")
    p.add_argument("--moe_impl", default="auto",
                   help="expert stage: auto, or an explicit name of the "
                   "JAX engine (pallas, tiled, ragged, capacity, ...)")
    p.add_argument("--export", action="store_true",
                   help="write per-bucket torch.export programs into "
                   "<engine>/exported/")
    p.add_argument("--export_platforms", default=None,
                   help="comma list of devices to export for with "
                   "--export (cuda, cpu; default the build device)")
    p.add_argument("-cmvn", "--cmvn_file",
                   help="accepted as the JAX build.py accepts it; not read")
    return p.parse_args(argv)


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def build_engine(args):
    """The engine ``args`` (``parse_args``) describe, warmed up unless
    ``--skip-warmup``: (engine, the raw YAML dict, the converted AED
    decoders). :func:`main` saves it."""
    import yaml

    from m3asr_tpu_torch import checkpoint as ckpt
    from m3asr_tpu_torch.config import model_config_from_dict
    from m3asr_tpu_torch.device import resolve_device
    from m3asr_tpu_torch.models.registry import get_family
    from m3asr_tpu_torch.runtime.engine import (Engine,
                                                config_from_engine_json,
                                                sharded_config)
    from m3asr_tpu_torch.utils.prior import read_prior

    dtype = ("int4" if args.int4 else "int8" if args.int8
             else "bfloat16" if args.bf16 else "float32")
    ecfg, _ = config_from_engine_json(dict(
        dtype=dtype, decode_output=args.decode_output,
        decode_topk=args.decode_topk,
        attn_impl=args.attn_impl, ep=args.ep, tp=args.tp,
        act_quant=args.act_quant, fuse_qkv=args.fuse_qkv,
        dense_quant=args.dense_quant, moe_impl=args.moe_impl))
    if args.buckets:
        pairs = [tuple(map(int, b.split("x"))) for b in
                 args.buckets.split(",")]
        ecfg.bucket_batches = tuple(sorted({b for b, _ in pairs}))
        ecfg.bucket_lengths = tuple(sorted({t for _, t in pairs}))
    device = resolve_device(args.device)

    with open(args.config) as f:
        raw = yaml.safe_load(f)
    raw.setdefault("input_dim", 40)
    model_cfg = model_config_from_dict(raw)
    if args.load_path:
        sd = ckpt.load_torch_checkpoint(args.load_path)
        params = ckpt.convert_encoder(sd, model_cfg)
        # the AED decoders ride along in the engine dir
        decoders = ckpt.convert_decoders(sd, model_cfg)
        ckpt.check_consumed(sd, strict=args.strict)
        print(f"Loading model from {args.load_path}")
    else:
        decoders = {}
        g = torch.Generator(device=device).manual_seed(0)
        params = get_family(model_cfg.nnet_proto).init(model_cfg, g)
        print("No checkpoint given — using synthetic init")
    numel = sum(int(np.prod(t.shape)) for t in _leaves(params))
    print(f"model parameter size: {numel}")

    prior = read_prior(args.prior_file) if args.prior_file else None
    ecfg.use_prior = prior is not None
    shards = ecfg.ep * ecfg.tp > 1
    if shards:
        # refused settings raise now; the engine built here is the
        # unsharded one, written as the sharded dir by main
        sharded_config(ecfg, get_family(model_cfg.nnet_proto).name)
        ecfg = dataclasses.replace(ecfg, ep=1, tp=1)
    engine = Engine(model_cfg, params, ecfg, prior=prior, device=device)
    if shards:
        print(f"ep={args.ep} x tp={args.tp}: no warm-up (the buckets run "
              "on the ranks)")
    elif not args.skip_warmup:
        print("warming up every bucket...")
        engine.warmup()
    return engine, raw, decoders


def main(argv=None):
    from m3asr_tpu_torch import checkpoint as ckpt
    args = parse_args(argv)
    engine, raw, decoders = build_engine(args)
    devices = None
    if args.export:
        devices = tuple((args.export_platforms
                         or engine.device.type).split(","))
        print(f"exporting buckets (torch.export, devices={devices})...")
    engine.save(args.output, raw_yaml=raw, export_devices=devices,
                shards=(args.ep, args.tp))
    if decoders:
        ckpt.save_decoders(args.output, decoders)
        print(f"decoders saved: {sorted(decoders)}")
    print(f"engine written to {args.output}")
    for b, t in engine.buckets.all_buckets():
        print(f"  feat({b}, {t}, {engine.model_cfg.input_dim})  "
              f"feat_len({b},)")


if __name__ == "__main__":
    main()
