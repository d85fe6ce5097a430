"""Engine-building CLI of the PyTorch port.

    python -m m3asr_tpu_torch.build -c config.yaml -m ckpt.pt -o engine_dir
        [-prior prior.txt] [-f | --int8 | --int4 [--act_quant]]
        [--attn_impl xla|flash] [--buckets 1x256,4x1024] [--strict]
        [--device cuda|cpu]

Reads a reference YAML config and PyTorch checkpoint, converts the
weights, and writes an engine directory in the JAX package's format.
``--int8`` / ``--int4`` write a bf16 engine with quantized expert
weights (int4 in 128-row scale groups); ``--act_quant`` adds per-token
int8 activations in the experts (w8a8 / w4a8). ``--attn_impl flash``
bakes the flash attention kernel (K2) into ``engine.json``.
Without ``-m`` the weights are random (seed 0). Flags of the JAX
``build.py`` that this slice does not run are accepted by name and raise
NotImplementedError naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse

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
    # JAX build.py settings; anything but the default raises
    p.add_argument("--decode_output", default="logits")
    p.add_argument("--ep", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--int8", action="store_true",
                   help="int8 expert weights (bf16 activations)")
    p.add_argument("--int4", action="store_true",
                   help="packed int4 expert weights, 128-row scale groups")
    p.add_argument("--act_quant", action="store_true",
                   help="with --int8/--int4: per-token int8 activations "
                   "in the experts (w8a8 / w4a8)")
    for name in ("fuse_qkv", "dense_quant", "export"):
        p.add_argument(f"--{name}", action="store_true",
                       help="not ported yet")
    p.add_argument("-cmvn", "--cmvn_file", help="not ported yet")
    return p.parse_args(argv)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def main(argv=None):
    args = parse_args(argv)
    if args.export:
        raise NotImplementedError(
            "--export is not ported: the port has no ahead-of-time "
            "artifact (ROADMAP Queue 1 item 5 notes)")
    if args.cmvn_file:
        raise NotImplementedError(
            "-cmvn is not ported yet: ROADMAP Queue 1 item 10")

    import yaml

    from m3asr_tpu_torch import checkpoint as ckpt
    from m3asr_tpu_torch.config import model_config_from_dict
    from m3asr_tpu_torch.device import resolve_device
    from m3asr_tpu_torch.models import moe_conformer
    from m3asr_tpu_torch.runtime.engine import (Engine,
                                                config_from_engine_json)
    from m3asr_tpu_torch.utils.prior import read_prior

    dtype = ("int4" if args.int4 else "int8" if args.int8
             else "bfloat16" if args.bf16 else "float32")
    ecfg, _ = config_from_engine_json(dict(
        dtype=dtype, decode_output=args.decode_output,
        attn_impl=args.attn_impl, ep=args.ep, tp=args.tp,
        act_quant=args.act_quant, fuse_qkv=args.fuse_qkv,
        dense_quant=args.dense_quant))
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
        ckpt.check_consumed(sd, strict=args.strict)
        print(f"Loading model from {args.load_path}")
    else:
        g = torch.Generator(device=device).manual_seed(0)
        params = moe_conformer.init(model_cfg.encoder_conf,
                                    model_cfg.input_dim,
                                    model_cfg.output_dim, g, device=device)
        print("No checkpoint given — using synthetic init")
    numel = sum(int(np.prod(t.shape)) for t in _leaves(params))
    print(f"model parameter size: {numel}")

    prior = read_prior(args.prior_file) if args.prior_file else None
    ecfg.use_prior = prior is not None
    engine = Engine(model_cfg, params, ecfg, prior=prior, device=device)
    engine.save(args.output, raw_yaml=raw)
    print(f"engine written to {args.output}")
    for b, t in engine.buckets.all_buckets():
        print(f"  feat({b}, {t}, {model_cfg.input_dim})  feat_len({b},)")


if __name__ == "__main__":
    main()
