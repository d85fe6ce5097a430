"""Training CLI of the port (the twin of the root ``train.py``):

    python -m m3asr_tpu_torch.train --config cfg.yaml \\
        --tr_rspecifier feats.scp --tr_labels labels.ark \\
        [--tr_aed_labels aed.ark] [--tr_domain_labels d.ark \\
         --tr_acc_labels a.ark] [--cv_rspecifier cv.scp --cv_labels
         cv.ark] [--bmuf [--sync_period N] | --smbr_cmd "tool {post}
         {grad} {trans}" --tr_trans_file trans.txt] --output_dir exp
        [--resume] [--device cpu]

The YAML schema is the JAX CLI's: model_conf / loader_conf /
collate_conf plus the optimizer keys (lr, optim, optim_conf,
schedule_type, schedule_conf, max_grad_norm, weight_decay, name_nodecay)
and the step's (embed_ctc_weight, ce_weight, attn_impl, compute_dtype,
accum_steps, spec_aug_device[_conf], loader_conf.mode -> loss_type,
ctc_weight, tap_weight, loss_scale, lsm_weight, bmuf_conf). Every proto
trains with the CTC / CE step; AED labels select the hier AED recipe of
the MoE conformers; domain and accent labels train the hier recipe's
heads or the in-model heads of ``dfsmn_san_res_embed_domain_acc``.
``--bmuf`` trains in BMUF mode (one replica on one device, synced every
``sync_period`` steps); ``--smbr_cmd`` runs sMBR training with the
external lattice command and writes ``smbr_epoch{n}.pkl``. The step runs
on ``--device`` (``cuda`` unless the caller asks for the CPU). The run
writes ``train.log``, ``scalars/`` and ``checkpoint_{last,best,final}.pkl``
under ``--output_dir``.

It exits where the root ``train.py`` exits (DFSMN with AED labels, sMBR
with the hier recipe, BMUF with ``--zero1/--fsdp`` or tp/sp/pp, domain
labels without heads to train, the meshes it refuses for a model).

Parallel training runs one rank per process over ``torch.distributed``
(``train/parallel.py``):

    python -m torch.distributed.run --nproc-per-node 4 \
        -m m3asr_tpu_torch.train ... --ep 2 --tp 2 [--sp N] [--pp N
        --pp_microbatches M] [--zero1 | --fsdp | --bmuf]

The mesh is (pp, dp, sp, ep, tp) with dp = gcd(batch_size, world // (ep
tp sp pp)), and the world must be exactly that many ranks. Every rank
draws the same seeded trees and keeps its blocks; only rank 0 logs and
writes scalars and checkpoints, which hold the whole trees in the
one-process format (``--resume`` cuts them again, so a run saved on
ranks resumes in one process and the other way round).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ASR training (PyTorch port)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--tr_rspecifier", required=True,
                   help="training features ark/scp (or wav scp with "
                   "loader_conf.raw_wav)")
    p.add_argument("--tr_labels", required=True)
    p.add_argument("--tr_aed_labels", required=False)
    p.add_argument("--tr_domain_labels", required=False,
                   help="per-utterance domain-id int-vector ark; activates "
                   "the domain classifier head")
    p.add_argument("--tr_acc_labels", required=False,
                   help="per-utterance accent-id int-vector ark; activates "
                   "the accent classifier head")
    p.add_argument("--cv_rspecifier", required=False)
    p.add_argument("--cv_labels", required=False)
    p.add_argument("--config", required=True)
    p.add_argument("--log_file", required=False)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh axis (Megatron column/row "
                   "splits)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel mesh axis (the main blocks' "
                   "hiddens split over time)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel mesh axis (GPipe over the "
                   "block stack)")
    p.add_argument("--pp_microbatches", type=int, default=2,
                   help="GPipe microbatches per step (with --pp)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel mesh axis")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: optimizer moments split over dp")
    p.add_argument("--fsdp", action="store_true",
                   help="FSDP: parameters split over dp too, gathered "
                   "where they are used")
    p.add_argument("--smbr_cmd", required=False,
                   help="external lattice command for sMBR training; "
                   "{post}/{grad}/{trans} are substituted per batch")
    p.add_argument("--tr_trans_file", required=False,
                   help="per-utterance transcript lines ('uttid w1 w2 "
                   "...'), parallel to the feature stream")
    p.add_argument("--bmuf", action="store_true",
                   help="BMUF training: local replica steps and a "
                   "block-momentum sync every sync_period batches")
    p.add_argument("--sync_period", type=int, default=0,
                   help="BMUF sync period in batches (or YAML "
                   "bmuf_conf.sync_period; default 100)")
    p.add_argument("--max_epochs", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def refuse_flags(args) -> None:
    """SystemExit where the root train.py exits before it reads the
    model (its words): BMUF with --zero1/--fsdp or with tp/sp/pp. Also
    sMBR with any parallel flag or more than one rank: its loop runs in
    one process, so every rank would run the whole job unsharded."""
    mesh_flags = (args.ep > 1 or args.tp > 1 or args.sp > 1
                  or args.pp > 1 or args.zero1 or args.fsdp or args.bmuf)
    if args.smbr_cmd and (mesh_flags
                          or int(os.environ.get("WORLD_SIZE", "1")) > 1):
        sys.exit("--smbr_cmd trains in one process on one device: drop "
                 "--ep/--tp/--sp/--pp/--zero1/--fsdp/--bmuf and launch it "
                 "without torch.distributed.run")
    if (args.zero1 or args.fsdp) and args.bmuf:
        sys.exit("--zero1/--fsdp shard the global state over dp; BMUF keeps "
                 "per-replica local optimizers — pick one")
    if (args.tp > 1 or args.sp > 1 or args.pp > 1) and args.bmuf:
        raise SystemExit("--bmuf composes with dp/ep only "
                         "(tp/sp/pp need the fused-step path)")


def refuse_mesh(args, model_cfg, hier: bool, attn_impl: str) -> None:
    """SystemExit for the mesh the root train.py refuses for this model,
    in its words."""
    tp, sp, pp = max(args.tp, 1), max(args.sp, 1), max(args.pp, 1)
    if pp > 1 and hier:
        raise SystemExit("--pp supports the non-hier recipes (the hier "
                         "taps need every block's hidden on one stage)")
    if (tp > 1 or sp > 1 or pp > 1) and "dfsmn" in model_cfg.nnet_proto:
        raise SystemExit("--tp/--sp/--pp cover the conformer families; "
                         "DFSMN protos train with dp/ep")
    if pp > 1 and "fmoe" not in model_cfg.nnet_proto:
        raise SystemExit("--pp supports the MoE conformer protos")
    if tp > 1 and attn_impl == "flash":
        raise SystemExit("--tp with attn_impl=flash is unsupported: the "
                         "Pallas kernel has no SPMD rule for head-split "
                         "weights (use attn_impl=xla)")


def build_mesh(args, batch_size: int):
    """The (pp, dp, sp, ep, tp) mesh of the run, over the ranks of
    ``torch.distributed`` (initialized from the env, as the JAX CLI's
    ``distributed.initialize``): dp = gcd(batch_size, world // (ep tp sp
    pp)), as the JAX CLI caps it. None for one process and no parallel
    flag. Raises unless the world is exactly dp x ep x tp x sp x pp
    ranks."""
    import math

    from m3asr_tpu_torch.parallel import distributed
    from m3asr_tpu_torch.parallel.mesh import make_mesh
    ep, tp = max(args.ep, 1), max(args.tp, 1)
    sp, pp = max(args.sp, 1), max(args.pp, 1)
    model = ep * tp * sp * pp
    if not distributed.initialize():
        if model == 1:
            return None      # one device: --zero1/--fsdp split nothing
        world = 1
    else:
        import torch.distributed as dist
        world = dist.get_world_size()
    dp = math.gcd(batch_size, world // model) if world >= model else 0
    if dp * model != world:
        n = max(dp, 1) * model
        raise SystemExit(
            f"the mesh dp{max(dp, 1)} x ep{ep} x tp{tp} x sp{sp} x pp{pp} "
            f"needs {n} ranks, one process each (batch_size {batch_size}); "
            f"this world has {world}: launch with python -m "
            f"torch.distributed.run --nproc-per-node {n} -m "
            "m3asr_tpu_torch.train ...")
    if world == 1:
        return None
    return make_mesh(dp=dp, ep=ep, tp=tp, sp=sp, pp=pp)


def train_config_kwargs(raw: dict, loader_conf: dict) -> dict:
    """The TrainConfig settings the YAML gives, read through the JAX
    CLI's keys."""
    return dict(
        learning_rate=raw.get("lr", 1e-3),
        warmup_steps=(raw.get("schedule_conf") or {}).get("warmup_steps",
                                                          25000),
        grad_clip=raw.get("max_grad_norm", 5.0),
        weight_decay=raw.get("weight_decay", 0.0),
        embed_ctc_weight=raw.get("embed_ctc_weight", 0.0),
        ce_weight=raw.get("ce_weight", 1e-5),
        attn_impl=raw.get("attn_impl", "xla"),
        compute_dtype=raw.get("compute_dtype", "float32"),
        accum_steps=int(raw.get("accum_steps", 1)),
        spec_aug=bool(raw.get("spec_aug_device", False)),
        spec_aug_conf=raw.get("spec_aug_device_conf"),
        loss_type=loader_conf.get("mode", "ctc"))


def main(argv=None):
    """Train as ``argv`` says, in this process; returns the Trainer, or
    with ``--smbr_cmd`` what ``run_smbr_training`` returns (params,
    opt_state, number of batches)."""
    args = parse_args(argv)
    refuse_flags(args)
    import torch
    import yaml

    from m3asr_tpu_torch.config import model_config_from_dict
    from m3asr_tpu_torch.device import resolve_device
    from m3asr_tpu_torch.frontend.augment import CollateFunc
    from m3asr_tpu_torch.io.loader import DataLoader
    from m3asr_tpu_torch.models import aed
    from m3asr_tpu_torch.models.registry import get_family
    from m3asr_tpu_torch.train.lr_scheduler import build_optimizer
    from m3asr_tpu_torch.train.metrics import set_logger
    from m3asr_tpu_torch.train.bmuf import BmufRecipe
    from m3asr_tpu_torch.train.step import (HierTrainConfig, TrainConfig,
                                            check_supported,
                                            init_domain_acc_heads,
                                            init_opt_state, loss_fn,
                                            make_hier_train_step,
                                            make_train_step,
                                            needs_generator)
    from m3asr_tpu_torch.train.parallel import Parallel
    from m3asr_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    with open(args.config) as f:
        raw = yaml.safe_load(f)
    model_cfg = model_config_from_dict(raw)

    collate = CollateFunc(**(raw.get("collate_conf") or {}))
    loader_conf = dict(raw.get("loader_conf") or {})
    loader_conf.setdefault("drop_last", True)

    def make_tr_loader(skip):
        loader = DataLoader(args.tr_rspecifier, args.tr_labels,
                            training=True, loader_conf=loader_conf,
                            collate_func=collate,
                            aed_label_rspec=args.tr_aed_labels,
                            domain_rspec=args.tr_domain_labels,
                            acc_rspec=args.tr_acc_labels)
        return loader(skip_num=skip)

    cv_loader = None
    if args.cv_rspecifier:
        # validation sees every utterance
        cv_conf = dict(loader_conf, drop_last=False)

        def cv_loader():
            return DataLoader(args.cv_rspecifier, args.cv_labels,
                              loader_conf=cv_conf)()

    probe = DataLoader(args.tr_rspecifier, args.tr_labels,
                       loader_conf=loader_conf)
    model_cfg.input_dim = probe.input_dim

    hier = bool(args.tr_aed_labels)
    if hier and "dfsmn" in model_cfg.nnet_proto:
        sys.exit("DFSMN protos carry no AED decoders (the reference's "
                 "DFSMN recipes are CTC/CE-trained) — drop --tr_aed_labels")
    tkw = train_config_kwargs(raw, loader_conf)
    if hier:
        tcfg = HierTrainConfig(
            **tkw, ctc_weight=raw.get("ctc_weight", 0.7),
            tap_weight=raw.get("tap_weight", 0.1),
            loss_scale=raw.get("loss_scale", 1e-4),
            lsm_weight=raw.get("lsm_weight", 0.1))
    else:
        tcfg = TrainConfig(**tkw)
    # the hier recipe on a proto outside the MoE conformers is refused
    # here, before any init
    check_supported(model_cfg, tcfg, hier=hier)
    if not args.smbr_cmd:
        refuse_mesh(args, model_cfg, hier, tcfg.attn_impl)
    if bool(args.tr_domain_labels) != bool(args.tr_acc_labels):
        sys.exit("--tr_domain_labels and --tr_acc_labels go together "
                 "(the domain_acc recipe carries both streams)")
    dfsmn_domain_acc = (model_cfg.nnet_proto
                        == "dfsmn_san_res_embed_domain_acc")
    if args.tr_domain_labels and not (hier or dfsmn_domain_acc):
        sys.exit("--tr_domain_labels/--tr_acc_labels require the hier "
                 "recipe (--tr_aed_labels) or the "
                 "dfsmn_san_res_embed_domain_acc proto (in-model "
                 "heads); without either the streams would be "
                 "silently ignored")
    domain_acc = bool(args.tr_domain_labels)

    family = get_family(model_cfg.nnet_proto)
    params = family.init(model_cfg, torch.Generator(device=device)
                         .manual_seed(args.seed))
    if hier:
        d_model = model_cfg.encoder_conf.attention_dim
        g = torch.Generator(device=device).manual_seed(args.seed + 1)
        params = {"encoder": params}
        for name in ("decoder", "decoder_1", "decoder_2"):
            params[name] = aed.init(model_cfg.decoder_conf,
                                    model_cfg.output_dim, d_model, g)
    if domain_acc and hier:
        # add-on heads over the embed hidden (the DFSMN domain_acc proto's
        # heads live in the model itself)
        enc_conf = model_cfg.encoder_conf
        params.update(init_domain_acc_heads(
            torch.Generator(device=device).manual_seed(args.seed + 2),
            enc_conf.embed_conf.attention_dim, enc_conf.output_dim_domain,
            enc_conf.output_dim_acc))
    optimizer = build_optimizer(
        raw.get("schedule_type", "warmup_noam"), raw.get("schedule_conf"),
        raw.get("lr", 1e-3), optim_type=raw.get("optim", "adam"),
        optim_conf=raw.get("optim_conf"),
        max_grad_norm=raw.get("max_grad_norm", 5.0),
        weight_decay=raw.get("weight_decay", 0.0),
        name_nodecay=raw.get("name_nodecay"), params=params)

    if args.smbr_cmd:
        if hier:
            sys.exit("--smbr_cmd trains on encoder posteriors; drop "
                     "--tr_aed_labels (the reference's sMBR recipe is "
                     "CTC-posterior based)")
        return smbr(args, raw, model_cfg, family, params, optimizer,
                    loader_conf, collate)
    # the mesh (under torch.distributed.run), and this rank's blocks of
    # the trees (every rank drew the same ones from the seed)
    mesh = build_mesh(args, loader_conf.get("batch_size", 1))
    par = None
    if mesh is not None:
        par = Parallel(mesh, params, tp=args.tp > 1, pp=args.pp > 1,
                       zero1=args.zero1, fsdp=args.fsdp, bmuf=args.bmuf,
                       pp_microbatches=args.pp_microbatches)
    rank0 = mesh is None or mesh.rank == 0
    step = (make_hier_train_step(model_cfg, tcfg, optimizer,
                                 with_domain_acc=domain_acc, device=device,
                                 mesh=par)
            if hier else make_train_step(model_cfg, tcfg, optimizer,
                                         with_domain_acc=domain_acc,
                                         device=device, mesh=par))
    bmuf_recipe = opt_state = None
    if args.bmuf:
        # a replica per dp rank (one in one process: dp = gcd(batch_size,
        # devices) = 1 there, as the JAX CLI computes it)
        bconf = dict(raw.get("bmuf_conf") or {})
        sync_period = args.sync_period or bconf.get("sync_period", 100)
        if par is not None:
            params = par.shard(params, par.param_specs)
        opt_state = BmufRecipe.stack(init_opt_state(optimizer, params), 1)
        params = BmufRecipe.stack(params, 1)
        bmuf_recipe = BmufRecipe(
            params, sync_period,
            block_momentum=bconf.get("block_momentum", 0.875),
            block_lr=bconf.get("block_lr", 1.0), mesh=mesh)
    elif par is not None:
        params = par.shard_params(params)
        opt_state = par.init_opt_state(optimizer, params)

    valid_step = None
    if cv_loader is not None:
        # validation never augments; the hier recipe scores the encoder's
        # CTC (the cv arks carry CTC labels); a sharded run's every rank
        # scores the whole cv batch on its blocks
        vcfg = TrainConfig(**dict(tkw, spec_aug=False))

        def valid_step(p, feat, feat_len, targets, target_lens):
            batch = tuple(torch.as_tensor(a, device=device)
                          for a in (feat, feat_len, targets, target_lens))
            with torch.no_grad(), sharded_forward(par):
                if par is not None and par.fsdp:
                    p = par.gather_unblocked(p)
                enc = p["encoder"] if hier else p
                return loss_fn(enc, model_cfg, vcfg, *batch)[0].item()

    os.makedirs(args.output_dir, exist_ok=True)
    if rank0:
        logger = set_logger("m3asr.train",
                            log_file=args.log_file or
                            os.path.join(args.output_dir, "train.log"))
    else:
        logger = logging.getLogger(f"m3asr.train.rank{mesh.rank}")
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
    batch_keys = ("data", "lens", "target", "target_lens")
    if hier:
        batch_keys += ("aed_target", "aed_target_lens")
    if domain_acc:
        batch_keys += ("domain", "acc")
    trainer = Trainer(model_cfg, params, optimizer, step,
                      bmuf=bmuf_recipe, opt_state=opt_state,
                      batch_keys=batch_keys,
                      make_loader=make_tr_loader, valid_loader=cv_loader,
                      save_dir=args.output_dir,
                      log_period=raw.get("log_period", 100),
                      save_period=raw.get("save_period"),
                      max_epochs=raw.get("max_epoch", args.max_epochs),
                      step_takes_rng=needs_generator(model_cfg, tcfg),
                      seed=args.seed,
                      scalar_dir=os.path.join(args.output_dir, "scalars"),
                      logger=logger, parallel=par)
    if args.resume:
        trainer.load_checkpoint("last")
    trainer.run(valid_step)
    trainer.save_checkpoint("final")
    for w in trainer.writers:
        w.close()
    if rank0:
        print(f"training done: {args.output_dir}")
    return trainer


def sharded_forward(par):
    """The context a sharded run's forward needs outside its step (its
    validation): the mesh's collectives, FSDP's layer gathers, the GPipe
    microbatch count. A plain context without a mesh."""
    import contextlib

    from m3asr_tpu_torch.parallel import fsdp
    from m3asr_tpu_torch.parallel import mesh as pmesh
    from m3asr_tpu_torch.parallel import pp as ppipe
    stack = contextlib.ExitStack()
    if par is not None:
        stack.enter_context(pmesh.sharded(par.mesh))
        stack.enter_context(ppipe.microbatches(par.pp_microbatches))
        if par.fsdp:
            stack.enter_context(fsdp.gathering(par.mesh, par.block_specs))
    return stack


def smbr(args, raw, model_cfg, family, params, optimizer, loader_conf,
         collate):
    """The --smbr_cmd mode: sMBR training on the model's posteriors with
    the external lattice command, one checkpoint per epoch under
    --output_dir."""
    import shlex

    from m3asr_tpu_torch.io.loader import DataLoader
    from m3asr_tpu_torch.train.metrics import set_logger
    from m3asr_tpu_torch.train.smbr import (KaldiLatticeBridge,
                                            run_smbr_training)
    loader = DataLoader(args.tr_rspecifier, args.tr_labels, training=True,
                        loader_conf=loader_conf, collate_func=collate,
                        trans_file=args.tr_trans_file)

    def fwd(p, feat, feat_len):
        return family.forward(p, model_cfg, feat, feat_len)

    os.makedirs(args.output_dir, exist_ok=True)
    logger = set_logger("m3asr.smbr",
                        log_file=args.log_file or
                        os.path.join(args.output_dir, "train.log"))
    out = run_smbr_training(
        model_cfg, fwd, params, optimizer,
        make_loader=lambda: loader(output_keys=True),
        bridge=KaldiLatticeBridge(command=shlex.split(args.smbr_cmd)),
        work_dir=args.output_dir,
        max_epochs=raw.get("max_epoch", args.max_epochs), logger=logger,
        log_period=raw.get("log_period", 100))
    print(f"smbr training done: {out[2]} batches -> {args.output_dir}")
    return out


if __name__ == "__main__":
    main()
