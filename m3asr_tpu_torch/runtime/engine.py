"""The inference engine (port of the float and quantized serving
subset of ``m3asr_tpu/runtime/engine.py``), for the hier MoE conformer,
the dense conformer and the DFSMN families (``models/registry.py``).

An engine directory has the JAX package's format, so either package
reads what the other wrote:

    engine_dir/
      config.yaml   the model config (reference YAML schema)
      engine.json   engine settings (dtype, buckets, prior, ...)
      params.npz    weights, flat "a/b/c" paths: floats as float32,
                    quantized expert and dense (kernel_q) weights as
                    int8, scales float32

Precision: ``float32`` engines run full float32 on the card. They turn
TF32 off for cuBLAS and cuDNN (PyTorch's cuDNN default is TF32 for
convolutions), whatever ``fp32_precision`` an engine.json names: the JAX
package's bf16_3x "high" mode has no PyTorch twin. ``bfloat16`` engines
hold weights and activations in bf16; attention scores, softmax, layer
norm statistics, router logits and the expert accumulation run in
float32, as in the JAX package. ``int8`` / ``int4`` engines are bf16
engines whose expert weights are quantized once, at construction, from
their bf16 values (``ops/quant.py``; int4 with 128-row scale groups);
``act_quant`` also quantizes the experts' activations per token (w8a8,
w4a8).

MoE policy: :func:`moe_auto_impl`, the JAX engine's measured TPU policy
taken as the card's, chosen per request bucket from its
post-subsampling token count (B x T for DFSMN, which does not
subsample). Float engines run K1 (``runs_f``); int4
runs K6 up to 128 tokens and K5 beyond; int8 runs the plain-PyTorch
``quant`` stage up to 128 tokens and K4 beyond; ``act_quant`` swaps each
for its a8 twin. On ``cuda`` the kernels run; on ``cpu`` their plain
PyTorch versions do, under the same names. An explicit ``moe_impl``
maps as the JAX engine's TPU branch maps it (``pallas`` to K8 on float
and int8 experts, ``tiled`` to K7 on int4, or a plain-PyTorch stage).
The DFSMN-MoE experts are ReLU clamped at 1.0 and take the stages of
their layer's table only (``models/dfsmn.DFSMN_MOE_STAGES``: no K8, no
capacity stages); an engine whose stage is outside it raises
ValueError. Their expert nodes are per-layer dicts, each quantized; the
dense first cFSMN layer and the embed sub-net keep their weights. A
family with no experts (the dense conformer) in an ``int8`` / ``int4``
engine quantizes nothing, as the JAX engine: it is a bf16 engine.

Attention: ``attn_impl="xla"`` (plain PyTorch, the default) or
``"flash"``, which runs every rel-pos attention layer on the flash
kernel (K2, ``ops/flash_attention.py``; the DFSMN memory-slot attention
through ``flash_attn_mem``; a no_pos conformer's plain attention stays
plain, as in JAX). ``fuse_qkv`` folds q/k/v into one
projection and ``dense_quant`` stores the dense kernels as int8, both
once at construction, in the JAX engine's order.

Buckets: each (batch, length, output mode) runs as a
:class:`BucketProgram`, the counterpart of the JAX engine's compiled
bucket program. On ``cuda`` it is a CUDA graph captured at the bucket's
first use (``get_fn``; ``warmup`` for every bucket); on the CPU, and for
the stages that read the host (``ops/moe.HOST_SYNC_STAGES``), it runs the
eager forward behind the same interface. Outputs follow the JAX engine's
``decode_output`` contract (logits, log_softmax, argmax, topk, beam),
optionally with the hier taps or the final hidden; ``infer_long`` decodes
one utterance longer than the largest bucket in stitched windows.

Sharding: ``ep`` / ``tp`` > 1 (the moe_conformer family only, as in the
JAX engine) runs one rank per shard on a ``torch.distributed`` world of
exactly ep x tp ranks (``parallel/``): every rank builds the whole tree
on the host (int4 w1 repacked per tp chunk), keeps its shard
(``parallel/mesh.param_sharding``: experts over "ep", Megatron splits
over "tp" in the main blocks), and every rank calls :meth:`Engine.infer`
with the same request; the forward all-reduces where GSPMD would and
every rank returns the same output. The expert stage is the JAX mesh
policy's (``dense``, ``quant``, ``quant_a8``) and the buckets run eager
(gloo's collectives cannot be captured). ``save`` gathers the whole tree
(every rank calls it; rank 0 writes); ``load`` shards again. Exported
programs are per rank (the forward fixes the rank's expert offset and
bias share while it is traced, and holds its all-reduces as
``m3asr::mesh_all_reduce``): ``{B}x{T}.{device}.r{rank}of{ep}x{tp}.pt2``,
each recording its rank and mesh shape, run under the engine's mesh. A
serving loop (recognize, serve) runs on rank 0 only: :meth:`Engine.lead`
sends each of rank 0's ``infer`` calls through a ``parallel/follow.Leader``,
which broadcasts the request to the other ranks' follower loops and runs
the forward under its lock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from m3asr_tpu_torch.checkpoint import (flatten_tree, params_to_numpy,
                                        to_torch, unflatten_tree)
from m3asr_tpu_torch.config import (ModelConfig, model_config_from_dict,
                                    model_config_to_dict)
from m3asr_tpu_torch.decode.ctc import ctc_prefix_beam_search_sparse
from m3asr_tpu_torch.decode.device import ctc_beam_search_device
from m3asr_tpu_torch.device import resolve_device
from m3asr_tpu_torch.models.dfsmn import check_moe_stage
from m3asr_tpu_torch.models.registry import get_family
from m3asr_tpu_torch.ops.attention import fuse_qkv_params
from m3asr_tpu_torch.ops.moe import HOST_SYNC_STAGES, collect_routing
from m3asr_tpu_torch.ops.masking import SUBSAMPLED_LENGTH
from m3asr_tpu_torch.ops.quant import (pack_int4, quantize_dense_params,
                                       quantize_moe_params, repack_int4_tp)
from m3asr_tpu_torch.parallel import mesh as pmesh
from m3asr_tpu_torch.runtime.buckets import (BucketSpec, DEFAULT_BATCHES,
                                             DEFAULT_LENGTHS)
from m3asr_tpu_torch.runtime import trace
from m3asr_tpu_torch.runtime.graphs import (  # noqa: F401 (re-exported)
    DEVICE_LOCK, GRAPH_WARMUP_RUNS, GraphProgram, HostStaging, copy_to_host)

log = logging.getLogger("m3asr_tpu_torch")
# the name, inside each exported program file, of the JSON that records
# the rank and ep x tp shape it was built for (Engine.layout)
LAYOUT_FILE = "m3asr_layout.json"

# engine dtype -> activation (and dense weight) dtype
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.bfloat16, "int4": torch.bfloat16}
_QUANT_BITS = {"int8": 8, "int4": 4}

# The JAX engine's token thresholds (m3asr_tpu/runtime/engine.py:101-107):
# a bucket of at most this many post-subsampling tokens takes the
# small-bucket stage.
MOE_Q4_DENSE_TOKEN_THRESHOLD = 128       # int4: K6, else K5
MOE_W4A8_DENSE_TOKEN_THRESHOLD = 128     # w4a8: K6 a8, else K5 a8
MOE_Q8_RUNS_TOKEN_THRESHOLD = 128        # int8/w8a8: quant[_a8], else K4

# Explicit moe_impl requests per engine mode -> the stage, as the JAX
# engine's TPU branch maps them (m3asr_tpu/runtime/engine.py:111-132,
# :146-263). A name outside a mode's table raises ValueError, as there.
_FLOAT_IMPL = {"runs": "runs_f", "runs_f": "runs_f", "dense": "dense",
               "ragged": "ragged", "tiled": "tiled",
               "ragged_padded": "ragged_padded", "capacity": "capacity",
               "pallas": "pallas"}
_INT8_IMPL = {"dense": "quant", "capacity": "quant_capacity",
              "pallas": "quant_pallas", "tiled": "quant_tiled",
              "runs": "quant_runs", "runs_f": "quant_runs",
              **{n: n for n in (
                  "quant", "quant_capacity", "quant_pallas", "quant_tiled",
                  "quant_a8", "quant_a8_tiled", "quant4_pallas",
                  "quant4_tiled", "quant4_a8", "quant4_a8_tiled",
                  "quant_runs", "quant_a8_runs", "quant4_runs",
                  "quant4_a8_runs")}}
_W8A8_IMPL = {"dense": "quant_a8", "quant": "quant_a8",
              "quant_a8": "quant_a8", "tiled": "quant_a8_tiled",
              "quant_tiled": "quant_a8_tiled",
              "quant_a8_tiled": "quant_a8_tiled",
              "runs": "quant_a8_runs", "runs_f": "quant_a8_runs",
              "quant_runs": "quant_a8_runs",
              "quant_a8_runs": "quant_a8_runs"}
# int4 engines: the JAX engine's int4 branches, then its int8 table for
# the names they do not take
_INT4_IMPL = {**_INT8_IMPL,
              "runs": "quant4_runs", "runs_f": "quant4_runs",
              **{n: "quant4_pallas" for n in (
                  "dense", "quant", "pallas", "quant_pallas",
                  "quant4_pallas")},
              **{n: "quant4_tiled" for n in (
                  "tiled", "quant_tiled", "quant4_tiled")}}
_W4A8_IMPL = {**_W8A8_IMPL,
              "runs": "quant4_a8_runs", "runs_f": "quant4_a8_runs",
              "quant4_runs": "quant4_runs",
              "quant4_a8_runs": "quant4_a8_runs",
              **{n: "quant4_a8" for n in (
                  "dense", "quant", "pallas", "quant_pallas",
                  "quant4_pallas", "quant4_tiled", "quant4_a8")},
              **{n: "quant4_a8_tiled" for n in (
                  "tiled", "quant_tiled", "quant4_a8_tiled")}}
# the stages each expert weight format runs; a name the JAX engine maps
# to a stage that cannot run on its weights fails there when traced
# (KeyError, or ValueError "w8a8 needs int8 expert weights")
_RUNS_ON = {
    None: {"dense", "ragged", "tiled", "ragged_padded", "capacity",
           "pallas", "runs_f"},
    8: {"quant", "quant_capacity", "quant_pallas", "quant_tiled",
        "quant_a8", "quant_a8_tiled", "quant_runs", "quant_a8_runs",
        "quant4_runs", "quant4_a8_runs"},
    4: {"quant", "quant_capacity", "quant_pallas", "quant_tiled",
        "quant4_pallas", "quant4_tiled", "quant4_a8", "quant4_a8_tiled",
        "quant_runs", "quant_a8_runs", "quant4_runs", "quant4_a8_runs"},
}


def moe_auto_impl(tokens: int, requested: str = "auto",
                  quant_bits: Optional[int] = None,
                  act_quant: bool = False) -> str:
    """The expert stage for a bucket of ``tokens`` post-subsampling
    tokens: the JAX engine's ``moe_auto_impl`` with its TPU branch as the
    card's policy. quant_bits: None (float), 8 or 4; act_quant: w8a8 /
    w4a8. An explicit ``requested`` name maps as the JAX engine maps it;
    one the JAX engine refuses, or maps to a stage that cannot run on the
    engine's expert weights, raises ValueError."""
    small = tokens <= (MOE_Q8_RUNS_TOKEN_THRESHOLD if quant_bits == 8
                       else MOE_W4A8_DENSE_TOKEN_THRESHOLD if act_quant
                       else MOE_Q4_DENSE_TOKEN_THRESHOLD)
    if requested == "auto":
        if quant_bits == 4 and act_quant:
            return "quant4_a8" if small else "quant4_a8_runs"
        if quant_bits == 4:
            return "quant4_pallas" if small else "quant4_runs"
        if quant_bits == 8 and act_quant:
            return "quant_a8" if small else "quant_a8_runs"
        if quant_bits == 8:
            return "quant" if small else "quant_runs"
        return "runs_f"
    table = {(None, False): _FLOAT_IMPL, (8, False): _INT8_IMPL,
             (8, True): _W8A8_IMPL, (4, False): _INT4_IMPL,
             (4, True): _W4A8_IMPL}[(quant_bits, act_quant)]
    impl = table.get(requested)
    if impl is None or impl not in _RUNS_ON[quant_bits]:
        mode = {None: "float", 8: "int8", 4: "int4"}[quant_bits] \
            + (" act_quant" if act_quant else "")
        runnable = sorted(k for k, v in table.items()
                          if v in _RUNS_ON[quant_bits])
        raise ValueError(f"moe_impl={requested!r} cannot run on {mode} "
                         f"expert weights; choose one of {runnable}")
    return impl


# JAX engine.json settings with no effect on this port's results
_IGNORED = {"fp32_precision", "donate_input"}

DECODE_OUTPUTS = ("logits", "log_softmax", "argmax", "topk", "beam")


@dataclasses.dataclass
class EngineConfig:
    dtype: str = "float32"            # float32 | bfloat16 | int8 | int4
    decode_output: str = "logits"     # logits | log_softmax | argmax |
                                      # topk | beam (see Engine.infer)
    decode_topk: int = 8              # K of "topk"; the beam width of
                                      # "beam"
    use_prior: bool = False           # subtract log-prior from logits
    bucket_lengths: Tuple[int, ...] = DEFAULT_LENGTHS
    bucket_batches: Tuple[int, ...] = DEFAULT_BATCHES
    moe_impl: str = "auto"            # auto, or a stage moe_auto_impl maps
    act_quant: bool = False           # int8/int4: per-token int8
                                      # activations (w8a8 / w4a8)
    attn_impl: str = "xla"            # xla | flash: every attention layer
                                      # on the flash kernel (K2)
    fuse_qkv: bool = False            # one (D, 3D) q/k/v projection and one
                                      # rel-pos score product per layer
                                      # (ops/attention.fuse_qkv_params)
    dense_quant: bool = False         # int8 weight-only dense (non-expert)
                                      # kernels (ops/quant.py
                                      # quantize_dense_params)
    return_hidden: bool = False       # also emit the normalized final
                                      # hidden (the AED rescoring memory)
    return_taps: bool = False         # also emit the hier taps (h6, h12,
                                      # h_final); takes precedence over
                                      # return_hidden
    ep: int = 1                       # expert-parallel ranks (experts split
                                      # over "ep")
    tp: int = 1                       # tensor-parallel ranks (Megatron
                                      # column/row splits over "tp"); an
                                      # engine with ep*tp > 1 runs on a
                                      # torch.distributed world of ep*tp

    def validate(self) -> None:
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.act_quant and self.dtype not in _QUANT_BITS:
            raise ValueError("act_quant requires quantized expert weights: "
                             "dtype='int8' (w8a8) or dtype='int4' (w4a8)")
        if self.attn_impl not in ("xla", "flash"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.fuse_qkv and self.attn_impl == "flash":
            raise NotImplementedError(
                "fuse_qkv with attn_impl='flash': the flash kernels read "
                "the separate q/k/v weights, as the JAX engine's do")
        if self.decode_output not in DECODE_OUTPUTS:
            raise ValueError(f"unknown decode_output {self.decode_output!r}")
        if self.ep < 1 or self.tp < 1:
            raise ValueError(f"ep={self.ep}, tp={self.tp}: each must be >= 1")
        if self.fuse_qkv and self.ep * self.tp > 1:
            raise NotImplementedError(
                "fuse_qkv with ep/tp-sharded serving: the tp head-split rules "
                "for the fused qkv kernel are not wired yet")
        if self.dense_quant and self.ep * self.tp > 1:
            raise NotImplementedError(
                "dense_quant with ep/tp-sharded serving: the tp column-split "
                "rules for kernel_q/kernel_scale pairs are not wired yet — "
                "serve dense-quant engines unsharded or drop dense_quant")
        moe_auto_impl(1, self.moe_impl, _QUANT_BITS.get(self.dtype),
                      self.act_quant)          # raises on a refused name


def config_from_engine_json(meta: Dict) -> Tuple[EngineConfig, Optional[list]]:
    """Parse a (JAX- or port-written) engine.json; settings the JAX engine
    refuses raise as there. Returns (config, neg_log_prior or None)."""
    meta = dict(meta)
    meta.pop("nnet_proto", None)
    neg_log_prior = meta.pop("neg_log_prior", None)
    for name in _IGNORED:
        meta.pop(name, None)
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = sorted(set(meta) - fields)
    if unknown:
        raise ValueError(f"unknown engine.json settings: {unknown}")
    cfg = EngineConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in meta.items()})
    cfg.validate()
    return cfg, neg_log_prior


def _flatten(tree) -> Dict[str, np.ndarray]:
    return flatten_tree(params_to_numpy(tree))


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    out = {}
    for path, v in flat.items():
        if path.endswith("__i4"):
            # legacy JAX engine dirs stored unpacked int4 leaves, one
            # value per byte: repack to the nibble-packed layout
            path, v = path[:-4] + "4", pack_int4(v)
        out[path] = v
    return unflatten_tree(out)


class BucketProgram(GraphProgram):
    """One (batch, length, out_mode) bucket's forward as a
    :class:`GraphProgram` of the static inputs ``feat`` (the engine
    dtype) and ``feat_len`` (int32) on the engine's device; :meth:`run`
    returns the output tuple, :meth:`run_routed` that and the routing
    (:meth:`Engine._forward_fn`)."""

    def __init__(self, fn, feat: torch.Tensor, feat_len: torch.Tensor,
                 graph_pool=None):
        self.feat, self.feat_len = feat, feat_len
        super().__init__(fn, (feat, feat_len), graph_pool)

    def run(self):
        return self.run_routed()[0]

    def run_routed(self):
        """(the output tuple, each run-length expert call's tokens per
        expert, (E,) int32 on the device)."""
        return super().run()


def valid_routing(counts, valid: int) -> np.ndarray:
    """The valid tokens per expert of each expert call, (calls, E)
    int32, from the calls' tokens per expert over the whole bucket
    (``counts``, (calls, E)): the padded positions, each call's total
    less ``valid``, are routed to expert 0 (the gate's mask), so they
    come off its count."""
    hist = np.array(counts, np.int32)
    hist[:, 0] -= hist.sum(axis=1, dtype=np.int32) - valid
    return hist


def sharded_config(cfg: EngineConfig, family_name: str) -> EngineConfig:
    """The settings an ep/tp-sharded engine serves, as the JAX engine
    settles them: only the moe_conformer family shards, and under tp
    ``attn_impl="flash"`` logs a warning and serves ``xla``."""
    if family_name != "moe_conformer":
        raise NotImplementedError(
            "ep/tp-sharded serving supports the moe_conformer family "
            "(scan-stacked (L, E, ...) expert tensors)")
    if cfg.tp > 1 and cfg.attn_impl == "flash":
        log.warning("tp-sharded serving: attn_impl='flash' has no SPMD "
                    "partitioning rule for head-split weights; falling "
                    "back to attn_impl='xla' for this engine")
        cfg = dataclasses.replace(cfg, attn_impl="xla")
    return cfg


def repack_for_tp(tree, tp: int):
    """Every int4 ``w1_q4`` of ``tree`` repacked per tp chunk into
    ``w1_q4c`` (``ops/quant.repack_int4_tp``), so that w1's columns split
    contiguously over "tp"; w2 splits its unpacked rows and keeps its
    bytes. A new tree (the repacked leaves on the CPU)."""
    if isinstance(tree, dict):
        if "w1_q4" in tree:
            tree = dict(tree)
            q4 = tree.pop("w1_q4")
            tree["w1_q4c"] = torch.from_numpy(repack_int4_tp(
                q4.cpu().numpy() if torch.is_tensor(q4) else q4, tp))
            return tree
        return {k: repack_for_tp(v, tp) for k, v in tree.items()}
    if isinstance(tree, list):
        return [repack_for_tp(v, tp) for v in tree]
    return tree


def serving_mesh(ep: int, tp: int,
                 layout_rank: Optional[int] = None) -> pmesh.Mesh:
    """The (dp=1, ep, tp) mesh of a sharded engine over the default
    process group, which must hold exactly ep*tp ranks (the JAX engine
    takes the first ep*tp devices). With ``layout_rank``: that rank's
    place in the layout, with no process group (no collective runs)."""
    import torch.distributed as dist
    n = ep * tp
    if layout_rank is not None:
        return pmesh.make_mesh(dp=1, ep=ep, tp=tp, world_size=n,
                               rank=layout_rank)
    if not dist.is_initialized():
        raise RuntimeError(
            f"ep={ep} x tp={tp} serving runs one rank per shard: launch "
            f"{n} ranks with python -m torch.distributed.run "
            f"--nproc-per-node {n} (parallel.distributed.initialize() "
            "then brings the process group up)")
    if dist.get_world_size() != n:
        raise RuntimeError(f"ep={ep} x tp={tp} needs a world of {n} ranks, "
                           f"not {dist.get_world_size()}")
    return pmesh.make_mesh(dp=1, ep=ep, tp=tp)


def _quantize_expert_nodes(node, bits: int):
    """Every dict holding float ``w1``, ``w2`` and ``router`` (a MoE
    layer's experts: the conformer's stacked ``feed_forward``, each
    DFSMN-MoE layer) quantized; the rest, and experts already quantized,
    as they are."""
    if isinstance(node, dict):
        if "w1" in node and "w2" in node and "router" in node:
            return quantize_moe_params(node, bits=bits)
        return {k: _quantize_expert_nodes(v, bits) for k, v in node.items()}
    if isinstance(node, list):
        return [_quantize_expert_nodes(v, bits) for v in node]
    return node


class Engine:
    """Inference engine for one model (hier MoE conformer, dense conformer
    or DFSMN) and its weights.

    ``device`` defaults to ``cuda`` and raises when there is no card;
    pass ``device="cpu"`` for the plain PyTorch path. On ``cuda`` each
    bucket runs as a CUDA graph captured at its first use
    (:meth:`get_fn`, :meth:`warmup`) unless ``cuda_graphs=False``; the
    expert stages of :data:`HOST_SYNC_STAGES` read the host and always
    run eager.

    The bucket programs read ``params`` and ``neg_log_prior`` as they
    were when they were built (a graph at fixed device addresses): both
    are frozen once the first program exists, and setting either then
    raises. Do not write into their tensors either.

    Threads may share an engine: ``get_fn``, ``infer`` and ``infer_long``
    (and ``warmup`` through them) hold the engine's re-entrant lock, so
    one call at a time uses its staging buffers, static inputs and graph
    pool. A bucket's static inputs and capture also hold
    :data:`~m3asr_tpu_torch.runtime.graphs.DEVICE_LOCK` exclusively, and
    the device section of ``infer`` holds it shared.

    ``layout_rank`` (with ep*tp > 1) builds that rank's engine of the ep
    x tp layout without a ``torch.distributed`` world: its shard of the
    tree, for :meth:`export_bucket` (``save(shards=...)`` exports every
    rank's programs from one process). Its forward's collectives
    raise."""

    def __init__(self, model_cfg: ModelConfig, params,
                 engine_cfg: Optional[EngineConfig] = None,
                 prior: Optional[np.ndarray] = None, device=None,
                 cuda_graphs: bool = True,
                 layout_rank: Optional[int] = None):
        self._programs = {}
        self._graph_pool = None
        self._exported_dir = None     # an engine dir's exported/ programs
        self._loaded = {}             # (batch, length) -> module or None
        self.loaded_buckets = set()   # buckets running a loaded program
        self._lock = threading.RLock()
        self.device = resolve_device(device)
        self.cuda_graphs = cuda_graphs
        self._staging = HostStaging(pin=self.device.type == "cuda")
        self.model_cfg = model_cfg
        self.family = get_family(model_cfg.nnet_proto)
        self.is_moe = self.family.name in ("moe_conformer", "dfsmn_moe")
        self.cfg = engine_cfg or EngineConfig()
        self.cfg.validate()
        if self.cfg.return_hidden and model_cfg.nnet_proto == \
                "dfsmn_base_res":
            raise NotImplementedError(
                "return_hidden: the plain cFSMN stack (dfsmn_base_res) has "
                "no hidden tap")
        if self.cfg.return_taps and self.family.name != "moe_conformer":
            raise NotImplementedError(
                "return_taps (hier decoder memories h6/h12) requires the "
                "hier MoE conformer family")
        self.buckets = BucketSpec(tuple(self.cfg.bucket_lengths),
                                  tuple(self.cfg.bucket_batches))
        self.dtype = _DTYPES[self.cfg.dtype]
        self.quant_bits = _QUANT_BITS.get(self.cfg.dtype)
        if self.device.type == "cuda" and (self.dtype == torch.float32
                                           or self.cfg.act_quant):
            # full float32 (cuDNN convolutions default to TF32); w8a8's
            # s8 products are summed exactly in float32 (ops/quant.py)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            log.info("TF32 disabled for cuBLAS and cuDNN")
        if self.family.name == "dfsmn_moe":
            # the stage of every bucket (explicit names map the same at
            # any token count; auto stays in the table): refused names
            # raise now
            check_moe_stage(self.moe_impl_for(1, 1))
        # ep/tp: every rank builds the whole tree on the host, then keeps
        # its shard (mesh / _specs; a world of ep*tp ranks is required)
        self.mesh = self._specs = self._lead = None
        if self.cfg.ep * self.cfg.tp > 1:
            self.cfg = sharded_config(self.cfg, self.family.name)
            self.mesh = serving_mesh(self.cfg.ep, self.cfg.tp, layout_rank)
        home = torch.device("cpu") if self.mesh is not None else self.device
        self.params = to_torch(params, home, self.dtype)
        # the JAX engine's order: cast, quantize the experts, fuse q/k/v,
        # quantize the dense kernels, shard. Each step leaves params that
        # already carry it (an engine dir, another engine's tree) as they
        # are.
        if self.quant_bits is not None:
            # once, from the bf16 values
            self.params = to_torch(
                _quantize_expert_nodes(self.params, self.quant_bits),
                home, self.dtype)
        if self.cfg.fuse_qkv:
            self.params = fuse_qkv_params(self.params)
        if self.cfg.dense_quant:
            self.params = to_torch(quantize_dense_params(self.params),
                                   self.device, self.dtype)
        if self.mesh is not None:
            full = self.params
            if self.cfg.tp > 1:
                full = to_torch(repack_for_tp(full, self.cfg.tp), home,
                                self.dtype)
            self._specs = pmesh.param_sharding(self.mesh, full,
                                               tp=self.cfg.tp > 1)
            self.params = to_torch(
                pmesh.shard_tree(full, self._specs, self.mesh),
                self.device, self.dtype)
        self.neg_log_prior = None
        if prior is not None and self.cfg.use_prior:
            self.neg_log_prior = torch.as_tensor(
                -np.log(np.asarray(prior))).to(self.device, self.dtype)

    def __setattr__(self, name, value):
        if name in ("params", "neg_log_prior") and \
                self.__dict__.get("_programs"):
            raise RuntimeError(
                f"Engine.{name} is frozen: the bucket programs (CUDA graphs "
                "on the card) read it at fixed addresses. Set it before the "
                "first infer, get_fn or warmup.")
        super().__setattr__(name, value)

    def moe_impl_for(self, batch: int, length: int) -> str:
        """The expert stage of a (batch, length) bucket, from its
        post-subsampling token count (the JAX engine's _moe_impl_for).
        A sharded engine runs the JAX engine's mesh policy, whatever
        ``moe_impl`` asks: ``dense`` for float experts, ``quant`` for
        quantized ones (``quant_a8`` for w8a8)."""
        if self.cfg.ep * self.cfg.tp > 1:
            if self.quant_bits is None:
                return "dense"
            return "quant_a8" if self.cfg.act_quant and \
                self.quant_bits == 8 else "quant"
        sub = SUBSAMPLED_LENGTH[self.model_cfg.encoder_conf.input_layer]
        return moe_auto_impl(batch * int(sub(length)), self.cfg.moe_impl,
                             self.quant_bits, self.cfg.act_quant)

    def subsample_factor(self) -> int:
        """Frame-rate reduction of the encoder front (1 for DFSMN)."""
        return {"linear": 1, "conv2d": 4, "conv2d6": 6, "conv2d8": 8}.get(
            self.model_cfg.encoder_conf.input_layer, 1)

    # ------------------------------------------------------------------
    # bucket programs
    # ------------------------------------------------------------------
    def _model_fn(self, batch: int, length: int):
        """The bucket's model forward ``(params, feat, feat_len) ->`` the
        family forward's tuple (logits, out_len, then the taps or the
        hidden): what :meth:`export_bucket` exports, with the parameter
        tree a runtime input."""
        # the JAX engine's keywords: the hier taps, else the hidden as
        # return_hidden (MoE families) or output_embed (dense ones)
        if self.cfg.return_taps:
            kw = dict(moe_impl=self.moe_impl_for(batch, length),
                      hier_taps=True)
        elif self.is_moe:
            kw = dict(moe_impl=self.moe_impl_for(batch, length),
                      return_hidden=self.cfg.return_hidden)
        else:
            kw = dict(output_embed=self.cfg.return_hidden)
        kw["attn_impl"] = self.cfg.attn_impl
        model_cfg, family_forward = self.model_cfg, self.family.forward
        mesh = self.mesh

        def model(params, feat, feat_len):
            with pmesh.sharded(mesh):
                return tuple(family_forward(params, model_cfg, feat,
                                            feat_len, **kw))
        return model

    def _forward_fn(self, batch: int, length: int, out_mode=None,
                    model=None):
        """The bucket's forward (feat, feat_len) -> the JAX engine's tuple:

        * ``logits`` / ``log_softmax``: (out (B, T', V), out_len);
        * ``argmax``: (ids int32 (B, T'), out_len, best log-prob);
        * ``topk``: (values (B, T', K), out_len, indices int32), best
          first (K = decode_topk);
        * ``beam``: (ids int32 (B, beam, T'), out_len, hyp_lens int32
          (B, beam), scores (B, beam)), the on-device prefix beam search
          (decode/device.py, beam = decode_topk), best first;

        then (h6, h12, h_final) with ``return_taps``, or h_final with
        ``return_hidden``. Every mode but ``logits`` runs in float32
        after log_softmax. ``out_mode`` overrides cfg.decode_output.
        ``model``: the model forward (:meth:`_model_fn`'s signature; a
        loaded program's), under the prior and the output mode.

        The forward returns that tuple and the routing of its run-length
        expert calls (``ops/moe.collect_routing``: each call's tokens per
        expert, in call order), which a graph keeps as static outputs:
        no device work. Other stages, and loaded programs, report
        none."""
        mode = out_mode or self.cfg.decode_output
        if mode not in DECODE_OUTPUTS:
            raise ValueError(f"unknown decode_output {mode!r}")
        k = int(self.cfg.decode_topk)
        if mode in ("topk", "beam") and k < 1:
            raise ValueError(f"decode_output={mode!r} needs decode_topk >= 1")
        model = model or self._model_fn(batch, length)
        params, prior = self.params, self.neg_log_prior

        def outputs(feat, feat_len):
            res = model(params, feat, feat_len)
            out, out_len, extra = res[0], res[1], tuple(res[2:])
            if prior is not None:
                out = out + prior
            if mode == "logits":
                return (out, out_len) + extra
            lp = torch.log_softmax(out.float(), dim=-1)
            if mode == "log_softmax":
                head = (lp, out_len)
            elif mode == "argmax":
                head = (torch.argmax(lp, dim=-1).to(torch.int32), out_len,
                        lp.amax(dim=-1))
            elif mode == "topk":
                vals, idx = torch.topk(lp, k, dim=-1)
                head = (vals, out_len, idx.to(torch.int32))
            else:
                ids, hyp_lens, scores = ctc_beam_search_device(lp, out_len, k)
                head = (ids, out_len, hyp_lens, scores)
            return head + extra

        def forward(feat, feat_len):
            with collect_routing() as routes:
                outs = outputs(feat, feat_len)
            return outs, tuple(routes)

        return forward

    def get_fn(self, batch: int, length: int,
               out_mode=None) -> BucketProgram:
        """The bucket's program, built at its first use. On ``cuda`` (with
        cuda_graphs, for a stage outside HOST_SYNC_STAGES) that captures
        its CUDA graph, and a failed capture raises; else the program
        runs the eager forward behind the same interface."""
        with self._lock:
            return self._get_fn(batch, length, out_mode)

    def _get_fn(self, batch: int, length: int, out_mode) -> BucketProgram:
        mode = out_mode or self.cfg.decode_output
        # sharded buckets run eager: gloo's collectives cannot be captured
        graph = (self.device.type == "cuda" and self.cuda_graphs
                 and self.mesh is None
                 and self.moe_impl_for(batch, length) not in HOST_SYNC_STAGES)
        key = (batch, length, mode, graph)
        prog = self._programs.get(key)
        if prog is None:
            fn = self._forward_fn(batch, length, mode,
                                  self._exported_fn(batch, length))
            pool = None
            if graph:
                # One memory pool for all of the engine's graphs: replays
                # run one at a time (the engine's lock) and infer copies
                # each one's outputs out before the next, so no graph's
                # intermediates are live while another runs, and every
                # graph's static outputs stay allocated, so no capture
                # reuses them.
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                pool = self._graph_pool
            with DEVICE_LOCK.exclusive(), torch.inference_mode():
                # static inputs, outside the graphs' pool
                feat = torch.zeros((batch, length, self.model_cfg.input_dim),
                                   dtype=self.dtype, device=self.device)
                feat_len = torch.full((batch,), length, dtype=torch.int32,
                                      device=self.device)
                prog = BucketProgram(fn, feat, feat_len, pool)
            self._programs[key] = prog
        return prog

    # ------------------------------------------------------------------
    # exported programs: the port of the JAX engine's jax.export
    # artifacts. One torch.export program per (bucket, device) of the
    # model forward, the parameter tree a runtime input (the program
    # holds no weights); the prior and the output mode run on top of it.
    # A sharded engine's program is its rank's: the forward reads the
    # rank's coordinates while it is traced (its experts, its share of
    # the biases) and holds the all-reduces as m3asr::mesh_all_reduce.
    # ------------------------------------------------------------------
    def layout(self) -> Dict[str, int]:
        """The rank and the ep x tp shape the programs are built for (rank
        0 of 1 x 1 unsharded); recorded in each program file."""
        if self.mesh is None:
            return {"rank": 0, "ep": 1, "tp": 1}
        return {"rank": self.mesh.rank, "ep": self.cfg.ep, "tp": self.cfg.tp}

    def program_file(self, batch: int, length: int, device) -> str:
        """The bucket's program file name for ``device``:
        ``{B}x{T}.{device}.pt2``, on ranks
        ``{B}x{T}.{device}.r{rank}of{ep}x{tp}.pt2``."""
        name = f"{batch}x{length}.{torch.device(device).type}"
        if self.mesh is not None:
            lay = self.layout()
            name += f".r{lay['rank']}of{lay['ep']}x{lay['tp']}"
        return name + ".pt2"

    def export_bucket(self, batch: int, length: int, device=None):
        """The bucket's model forward as a ``torch.export`` program for
        ``device`` (default: the engine's), traced on fake tensors of the
        parameter tree's shapes (nothing is computed or copied, and no
        collective runs). The kernels appear in it as their ``m3asr::``
        operators. A bucket whose expert stage reads the host
        (``HOST_SYNC_STAGES``) cannot be exported and raises
        ValueError."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils import _pytree
        impl = self.moe_impl_for(batch, length) if self.is_moe else None
        if impl in HOST_SYNC_STAGES:
            raise ValueError(
                f"bucket {batch}x{length}: expert stage {impl!r} reads "
                "group sizes on the host and cannot be exported (the JAX "
                "engine exports it through lax.cond)")
        dev = torch.device(device or self.device)
        if dev.type == "cuda" and not torch.backends.cuda.is_built():
            raise ValueError("cannot export for cuda: this PyTorch is "
                             "built without CUDA")
        model = self._model_fn(batch, length)

        class Bucket(torch.nn.Module):
            def forward(self, params, feat, feat_len):
                return model(params, feat, feat_len)

        with FakeTensorMode(allow_non_fake_inputs=True):
            args = _pytree.tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev),
                (self.params,
                 torch.empty((batch, length, self.model_cfg.input_dim),
                             dtype=self.dtype),
                 torch.empty((batch,), dtype=torch.int32)))
        with torch.no_grad():
            ep = torch.export.export(Bucket(), args, strict=False)
        ep._example_inputs = None      # fake tensors: nothing to keep
        return ep

    def save_program(self, batch: int, length: int, device,
                     exp_dir: str) -> str:
        """Export the bucket for ``device`` into ``exp_dir`` under
        :meth:`program_file`, with :meth:`layout` recorded in the file.
        Returns the path."""
        path = os.path.join(exp_dir, self.program_file(batch, length, device))
        torch.export.save(self.export_bucket(batch, length, device), path,
                          extra_files={LAYOUT_FILE: json.dumps(self.layout())})
        return path

    def _exported_fn(self, batch: int, length: int):
        """The bucket's loaded program (:meth:`_model_fn`'s signature,
        run under this engine's mesh) if the engine dir holds one for this
        device and rank, else None (the bucket is traced as the model code
        says). A program that cannot be read, or that was built for
        another device, rank, mesh shape or parameter tree, logs a warning
        and is not used. :attr:`loaded_buckets` records the buckets that
        run a loaded program."""
        d = self._exported_dir
        if not d or self.moe_impl_for(batch, length) in HOST_SYNC_STAGES:
            return None
        if (batch, length) in self._loaded:
            return self._loaded[(batch, length)]
        path = os.path.join(d, self.program_file(batch, length, self.device))
        try:
            if not os.path.exists(path):
                others = sorted(f for f in os.listdir(d)
                                if f.startswith(f"{batch}x{length}."))
                if not others:
                    return None
                raise ValueError(f"built for another device or layout: "
                                 f"{others}")
            extra = {LAYOUT_FILE: ""}
            ep = torch.export.load(path, extra_files=extra)
            self._check_program(ep, batch, length, extra[LAYOUT_FILE])
            module = ep.module()
        except Exception as e:       # unreadable, another device or tree
            log.warning("exported bucket %s unusable (%s); retracing",
                        path, e)
            self._loaded[(batch, length)] = None
            return None
        mesh = self.mesh

        def program(params, feat, feat_len):
            with pmesh.sharded(mesh):     # its collectives' mesh
                return module(params, feat, feat_len)
        self._loaded[(batch, length)] = program
        self.loaded_buckets.add((batch, length))
        return program

    def _check_program(self, ep, batch: int, length: int,
                       layout: str = "") -> None:
        """Raise ValueError unless ``ep`` was built for this engine's rank
        and mesh shape (``layout``: the JSON recorded in the file; none
        means rank 0 of 1 x 1), takes this engine's parameter tree and the
        bucket's inputs, on this device, and returns the outputs this
        engine's settings ask for."""
        from torch.utils import _pytree
        got = json.loads(layout) if layout else {"rank": 0, "ep": 1, "tp": 1}
        if got != self.layout():
            raise ValueError(f"built for rank {got.get('rank')} of ep "
                             f"{got.get('ep')} x tp {got.get('tp')}, not "
                             f"rank {self.layout()['rank']} of ep "
                             f"{self.cfg.ep} x tp {self.cfg.tp}")
        feat = torch.empty((batch, length, self.model_cfg.input_dim),
                           dtype=self.dtype, device="meta")
        lens = torch.empty((batch,), dtype=torch.int32, device="meta")
        leaves, spec = _pytree.tree_flatten(((self.params, feat, lens), {}))
        if spec != ep.call_spec.in_spec:
            raise ValueError("its inputs are not this engine's parameter "
                             "tree and bucket")
        # logits, out_len, then the taps or the hidden (_model_fn)
        n_out = 2 + (3 if self.cfg.return_taps else
                     1 if self.cfg.return_hidden else 0)
        if ep.call_spec.out_spec.num_leaves != n_out:
            raise ValueError(f"it returns {ep.call_spec.out_spec.num_leaves}"
                             f" outputs, not the {n_out} of this engine's "
                             "return_taps / return_hidden")
        vals = [n.meta.get("val") for n in ep.graph.nodes
                if n.op == "placeholder"][-len(leaves):]
        for v, t in zip(vals, leaves):
            if v is None or tuple(v.shape) != tuple(t.shape) \
                    or v.dtype != t.dtype:
                raise ValueError("its input shapes or dtypes differ")
            if v.device.type != self.device.type:
                raise ValueError(f"built for {v.device.type}, not "
                                 f"{self.device.type}")

    def warmup(self, buckets=None, execute: bool = False) -> None:
        """Build the given (default: all) buckets' programs: on ``cuda``
        this captures their graphs. ``execute`` also serves one request of
        zeros on the smallest bucket."""
        items = list(buckets or self.buckets.all_buckets())
        with self._lock:
            for b, t in items:
                self.get_fn(b, t)
            if execute and items:
                b, t = min(items)
                self.infer(np.zeros((b, t, self.model_cfg.input_dim),
                                    np.float32),
                           np.full((b,), t, np.int32))

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def lead(self, leader) -> None:
        """Rank 0 of a sharded engine running a serving loop: every later
        :meth:`infer` (``infer_long``'s windows and ``warmup``'s call
        included) first broadcasts its request through ``leader`` (a
        ``parallel/follow.Leader``) to the followers, which run the same
        call, and holds the leader's lock through the forward. The
        leader's current generation is kept: after its ``reload`` this
        engine's calls raise. ``None`` detaches."""
        if leader is not None and self.mesh is None:
            raise ValueError("only a sharded (ep/tp) engine leads followers")
        self._lead = None if leader is None else (leader, leader.generation)

    def _leading(self, feat: np.ndarray, feat_len: np.ndarray, mode: str):
        """The leader's INFER call of this request, or a null context."""
        if self._lead is None:
            return contextlib.nullcontext()
        leader, generation = self._lead
        return leader.infer(feat, feat_len, DECODE_OUTPUTS.index(mode),
                            generation)

    def infer(self, feat: np.ndarray, feat_len: np.ndarray, out_mode=None):
        """feat: (B, T, input_dim); feat_len: (B,) or (1, B). Pads to the
        bucket, runs its program, trims to the valid region. Returns
        numpy arrays in the JAX engine's contract (see _forward_fn):
        floats as float32, ids and lengths as int32, every frame-aligned
        output cut to max(out_len) frames. ``out_mode`` overrides
        cfg.decode_output for this call.

        The features go through a pinned host buffer to the program's
        static input; out_len comes from the subsampling arithmetic on
        the host, and only the valid [:B, :max(out_len)] region of each
        output comes back, in its own dtype (bf16 widened to float32 on
        the host, which is exact).

        Traced (``runtime/trace.py``) as ``engine.infer``, with the
        children ``engine.prepare`` (the checks, the bucket, the locks,
        ``get_fn``), ``engine.stage``, ``engine.replay``, ``engine.sync``
        and ``engine.copy_out``; while the tracer is on, the call's
        routing comes back with the outputs (:meth:`_copy_back`)."""
        with trace.span("engine.infer") as call, \
                contextlib.ExitStack() as held:
            with trace.span("engine.prepare"):
                feat, feat_len, bb, bt, mode, out_len = self._request(
                    feat, feat_len, out_mode)
                B = feat.shape[0]
                if call is not None:
                    call.meta.update(bucket=[bb, bt], B=B,
                                     lens=feat_len.tolist())
                held.enter_context(self._lock)
                held.enter_context(self._leading(feat, feat_len, mode))
                prog = self.get_fn(bb, bt, out_mode)
            max_out = int(out_len.max()) if B else 0
            with DEVICE_LOCK.shared(), torch.inference_mode():
                self._stage_in(prog, feat, feat_len)
                with trace.span("engine.replay"):
                    outs, routes = prog.run_routed()
                got = self._copy_back(outs, mode, B, max_out, routes,
                                      int(np.maximum(out_len, 0).sum()))
        return (got[0], out_len) + tuple(got[1:])

    def _request(self, feat, feat_len, out_mode):
        """The request checked whole, before it runs (on ranks a call
        that fails after the leader's broadcast stops every rank):
        (feat float32 (B, T, D), feat_len int32 (B,), the bucket's batch
        and length, the output mode, out_len int32 (B,))."""
        feat = np.ascontiguousarray(feat, np.float32)
        feat_len = np.ascontiguousarray(np.asarray(feat_len).reshape(-1),
                                        np.int32)
        D = self.model_cfg.input_dim
        if feat.ndim != 3 or feat.shape[2] != D:
            raise ValueError(f"feat must be (B, T, {D}), got {feat.shape}")
        B, T = feat.shape[:2]
        if feat_len.shape != (B,) or (B and not (
                1 <= feat_len.min() and feat_len.max() <= T)):
            raise ValueError(f"feat_len must hold {B} lengths in [1, {T}], "
                             f"got {feat_len.tolist()}")
        bb, bt = self.buckets.pick(B, T)
        mode = out_mode or self.cfg.decode_output
        if mode not in DECODE_OUTPUTS:
            raise ValueError(f"unknown decode_output {mode!r}")
        sub = SUBSAMPLED_LENGTH[self.model_cfg.encoder_conf.input_layer]
        return (feat, feat_len, bb, bt, mode,
                np.asarray(sub(feat_len), np.int32))

    def _stage_in(self, prog: BucketProgram, feat: np.ndarray,
                  feat_len: np.ndarray) -> None:
        """Pad the request into the host buffer and copy it (on ``cuda``
        asynchronously, from pinned memory) into the static inputs: the
        span ``engine.stage``."""
        with trace.span("engine.stage"):
            B, T = feat.shape[:2]
            hf, hl = self._staging.views("in", [
                (tuple(prog.feat.shape), torch.float32),
                (tuple(prog.feat_len.shape), torch.int32)])
            hfn, hln = hf.numpy(), hl.numpy()
            hfn[:B, :T] = feat
            hfn[:B, T:] = 0
            hfn[B:] = 0
            hln[:] = 0
            hln[:B] = feat_len
            prog.feat.copy_(hf, non_blocking=True)
            prog.feat_len.copy_(hl, non_blocking=True)

    def _copy_back(self, outs, mode: str, B: int, max_out: int,
                   routes=(), valid: int = 0):
        """Every output but out_len, cut to its valid region ([:B] and
        max_out frames on its time axis) and copied in its own dtype
        into the host buffer. Returns them as numpy arrays of their own,
        in order: bf16 widened to float32 on the host (exact), the rest
        copied out of the reused buffer; the wait for the device is the
        span ``engine.sync``, what follows it ``engine.copy_out``.

        While the tracer is on, the program's ``routes`` (each expert
        call's tokens per expert) come back in the same synchronisation,
        stacked into one copy, and
        :func:`valid_routing` of them, with ``valid`` the call's valid
        tokens, goes into the call's ``engine.infer`` meta as
        ``routing`` and into the tracer's routing counters."""
        srcs = []
        for i, t in enumerate(outs):
            if i == 1:                          # out_len: from the host
                continue
            if mode == "beam" and i in (2, 3):  # hyp_lens, scores
                t = t[:B]
            elif mode == "beam" and i == 0:     # (B, beam, T') ids
                t = t[:B, :, :max_out]
            else:
                t = t[:B, :max_out]
            srcs.append(t)
        routed = bool(routes) and trace.on()
        if routed:
            srcs.append(torch.stack(routes))    # one copy for them all
        got = copy_to_host(self._staging, "out", srcs, self.device,
                           ("engine.sync", "engine.copy_out"))
        if routed:
            hist = valid_routing(got.pop(), valid)
            trace.annotate("engine.infer", routing=hist)
            trace.add_routing(hist)
        return got

    def infer_long(self, feat: np.ndarray, feat_len: Optional[int] = None,
                   overlap: Optional[int] = None):
        """Long-form decode of ONE utterance longer than the largest
        bucket: forwards over windows of the largest bucket length with
        ``overlap`` input frames of context on each side, stitched by
        center cuts (each window gives the output rows whose centers
        fall in its exclusive region). Returns infer()'s tuple; every
        frame-aligned extra (best log-prob, top-K indices, taps, hidden)
        stitches with the same cuts. A ``beam`` engine runs its windows
        in ``topk`` mode (K = the beam width, the search's own per-frame
        prune) and finishes one host prefix beam search over the
        stitched candidates, returning (ids (1, beam, T'), out_len,
        hyp_lens, scores) (the JAX engine's infer_long)."""
        with self._lock:
            return self._infer_long(feat, feat_len, overlap)

    def _infer_long(self, feat, feat_len, overlap):
        feat = np.asarray(feat)
        if feat.ndim == 3:
            if feat.shape[0] != 1:
                raise ValueError("infer_long takes a single utterance")
            feat = feat[0]
        T = int(feat_len) if feat_len is not None else feat.shape[0]
        W = self.buckets.lengths[-1]
        if T <= W:
            return self.infer(feat[None, :T], np.array([T]))
        mode = self.cfg.decode_output
        win_mode = "topk" if mode == "beam" else None
        f = self.subsample_factor()
        # 64 input frames of context per side per subsampling step, at
        # most a quarter window; aligned to the subsampling grid
        O = overlap if overlap is not None else min(64 * f, W // 4)
        O = max(f, (O // f) * f)
        hop = W - 2 * O
        if hop <= 0:
            raise ValueError(f"overlap {O} too large for window {W}")
        pieces, extras = [], None
        s = 0
        while True:
            e = min(s + W, T)
            win = e - s
            r = self.infer(feat[None, s:e], np.array([win]),
                           out_mode=win_mode)
            n = int(r[1][0])
            lo = 0 if s == 0 else O // f
            hi = n if e == T else min(n, (win - O) // f)
            pieces.append(r[0][0, lo:hi])
            if extras is None:
                extras = [[] for _ in r[2:]]
            for j, a in enumerate(r[2:]):
                extras[j].append(a[0, lo:hi])
            if e == T:
                break
            s += hop
        stitched = np.concatenate(pieces, axis=0)[None]
        ex = tuple(np.concatenate(x, axis=0)[None] for x in extras)
        out_len = np.array([stitched.shape[1]], np.int32)
        if mode != "beam":
            return (stitched, out_len) + ex
        beam = int(self.cfg.decode_topk)
        nbest = ctc_prefix_beam_search_sparse(stitched[0], ex[0][0],
                                              int(out_len[0]), beam)
        ids = np.zeros((1, beam, stitched.shape[1]), np.int32)
        hyp_lens = np.zeros((1, beam), np.int32)
        scores = np.full((1, beam), -np.inf, np.float32)
        for i, (prefix, score) in enumerate(nbest[:beam]):
            ids[0, i, :len(prefix)] = prefix
            hyp_lens[0, i] = len(prefix)
            scores[0, i] = score
        return (ids, out_len, hyp_lens, scores) + ex[1:]

    # ------------------------------------------------------------------
    # engine directories (the JAX package's format)
    # ------------------------------------------------------------------
    def save(self, engine_dir: str, raw_yaml: Optional[dict] = None,
             export_devices: Optional[Tuple[str, ...]] = None,
             shards: Optional[Tuple[int, int]] = None):
        """Write the engine dir; ``export_devices`` (e.g. ``("cuda",
        "cpu")``) also writes every bucket's program for each device,
        ``exported/{B}x{T}.{device}.pt2`` (:meth:`export_bucket`).

        A sharded engine writes the whole tree, as the JAX engine does:
        every rank calls ``save`` (the shards are gathered), rank 0
        writes; with ``export_devices`` each rank writes its own programs,
        ``exported/{B}x{T}.{device}.r{rank}of{ep}x{tp}.pt2``.
        ``shards=(ep, tp)`` writes this single-device engine as the dir of
        an ep x tp engine (``build --ep/--tp``): the sharded settings in
        engine.json, int4 w1 repacked for tp, and with ``export_devices``
        every rank's programs, each traced here from that rank's shard
        (``layout_rank``; no collective runs)."""
        import yaml
        cfg, params = self.cfg, self.params
        exporters = [self]
        if self.mesh is not None:
            params = pmesh.gather_tree(params, self._specs, self.mesh)
        elif shards is not None and shards[0] * shards[1] > 1:
            cfg = sharded_config(dataclasses.replace(
                cfg, ep=shards[0], tp=shards[1]), self.family.name)
            cfg.validate()
            if cfg.tp > 1:
                params = repack_for_tp(params, cfg.tp)
            exporters = (Engine(self.model_cfg, params, cfg, device="cpu",
                                layout_rank=r)
                         for r in range(cfg.ep * cfg.tp))
        os.makedirs(engine_dir, exist_ok=True)
        if export_devices:
            exp_dir = os.path.join(engine_dir, "exported")
            os.makedirs(exp_dir, exist_ok=True)
            for eng in exporters:
                for dev in export_devices:
                    for b, t in eng.buckets.all_buckets():
                        eng.save_program(b, t, dev, exp_dir)
        if self.mesh is not None and self.mesh.rank != 0:
            return
        np.savez(os.path.join(engine_dir, "params.npz"), **_flatten(params))
        meta = dataclasses.asdict(cfg)
        meta["nnet_proto"] = self.model_cfg.nnet_proto
        if self.neg_log_prior is not None:
            meta["neg_log_prior"] = self.neg_log_prior.float().cpu().tolist()
        with open(os.path.join(engine_dir, "engine.json"), "w") as f:
            json.dump(meta, f, indent=1)
        with open(os.path.join(engine_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(raw_yaml or model_config_to_dict(self.model_cfg),
                           f)

    @classmethod
    def load(cls, engine_dir: str, device=None) -> "Engine":
        import yaml
        with open(os.path.join(engine_dir, "config.yaml")) as f:
            model_cfg = model_config_from_dict(yaml.safe_load(f))
        with open(os.path.join(engine_dir, "engine.json")) as f:
            ecfg, neg_log_prior = config_from_engine_json(json.load(f))
        with np.load(os.path.join(engine_dir, "params.npz")) as z:
            params = _unflatten(dict(z))
        eng = cls(model_cfg, params, ecfg, device=device)
        exp_dir = os.path.join(engine_dir, "exported")
        if os.path.isdir(exp_dir):
            eng._exported_dir = exp_dir
        if neg_log_prior is not None:
            eng.neg_log_prior = torch.as_tensor(
                np.asarray(neg_log_prior)).to(eng.device, eng.dtype)
        return eng
