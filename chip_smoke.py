#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero with no
result line:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them.
2. build: every hand-written kernel, compiled by nvcc from csrc/ (one
   nvcc per source, all started together), with ptxas registers and
   spills per instantiation (K1, K4-K8 and K6's/K8's row-tile front
   must not spill, also when an earlier run built them: nvcc's output is
   kept beside each library); the SASS (cuobjdump) of the flash kernels,
   K1 (expert_tile_gemm), K4/K5 (runs_gemm, runs_gemm_s8), K6
   (dense_gemm), K7 (tiled_gemm, tiled_gemm_s8), K8 (stream_gemm) and the
   front (row_tiles) must run bf16, int8-on-bf16 K8 and K4-K7
   weight-only on HMMA.16816.F32.BF16, K4-K7 a8 on IMMA.16832.S8.S8 and
   float32 on FFMA, with no other MMA and no atomic; the front runs no
   MMA.
3. kernels against their plain PyTorch versions at the flagship widths
   (E=32, d=512, h=1024):
   K6's and K8's row-tile front (row_tiles, in each library) against its
   plain twin (ops/row_tiles.py) at 1, 63, 127, 511, 1020 and 2048 rows
   under every routing below: the same tile table and row order.
   K1 (float run-length, moe_runs_f): stacked L=18 at layers 0 and 17,
   fp32 and bf16, at 63/127/511/1020/1535 tokens (the 256/512/2048/
   6144-frame buckets and the 4x1000 request) under the four routings of
   K4-K6 below, and stacked L=2 at d=320, h=640
   (multiples of K1's 64-column block, d not of 128). fp32:
   allclose(rtol 1e-5, atol 1e-5); bf16: max|diff| within 1e-2 of
   max|ref|. Under the router's and the heavy routing fp32 K1 must equal
   K8 (moe_stream) bit for bit: both sum in ascending k.
   K4 (int8 run-length), K5 (int4 run-length) at 63, 511 and 1020
   tokens, K6 (int4 dense streamer) at 63 and 127, each weight-only and
   a8, random int weights stacked L=3 at layers 0 and 2, bf16
   activations, under a router's skewed routing, all tokens on one
   expert, half the experts empty, and 55% of the tokens on one expert
   (heavy); K6 also with gate -1 rows, which must come out 0; K5 also
   with 32-row int4 groups
   (a group ends inside its 64-deep slices) at 63 and 511 tokens; K4, K5
   and K6 also at d=320, h=640, where the two nibble halves of w2's
   packed columns meet inside one column block. Under the router's and
   the heavy routing at 63 tokens K5 a8 must equal K6 a8 bit for bit
   (the same quant_rows, s8 tiles, exact s32 sums and epilogue).
   Weight-only: max|diff| within 1e-2 of max|ref| (bf16 output and
   hidden, float32 sums in another order). a8: within 2e-2 (the integer
   sums are exact on both sides, but SiLU rounds differently in the two,
   which can move a hidden value to the next of its 127 levels).
   K2 (flash forward: out and LSE) and K3 (flash backward: dq2, dk2, dv)
   at B=4, T=S=255 and B=1, T=S=511, heads (H=8, Dk=64) and (H=4,
   Dk=128), fp32 and bf16, under mixed lengths (with a 7-frame and a
   zero-length row), a 16-frame static chunk window, and that window
   with mem_cols=4, at the wrapper's tile heights; then at B=4, T=255
   with the window, every tile height each kernel is built for (K2 16,
   32, 64 rows; K3 16, 32), where two K3 calls must give bit-identical
   gradients. Each output within FLASH_TOL of max|ref| (fp32 2e-6,
   float32 sums in another order; bf16 2e-2); the LSE on rows with a key
   to attend.
   K8 (dense float/int8 streamer) on fp32, bf16 and int8 weights (int8
   on bf16 activations) and K7 (tiled int4 grouped GEMM) weight-only and
   a8, at 63, 511 and 1020 tokens (K7's tile 64, 64, 128), under the
   router's routing, all tokens on one expert, half the experts empty,
   the heavy routing and (K8) rows padded with gate -1, which must
   come out 0; K7 stacked
   L=3 at layers 0 and 2, with upper_bound at layer 1, and at d=320,
   h=640, on bf16 activations, and weight-only on float32 activations
   at the same token counts under the router's and the heavy routing
   (with upper_bound at 511, d=320 at 63). fp32 within 1e-5 of
   max|ref| (float32 sums in another order), bf16, int8 and weight-only
   int4 within 1e-2, a8 within 2e-2. Under the router's and the heavy
   routing at 511 and 1020 tokens K7 a8 must equal K5 a8 bit for bit
   (the same quant_rows, s8 tiles, exact s32 sums and epilogue).
4. serve, float: the flagship hier MoE conformer (6 embed blocks, 18 MoE
   blocks, 32 experts, vocabulary 5000; random weights from a seeded
   CUDA generator, routers randomised) in an fp32 and a bf16 Engine
   (phases 4-7 run their engines eager: cuda_graphs=False) answers
   1x206, 4x1000 and 1x2048 frames. Each forward must launch K1 once per
   MoE block (18), and the logits must match the same engine
   with moe_impl="dense" on the valid region. fp32: allclose(1e-5,
   1e-3). bf16 rounding sends tokens at router near-ties to other
   experts, differently in the two runs; those flips and the
   free-running max|diff| and argmax agreement are printed. The dense
   run is repeated with its tokens sent to the kernel run's experts and
   must meet max|diff| / max|ref| <= 0.05 on every valid frame (its
   per-frame argmax agreement is printed); against the fp32 logits the
   kernel path's mean distance must be within 1.5x the dense path's and
   its argmax agreement within three standard errors of the dense
   path's. Hypotheses are CTC-greedy decoded.
5. serve, quantized: int8, w8a8, int4 and w4a8 Engines built from the
   same weights (int8 quantized once for int8 and w8a8, int4 once for
   int4 and w4a8) answer the same requests. Each forward must launch
   exactly: int4/w4a8 K6 18 times at 1x206 (63 tokens) and K5 18 times
   at 4x1000 and 1x2048 (1020 and 511 tokens); int8/w8a8 K4 18 times at
   the two long requests, and no kernel at 1x206, which takes the
   plain-PyTorch quant / quant_a8 stage. The logits must match the same
   engine with its experts on the kernels' plain versions, routing
   pinned to the kernel run's: max|diff| / max|ref| <= 0.05 on every
   valid frame. Each mode's distance and argmax agreement against the
   fp32 logits (the quantization error) are printed, not held. Each
   engine's median request latency, peak device memory and device time
   under torch.profiler are printed before it is freed.
6. serve, explicit expert stages: fp32, bf16 and int8 Engines with
   moe_impl="pallas" (K8) and int4 and w4a8 Engines with
   moe_impl="tiled" (K7) answer the three requests; each forward must
   launch its kernel once per MoE block (18) and no other expert kernel,
   and the logits must match the same engine with its experts on the
   kernels' plain versions, routing pinned: fp32 allclose(1e-5, 1e-3),
   the others max|diff| / max|ref| <= 0.05. The plain-PyTorch stages
   (fp32 tiled, ragged, ragged_padded, capacity; int8 quant_tiled,
   quant_capacity; w8a8 quant_a8_tiled) answer the 4x1000 request with
   no expert kernel, held the same way to the dense / quant / quant_a8
   engine. An int4 Engine with dense_quant and fuse_qkv answers 1x206,
   held within 0.05 of the int4 engine on the same weights dequantized
   (its distance from the unquantized dense weights' engine is
   printed). Each engine's latency, device time and peak memory are
   printed.
7. serve, flash: fp32 and bf16 Engines with attn_impl="flash" answer
   the same requests. Each forward must launch K2 once per attention
   layer (24) and K1 once per MoE block (18); the logits are held to
   phase 4's attn_impl="xla" engine with its tokens sent to the flash
   run's experts: fp32 allclose(1e-5, 1e-3), bf16 max|diff| / max|ref|
   <= 0.05 (and printed against the free-running fp32 logits).
8. serve, graphs: the auto fp32, bf16, int8, w8a8, int4 and w4a8
   Engines, fp32 and bf16 with attn_impl="flash", fp32 "pallas" (K8) and
   int4 "tiled" (K7) answer the same requests through the CUDA-graph path
   (Engine.get_fn: GRAPH_WARMUP_RUNS eager forwards on a side stream,
   then one captured). Each bucket must be captured (no stage of
   ops/moe.HOST_SYNC_STAGES on it), launch each kernel of phases 4-7's
   policy once per MoE block (K2 once per attention layer with flash) in
   every one of those forwards and in no replay, and give outputs
   bit-equal to the same engine's eager forward. Eager and graph request
   latency (median of 5), device time and D2H time under torch.profiler,
   busy share, peak memory, and each graph's replay by CUDA events are
   printed. The bf16 engine's argmax and topk (K=8) outputs at 4x1000
   are held to its logits reduced on the host in float64: argmax ids
   equal where the top two log-probs are not tied, best log-probs and
   top-K values within 1e-6, each index naming its value. The fp32
   engine's beam search (width 8) at 4x1000: its best hypothesis and
   score (1e-4 relative) equal to the host prefix beam search on the
   card's log-probs (bf16 logits hold exact ties, at which two searches
   keep different prefixes). The bytes each mode copies back, and the
   host's part of a logits copy-back, are printed. infer_long answers
   one 15000-frame request on the fp32 and int4 engines (out_len the
   subsampled length, finite logits, a second call equal to the first).
   K1's layout prep alone is captured and timed at the requests' token
   counts. The six auto engines' graph replays at 1x206, 1x2048 and the
   largest bucket (1x6144) are printed as the bucket tuner's points
   (m3asr_tpu_torch/runtime/bucket_tuner.py). Last, the fp32 engine's
   warmup() captures all 24 buckets: its seconds, launches and peak
   memory.
9. stream: the flagship's chunk streams (8 slots, chunk 16, two left
   chunks; 8 streams of 300-1200 frames, staggered, pushed in uneven
   pieces) on fp32 and bf16 engines (K1) and an int4 engine (K6), each
   mode's stage as the port's serve picks it. A StreamBatcher's chunk
   program is captured (K1/K6 launched 18 times in each of its 3
   forwards) and replayed tick by tick (no launch), its outputs bit-equal
   to the same program run eager (18 launches a tick); single-stream
   StreamingSessions run the same audio through their own graphs, and
   for four streams also eager, bit-equal chunk for chunk. Held, with the
   eager session's experts pinned to the batched run's (GateRecorder):
   batched against single, fp32 allclose(1e-5, 1e-3), bf16 and int4
   max|diff| / max|ref| <= 0.05; then, on the causal flagship
   (causal=True in both encoders), the batched streams against
   moe_conformer.forward with chunk_attention_mask, experts pinned to the
   streams', on every full chunk's frames, at the same tolerances. The
   frames whose experts differ when free-running are printed. A
   loopback m3asr_tpu_torch.serve (--warmup, port 0) on a bf16 engine
   answers a greedy and a beam request (two hotword phrases, a seeded
   ARPA bigram LM) and two concurrent beam streams; every response must
   equal the engine and the host decode called directly (the native C++
   decoder, which must have built). Two threads call infer and
   infer_long on that engine, each result equal to the serial one.
   Printed: the median tick and a stream's chunk latency, graph and
   eager; a tick's device time and busy share; each graph's pool; K1
   and K6 alone at 16 and 128 tokens.
10. train: the flagship's CTC training step (make_train_step, Adam with
   warmup_noam, embed CTC weight 0.3 so that every attention layer
   trains) on 4 x 1000 frames with seeded targets. One fp32 gradient
   with attn_impl="flash" and one with "xla", routing pinned: losses
   within 1e-5 relative, gradients within TRAIN_GRAD_TOL of each
   parameter group's max|g|. Four flash steps (24 K2 and 24 launches of
   each K3 kernel per step, asserted; losses finite), two xla steps, one
   bf16-compute flash step (its loss within 2e-2 of the fp32 loss); step
   times, the busy share of one step under torch.profiler, peak memory.
   TF32 is switched on before each fp32 step is built, and
   make_train_step must switch it off again (cuBLAS and cuDNN); cuDNN's
   is switched on again before the steps, which must switch it off.
11. times: each kernel per call (CUDA events over many calls after
   warm-up, layers rotated so weights come from device memory) and its
   launches alone, at the main path's token counts (K1 at 63, 511 and
   1020 with its column block and each launch's live blocks; K6 at 63
   and 127 and K8 at 63, 511 and 1020 under the router's and the heavy
   routing, K7 at 63, 511 and 1020 under the router's (float32
   weight-only too), each beside its yardstick's launches alone on the
   same tokens: K5 for K6 and K7, K1 for K8; K2/K3 at both long
   requests' attention
   shapes, with each launch's tile rows and blocks),
   beside its bound, the plain version's time and, for K2/K3,
   scaled_dot_product_attention's; the float engines' request latency,
   peak device memory and device time of one request under
   torch.profiler with the kernels that took most of it and K1's part.
   Every device-time line names the expert kernels' (K1, K4-K8, the
   front) summed time in the request.

The line before the last is one JSON object describing each kernel
(route, source, launches on the main path, error, times, bound); the
last line is {"ok": true, "device": {...}}.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_OPS_PER_S = {"float32": 67e12,  # fp32 outside the tensor cores
                  "bfloat16": 989e12, "int8": 1979e12}
E, D, H, L = 32, 512, 1024, 18
TOKENS = (63, 127, 511, 1020, 1535)
REQUESTS = ((1, 206), (4, 1000), (1, 2048))
KINDS = ("router", "one_expert", "half_empty")
# (kernel, a8) -> the name of that kernel variant in the output
QUANT_NAMES = {("K4", False): "moe_runs_q8[int8]",
               ("K4", True): "moe_runs_q8[w8a8]",
               ("K5", False): "moe_runs_q4[int4]",
               ("K5", True): "moe_runs_q4[w4a8]",
               ("K6", False): "moe_q4_dense[int4]",
               ("K6", True): "moe_q4_dense[w4a8]"}
MODES = {("int8", False): "int8", ("int8", True): "w8a8",
         ("int4", False): "int4", ("int4", True): "w4a8"}
# engine dtype -> the kernel each request's forward launches once per
# MoE block (None: the plain-PyTorch quant stage, no kernel)
QUANT_EXPECT = {"int8": (None, "K4", "K4"), "int4": ("K6", "K5", "K5")}
# K2/K3 against their plain versions: max|diff| / max|ref| per output
# (FMA kernels: at most 6.5e-7 in float32; MMA kernels 6.8e-3 in bf16)
FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def log(*a):
    print(*a, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("FAIL device: torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def phase_build(kernels):
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels.ALL)) as ex:
        for lib, _ in zip(kernels.ALL, ex.map(lambda k: k.load(),
                                              kernels.ALL)):
            # ptxas -v: per entry function, its name with the template
            # arguments (demangled by c++filt where the host has it), then
            # its spills, then its registers and shared memory
            mangled = [ln.split("'")[1] for ln in lib.log.splitlines()
                       if "Compiling entry function" in ln]
            names = iter(demangle(mangled))
            ptxas = []
            for ln in lib.log.splitlines():
                if "Compiling entry function" in ln:
                    ptxas.append(short_name(next(names)))
                elif not ptxas:
                    continue
                elif "spill stores" in ln and not ln.strip().startswith(
                        "0 bytes stack frame, 0 bytes spill"):
                    ptxas[-1] += " SPILLS " + ln.strip()
                elif "registers" in ln:
                    ptxas[-1] += ": " + ln.split(":", 1)[1].strip()
            if lib.build_seconds is None:     # built by an earlier run
                log(f"build {lib.source}: already in {kernels.BUILD_DIR}; "
                    "ptxas: " + " | ".join(ptxas))
            else:
                log(f"build {lib.source}: {lib.build_seconds:.2f} s, "
                    f"{' '.join(lib.command[:4])} ...; ptxas: "
                    + " | ".join(ptxas))
            for kern in BUILD_GATES.get(lib.source, ()):
                found = [ln for ln in ptxas if expert_kernel(ln) == kern]
                if not found:
                    raise SystemExit(f"FAIL build: no ptxas record of {kern}")
                spilled = [ln for ln in found if "SPILLS" in ln]
                if spilled:
                    raise SystemExit(f"FAIL build: {kern} spills: "
                                     + " | ".join(spilled))
    log(f"build: all kernels in {time.perf_counter() - t0:.2f} s")
    kernel_sass(kernels)


def demangle(names):
    """C++ names demangled by c++filt where the host has it."""
    if not names or not shutil.which("c++filt"):
        return list(names)
    return subprocess.run(["c++filt"], input="\n".join(names),
                          capture_output=True, text=True,
                          check=True).stdout.splitlines()


def expert_kernel(name):
    """Which expert kernel an instantiation's or a device event's name
    belongs to: "K1" (moe_runs.cu's expert_tile_gemm), "K4/K5"
    (runs_gemm), "K4/K5 a8" (runs_gemm_s8), "K6" / "K6 a8" (moe_q4.cu's
    dense_gemm weight-only / a8), "K7" / "K7 a8" (moe_q4_tiled.cu's
    tiled_gemm / tiled_gemm_s8), "K8" (moe_stream.cu's stream_gemm),
    "front" (row_tiles, K6's and K8's row-tile front), or None."""
    if "runs_gemm_s8" in name:
        return "K4/K5 a8"
    if "runs_gemm" in name:
        return "K4/K5"
    if "tiled_gemm_s8" in name:
        return "K7 a8"
    if "tiled_gemm" in name:
        return "K7"
    if "expert_tile_gemm" in name:
        return "K1"
    if "dense_gemm" in name:
        # a8 is the first template argument (mangled: ILb1E)
        a8 = re.search(r"dense_gemm(?:[<\[]true|ILb1E)", name)
        return "K6 a8" if a8 else "K6"
    if "stream_gemm" in name:
        return "K8"
    return "front" if "row_tiles" in name else None


KERNEL_NAMES = {"K1": "expert_tile_gemm", "K4/K5": "runs_gemm",
                "K4/K5 a8": "runs_gemm_s8", "K6": "dense_gemm",
                "K6 a8": "dense_gemm a8", "K7": "tiled_gemm",
                "K7 a8": "tiled_gemm_s8", "K8": "stream_gemm",
                "front": "row_tiles"}
# per library, the kernels that must have a ptxas record and no spill
BUILD_GATES = {"moe_runs.cu": ("K1", "K4/K5", "K4/K5 a8"),
               "moe_q4.cu": ("K6", "K6 a8", "front"),
               "moe_q4_tiled.cu": ("K7", "K7 a8"),
               "moe_stream.cu": ("K8", "front")}


def sass_want(short):
    """The instruction a kernel instantiation must run: K4-K7 a8
    IMMA.16832.S8.S8, K4/K5 and K6 weight-only and every bf16 one
    (K1, K7, K8, flash) HMMA.16816.F32.BF16, float32 FFMA (no TF32 MMA);
    the row-tile front none (it must run no MMA either)."""
    kern = expert_kernel(short)
    if kern in ("K4/K5 a8", "K6 a8", "K7 a8"):
        return "IMMA.16832.S8.S8"
    if kern in ("K4/K5", "K6") or "bfloat16" in short:
        return "HMMA.16816.F32.BF16"
    return None if kern == "front" else "FFMA"


def kernel_sass(kernels):
    """The arithmetic instructions of every tensor-core kernel's
    instantiations, from cuobjdump -sass of the built libraries: each
    flash kernel, K1 (moe_runs.cu's expert_tile_gemm), K4/K5 (runs_gemm,
    runs_gemm_s8), K6 (moe_q4.cu's dense_gemm), K7 (moe_q4_tiled.cu's
    tiled_gemm, tiled_gemm_s8), K8 (moe_stream.cu's stream_gemm) and
    their row-tile front. Each must run on its sass_want
    instruction (or FFMA alone for float32, no TF32 MMA), no other MMA,
    and no atomic (ATOM, ATOMS, RED)."""
    cuobjdump = os.path.join(os.path.dirname(kernels.find_nvcc()),
                             "cuobjdump")
    for lib, moe in ((kernels.FLASH, False), (kernels.MOE_RUNS, True),
                     (kernels.MOE_Q4, True), (kernels.MOE_Q4_TILED, True),
                     (kernels.MOE_STREAM, True)):
        sass = subprocess.run([cuobjdump, "-sass", lib.build()],
                              capture_output=True, text=True,
                              check=True).stdout
        funcs, counts = [], []
        for ln in sass.splitlines():
            if "Function :" in ln:
                funcs.append(ln.split("Function :")[1].strip())
                counts.append({})
            elif funcs and "/*" in ln and ";" in ln:
                words = ln.split("*/", 1)[1].split()
                op = words[1] if words[0].startswith("@") else words[0]
                if op.startswith(("HMMA", "IMMA", "FFMA", "ATOM", "RED")):
                    op = op.split(".")[0] if op.startswith("FFMA") else op
                    counts[-1][op] = counts[-1].get(op, 0) + 1
        lines = []
        for name, c in zip(demangle(funcs), counts):
            short = short_name(name.replace("<", "[").replace(">", "]"))
            if moe and expert_kernel(short) is None:
                continue
            want = sass_want(short)
            lines.append(f"{short}: " + (", ".join(
                f"{k} x{v}" for k, v in sorted(c.items())) or "no MMA"))
            wrong = [k for k in c if k != want and k.startswith(
                ("HMMA", "IMMA", "ATOM", "RED"))]
            if (want is not None and not c.get(want)) or wrong:
                raise SystemExit(f"FAIL build: {short} runs {sorted(c)}, "
                                 f"not {want} alone")
        if not lines:
            raise SystemExit(f"FAIL build: no kernel in {lib.source}")
        log(f"sass {lib.source} (cuobjdump -sass): " + " | ".join(lines))


def expert_weights(torch, dtype, gen, n_layers=L, d=D, h=H):
    """Stacked (n_layers, E, d, h) / (n_layers, E, h, d) weights,
    per-layer biases."""
    def u(*shape, scale):
        return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
                * scale).to(dtype)
    return {"w1": u(n_layers, E, d, h, scale=0.5 * (6 / (d + h)) ** 0.5),
            "w2": u(n_layers, E, h, d, scale=0.5 * (6 / (d + h)) ** 0.5),
            "b1": u(E, h, scale=0.1), "b2": u(E, d, scale=0.1)}


def routing(torch, kind, n, gen):
    """Gate indices (1, n): a random router over random catEmbed
    features (skewed but spread, as a real router), all tokens on one
    expert, half the experts empty, 55% of the tokens on the router's
    busiest expert and the rest as the router sends them ("heavy": the
    engine's real routing gives one expert a median 43-56% of a block's
    tokens, PERF.md section 5), or the router result as is."""
    feats = torch.randn(n, 2 * D, generator=gen, device="cuda")
    router = torch.randn(2 * D, E, generator=gen, device="cuda") * 0.5
    logits = feats @ router
    if kind == "half_empty":
        logits[:, 1::2] = -1e30
    idx = logits.argmax(-1)
    if kind == "one_expert":
        idx = torch.full_like(idx, E - 1)
    if kind == "heavy":
        pick = torch.randperm(n, generator=gen, device="cuda")
        idx[pick[:round(0.55 * n)]] = torch.bincount(idx, minlength=E).argmax()
    return idx.to(torch.int32)[None]


def phase_kernel(torch, moe_runs):
    """K1 against its plain version: fp32 allclose(1e-5, 1e-5), bf16
    max|diff| within 1e-2 of max|ref|; fp32 K1 and K8 equal bit for bit.
    Returns the worst max_abs_err per dtype."""
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops.moe_stream import stream_kernel
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = {}
    bn = kernels.MOE_RUNS.load().moe_runs_f_col_block()

    def check(dtype, p, n, kind, layer, d=D):
        x = torch.randn(1, n, d, generator=gen, device="cuda").to(dtype)
        gate = routing(torch, kind, n, gen)
        got = moe_runs.runs_kernel.launch(p, x, gate, layer)
        torch.cuda.synchronize()
        ref = moe_runs.moe_experts_runs_reference(p, x, gate, layer)
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if dtype == torch.float32:
            ok = torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
        else:
            ok = err <= 1e-2 * scale
        log(f"kernel moe_runs_f {str(dtype)[6:]} d={d} "
            f"h={p['w1'].shape[-1]} n={n} {kind} layer={layer} "
            f"active={n_active(torch, gate)} column block {bn}: "
            f"max_abs_err={err:.3e} max|ref|={scale:.3e} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("FAIL kernel: moe_runs_f disagrees "
                             "with its plain version")
        key = str(dtype)[6:]
        max_err[key] = max(max_err.get(key, 0.0), err)
        if dtype == torch.float32 and kind in ("router", "heavy"):
            # K8 sums fp32 in K1's order: one accumulator, ascending k
            one = {k: v[layer] if k in ("w1", "w2") else v
                   for k, v in p.items()}
            if not torch.equal(got, stream_kernel.launch(one, x, gate)):
                raise SystemExit("FAIL kernel: fp32 moe_runs_f and "
                                 "moe_stream differ")

    for dtype in (torch.float32, torch.bfloat16):
        p = expert_weights(torch, dtype, gen)
        cases = [(n, kind) for n in TOKENS for kind in KINDS + ("heavy",)]
        cases.append((5, "router"))                   # N < tile
        for n, kind in cases:
            for layer in (0, L - 1):
                check(dtype, p, n, kind, layer)
        # d=320, h=640: multiples of 64, not both of 128
        p = expert_weights(torch, dtype, gen, n_layers=2, d=320, h=640)
        for n in (63, 511):
            check(dtype, p, n, "router", 1, d=320)
    log("kernel moe_runs_f float32 == moe_stream float32 (K8) bit for bit "
        "at every router and heavy case above")
    return max_err


def quant_experts(torch, bits, gen, n_layers, d=D, h=H, group=128):
    """Random quantized expert weights stacked (n_layers, E, ...): int8
    values, or random bytes (each byte holds two int4 values); float32
    scales (n_layers, E, [G,] 1, out) sized for outputs of order one,
    with `group`-row groups for int4 where the contraction allows; bf16
    biases (E, out)."""
    rms = 73.3 if bits == 8 else 4.6       # rms of uniform int8 / int4

    def ints(*shape):
        return torch.randint(-127 if bits == 8 else -128, 128, shape,
                             generator=gen, device="cuda",
                             dtype=torch.int16).to(torch.int8)

    def scales(k, out):
        groups = k // group if bits == 4 and k % group == 0 and k > group \
            else 1
        shape = (n_layers, E) + ((groups,) if bits == 4 else ()) + (1, out)
        return (torch.rand(shape, generator=gen, device="cuda") + 0.5) \
            / (rms * k ** 0.5)

    def bias(n):
        return ((torch.rand(E, n, generator=gen, device="cuda") * 2 - 1)
                * 0.1).to(torch.bfloat16)
    half = 2 if bits == 4 else 1
    k1, k2 = ("w1_q4", "w2_q4") if bits == 4 else ("w1_q", "w2_q")
    return {k1: ints(n_layers, E, d, h // half),
            k2: ints(n_layers, E, h, d // half),
            "w1_scale": scales(d, h), "w2_scale": scales(h, d),
            "b1": bias(h), "b2": bias(d)}


def at_layer(p, layer):
    """The wrappers' arguments for one layer: the stacked weights and
    this layer's scales."""
    return {k: v[layer] if k.endswith("_scale") else v for k, v in p.items()}


def n_active(torch, gate):
    return int((torch.bincount(gate.flatten().long(), minlength=E) > 0)
               .sum())


def phase_kernel_quant(torch):
    """K4, K5 and K6 against their plain versions, and K5 a8 against K6 a8
    bit for bit; returns the worst max_abs_err of each (kernel, a8)."""
    from m3asr_tpu_torch.ops import moe_q4, moe_runs
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {}
    n_layers = 3
    runs = {"K4": moe_runs.runs_q8_kernel, "K5": moe_runs.runs_q4_kernel}

    def check(key, kern, plain, p, n, kind, layer, d=D, note=""):
        kname, a8 = key
        x = torch.randn(1, n, d, generator=gen, device="cuda") \
            .to(torch.bfloat16)
        gate = stage_routing(torch, kind, n, gen)
        pl = at_layer(p, layer)
        got = kern.launch(pl, x, gate, layer, act_quant=a8)
        torch.cuda.synchronize()
        if kind == "padded" and bool((got[gate < 0] != 0).any()):
            raise SystemExit(f"FAIL kernel: {QUANT_NAMES[key]} wrote a row "
                             "of no expert")
        ref = plain(pl, x, gate, layer, act_quant=a8)
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        ok = err <= (2e-2 if a8 else 1e-2) * scale
        log(f"kernel {QUANT_NAMES[key]} ({kname}) d={d} n={n} {kind} "
            f"layer={layer}{note} active={n_active(torch, gate[gate >= 0])}: "
            f"max_abs_err={err:.3e} max|ref|={scale:.3e} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"FAIL kernel: {QUANT_NAMES[key]} disagrees "
                             "with its plain version")
        worst[key] = max(worst.get(key, 0.0), err)
        if kname == "K5" and a8 and kind in ("router", "heavy") and n == 63:
            # the same quant_rows, exact s32 sums and epilogue as K6
            k6 = moe_q4.q4_kernel.launch(pl, x, gate, layer, act_quant=True)
            if not torch.equal(got, k6):
                raise SystemExit(
                    "FAIL kernel: moe_runs_q4[w4a8] and moe_q4_dense[w4a8] "
                    "differ by up to "
                    f"{(got.float() - k6.float()).abs().max().item():.3e}")
            log(f"kernel moe_runs_q4[w4a8] (K5) == moe_q4_dense[w4a8] (K6) "
                f"bit for bit: n={n} {kind} layer={layer}{note}")

    last = n_layers - 1
    for bits, kname in ((8, "K4"), (4, "K5")):
        p = quant_experts(torch, bits, gen, n_layers)
        for a8 in (False, True):
            for n in (63, 511, 1020):
                for kind in KINDS + ("heavy",):
                    for layer in (0, last):
                        check((kname, a8), runs[kname],
                              moe_runs.moe_experts_runs_reference, p, n,
                              kind, layer)
    for a8 in (False, True):
        for n in (63, 127):
            for kind in KINDS + ("heavy", "padded"):
                for layer in (0, last):
                    check(("K6", a8), moe_q4.q4_kernel,
                          moe_q4.moe_experts_q4_reference, p, n, kind,
                          layer)
    # 32-row int4 groups, the smallest the width rule takes: a group ends
    # in the middle of each 64-deep slice of K5
    p = quant_experts(torch, 4, gen, n_layers, group=32)
    for a8 in (False, True):
        for n in (63, 511):
            for layer in (0, last):
                check(("K5", a8), runs["K5"],
                      moe_runs.moe_experts_runs_reference, p, n, "router",
                      layer, note=" groups=32 rows")
    # d=320: w2's packed columns hold columns j and j + 160, so the
    # column block [128, 192) takes low nibbles and high nibbles
    for bits, kname in ((8, "K4"), (4, "K5")):
        p = quant_experts(torch, bits, gen, 1, d=320, h=640)
        for a8 in (False, True):
            check((kname, a8), runs[kname],
                  moe_runs.moe_experts_runs_reference, p, 63, "router", 0,
                  320)
            check((kname, a8), runs[kname],
                  moe_runs.moe_experts_runs_reference, p, 511, "router", 0,
                  320)
            if bits == 4:
                check(("K6", a8), moe_q4.q4_kernel,
                      moe_q4.moe_experts_q4_reference, p, 63, "router", 0,
                      320)
    return worst


STAGE_TOKENS = (63, 511, 1020)       # the requests' token counts
# K8 variant -> (activation dtype, weight format); K7 a8 -> its name
STREAM_NAMES = {"float32": "moe_stream[float32]",
                "bfloat16": "moe_stream[bfloat16]",
                "int8": "moe_stream[int8]"}
TILED_NAMES = {False: "moe_q4_tiled[int4]", True: "moe_q4_tiled[w4a8]"}
TILED_F32 = "moe_q4_tiled[int4 float32]"   # no engine reaches it


def stream_layers(torch, wtype, gen, n_layers):
    """n_layers one-layer expert dicts for K8 (the model hands K8 one
    layer's views): float weights (E, d, h) / (E, h, d) of wtype with
    biases of that type, or (wtype "int8") int8 weights with float32
    (E, 1, out) scales and bf16 biases."""
    if wtype == "int8":
        p = quant_experts(torch, 8, gen, n_layers)
        return [{k: v[i] if k != "b1" and k != "b2" else v
                 for k, v in p.items()} for i in range(n_layers)]
    p = expert_weights(torch, getattr(torch, wtype), gen)
    return [{"w1": p["w1"][i], "w2": p["w2"][i], "b1": p["b1"],
             "b2": p["b2"]} for i in range(n_layers)]


def stage_routing(torch, kind, n, gen):
    """The routings of the K4-K8 checks: routing()'s kinds, and (K6, K8)
    "padded", the router's routing with every fifth row and the last row
    padded with gate -1, as the JAX wrapper pads rows of no expert."""
    if kind != "padded":
        return routing(torch, kind, n, gen)
    gate = routing(torch, "router", n, gen)
    gate[0, ::5] = -1
    gate[0, -1] = -1
    return gate


FRONT_TOKENS = (1, 63, 127, 511, 1020, 2048)


def phase_kernel_front(torch):
    """K6's and K8's row-tile front (row_tiles, built into each of their
    libraries) against its plain twin (ops/row_tiles.py): the same tile
    count, rows of no expert, row order and tile table, at 1 to 2048
    rows under every routing, gate -1 padding included. Returns the
    number of cases."""
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import row_tiles
    gen = torch.Generator(device="cuda").manual_seed(12)
    stream = torch.cuda.current_stream().cuda_stream
    cases = 0
    for lib, prefix in ((kernels.MOE_Q4.load(), "moe_q4"),
                        (kernels.MOE_STREAM.load(), "moe_stream")):
        size = getattr(lib, f"{prefix}_front_ints")
        run = getattr(lib, f"{prefix}_row_tiles")
        for n in FRONT_TOKENS:
            if size(n, E) != row_tiles.front_ints(n, E):
                raise SystemExit(f"FAIL kernel: {prefix} front size "
                                 f"{size(n, E)} != plain "
                                 f"{row_tiles.front_ints(n, E)}")
            for kind in KINDS + ("heavy", "padded"):
                gate = stage_routing(torch, kind, n, gen).reshape(n)
                words = torch.full((size(n, E),), -7, dtype=torch.int32,
                                   device="cuda")
                if run(gate.data_ptr(), n, E, words.data_ptr(), stream):
                    raise SystemExit(f"FAIL kernel: {prefix}_row_tiles "
                                     "launch error")
                torch.cuda.synchronize()
                got = row_tiles.read_front(words, n, E)
                want = row_tiles.read_front(
                    row_tiles.row_tiles_reference(gate, E), n, E)
                same = got[:2] == want[:2] and all(
                    torch.equal(a, b) for a, b in zip(got[2:], want[2:]))
                if not same:
                    raise SystemExit(f"FAIL kernel: {prefix}_row_tiles n={n} "
                                     f"{kind} differs from its plain twin: "
                                     f"tiles {got.n_tiles} / {want.n_tiles},"
                                     f" no expert {got.n_none} / "
                                     f"{want.n_none}")
                cases += 1
    log(f"kernel row_tiles (K6/K8 front) == plain twin at {cases} cases: "
        f"n in {FRONT_TOKENS}, {KINDS + ('heavy', 'padded')}, both "
        "libraries")
    return cases


def rel_check(got, ref, tol, label, name):
    """max|diff| within tol of max|ref| (both finite); logs one line and
    exits on a failure. Returns max|diff|."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = np.isfinite(err) and err <= tol * scale
    log(f"kernel {label}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
        f"(held to {tol:g} of it) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"FAIL kernel: {name} disagrees with its plain "
                         "version")
    return err


def phase_kernel_stage(torch):
    """K8 (fp32, bf16, int8 weights on bf16 activations) and K7
    (weight-only on bf16 and float32 activations, a8) against their plain
    versions at the flagship widths and the requests' token counts, and
    K7 a8 against K5 a8 bit for bit. Returns the worst max_abs_err per
    variant name."""
    from m3asr_tpu_torch.ops import moe_q4, moe_runs, moe_stream
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = {}
    # K8: fp32 within 1e-5 of max|ref| (float32 sums in another order),
    # bf16 and int8 (bf16 weights, hidden and output) within 1e-2
    for wtype, name in STREAM_NAMES.items():
        p = stream_layers(torch, wtype, gen, 1)[0]
        xdt = torch.float32 if wtype == "float32" else torch.bfloat16
        tol = 1e-5 if wtype == "float32" else 1e-2
        for n in STAGE_TOKENS:
            for kind in KINDS + ("heavy", "padded"):
                x = torch.randn(1, n, D, generator=gen, device="cuda").to(xdt)
                gate = stage_routing(torch, kind, n, gen)
                got = moe_stream.stream_kernel.launch(p, x, gate)
                torch.cuda.synchronize()
                ref = moe_stream.moe_experts_dense_stream_reference(
                    p, x, gate)
                if kind == "padded" and bool((got[gate < 0] != 0).any()):
                    raise SystemExit(f"FAIL kernel: {name} wrote a row of "
                                     "no expert")
                err = rel_check(got, ref, tol, f"{name} (K8) n={n} {kind} "
                                f"active={n_active(torch, gate[gate >= 0])}",
                                name)
                worst[name] = max(worst.get(name, 0.0), err)
    # K7: stacked L=3 at layers 0 and 2; bf16 weight-only within 1e-2 of
    # max|ref|, a8 within 2e-2 (as K4-K6), float32 weight-only within 1e-5
    # (as fp32 K8: float32 sums in another order)
    n_layers = 3
    p = quant_experts(torch, 4, gen, n_layers)

    def check_tiled(p, a8, n, kind, layer, d=D, upper=None,
                    dtype=torch.bfloat16):
        x = torch.randn(1, n, d, generator=gen, device="cuda").to(dtype)
        gate = routing(torch, kind, n, gen)
        pl = at_layer(p, layer)
        got = moe_q4.q4_tiled_kernel.launch(pl, x, gate, layer=layer,
                                            act_quant=a8, upper_bound=upper)
        torch.cuda.synchronize()
        ref = moe_q4.moe_experts_q4_tiled_reference(
            pl, x, gate, layer=layer, act_quant=a8, upper_bound=upper)
        f32 = dtype == torch.float32
        name = TILED_F32 if f32 else TILED_NAMES[a8]
        err = rel_check(got, ref, 1e-5 if f32 else 2e-2 if a8 else 1e-2,
                        f"{name} (K7) d={d} n={n} tile="
                        f"{moe_q4.tiled_tile(n)} {kind} layer={layer} "
                        f"upper_bound={upper} active={n_active(torch, gate)}",
                        name)
        worst[name] = max(worst.get(name, 0.0), err)
        if a8 and kind in TIME_KINDS and n in (511, 1020) and upper is None:
            # the same quant_rows, s8 tiles, exact s32 sums and epilogue
            k5 = moe_runs.runs_q4_kernel.launch(pl, x, gate, layer,
                                                act_quant=True)
            if not torch.equal(got, k5):
                raise SystemExit(
                    "FAIL kernel: moe_q4_tiled[w4a8] and moe_runs_q4[w4a8] "
                    "differ by up to "
                    f"{(got.float() - k5.float()).abs().max().item():.3e}")
            log(f"kernel moe_q4_tiled[w4a8] (K7) == moe_runs_q4[w4a8] (K5) "
                f"bit for bit: n={n} {kind} layer={layer}")

    for a8 in (False, True):
        for n in STAGE_TOKENS:
            for kind in KINDS + ("heavy",):
                for layer in (0, n_layers - 1):
                    check_tiled(p, a8, n, kind, layer)
        check_tiled(p, a8, 511, "router", 1, upper=0.5)   # DFSMN's clamp
    for n in STAGE_TOKENS:
        for kind in TIME_KINDS:
            check_tiled(p, False, n, kind, n_layers - 1,
                        dtype=torch.float32)
    check_tiled(p, False, 511, "router", 1, upper=0.5, dtype=torch.float32)
    # d=320, h=640: w2's packed columns hold columns j and j + 160 (both
    # nibble halves inside one column block); w1 one scale group, w2 five
    p = quant_experts(torch, 4, gen, 1, d=320, h=640)
    for a8 in (False, True):
        for n in (63, 1020):
            check_tiled(p, a8, n, "router", 0, 320)
    check_tiled(p, False, 63, "router", 0, 320, dtype=torch.float32)
    return worst


def flash_inputs(torch, B, T, H, Dk, dtype, masks, gen):
    """q2 (B,H,T,2Dk), k2, v, g and the masks of one K2/K3 check case:
    ``lengths`` mixed (full, one short row, one zero-length row when
    B > 1), ``window`` a static chunk mask of 16 frames (with lengths),
    ``mem_cols`` that window plus 4 always-attended leading keys."""
    from m3asr_tpu_torch.ops import masking
    from m3asr_tpu_torch.ops.flash_attention import window_from_mask
    D2 = 2 * Dk
    q2, k2 = (torch.randn(B, H, T, D2, generator=gen, device="cuda")
              .to(dtype) for _ in range(2))
    v = torch.randn(B, H, T, Dk, generator=gen, device="cuda").to(dtype)
    g = torch.randn(B, H, T, Dk, generator=gen, device="cuda").to(dtype)
    lens = [T, 7, 0, T - 40][:B] if masks == "lengths" else \
        [T, T - 40, 100, T][:B]
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    window, mem = None, 0
    if masks != "lengths":
        m = masking.add_optional_chunk_mask(lens, T, False, False, 0, 16, -1)
        window = window_from_mask(m, T, T)
        mem = 4 if masks == "mem_cols" else 0
    return q2, k2, v, g, lens, window, mem


FLASH_SHAPES = ((4, 255), (1, 511))      # (B, T = S): the main path's
FLASH_HEADS = ((8, 64), (4, 128))        # (H, Dk): MoE, embed blocks


def phase_kernel_flash(torch):
    """K2 (out, LSE) and K3 (dq2, dk2, dv) against their plain versions at
    the flagship's shapes, head widths, types and masks, with the wrapper's
    tile heights; then every tile height each kernel is built for at B=4,
    T=255, where two K3 calls must also give bit-identical gradients.
    Returns the worst max_abs_err of each (kernel, dtype)."""
    from m3asr_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = {}

    def check(dtype, B, T, H, Dk, masks, rows=None):
        dname = str(dtype)[6:]
        tol = FLASH_TOL[dname]
        q2, k2, v, g, lens, window, mem = flash_inputs(
            torch, B, T, H, Dk, dtype, masks, gen)
        scale = Dk ** -0.5
        fwd_rows, bwd_rows = (None, None) if rows is None else (
            rows, (min(rows, 32),) * 2)
        out, lse = fa.flash_kernels.forward(
            q2, k2, v, lens, scale, window, mem, True, rows=fwd_rows)
        delta = (g.float() * out.float()).sum(-1, keepdim=True)
        grads = fa.flash_kernels.backward(q2, k2, v, g, lse, delta, lens,
                                          scale, window, mem, rows=bwd_rows)
        torch.cuda.synchronize()
        r_out, r_lse = fa.flash_attention_reference(
            q2, k2, v, lens, scale, window, mem)
        r_grads = fa.flash_attention_bwd_reference(
            q2, k2, v, g, r_lse,
            (g.float() * r_out.float()).sum(-1, keepdim=True),
            lens, scale, window, mem)
        label = (f"kernel flash {dname} B={B} T={T} H={H} Dk={Dk} {masks} "
                 f"rows={'auto' if rows is None else rows}")
        rels = []
        keep = r_lse > -1e29       # rows with a key to attend
        for kern, name, a, r in (
                ("K2", "out", out, r_out),
                ("K2", "lse", lse[keep], r_lse[keep]),
                ("K3", "dq2", grads[0], r_grads[0]),
                ("K3", "dk2", grads[1], r_grads[1]),
                ("K3", "dv", grads[2], r_grads[2])):
            err = (a.float() - r.float()).abs().max().item()
            rel = err / r.float().abs().max().item()
            rels.append(f"{name} {rel:.2e}")
            worst[(kern, dname)] = max(worst.get((kern, dname), 0.0), err)
            if not (rel <= tol and np.isfinite(err)):
                log(f"{label}: {name} max|diff|/max|ref|={rel:.3e} > {tol} "
                    "FAIL")
                raise SystemExit(f"FAIL kernel: flash {name} disagrees with "
                                 "its plain version")
        if rows is not None:     # K3 repeats bit for bit (no atomics)
            again = fa.flash_kernels.backward(
                q2, k2, v, g, lse, delta, lens, scale, window, mem,
                rows=bwd_rows)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise SystemExit(f"FAIL kernel: {label}: two K3 calls gave "
                                 "different gradients")
            rels.append("K3 bit-identical twice")
        log(f"{label} lens={lens.tolist()}: max|diff|/max|ref| "
            + ", ".join(rels) + " OK")

    for dtype in (torch.float32, torch.bfloat16):
        for B, T in FLASH_SHAPES:
            for H, Dk in FLASH_HEADS:
                for masks in ("lengths", "window", "mem_cols"):
                    check(dtype, B, T, H, Dk, masks)
        for H, Dk in FLASH_HEADS:
            for rows in fa.FWD_ROWS:
                check(dtype, 4, 255, H, Dk, "window", rows)
    return worst


def flagship_cfg():
    from m3asr_tpu_torch.config import (EncoderConfig, ModelConfig,
                                        MoEConfig, MoEEncoderConfig)
    cfg = ModelConfig(input_dim=40, output_dim=5000)
    cfg.encoder_conf = MoEEncoderConfig(
        attention_dim=512, attention_heads=8, num_blocks=18,
        embed_conf=EncoderConfig(attention_dim=512, attention_heads=4,
                                 linear_units=1024, num_blocks=6),
        moe_conf=MoEConfig(num_experts=32, hidden_units=1024))
    return cfg


def flagship_params(torch):
    """The flagship's config and its random parameters from a seeded
    generator on the card (routers normal x 0.5, so that routing spreads
    over the experts)."""
    from m3asr_tpu_torch.models import moe_conformer
    cfg = flagship_cfg()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = moe_conformer.init(cfg.encoder_conf, cfg.input_dim,
                                cfg.output_dim, gen, device="cuda")
    r = params["blocks"]["feed_forward"]["router"]
    r["kernel"] = torch.randn(r["kernel"].shape, generator=gen,
                              device="cuda") * 0.5
    return cfg, params


class GateRecorder:
    """Records the expert index of every token at every MoE block, to
    count tokens whose expert differs between two runs. Given an earlier
    run's record (``replay``), it sends each block's tokens to the
    experts of that run instead. The gate value stays this run's router
    maximum: where the two runs chose differently the router was at a
    near-tie, so the two experts' probabilities are nearly equal."""

    def __init__(self, moe_mod, replay=None):
        self.moe_mod, self.replay, self.inner, self.calls = (
            moe_mod, replay, None, [])

    def __enter__(self):
        self.inner = self.moe_mod.softmax_top1_gate

        def gate(p, router_inputs, lengths):
            value, idx = self.inner(p, router_inputs, lengths)
            if self.replay is not None:
                idx = self.replay[len(self.calls)]
            self.calls.append(idx.clone())
            return value, idx
        self.moe_mod.softmax_top1_gate = gate
        return self

    def __exit__(self, *exc):
        self.moe_mod.softmax_top1_gate = self.inner


def phase_serve(torch, state):
    from m3asr_tpu_torch.decode.ctc import ctc_greedy_search
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.moe_runs import runs_kernel
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg, params = flagship_params(torch)
    rng = np.random.default_rng(2)
    reqs = [(rng.standard_normal((b, t, cfg.input_dim)).astype(np.float32),
             np.full((b,), t, np.int32)) for b, t in REQUESTS]
    engines = {}
    for dtype in ("float32", "bfloat16"):
        engines[dtype] = (
            Engine(cfg, params, EngineConfig(dtype=dtype), device="cuda",
                   cuda_graphs=False),
            Engine(cfg, params, EngineConfig(dtype=dtype, moe_impl="dense"),
                   device="cuda", cuda_graphs=False))
    state["engines"], state["requests"] = engines, reqs
    state["cfg"], state["params"] = cfg, params
    n_blocks = cfg.encoder_conf.num_blocks

    runs_kernel.launches = 0           # the main path's run starts here
    per_dtype = {}
    truth = {}                         # fp32 logits, the bf16 yardstick
    for dtype, (eng, dense) in engines.items():
        before = runs_kernel.launches
        for i, (feat, lens) in enumerate(reqs):
            n0 = runs_kernel.launches
            with GateRecorder(moe_mod) as rec_k:
                out, out_len = eng.infer(feat, lens)
            got = runs_kernel.launches - n0
            if got != n_blocks:
                raise SystemExit(f"FAIL serve: {got} K1 calls in one "
                                 f"forward, want {n_blocks}")
            with GateRecorder(moe_mod) as rec_d:
                ref, ref_len = dense.infer(feat, lens)
            if not (np.array_equal(out_len, ref_len)
                    and np.isfinite(out).all()):
                raise SystemExit("FAIL serve: lengths differ or logits "
                                 "are not finite")
            B = feat.shape[0]

            def valid_rows(a):
                return np.concatenate([a[b, :out_len[b]] for b in range(B)])

            def compare(a, r):
                """(max|diff|/max|ref|, share of frames with equal argmax)"""
                return (float(np.abs(a - r).max() / np.abs(r).max()),
                        float((a.argmax(-1) == r.argmax(-1)).mean()))
            valid, rvalid = valid_rows(out), valid_rows(ref)
            rel, agree = compare(valid, rvalid)
            # (token, block) pairs whose expert differs between the runs,
            # and the frames whose token changed expert in some block
            flips = torch.stack([a != b for a, b in
                                 zip(rec_k.calls, rec_d.calls)])[:, :B]
            flipped = valid_rows(flips.any(0).cpu().numpy())
            line = (f"serve {dtype} {B}x{feat.shape[1]}: out {out.shape}, "
                    f"K1 calls {got}, vs dense: max|diff|/max|ref|="
                    f"{rel:.3e}, argmax agree={agree:.4f}; flipped (token, "
                    f"block) pairs={int(flips.sum())} in "
                    f"{int(flipped.sum())} of {len(flipped)} frames")
            if dtype == "float32":
                truth[i] = valid
                ok = np.allclose(valid, rvalid, rtol=1e-5, atol=1e-3)
            else:
                # bf16 rounding sends tokens at router near-ties to other
                # experts, differently in two runs that sum in another
                # order, and one flipped token reaches every frame of its
                # sequence through attention. So the dense run is made
                # again with its tokens sent to the kernel run's experts:
                # then the two differ by summation order alone, and are
                # held to max|diff|/max|ref| <= 0.05 on every valid
                # frame. Their argmax agreement is printed, not held:
                # random-weight logits have near-tied maxima that bf16
                # noise of that size reorders. Both free-running paths
                # are held to the fp32 logits: the kernel path's mean
                # distance from them within 1.5x the dense path's, its
                # argmax agreement with them within three standard
                # errors of the dense path's.
                with GateRecorder(moe_mod, replay=rec_k.calls):
                    pin, _ = dense.infer(feat, lens)
                rel_pin, agree_pin = compare(valid, valid_rows(pin))
                t = truth[i]
                err_k = float(np.abs(valid - t).mean())
                err_d = float(np.abs(rvalid - t).mean())
                arg_k = float((valid.argmax(-1) == t.argmax(-1)).mean())
                arg_d = float((rvalid.argmax(-1) == t.argmax(-1)).mean())
                slack = 3 * (arg_d * (1 - arg_d) / len(t)) ** 0.5
                ok = (rel_pin <= 0.05 and err_k <= 1.5 * err_d
                      and arg_k >= arg_d - slack)
                line += (f"; vs dense on the kernel run's experts: max|diff|"
                         f"/max|ref|={rel_pin:.3e}, argmax agree="
                         f"{agree_pin:.4f}; vs fp32: mean|diff| kernel "
                         f"{err_k:.4e} dense {err_d:.4e}, argmax agree "
                         f"kernel {arg_k:.4f} dense {arg_d:.4f} (slack "
                         f"{slack:.4f})")
            hyps = ctc_greedy_search(out, out_len)
            log(f"{line} {'OK' if ok else 'FAIL'}; greedy hyp lengths "
                f"{[len(h) for h in hyps]}")
            if not ok:
                raise SystemExit("FAIL serve: kernel path disagrees with "
                                 "moe_impl='dense'")
        per_dtype[dtype] = runs_kernel.launches - before
    log(f"serve: main path made {runs_kernel.launches} K1 calls "
        f"({per_dtype})")
    state["truth"] = truth
    return per_dtype


class PlainExperts:
    """Sends the expert stages that have a kernel to the kernels' plain
    versions, on the card's tensors: the reference run of phase 5."""

    def __init__(self, moe_mod):
        self.moe_mod, self.inner = moe_mod, None

    def __enter__(self):
        from m3asr_tpu_torch.ops import moe_q4, moe_runs, moe_stream
        inner = self.inner = self.moe_mod._dispatch

        def plain(p, x, gate_idx, impl):
            if impl == "runs_f" or impl.endswith("_runs"):
                return moe_runs.moe_experts_runs_reference(
                    p, x, gate_idx, act_quant="_a8" in impl)
            if impl in ("quant4_pallas", "quant4_a8") or (
                    impl == "quant_pallas" and "w1_q4" in p):
                return moe_q4.moe_experts_q4_reference(
                    p, x, gate_idx, act_quant=impl == "quant4_a8")
            if impl in ("pallas", "quant_pallas"):
                return moe_stream.moe_experts_dense_stream_reference(
                    p, x, gate_idx)
            if impl in ("quant4_tiled", "quant4_a8_tiled"):
                return moe_q4.moe_experts_q4_tiled_reference(
                    p, x, gate_idx, act_quant=impl == "quant4_a8_tiled")
            return inner(p, x, gate_idx, impl)
        self.moe_mod._dispatch = plain
        return self

    def __exit__(self, *exc):
        self.moe_mod._dispatch = self.inner


def phase_serve_quant(torch, state, smi):
    """Serves the requests with the int8, w8a8, int4 and w4a8 engines;
    returns each mode's kernel launches on its run."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    wrappers = stage_wrappers()
    cfg, reqs, truth = state["cfg"], state["requests"], state["truth"]
    n_blocks = cfg.encoder_conf.num_blocks
    launches = {}
    for dtype in ("int8", "int4"):
        base = None
        for act_quant in (False, True):
            mode = MODES[(dtype, act_quant)]
            t0 = time.perf_counter()
            eng = Engine(cfg, state["params"] if base is None
                         else base.params,
                         EngineConfig(dtype=dtype, act_quant=act_quant),
                         device="cuda", cuda_graphs=False)
            log(f"serve {mode}: engine built in "
                f"{time.perf_counter() - t0:.2f} s ("
                + ("experts quantized from their bf16 values" if base is None
                   else f"sharing the {dtype} engine's weights") + ")")
            if base is None:
                base = eng
            for w in wrappers.values():
                w.launches = 0          # this mode's run starts here
            for i, (feat, lens) in enumerate(reqs):
                B, T = feat.shape[:2]
                before = {k: w.launches for k, w in wrappers.items()}
                with GateRecorder(moe_mod) as rec:
                    out, out_len = eng.infer(feat, lens)
                got = {k: w.launches - before[k]
                       for k, w in wrappers.items()
                       if w.launches != before[k]}
                kname = QUANT_EXPECT[dtype][i]
                want = {} if kname is None else {kname: n_blocks}
                with GateRecorder(moe_mod, replay=rec.calls), \
                        PlainExperts(moe_mod):
                    ref, ref_len = eng.infer(feat, lens)
                if not (np.array_equal(out_len, ref_len)
                        and np.isfinite(out).all()):
                    raise SystemExit(f"FAIL serve {mode}: lengths differ or "
                                     "logits are not finite")

                def valid_rows(a):
                    return np.concatenate([a[b, :out_len[b]]
                                           for b in range(B)])
                valid, rvalid, t = valid_rows(out), valid_rows(ref), truth[i]
                rel = float(np.abs(valid - rvalid).max()
                            / np.abs(rvalid).max())
                agree = float((valid.argmax(-1) == rvalid.argmax(-1)).mean())
                ok = rel <= 0.05 and got == want
                stage = eng.moe_impl_for(*eng.buckets.pick(B, T))
                log(f"serve {mode} {B}x{T}: stage {stage}, launches per "
                    f"forward {got or 'none (plain-PyTorch stage)'} (want "
                    f"{want or 'none'}); vs the kernels' plain versions, "
                    f"routing pinned: max|diff|/max|ref|={rel:.3e}, argmax "
                    f"agree={agree:.4f}; vs fp32 logits (information): "
                    f"mean|diff| {float(np.abs(valid - t).mean()):.4e}, "
                    f"max|diff|/max|ref| "
                    f"{float(np.abs(valid - t).max() / np.abs(t).max()):.3e},"
                    f" argmax agree "
                    f"{float((valid.argmax(-1) == t.argmax(-1)).mean()):.4f}"
                    f" {'OK' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"FAIL serve {mode}: wrong kernel "
                                     "launches or logits off the plain "
                                     "versions'")
            launches[mode] = {k: w.launches for k, w in wrappers.items()}
            log(f"serve {mode}: main path launches {launches[mode]}")
            request_times(torch, eng, mode, reqs, smi)
            eng = None
        # the quantized tree, for phase 6's engines with explicit stages
        state.setdefault("qparams", {})[dtype] = base.params
        base = None
        torch.cuda.empty_cache()
    return launches


def stage_wrappers():
    """Every expert kernel's wrapper, by kernel."""
    from m3asr_tpu_torch.ops import moe_q4, moe_runs, moe_stream
    return {"K1": moe_runs.runs_kernel, "K4": moe_runs.runs_q8_kernel,
            "K5": moe_runs.runs_q4_kernel, "K6": moe_q4.q4_kernel,
            "K7": moe_q4.q4_tiled_kernel, "K8": moe_stream.stream_kernel}


# engines with an explicit kernel stage: (label, EngineConfig settings,
# the params they start from, the kernel each forward launches once per
# MoE block, the kernel variant's name in the output)
KERNEL_STAGE_ENGINES = (
    ("float32 pallas", dict(dtype="float32", moe_impl="pallas"), "float",
     "K8", STREAM_NAMES["float32"]),
    ("bfloat16 pallas", dict(dtype="bfloat16", moe_impl="pallas"), "float",
     "K8", STREAM_NAMES["bfloat16"]),
    ("int8 pallas", dict(dtype="int8", moe_impl="pallas"), "int8", "K8",
     STREAM_NAMES["int8"]),
    ("int4 tiled", dict(dtype="int4", moe_impl="tiled"), "int4", "K7",
     TILED_NAMES[False]),
    ("w4a8 tiled", dict(dtype="int4", act_quant=True, moe_impl="tiled"),
     "int4", "K7", TILED_NAMES[True]),
)
# engines with a plain-PyTorch stage, each answering the 4x1000 request:
# (label, settings, params, the reference engine's settings)
PLAIN_STAGE_ENGINES = tuple(
    (f"float32 {impl}", dict(dtype="float32", moe_impl=impl), "float",
     dict(dtype="float32", moe_impl="dense"))
    for impl in ("tiled", "ragged", "ragged_padded", "capacity")) + (
    ("int8 quant_tiled", dict(dtype="int8", moe_impl="quant_tiled"), "int8",
     dict(dtype="int8", moe_impl="quant")),
    ("int8 quant_capacity", dict(dtype="int8", moe_impl="quant_capacity"),
     "int8", dict(dtype="int8", moe_impl="quant")),
    ("w8a8 quant_a8_tiled", dict(dtype="int8", act_quant=True,
                                 moe_impl="quant_a8_tiled"), "int8",
     dict(dtype="int8", act_quant=True, moe_impl="quant_a8")),
)


def served_valid(eng, ref_eng, moe_mod, feat, lens, plain=False):
    """One request through eng, then through ref_eng with its tokens sent
    to eng's experts (on the kernels' plain versions if ``plain``).
    Returns (valid rows of eng's logits, of ref_eng's, launches per
    kernel in eng's forward, the largest expert's share of the bucket's
    tokens in each MoE block)."""
    wrappers = stage_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    with GateRecorder(moe_mod) as rec:
        out, out_len = eng.infer(feat, lens)
    got = {k: w.launches - before[k] for k, w in wrappers.items()
           if w.launches != before[k]}
    with GateRecorder(moe_mod, replay=rec.calls):
        if plain:
            with PlainExperts(moe_mod):
                ref, ref_len = ref_eng.infer(feat, lens)
        else:
            ref, ref_len = ref_eng.infer(feat, lens)
    if not (np.array_equal(out_len, ref_len) and np.isfinite(out).all()):
        raise SystemExit("FAIL serve stages: lengths differ or logits are "
                         "not finite")
    share = [float(c.flatten().bincount().max()) / c.numel()
             for c in rec.calls]
    return valid_rows(out, out_len), valid_rows(ref, out_len), got, share


def phase_serve_stages(torch, state, smi):
    """Engines with explicit expert stages (ROADMAP item 6b). Kernel
    stages: each request's forward launches its kernel once per MoE block
    and no other expert kernel; logits held to the same engine with its
    experts on the plain versions, routing pinned (fp32 allclose(1e-5,
    1e-3), else max|diff|/max|ref| <= 0.05). Plain-PyTorch stages: one
    4x1000 request each, no expert kernel, held the same way to the
    dense / quant / quant_a8 engine. Then one int4 engine with
    dense_quant and fuse_qkv at 1x206. Returns the launches of each
    kernel variant on its engine's run."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.quant import dequantize_dense_params
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg, reqs, truth = state["cfg"], state["requests"], state["truth"]
    trees = {"float": state["params"], **state["qparams"]}
    n_blocks = cfg.encoder_conf.num_blocks
    wrappers = stage_wrappers()
    launches = {}

    def judge(valid, rvalid, fp32):
        rel = float(np.abs(valid - rvalid).max() / np.abs(rvalid).max())
        if fp32:
            return np.allclose(valid, rvalid, rtol=1e-5, atol=1e-3), rel, \
                "allclose(1e-5, 1e-3)"
        return rel <= 0.05, rel, "max|diff|/max|ref| <= 0.05"

    for label, settings, tree, kname, vname in KERNEL_STAGE_ENGINES:
        eng = Engine(cfg, trees[tree], EngineConfig(**settings),
                     device="cuda", cuda_graphs=False)
        for w in wrappers.values():
            w.launches = 0              # this engine's run starts here
        for i, (feat, lens) in enumerate(reqs):
            valid, rvalid, got, share = served_valid(eng, eng, moe_mod, feat,
                                                     lens, plain=True)
            ok, rel, held = judge(valid, rvalid,
                                  settings["dtype"] == "float32")
            ok = ok and got == {kname: n_blocks}
            t = truth[i]
            B, T = feat.shape[:2]
            log(f"serve {label} {B}x{T}: stage "
                f"{eng.moe_impl_for(*eng.buckets.pick(B, T))}, launches per "
                f"forward {got} (want {{{kname!r}: {n_blocks}}}); vs the "
                f"kernels' plain versions, routing pinned: max|diff|/max|ref|"
                f"={rel:.3e}, held to {held}; vs fp32 logits (information): "
                f"max|diff|/max|ref| "
                f"{float(np.abs(valid - t).max() / np.abs(t).max()):.3e}, "
                f"argmax agree "
                f"{float((valid.argmax(-1) == t.argmax(-1)).mean()):.4f}; "
                f"the largest expert's share of the tokens per MoE block: "
                f"median {np.median(share):.3f}, max {max(share):.3f} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"FAIL serve {label}: wrong kernel launches "
                                 "or logits off the plain versions'")
        launches[vname] = wrappers[kname].launches
        log(f"serve {label}: main path launches {kname} "
            f"{wrappers[kname].launches}")
        request_times(torch, eng, label, reqs, smi)
        eng = None
        torch.cuda.empty_cache()

    feat, lens = reqs[1]                               # 4x1000
    refs = {}
    for label, settings, tree, ref_settings in PLAIN_STAGE_ENGINES:
        eng = Engine(cfg, trees[tree], EngineConfig(**settings),
                     device="cuda", cuda_graphs=False)
        key = tuple(sorted(ref_settings.items()))
        if key not in refs:
            refs[key] = Engine(cfg, trees[tree], EngineConfig(**ref_settings),
                               device="cuda", cuda_graphs=False)
        valid, rvalid, got, _ = served_valid(eng, refs[key], moe_mod, feat,
                                             lens)
        ok, rel, held = judge(valid, rvalid,
                              settings["dtype"] == "float32")
        ok = ok and not got
        log(f"serve {label} 4x1000: stage {eng.moe_impl_for(4, 1000)} "
            f"(plain PyTorch), expert kernel launches {got or 'none'}; vs "
            f"moe_impl={ref_settings['moe_impl']!r}, routing pinned: "
            f"max|diff|/max|ref|={rel:.3e}, held to {held} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"FAIL serve {label}: a kernel launched or the "
                             "logits are off the reference stage's")
        request_times(torch, eng, label, [reqs[1]], smi)
        eng = None
    refs = None
    torch.cuda.empty_cache()

    # dense_quant + fuse_qkv: int8 dense kernels, one fused q/k/v product
    feat, lens = reqs[0]                               # 1x206
    eng = Engine(cfg, trees["int4"], EngineConfig(
        dtype="int4", dense_quant=True, fuse_qkv=True), device="cuda",
        cuda_graphs=False)
    sa = eng.params["blocks"]["self_attn"]
    if "linear_q" in sa or sa["linear_qkv"]["kernel_q"].dtype != torch.int8:
        raise SystemExit("FAIL serve dense_quant+fuse_qkv: params not "
                         "fused and quantized")
    deq = Engine(cfg, dequantize_dense_params(eng.params, torch.bfloat16),
                 EngineConfig(dtype="int4"), device="cuda", cuda_graphs=False)
    valid, rvalid, got, _ = served_valid(eng, deq, moe_mod, feat, lens)
    ok, rel, held = judge(valid, rvalid, False)
    ok = ok and got == {"K6": n_blocks}
    plain_eng = Engine(cfg, trees["int4"], EngineConfig(dtype="int4"),
                       device="cuda", cuda_graphs=False)
    _, pvalid, _, _ = served_valid(eng, plain_eng, moe_mod, feat, lens)
    prel = float(np.abs(valid - pvalid).max() / np.abs(pvalid).max())
    log(f"serve int4+dense_quant+fuse_qkv 1x206: launches per forward {got}"
        f"; vs the int4 engine on the same fused weights dequantized "
        f"(routing pinned): max|diff|/max|ref|={rel:.3e}, held to {held}; "
        f"vs the int4 engine on the unquantized, unfused dense weights "
        f"(routing pinned, information): max|diff|/max|ref|={prel:.3e}, "
        f"argmax agree {float((valid.argmax(-1) == pvalid.argmax(-1)).mean()):.4f}"
        f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL serve int4+dense_quant+fuse_qkv: wrong "
                         "launches or logits off the dequantized engine's")
    request_times(torch, eng, "int4+dense_quant+fuse_qkv", [reqs[0]], smi)
    eng = deq = plain_eng = None
    torch.cuda.empty_cache()
    return launches


def valid_rows(a, out_len):
    return np.concatenate([a[b, :out_len[b]] for b in range(len(out_len))])


def reset_flash(flash_kernels):
    flash_kernels.fwd_launches = flash_kernels.dq_launches = \
        flash_kernels.dkv_launches = 0


def phase_serve_flash(torch, state, smi):
    """The fp32 and bf16 engines with attn_impl="flash" answer the
    requests: each forward launches K2 once per attention layer (24) and
    K1 once per MoE block (18); the logits are held to the same engine
    with attn_impl="xla" (phase 4's), its tokens sent to the flash run's
    experts: fp32 allclose(1e-5, 1e-3), bf16 max|diff| <= 0.05 max|ref|.
    Returns K2's launches per dtype."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.ops.moe_runs import runs_kernel
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg, reqs, truth = state["cfg"], state["requests"], state["truth"]
    enc = cfg.encoder_conf
    n_attn, n_moe = enc.embed_conf.num_blocks + enc.num_blocks, enc.num_blocks
    launches = {}
    for dtype in ("float32", "bfloat16"):
        eng = Engine(cfg, state["params"], EngineConfig(
            dtype=dtype, attn_impl="flash"), device="cuda", cuda_graphs=False)
        xla = state["engines"][dtype][0]
        reset_flash(flash_kernels)        # this run starts here
        runs_kernel.launches = 0
        for i, (feat, lens) in enumerate(reqs):
            f0, k0 = flash_kernels.fwd_launches, runs_kernel.launches
            with GateRecorder(moe_mod) as rec:
                out, out_len = eng.infer(feat, lens)
            got = (flash_kernels.fwd_launches - f0, runs_kernel.launches - k0)
            with GateRecorder(moe_mod, replay=rec.calls):
                ref, ref_len = xla.infer(feat, lens)
            if not (np.array_equal(out_len, ref_len)
                    and np.isfinite(out).all()):
                raise SystemExit("FAIL serve flash: lengths differ or logits "
                                 "are not finite")
            valid, rvalid = valid_rows(out, out_len), valid_rows(ref, out_len)
            rel = float(np.abs(valid - rvalid).max() / np.abs(rvalid).max())
            agree = float((valid.argmax(-1) == rvalid.argmax(-1)).mean())
            t = truth[i]
            if dtype == "float32":
                ok = np.allclose(valid, rvalid, rtol=1e-5, atol=1e-3)
                held = "allclose(1e-5, 1e-3)"
            else:
                ok = rel <= 0.05
                held = "max|diff|/max|ref| <= 0.05"
            ok = ok and got == (n_attn, n_moe)
            B, T = feat.shape[:2]
            log(f"serve {dtype}+flash {B}x{T}: K2 calls {got[0]} (want "
                f"{n_attn}), K1 calls {got[1]} (want {n_moe}); vs "
                f"attn_impl='xla' on the flash run's experts: max|diff|/"
                f"max|ref|={rel:.3e}, argmax agree={agree:.4f}, held to "
                f"{held}; vs the free-running fp32 xla logits: "
                f"max|diff|/max|ref| "
                f"{float(np.abs(valid - t).max() / np.abs(t).max()):.3e}, "
                f"argmax agree "
                f"{float((valid.argmax(-1) == t.argmax(-1)).mean()):.4f} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("FAIL serve flash: wrong launches or logits "
                                 "off the xla path's")
        launches[dtype] = flash_kernels.fwd_launches
        log(f"serve {dtype}+flash: main path launches K2 "
            f"{flash_kernels.fwd_launches}, K1 {runs_kernel.launches}")
        request_times(torch, eng, f"{dtype}+flash", reqs, smi)
        eng = None
    torch.cuda.empty_cache()
    return launches


# engines of phase "serve, graphs": (label, EngineConfig settings, the
# params they start from, the kernel each request's forward launches once
# per MoE block: phases 4-7's policy)
GRAPH_ENGINES = (
    ("float32", dict(dtype="float32"), "float", ("K1",) * 3),
    ("bfloat16", dict(dtype="bfloat16"), "float", ("K1",) * 3),
    ("int8", dict(dtype="int8"), "int8", QUANT_EXPECT["int8"]),
    ("w8a8", dict(dtype="int8", act_quant=True), "int8",
     QUANT_EXPECT["int8"]),
    ("int4", dict(dtype="int4"), "int4", QUANT_EXPECT["int4"]),
    ("w4a8", dict(dtype="int4", act_quant=True), "int4",
     QUANT_EXPECT["int4"]),
    ("float32+flash", dict(dtype="float32", attn_impl="flash"), "float",
     ("K1",) * 3),
    ("bfloat16+flash", dict(dtype="bfloat16", attn_impl="flash"), "float",
     ("K1",) * 3),
    ("float32 pallas", dict(dtype="float32", moe_impl="pallas"), "float",
     ("K8",) * 3),
    ("int4 tiled", dict(dtype="int4", moe_impl="tiled"), "int4",
     ("K7",) * 3),
)
LONG_FRAMES = 15000          # infer_long's request: 3 windows of 6144
# the auto engines whose graph replays give the bucket tuner's points
TUNER_MODES = ("float32", "bfloat16", "int8", "w8a8", "int4", "w4a8")
DECODE_TOPK = 8              # K of "topk", the beam width of "beam"


def kernel_counts():
    """Every expert kernel's launches and K2's, the nonzero ones."""
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    counts = {k: w.launches for k, w in stage_wrappers().items()}
    counts["K2"] = flash_kernels.fwd_launches
    return {k: v for k, v in counts.items() if v}


def reset_counts():
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    for w in stage_wrappers().values():
        w.launches = 0
    reset_flash(flash_kernels)


def serve_times(torch, eng, feat, lens, runs=5):
    """The request through eng.infer: median host latency of ``runs``
    requests, peak device memory (allocated and reserved), and under
    torch.profiler the device time of one request, its device events and
    the part of it in device-to-host copies. With a CUDA graph, also the
    median of 5 replays alone timed by CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng.infer(feat, lens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(runs):
        t0 = time.perf_counter()
        eng.infer(feat, lens)
        lat.append((time.perf_counter() - t0) * 1e3)
    r = {"lat": float(np.median(lat)), "lat_min": min(lat),
         "lat_max": max(lat),
         "alloc": torch.cuda.max_memory_allocated() / 2**30,
         "reserved": torch.cuda.max_memory_reserved() / 2**30}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.infer(feat, lens)
    dev = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    r["dev"] = sum(us for _, us in dev) / 1e3
    r["events"] = len(dev)
    r["d2h"] = sum(us for n, us in dev if "DtoH" in n) / 1e3
    prog = eng.get_fn(*eng.buckets.pick(*feat.shape[:2]))
    r["replay"] = None if prog.graph is None else replay_ms(torch, prog)
    return r


def replay_ms(torch, prog):
    """Median of 5 replays of a captured program, timed by CUDA events."""
    ms = []
    for _ in range(5):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        prog.run()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    return float(np.median(ms))


def times_line(label, B, T, path, r, smi):
    replay = ("" if r["replay"] is None else
              f", graph replay {r['replay']:.3f} ms by CUDA events")
    return (f"graphs {label} {B}x{T} {path}: latency median {r['lat']:.3f} "
            f"ms (min {r['lat_min']:.3f}, max {r['lat_max']:.3f}, 5 runs), "
            f"device {r['dev']:.3f} ms under torch.profiler ({r['events']} "
            f"events), busy {r['dev'] / r['lat']:.3f}, D2H {r['d2h']:.3f} "
            f"ms, peak {r['alloc']:.3f} GiB allocated / {r['reserved']:.3f} "
            f"GiB reserved{replay}; {smi}")


def layout_prep_ms(torch, n_tokens, d, dtype):
    """Device time of K1's layout prep alone (runs_layout, padding the
    tokens into tiles and back) for one forward's 18 MoE blocks, captured
    in a CUDA graph on a router's routing and timed by CUDA events over
    the replays (median of 5)."""
    from m3asr_tpu_torch.ops.moe_runs import (TILE, _pad_tokens, _unpad,
                                              runs_layout)
    gen = torch.Generator(device="cuda").manual_seed(14)
    gate = routing(torch, "router", n_tokens, gen).reshape(-1)
    x = torch.randn(n_tokens, d, generator=gen, device="cuda").to(dtype)

    def prep():
        for _ in range(L):
            lay = runs_layout(gate, E, TILE)
            _unpad(_pad_tokens(x, lay, TILE), lay)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        prep()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        prep()
    ms = []
    for _ in range(5):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    return float(np.median(ms))


def phase_serve_graphs(torch, state, smi):
    """Every serving mode through the CUDA-graph path (Engine.get_fn):
    each request's bucket is captured, its kernels counted at capture
    ((GRAPH_WARMUP_RUNS + 1) forwards of 18 MoE-block launches, 24 K2
    with flash) and at no replay; no captured stage may run eager; the
    graph's outputs must be bit-equal to the same engine's eager forward.
    Eager and graph latency, device time, busy share, D2H time and peak
    memory per request; the bf16 argmax and topk outputs held to the
    logits, the fp32 beam search to the host search; infer_long on 15000
    frames (fp32, int4); the fp32 engine's whole 24-bucket warm-up."""
    from m3asr_tpu_torch.ops.moe import HOST_SYNC_STAGES
    from m3asr_tpu_torch.ops.moe_runs import runs_kernel
    from m3asr_tpu_torch.ops.masking import subsampling4_length
    from m3asr_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                GRAPH_WARMUP_RUNS)

    cfg, reqs = state["cfg"], state["requests"]
    trees = {"float": state["params"], **state["qparams"]}
    enc = cfg.encoder_conf
    n_attn, n_moe = enc.embed_conf.num_blocks + enc.num_blocks, enc.num_blocks
    fwds = GRAPH_WARMUP_RUNS + 1
    long_feat = np.random.default_rng(3).standard_normal(
        (1, LONG_FRAMES, cfg.input_dim)).astype(np.float32)
    for label, settings, tree, expect in GRAPH_ENGINES:
        eng = Engine(cfg, trees[tree], EngineConfig(**settings),
                     device="cuda")
        flash = settings.get("attn_impl") == "flash"
        points = {}
        for i, (feat, lens) in enumerate(reqs):
            B, T = feat.shape[:2]
            bb, bt = eng.buckets.pick(B, T)
            stage = eng.moe_impl_for(bb, bt)
            want = {expect[i]: n_moe} if expect[i] else {}
            if flash:
                want["K2"] = n_attn
            reset_counts()                 # this capture starts here
            t0 = time.perf_counter()
            prog = eng.get_fn(bb, bt)
            cap_s = time.perf_counter() - t0
            at_capture = kernel_counts()
            reset_counts()
            out_g = eng.infer(feat, lens)
            at_replay = kernel_counts()
            eng.cuda_graphs = False
            reset_counts()
            out_e = eng.infer(feat, lens)
            at_eager = kernel_counts()
            eng.cuda_graphs = True
            equal = len(out_g) == len(out_e) and all(
                a.dtype == b.dtype and np.array_equal(a, b)
                for a, b in zip(out_g, out_e))
            ok = (prog.graph is not None and stage not in HOST_SYNC_STAGES
                  and at_capture == {k: v * fwds for k, v in want.items()}
                  and not at_replay and at_eager == want and equal
                  and np.isfinite(out_g[0]).all())
            log(f"graphs {label} {B}x{T}: stage {stage}, bucket {bb}x{bt} "
                f"captured in {cap_s:.2f} s with launches {at_capture} "
                f"({fwds} forwards: {GRAPH_WARMUP_RUNS} warm-up, 1 "
                f"captured; want {want} a forward), replay launches "
                f"{at_replay or 'none'}, eager launches {at_eager}; graph "
                f"logits bit-equal to the eager forward's: {equal} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"FAIL serve graphs {label} {B}x{T}: capture"
                                 ", launches or logits off the eager path")
            for path in ("eager", "graph"):
                eng.cuda_graphs = path == "graph"
                r = serve_times(torch, eng, feat, lens)
                log(times_line(label, B, T, path, r, smi))
            eng.cuda_graphs = True
            points[(B, T)] = r["replay"]
            if label == "bfloat16" and (B, T) == (4, 1000):
                decode_outputs(torch, eng, feat, lens, out_g, smi)
            if label == "float32" and (B, T) == (4, 1000):
                decode_beam(torch, eng, feat, lens, smi)
        if label in TUNER_MODES:
            # the bucket tuner's points (runtime/bucket_tuner.py)
            top = eng.buckets.lengths[-1]
            log(f"graphs {label} tuner points: graph replay by CUDA events "
                f"(median of 5) 1x206 {points[(1, 206)]:.3f} ms, 1x2048 "
                f"{points[(1, 2048)]:.3f} ms, 1x{top} "
                f"{replay_ms(torch, eng.get_fn(1, top)):.3f} ms; {smi}")
        if label in ("float32", "int4"):
            t0 = time.perf_counter()
            first = eng.infer_long(long_feat)
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = eng.infer_long(long_feat)
            again_s = time.perf_counter() - t0
            n = int(subsampling4_length(LONG_FRAMES))
            ok = (int(res[1][0]) == n
                  and res[0].shape == (1, n, cfg.output_dim)
                  and np.isfinite(res[0]).all()
                  and all(np.array_equal(a, b) for a, b in zip(first, res)))
            log(f"graphs {label} infer_long 1x{LONG_FRAMES}: out_len "
                f"{int(res[1][0])} (want {n}), logits {res[0].shape} finite, "
                f"first call {first_s:.3f} s (captures 1x"
                f"{eng.buckets.lengths[-1]}), then {again_s * 1e3:.3f} ms; "
                f"{smi} {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"FAIL serve graphs {label} infer_long")
        if label == "float32":
            for (B, T), n in zip(REQUESTS, (63, 1020, 511)):
                prep = layout_prep_ms(torch, n, D, torch.float32)
                log(f"graphs layout prep {B}x{T} ({n} tokens, float32): "
                    f"{prep:.3f} ms of device time for 18 MoE blocks "
                    f"(runs_layout and the tile padding, in a CUDA graph, "
                    f"CUDA events); {smi}")
        eng = None
        torch.cuda.empty_cache()

    # the fp32 engine's whole bucket ladder, captured
    eng = Engine(cfg, trees["float"], EngineConfig(dtype="float32"),
                 device="cuda")
    n_buckets = len(eng.buckets.all_buckets())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs_kernel.launches = 0
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ok = runs_kernel.launches == n_buckets * fwds * n_moe and all(
        eng.get_fn(b, t).graph is not None
        for b, t in eng.buckets.all_buckets())
    log(f"graphs float32 warmup(): {n_buckets} buckets captured in "
        f"{secs:.2f} s, K1 launches {runs_kernel.launches} (want "
        f"{n_buckets * fwds * n_moe}), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB allocated / "
        f"{torch.cuda.max_memory_reserved() / 2**30:.3f} GiB reserved; {smi} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL serve graphs: the ladder's warm-up")
    eng = None
    torch.cuda.empty_cache()


def decode_outputs(torch, eng, feat, lens, logits_out, smi):
    """The bf16 engine's argmax and topk (K=8) outputs at one request (its
    4x1000), through graphs, held to its logits (logits_out, widened
    exactly from bf16) reduced on the host in float64: argmax ids equal
    wherever the top two log-probs are not tied, best log-probs and top-K
    values within 1e-6 (a float32 log-softmax on the card), every top-K
    index naming its value. Prints the bytes each mode copies back, its
    times, and the host's part of copying these logits back."""
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    logits, out_len = logits_out[0], logits_out[1]
    B, T = feat.shape[:2]
    x = logits.astype(np.float64)
    lp64 = x - x.max(-1, keepdims=True)
    lp64 -= np.log(np.exp(lp64).sum(-1, keepdims=True))
    valid = np.arange(lp64.shape[1])[None] < out_len[:, None]
    top = -np.sort(-lp64, axis=-1)[..., :DECODE_TOPK]
    tol = 1e-6
    nbytes = {"logits": logits.size * 2}
    res = {}
    for mode in ("argmax", "topk"):
        m = Engine(eng.model_cfg, eng.params, EngineConfig(
            dtype="bfloat16", decode_output=mode, decode_topk=DECODE_TOPK),
            device="cuda")
        res[mode] = m.infer(feat, lens)
        nbytes[mode] = sum(a.nbytes for j, a in enumerate(res[mode]) if j != 1)
        log(times_line(f"bfloat16 decode_output={mode}", B, T, "graph",
                       serve_times(torch, m, feat, lens), smi))
        m = None
    ids, _, best = res["argmax"]
    untied = valid & (top[..., 0] != top[..., 1])
    ok_ids = np.array_equal(ids[untied], lp64.argmax(-1)[untied])
    ok_best = (np.abs(best - top[..., 0]) <= tol)[valid].all()
    vals, _, idx = res["topk"]
    ok_vals = (np.abs(vals - top) <= tol)[valid].all()
    named = np.take_along_axis(lp64, idx.astype(np.int64), -1)
    ok_idx = (np.abs(vals - named) <= tol)[valid].all()
    err = float(np.abs(vals - top)[valid].max())
    ok = ok_ids and ok_best and ok_vals and ok_idx
    log(f"graphs bfloat16 decode outputs {B}x{T}: argmax ids equal on "
        f"{int(untied.sum())} untied of {int(valid.sum())} valid frames: "
        f"{ok_ids}, best log-prob within tolerance: {ok_best}; top-"
        f"{DECODE_TOPK} values within 1e-6: {ok_vals} "
        f"(max |diff| {err:.3e}), indices name their values: {ok_idx}; "
        "bytes copied back: " + ", ".join(f"{k} {v}" for k, v in
                                          nbytes.items())
        + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL serve graphs: argmax or topk disagrees with "
                         "the logits")
    # the host's part of infer's copy-back of these logits: widening the
    # bf16 bits in numpy and in torch (Engine.infer's way, on the host's
    # cores), and a float32 engine's copy of the same count in numpy and
    # in torch (Engine.infer's)
    bits = np.random.default_rng(15).integers(
        0, 2**15, logits.shape, dtype=np.uint16)
    f32 = np.zeros(logits.shape, np.float32)
    host = {}
    for name, fn in (
            ("numpy widen", lambda: (bits.astype(np.uint32) << 16)
             .view(np.float32)),
            ("torch widen", lambda: torch.from_numpy(bits.view(np.int16))
             .view(torch.bfloat16).float().numpy()),
            ("numpy float32 copy", lambda: f32.astype(np.float32)),
            ("torch float32 copy",
             lambda: torch.from_numpy(f32).clone().numpy())):
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        host[name] = float(np.median(ms))
    log(f"graphs host copy-back of {B}x{T}'s logits {logits.shape} "
        "(median of 5): " + ", ".join(f"{k} {v:.3f} ms"
                                      for k, v in host.items()))


def decode_beam(torch, eng, feat, lens, smi):
    """The fp32 engine's on-device beam search (width 8) at one request
    (its 4x1000), through a graph: each utterance's best hypothesis and
    score (within 1e-4 relative) equal to the host prefix beam search on
    the card's log-probs (the log_softmax mode's); the share of the host
    n-best the card's n-best holds is printed. In float32, because bf16
    logits hold exact ties, at which the two searches keep different
    equally scored prefixes."""
    from m3asr_tpu_torch.decode.ctc import ctc_prefix_beam_search
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    B, T = feat.shape[:2]
    res = {}
    for mode in ("beam", "log_softmax"):
        m = Engine(eng.model_cfg, eng.params, EngineConfig(
            dtype="float32", decode_output=mode, decode_topk=DECODE_TOPK),
            device="cuda")
        res[mode] = m.infer(feat, lens)
        if mode == "beam":
            log(times_line("float32 decode_output=beam", B, T, "graph",
                           serve_times(torch, m, feat, lens), smi))
        m = None
    hyp_ids, out_len, hyp_lens, scores = res["beam"]
    lp = res["log_softmax"][0]
    agree, total, ok = 0, 0, True
    for b in range(B):
        host = ctc_prefix_beam_search(lp[b], int(out_len[b]), DECODE_TOPK)
        dev = [(tuple(hyp_ids[b, j, :hyp_lens[b, j]].tolist()),
                float(scores[b, j])) for j in range(DECODE_TOPK)
               if np.isfinite(scores[b, j])]
        ok &= (dev[0][0] == host[0][0]
               and abs(dev[0][1] - host[0][1]) <= 1e-4 * abs(host[0][1]))
        hmap = dict(host)
        agree += sum(p in hmap and abs(s - hmap[p]) <= 1e-4 * abs(hmap[p])
                     for p, s in dev)
        total += len(host)
    nbytes = sum(a.nbytes for j, a in enumerate(res["beam"]) if j != 1)
    log(f"graphs float32 beam {DECODE_TOPK} {B}x{T}: best hypothesis and "
        f"score equal to the host search's on the card's log-probs for all "
        f"{B} utterances: {ok}; n-best agreement {agree}/{total}; bytes "
        f"copied back {nbytes} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL serve graphs: the on-device beam search "
                         "disagrees with the host search")


# phase "stream": the flagship's chunk streams (models/streaming.py, the
# sessions and batchers of runtime/) and the port's server
STREAM_SLOTS, STREAM_CHUNK, STREAM_LEFT = 8, 16, 2
STREAM_FRAMES = (1200, 1131, 1010, 917, 763, 640, 488, 300)
STREAM_PIECES = (37, 90, 13, 211, 64, 150)     # uneven pieces, cycled
SESSION_CHECKED = (0, 2, 4, 6)   # streams also run by eager sessions
# (label, EngineConfig settings, the params they start from, the kernel
# of the chunk programs' expert stage, serve's policy at 16 x 8 tokens)
STREAM_MODES = (("float32", dict(dtype="float32"), "float", "K1", "runs_f"),
                ("bfloat16", dict(dtype="bfloat16"), "float", "K1",
                 "runs_f"),
                ("int4", dict(dtype="int4"), "int4", "K6", "quant4_pallas"))
# the offline oracle's expert stage (any length): K1, or K5 on int4
ORACLE_IMPL = {"float32": "runs_f", "bfloat16": "runs_f",
               "int4": "quant4_runs"}
STREAM_TOKENS = (16, 128)     # one stream's chunk; a tick of 8 slots
SERVE_SETTINGS = dict(dtype="bfloat16", bucket_lengths=(256, 512, 1024,
                                                        2048),
                      bucket_batches=(1, 2))


def stream_windows(feat, chunk):
    """The windows a StreamingSession cuts from one (T, D) stream, however
    it is pushed: full windows of 4 * chunk + 3 frames at stride
    4 * chunk, then finish()'s zero-padded tail. [(window (1, W, D),
    output frames kept)]."""
    W, S = 4 * chunk + 3, 4 * chunk
    out, i = [], 0
    while feat.shape[0] - i >= W:
        out.append((feat[None, i:i + W], chunk))
        i += S
    rest = feat.shape[0] - i
    if rest >= 7 and (rest - 3) // 4 > 0:
        w = np.zeros((1, W, feat.shape[1]), np.float32)
        w[0, :rest] = feat[i:]
        out.append((w, (rest - 3) // 4))
    return out


def batched_ticks(b, streams):
    """Drive StreamBatcher ``b`` tick by tick: stream i in slot i from
    tick i, one window a tick. Returns (each stream's kept outputs
    (frames, V), every tick's (slots, C, V) output, tick times in ms by
    the host clock)."""
    from m3asr_tpu_torch.runtime.graphs import DEVICE_LOCK
    W, D = streams[0][0][0].shape[1:]
    with DEVICE_LOCK.shared():
        b._reset_slots(range(b.slots))
    outs = [[] for _ in streams]
    raw, ms = [], []
    for t in range(max(i + len(s) for i, s in enumerate(streams))):
        windows = np.zeros((b.slots, W, D), np.float32)
        mask = np.zeros((b.slots,), bool)
        for i, s in enumerate(streams):
            if 0 <= t - i < len(s):
                windows[i], mask[i] = s[t - i][0][0], True
        t0 = time.perf_counter()
        with DEVICE_LOCK.shared():
            out = b._tick(windows, mask)
        ms.append((time.perf_counter() - t0) * 1e3)
        raw.append(out)
        for i, s in enumerate(streams):
            if 0 <= t - i < len(s):
                outs[i].append(out[i, :s[t - i][1]])
    return [np.concatenate(o) for o in outs], raw, ms


def pieces_of(T):
    """Uneven piece sizes covering T frames."""
    out, k = [], 0
    while sum(out) < T:
        out.append(min(STREAM_PIECES[k % len(STREAM_PIECES)], T - sum(out)))
        k += 1
    return out


def session_run(sess, feat):
    """One stream through a single StreamingSession (reset first), pushed
    in uneven pieces, then finish(). Returns (outputs (frames, V), each
    chunk's outputs, ms per chunk of the pushes that emitted chunks)."""
    sess.reset()
    chunks, per_chunk, i = [], [], 0
    for n in pieces_of(feat.shape[0]):
        t0 = time.perf_counter()
        got = sess.push(feat[None, i:i + n])
        if got:
            per_chunk.append((time.perf_counter() - t0) * 1e3 / len(got))
        chunks += got
        i += n
    chunks += sess.finish()
    return np.concatenate([c[0] for c in chunks]), chunks, per_chunk


def stream_routing(rec_calls, n_blocks, tick_of, slot):
    """A stream's expert choices (n_blocks, frames) from a GateRecorder of
    a batched run: chunk c of the stream ran at tick tick_of(c) in
    ``slot``."""
    n_ticks = len(rec_calls) // n_blocks
    rows = [[] for _ in range(n_blocks)]
    for c in range(n_ticks):
        t = tick_of(c)
        if t is None:
            break
        for blk in range(n_blocks):
            rows[blk].append(rec_calls[t * n_blocks + blk][slot])
    return rows


def routing_frames(rows, n):
    """stream_routing's rows as one (n_blocks, n) array of its first n
    frames."""
    return np.stack([np.concatenate([x.reshape(-1).cpu().numpy()
                                     for x in r])[:n] for r in rows])


def held(a, ref, fp32):
    """fp32: allclose(1e-5, 1e-3); else max|diff| / max|ref| <= 0.05.
    Returns (ok, max|diff| / max|ref|)."""
    rel = float(np.abs(a - ref).max() / np.abs(ref).max())
    ok = (np.allclose(a, ref, rtol=1e-5, atol=1e-3) if fp32
          else rel <= 0.05)
    return ok, rel


def write_arpa(path, V, seed):
    """A seeded random bigram ARPA over unit ids 0..V-1."""
    rng = np.random.default_rng(seed)
    bigrams = sorted({(int(a), int(b)) for a, b in
                      rng.integers(1, V, (2000, 2))})
    with open(path, "w") as f:
        f.write(f"\\data\\\nngram 1={V + 1}\nngram 2={len(bigrams)}\n\n"
                "\\1-grams:\n")
        f.write(f"-99 <s> {rng.uniform(-1, 0):.4f}\n")
        for u in range(1, V):
            f.write(f"{rng.uniform(-5, -2):.4f} {u} "
                    f"{rng.uniform(-1, 0):.4f}\n")
        f.write(f"{rng.uniform(-3, -1):.4f} </s>\n\n\\2-grams:\n")
        for a, b in bigrams:
            f.write(f"{rng.uniform(-2, -0.1):.4f} {a} {b}\n")
        f.write("\n\\end\\\n")


def rotated_device_ms(torch, fn, iters):
    """profiled_ms of fn(i) with i counting up across calls (layers
    rotate as in cuda_time_ms): the device time of one call."""
    calls = iter(range(10 ** 9))
    return profiled_ms(torch, lambda: fn(next(calls)), iters)


def stream_kernel_check(torch, got, ref, fp32, tol, label):
    """A stream-count launch against its plain version on the same
    inputs: fp32 allclose(1e-5, 1e-5), else max|diff| within ``tol`` of
    max|ref| (phase_kernel's and phase_kernel_quant's tolerances). Logs
    one line, exits on a failure; returns max|diff|."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = np.isfinite(err) and (
        torch.allclose(got, ref, rtol=1e-5, atol=1e-5) if fp32
        else err <= tol * scale)
    log(f"kernel {label}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
        f"({'allclose(1e-5, 1e-5)' if fp32 else f'held to {tol:g} of it'})"
        f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"FAIL kernel: {label} disagrees with its plain "
                         "version")
    return err


def time_stream_kernels(torch, smi):
    """K1 (fp32, bf16) and K6 (int4, w4a8) at a stream chunk's and an
    8-slot tick's token counts (16, 128) under the router's routing,
    layers rotated: each first held against its plain version on the
    same inputs (stream_kernel_check), then the wrapper call (CUDA
    events) and its device time (torch.profiler), the plain version and
    the bound. Returns the worst max_abs_err under the keys of
    phase_kernel (dtype name) and phase_kernel_quant (("K6", a8))."""
    from m3asr_tpu_torch.ops import moe_q4, moe_runs
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        p = expert_weights(torch, dtype, gen, d=D, h=H)
        for n in STREAM_TOKENS:
            x = torch.randn(1, n, D, generator=gen, device="cuda").to(dtype)
            gate = routing(torch, "router", n, gen)
            elt = x.element_size()
            t_bytes = (n_active(torch, gate) * (2 * D * H + H + D) * elt
                       + 2 * n * D * elt + n * 4) / HBM_BYTES_PER_S * 1e3
            t_ops = 4 * n * D * H / PEAK_OPS_PER_S[dname] * 1e3
            for layer in (0, L - 1):
                got = moe_runs.runs_kernel.launch(p, x, gate, layer)
                torch.cuda.synchronize()
                err = stream_kernel_check(
                    torch, got, moe_runs.moe_experts_runs_reference(
                        p, x, gate, layer), dtype == torch.float32, 1e-2,
                    f"moe_runs_f {dname} (K1) n={n} router layer={layer}")
                worst[dname] = max(worst.get(dname, 0.0), err)
            ms = cuda_time_ms(torch, lambda i: moe_runs.runs_kernel.launch(
                p, x, gate, i % L), 54)
            dev = rotated_device_ms(torch, lambda i: (
                moe_runs.runs_kernel.launch(p, x, gate, i % L)), 18)
            plain = cuda_time_ms(
                torch, lambda i: moe_runs.moe_experts_runs_reference(
                    p, x, gate, i % L), 18)
            log(f"time stream moe_runs_f[{dname}] (K1) n={n} router: call "
                f"{ms:.4f} ms (device {dev:.4f} ms), plain {plain:.4f} ms, "
                f"bound "
                f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f} / ops "
                f"{t_ops:.4f}), library_ms none; {smi}")
    n_layers = 6
    p = quant_experts(torch, 4, gen, n_layers, d=D, h=H)
    layers = [at_layer(p, i) for i in range(n_layers)]
    per_expert = (p["w1_q4"][0, 0].numel() + p["w2_q4"][0, 0].numel()
                  + 4 * (layers[0]["w1_scale"][0].numel()
                         + layers[0]["w2_scale"][0].numel()) + 2 * (H + D))
    for a8 in (False, True):
        for n in STREAM_TOKENS:
            x = torch.randn(1, n, D, generator=gen, device="cuda") \
                .to(torch.bfloat16)
            gate = routing(torch, "router", n, gen)
            t_bytes = (n_active(torch, gate) * per_expert + 2 * n * D * 2
                       + n * 4) / HBM_BYTES_PER_S * 1e3
            t_ops = 4 * n * D * H / PEAK_OPS_PER_S[
                "int8" if a8 else "bfloat16"] * 1e3
            for layer in (0, n_layers - 1):
                got = moe_q4.q4_kernel.launch(layers[layer], x, gate, layer,
                                              act_quant=a8)
                torch.cuda.synchronize()
                err = stream_kernel_check(
                    torch, got, moe_q4.moe_experts_q4_reference(
                        layers[layer], x, gate, layer, act_quant=a8),
                    False, 2e-2 if a8 else 1e-2,
                    f"{QUANT_NAMES[('K6', a8)]} (K6) n={n} router "
                    f"layer={layer}")
                worst[("K6", a8)] = max(worst.get(("K6", a8), 0.0), err)
            ms = cuda_time_ms(torch, lambda i: moe_q4.q4_kernel.launch(
                layers[i % n_layers], x, gate, i % n_layers, act_quant=a8),
                60)
            dev = rotated_device_ms(torch, lambda i: moe_q4.q4_kernel.launch(
                layers[i % n_layers], x, gate, i % n_layers, act_quant=a8),
                18)
            plain = cuda_time_ms(torch, lambda i: (
                moe_q4.moe_experts_q4_reference(
                    layers[i % n_layers], x, gate, i % n_layers,
                    act_quant=a8)), 6)
            log(f"time stream {QUANT_NAMES[('K6', a8)]} (K6) n={n} router: "
                f"call {ms:.4f} ms (device {dev:.4f} ms), plain "
                f"{plain:.4f} ms, bound "
                f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f} / ops "
                f"{t_ops:.4f}), library_ms none; {smi}")
    return worst


def stream_mode(torch, label, eng, cfg, cfg_c, feats, kname, want_impl, smi):
    """The checks of phase "stream" for one engine mode; returns the
    launches of its kernel."""
    import m3asr_tpu_torch.serve as serve
    from m3asr_tpu_torch.models import moe_conformer
    from m3asr_tpu_torch.models.conformer import chunk_attention_mask
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.moe import HOST_SYNC_STAGES
    from m3asr_tpu_torch.runtime.graphs import DEVICE_LOCK, GRAPH_WARMUP_RUNS
    from m3asr_tpu_torch.runtime.streaming_batch import StreamBatcher
    from m3asr_tpu_torch.runtime.streaming_session import StreamingSession

    fp32 = label == "float32"
    n_moe = cfg.encoder_conf.num_blocks
    fwds = GRAPH_WARMUP_RUNS + 1
    params = serve.stream_params(eng)
    impl = serve._stream_moe_impl(eng, STREAM_SLOTS)
    if impl != want_impl or impl in HOST_SYNC_STAGES:
        raise SystemExit(f"FAIL stream {label}: stage {impl}, want "
                         f"{want_impl}")
    streams = [stream_windows(f, STREAM_CHUNK) for f in feats]
    n_ticks = max(i + len(s) for i, s in enumerate(streams))
    kw = dict(chunk_size=STREAM_CHUNK, num_left_chunks=STREAM_LEFT,
              moe=True, moe_impl=impl)
    bkw = dict(kw, slots=STREAM_SLOTS, input_dim=cfg.input_dim)
    launched = 0

    def counted(want, what, main=False):
        """Hold the launches since the last reset to ``want``; the
        captures (the main path's programs) add to ``launched``."""
        nonlocal launched
        got = kernel_counts()
        if main:
            launched += got.get(kname, 0)
        if got != want:
            raise SystemExit(f"FAIL stream {label}: {what} launched {got}, "
                             f"want {want}")
        reset_counts()

    # the batched chunk program: captured (3 forwards counted), replayed
    # (none), against the same program eager (18 a tick), bit for bit
    reset_counts()
    b_g = StreamBatcher(params, cfg.encoder_conf, **bkw)
    if b_g.graph is None:
        raise SystemExit(f"FAIL stream {label}: no graph captured")
    counted({kname: fwds * n_moe}, "the batcher's capture", main=True)
    outs_b, raw_g, tick_g = batched_ticks(b_g, streams)
    counted({}, "the graph's replays")
    b_e = StreamBatcher(params, cfg.encoder_conf, cuda_graphs=False, **bkw)
    with GateRecorder(moe_mod) as rec_b:
        _, raw_e, tick_e = batched_ticks(b_e, streams)
    counted({kname: n_ticks * n_moe}, "the eager ticks")
    equal = all(np.array_equal(a, b) for a, b in zip(raw_g, raw_e))
    full = (np.zeros((STREAM_SLOTS,) + streams[0][0][0].shape[1:],
                     np.float32), np.ones((STREAM_SLOTS,), bool))

    def tick():
        with DEVICE_LOCK.shared():
            b_g._tick(*full)
    dev, events = profiled_events(torch, tick, 5)
    reset_counts()
    tg, te = float(np.median(tick_g)), float(np.median(tick_e))
    log(f"stream {label} batcher ({STREAM_SLOTS} slots, chunk "
        f"{STREAM_CHUNK}, left {STREAM_LEFT}, stage {impl}): {n_ticks} "
        f"ticks of {len(streams)} staggered streams; graph outputs "
        f"bit-equal to the eager step's: {equal}; median tick graph "
        f"{tg:.3f} ms, eager {te:.3f} ms (host clock); a graph tick's "
        f"device time {dev:.3f} ms under torch.profiler ({events // 5} "
        f"events), busy {dev / tg:.3f}; graph pool "
        f"{b_g.pool_bytes / 2**20:.1f} MiB reserved; {smi} "
        f"{'OK' if equal else 'FAIL'}")
    if not equal:
        raise SystemExit(f"FAIL stream {label}: graph ticks differ from "
                         "eager")
    b_g.close()
    b_e.close()

    # single-stream sessions (scalar offsets), pushed in uneven pieces:
    # graph against eager bit for bit, then the eager session pinned to
    # the batched run's experts against the batched outputs
    s_g = StreamingSession(params, cfg.encoder_conf, **kw)
    s_e = StreamingSession(params, cfg.encoder_conf, cuda_graphs=False, **kw)
    lat_g, lat_e, worst, flipped, frames = [], [], 0.0, 0, 0
    bit_equal, ok_all = True, True
    for i, f in enumerate(feats):
        out_g, chunks_g, pc = session_run(s_g, f)
        if i == 0:      # the capture at its first chunk, then replays
            counted({kname: fwds * n_moe}, "the session's capture and "
                    "replays", main=True)
        lat_g += pc
        ok_all &= out_g.shape == outs_b[i].shape
        if i not in SESSION_CHECKED:
            continue
        with GateRecorder(moe_mod) as rec_s:
            out_e, chunks_e, pc = session_run(s_e, f)
        lat_e += pc
        bit_equal &= len(chunks_g) == len(chunks_e) and all(
            np.array_equal(a, b) for a, b in zip(chunks_g, chunks_e))
        mine = stream_routing(rec_b.calls, n_moe,
                              lambda c: i + c if c < len(streams[i])
                              else None, i)
        free = stream_routing(rec_s.calls, n_moe, lambda c: c, 0)
        n = out_e.shape[0]
        flipped += int(np.any(routing_frames(mine, n)
                              != routing_frames(free, n), 0).sum())
        frames += n
        replay = [rec_b.calls[(i + c) * n_moe + blk][i:i + 1]
                  for c in range(len(streams[i])) for blk in range(n_moe)]
        with GateRecorder(moe_mod, replay=replay):
            out_p, _, _ = session_run(s_e, f)
        ok, rel = held(outs_b[i], out_p, fp32)
        worst = max(worst, rel)
        ok_all &= ok
    eager_chunks = sum(len(streams[i]) for i in SESSION_CHECKED)
    counted({kname: 2 * eager_chunks * n_moe},
            "the sessions' replays and two eager runs")
    log(f"stream {label} sessions: {len(feats)} streams of {STREAM_FRAMES} "
        f"frames in pieces of {STREAM_PIECES} through the graph, streams "
        f"{SESSION_CHECKED} also eager (free-running and pinned); graph "
        f"chunks bit-equal to eager: {bit_equal}; batched vs single session "
        f"on the batched run's experts: max|diff|/max|ref| {worst:.3e} "
        f"({'allclose(1e-5, 1e-3)' if fp32 else '<= 0.05'}); frames whose "
        f"expert differs in some block, free-running: {flipped} of "
        f"{frames}; chunk latency median graph {np.median(lat_g):.3f} ms, "
        f"eager {np.median(lat_e):.3f} ms (host clock); session graph "
        f"pool {s_g._prog.pool_bytes / 2**20:.1f} MiB reserved; {smi} "
        f"{'OK' if bit_equal and ok_all else 'FAIL'}")
    if not (bit_equal and ok_all):
        raise SystemExit(f"FAIL stream {label}: sessions")

    # the oracle: the causal flagship's streams against the offline
    # forward with the chunk attention mask, routing pinned to the
    # streams' experts, on every full chunk's frames
    b_o = StreamBatcher(params, cfg_c.encoder_conf, cuda_graphs=False, **bkw)
    with GateRecorder(moe_mod) as rec_o:
        outs_o, _, _ = batched_ticks(b_o, streams)
    b_o.close()
    T = max(STREAM_FRAMES)
    Tp = (T - 3) // 4
    feat_t = torch.zeros((len(feats), T, cfg.input_dim), device="cuda")
    for i, f in enumerate(feats):
        feat_t[i, :f.shape[0]] = torch.from_numpy(f).cuda()
    lens = torch.tensor([f.shape[0] for f in feats], dtype=torch.int32,
                        device="cuda")
    mask = chunk_attention_mask(Tp, STREAM_CHUNK, STREAM_LEFT,
                                device="cuda")
    dtype = eng.dtype
    with torch.inference_mode():
        with GateRecorder(moe_mod) as rec_f:
            moe_conformer.forward(params, cfg_c.encoder_conf,
                                  feat_t.to(dtype), lens,
                                  moe_impl=ORACLE_IMPL[label],
                                  chunk_mask=mask)
        replay = [g.clone() for g in rec_f.calls]
        for i, s in enumerate(streams):
            n = (len(s) - (s[-1][1] < STREAM_CHUNK)) * STREAM_CHUNK
            rows = stream_routing(rec_o.calls, n_moe,
                                  lambda c: i + c if c < len(s) else None, i)
            for blk in range(n_moe):
                replay[blk][i, :n] = torch.cat(rows[blk])[:n]
        with GateRecorder(moe_mod, replay=replay):
            ref = moe_conformer.forward(params, cfg_c.encoder_conf,
                                        feat_t.to(dtype), lens,
                                        moe_impl=ORACLE_IMPL[label],
                                        chunk_mask=mask)[0]
    ref = ref.float().cpu().numpy()
    worst, flipped, frames, ok_all = 0.0, 0, 0, True
    for i, s in enumerate(streams):
        n = (len(s) - (s[-1][1] < STREAM_CHUNK)) * STREAM_CHUNK
        ok, rel = held(outs_o[i][:n], ref[i, :n], fp32)
        worst = max(worst, rel)
        ok_all &= ok
        free = [rec_f.calls[blk][i, :n].cpu().numpy() for blk in range(n_moe)]
        mine = [replay[blk][i, :n].cpu().numpy() for blk in range(n_moe)]
        flipped += int(np.any(np.stack(free) != np.stack(mine), 0).sum())
        frames += n
    reset_counts()
    log(f"stream {label} oracle (causal=True in both encoders): batched "
        f"streams vs moe_conformer.forward with chunk_attention_mask("
        f"{Tp}, {STREAM_CHUNK}, {STREAM_LEFT}) ({ORACLE_IMPL[label]}, "
        f"experts pinned to the streams'), {frames} full-chunk frames: "
        f"max|diff|/max|ref| {worst:.3e} "
        f"({'allclose(1e-5, 1e-3)' if fp32 else '<= 0.05'}); frames whose "
        f"expert differs free-running: {flipped}; {smi} "
        f"{'OK' if ok_all else 'FAIL'}")
    if not ok_all:
        raise SystemExit(f"FAIL stream {label}: streams disagree with the "
                         "chunk-masked offline forward")
    return launched


def serve_client(port, reqs):
    """Send requests on one connection; their responses."""
    import socket
    with socket.create_connection(("127.0.0.1", port)) as sock:
        f = sock.makefile("rwb")
        out = []
        for r in reqs:
            f.write((json.dumps(r) + "\n").encode())
            f.flush()
            out.append(json.loads(f.readline()))
        return out


def phase_stream_serve(torch, cfg, tree, smi):
    """A loopback server (m3asr_tpu_torch.serve, --warmup, port 0) on a
    bf16 engine of the flagship: two offline requests (greedy; beam with
    a context trie and a seeded ARPA LM) and two concurrent beam streams,
    each response held equal to the engine and the host decode called
    directly; the native decoder must be the one that ran, and --warmup
    must have captured the default stream batcher before the first
    stream. Then two threads call infer and infer_long on the engine,
    each result equal to the serial one, and the mixed load
    (mixed_load). Returns the K1 launches of the server's captures."""
    import socketserver
    import tempfile
    import threading
    import m3asr_tpu_torch.serve as serve
    from m3asr_tpu_torch.decode import native
    from m3asr_tpu_torch.decode.ctc import ContextTrie
    from m3asr_tpu_torch.decode.lm import NgramLM
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    if not native.available():
        raise SystemExit(f"FAIL stream serve: the native decoder did not "
                         f"build: {native.load_error()}")
    eng = Engine(cfg, tree, EngineConfig(**SERVE_SETTINGS), device="cuda")
    tmp = tempfile.mkdtemp()
    arpa = os.path.join(tmp, "lm.arpa")
    write_arpa(arpa, cfg.output_dim, 21)
    args = serve.parser().parse_args(
        ["-p", tmp, "--warmup", "--port", "0", "--lm", arpa,
         "--stream_slots", str(STREAM_SLOTS)])
    reset_counts()
    t0 = time.perf_counter()
    state = serve._build_runtime(args, engine=eng)
    warm_s = time.perf_counter() - t0
    warm_key = serve.DEFAULT_STREAM_KEY
    warm_b = state["stream_batchers"].get(warm_key)
    if warm_key != (STREAM_CHUNK, STREAM_LEFT) or warm_b is None \
            or warm_b.graph is None:
        raise SystemExit("FAIL stream serve: --warmup did not capture the "
                         f"{warm_key} stream batcher")
    lm = serve.load_lm(args)
    srv = socketserver.ThreadingTCPServer(
        ("127.0.0.1", 0), serve.make_handler(state, args.beam_size, lm=lm))
    srv.daemon_threads = True
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    rng = np.random.default_rng(9)
    try:
        # offline: greedy, then beam with hotwords and the LM
        fa = rng.standard_normal((206, cfg.input_dim)).astype(np.float32)
        fb = rng.standard_normal((1000, cfg.input_dim)).astype(np.float32)
        out, out_len = eng.infer(fb[None], np.array([1000]))
        lp = out[0] - out[0].max(-1, keepdims=True)
        lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
        greedy_b = native.ctc_greedy_search(out, out_len)[0]
        ctx = [greedy_b[2:5], greedy_b[8:10]]
        ra, rb = serve_client(port, [
            {"id": "a", "feat": fa.tolist()},
            {"id": "b", "feat": fb.tolist(), "decode": "beam",
             "beam_size": 8, "context": ctx, "nbest": 3,
             "timestamps": True}])
        oa, la = eng.infer(fa[None], np.array([206]))
        want_a = native.ctc_greedy_search(oa, la)[0]
        hyps = native.ctc_prefix_beam_search_ext(
            lp, int(out_len[0]), 8, context=ContextTrie(ctx, 3.0), lm=lm,
            lm_weight=args.lm_weight)
        ok_off = (ra.get("hyp") == want_a and rb.get("hyp") ==
                  list(hyps[0].tokens) and rb.get("times") ==
                  list(hyps[0].times) and [n["hyp"] for n in rb["nbest"]]
                  == [list(h.tokens) for h in hyps[:3]] and
                  [n["score"] for n in rb["nbest"]] ==
                  [round(float(h.score), 4) for h in hyps[:3]])
        # two concurrent beam streams
        feats = [rng.standard_normal((T, cfg.input_dim)).astype(np.float32)
                 for T in (900, 611)]
        start = {"stream": "start", "chunk_size": STREAM_CHUNK,
                 "num_left_chunks": STREAM_LEFT, "decode": "beam",
                 "beam_size": 8, "timestamps": True}

        def stream_reqs(f):
            reqs, i = [start], 0
            for n in pieces_of(f.shape[0]):
                reqs.append({"stream": "chunk",
                             "feat": f[i:i + n].tolist()})
                i += n
            return reqs + [{"stream": "end"}]
        got = [None, None]
        clients = [threading.Thread(target=lambda j: got.__setitem__(
            j, serve_client(port, stream_reqs(feats[j]))), args=(j,))
            for j in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        stats = serve_client(port, [{"stats": True}])[0]
        # the same pieces through the server's own batcher and a native
        # beam state, one stream at a time
        pool = state["stream_pool"]
        want, native_used = [], True
        for f in feats:
            sess = pool.acquire((STREAM_CHUNK, STREAM_LEFT))
            beam = native.make_beam_state(8, lm=lm,
                                          lm_weight=args.lm_weight)
            native_used &= isinstance(beam, native.NativeBeamState)
            dec = serve._StreamDecode(sess, beam_state=beam)
            resp, i = [], 0
            for n in pieces_of(f.shape[0]):
                dec.update(sess.push(f[None, i:i + n]))
                toks, times = dec.result()
                resp.append((toks, dec.frames, times))
                i += n
            dec.update(sess.finish())
            toks, times = dec.result()
            resp.append((toks, dec.frames, times))
            pool.release((STREAM_CHUNK, STREAM_LEFT), sess)
            want.append(resp)
        ok_str = all(
            [(r.get("partial", r.get("hyp")), r["out_frames"], r["times"])
             for r in g[1:]] == w for g, w in zip(got, want))
        ticks = stats["stream_batchers"][str((STREAM_CHUNK, STREAM_LEFT))]
    finally:
        srv.shutdown()
        srv.server_close()
    launches = kernel_counts().get("K1", 0)
    ok = (ok_off and ok_str and native_used
          and list(state["stream_batchers"]) == [warm_key])
    log(f"stream serve (loopback 127.0.0.1:{port}, --warmup: "
        f"{len(eng.buckets.all_buckets())} buckets and the {warm_key} "
        f"stream batcher ({warm_b.pool_bytes / 2**20:.1f} MiB pool) "
        f"captured in {warm_s:.2f} s, before the first stream; batchers "
        f"after the streams: {list(state['stream_batchers'])}): offline "
        f"greedy 1x206 and beam "
        f"(width 8, 2 hotword phrases, {lm.order}-gram ARPA of "
        f"{len(lm.logp)} ngrams) 1x1000 equal to the engine and host "
        f"decode called directly: {ok_off}; 2 concurrent beam streams of "
        f"{[f.shape[0] for f in feats]} frames, "
        f"{sum(len(g) for g in got)} responses equal to the server's "
        f"batcher and a native beam state driven directly: {ok_str}; tick "
        f"batch sizes {ticks['tick_batch_sizes']}; native decoder used: "
        f"{native_used}; {smi} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL stream serve: responses differ from direct "
                         "decoding")

    # two threads on one engine: infer and infer_long, against serial
    short = [rng.standard_normal((1, 206, cfg.input_dim)).astype(np.float32)
             for _ in range(4)]
    long_f = rng.standard_normal((1, 5000, cfg.input_dim)).astype(
        np.float32)
    ref_s = [eng.infer(f, np.array([206])) for f in short]
    ref_l = eng.infer_long(long_f)
    bad = []

    def run_short():
        for k in range(40):
            r = eng.infer(short[k % 4], np.array([206]))
            bad.append(not all(np.array_equal(a, b)
                               for a, b in zip(r, ref_s[k % 4])))

    def run_long():
        for _ in range(4):
            r = eng.infer_long(long_f)
            bad.append(not all(np.array_equal(a, b)
                               for a, b in zip(r, ref_l)))
    ths = [threading.Thread(target=run_short),
           threading.Thread(target=run_long)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    ok = len(bad) == 44 and not any(bad)
    log(f"stream engine threads: 40 infer calls (1x206) and 4 infer_long "
        f"calls (1x5000) from two threads on one bf16 engine, each equal to "
        f"its serial result: {len(bad) - sum(bad)} of 44; {smi} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL stream: the engine is not re-entrant")
    mixed_load(torch, cfg, eng, warm_b, short, ref_s, smi)
    state["batcher"].close()
    for b in state["stream_batchers"].values():
        b.close()
    return launches


def mixed_load(torch, cfg, eng, b, short, ref_s, smi):
    """Offline requests (infer 1x206, each result held to its serial one)
    on one thread beside full ticks of the server's stream batcher ``b``
    on another, 40 calls each: each alone, then both with the device
    sections shared as the port runs them, against each call holding
    DEVICE_LOCK exclusively (every section serialised, host work
    included), in turns. Wall ms by the host clock."""
    import threading
    from m3asr_tpu_torch.runtime.graphs import DEVICE_LOCK
    full = (np.zeros((b.slots, 4 * b.chunk + 3, cfg.input_dim), np.float32),
            np.ones((b.slots,), bool))
    n, bad = 40, []

    def offline(side):
        for k in range(n):
            with side():
                r = eng.infer(short[k % 4], np.array([206]))
            bad.append(not all(np.array_equal(x, y)
                               for x, y in zip(r, ref_s[k % 4])))

    def ticks(side):
        for _ in range(n):
            with side(), DEVICE_LOCK.shared():
                b._tick(*full)

    def wall(fns, side):
        ths = [threading.Thread(target=f, args=(side,)) for f in fns]
        t0 = time.perf_counter()
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        return (time.perf_counter() - t0) * 1e3
    shared, alone = DEVICE_LOCK.shared, DEVICE_LOCK.exclusive
    walls = {"offline": wall([offline], shared),
             "stream": wall([ticks], shared)}
    for k in ("shared", "serialised", "shared", "serialised"):
        walls.setdefault(k, []).append(
            wall([offline, ticks], shared if k == "shared" else alone))
    ok = len(bad) == 5 * n and not any(bad)
    log(f"stream mixed load: {n} offline 1x206 requests on one thread and "
        f"{n} full {b.slots}-slot ticks on another; wall ms (host clock): "
        f"offline alone {walls['offline']:.1f}, ticks alone "
        f"{walls['stream']:.1f}, both with shared device sections "
        f"{[round(w, 1) for w in walls['shared']]}, both with every call "
        f"holding DEVICE_LOCK alone "
        f"{[round(w, 1) for w in walls['serialised']]}; offline results "
        f"equal to serial: {len(bad) - sum(bad)} of {len(bad)}; {smi} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL stream: offline results differ beside "
                         "stream ticks")


def phase_stream(torch, state, smi):
    """Phase "stream": fp32, bf16 (K1) and int4 (K6) streams of the
    flagship, 8 slots, chunk 16, left 2 (stream_mode), the loopback
    server and the threaded engine (phase_stream_serve), K1 and K6 alone
    at 16 and 128 tokens. Returns each mode's launches of its kernel on
    the phase's main path (the captures), under their report names."""
    import copy
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg = state["cfg"]
    cfg_c = copy.deepcopy(cfg)
    cfg_c.encoder_conf.causal = True
    cfg_c.encoder_conf.embed_conf.causal = True
    trees = {"float": state["params"], **state.pop("qparams")}
    rng = np.random.default_rng(8)
    feats = [rng.standard_normal((T, cfg.input_dim)).astype(np.float32)
             for T in STREAM_FRAMES]
    reset_counts()                        # the phase's run starts here
    t0 = time.perf_counter()
    launches = {}
    for label, settings, tree, kname, impl in STREAM_MODES:
        eng = Engine(cfg, trees[tree], EngineConfig(**settings),
                     device="cuda")
        launches[label] = stream_mode(torch, label, eng, cfg, cfg_c, feats,
                                      kname, impl, smi)
        eng = None
        torch.cuda.empty_cache()
    launches["bfloat16"] += phase_stream_serve(torch, cfg, trees["float"],
                                               smi)
    torch.cuda.empty_cache()
    for key, err in time_stream_kernels(torch, smi).items():
        errs = state.setdefault(
            "max_err" if isinstance(key, str) else "max_err_q", {})
        errs[key] = max(errs.get(key, 0.0), err)
    log(f"stream: phase took {time.perf_counter() - t0:.1f} s; launches on "
        f"its main path (captures) {launches}")
    if not all(launches.values()):
        raise SystemExit("FAIL stream: a kernel of the path never launched")
    return launches


TRAIN_BATCH = (4, 1000)
TRAIN_LENS = (1000, 960, 880, 800)
TRAIN_LABELS = (40, 36, 30, 25)        # CTC targets per utterance
TRAIN_GRAD_TOL = 1e-3   # flash vs xla: max|diff| / max|g| per group
# the bf16-compute flash step's gradients against the fp32 flash step's:
# max|diff| / max|g| per group within this multiple of the bf16 xla
# step's (the first card run saw at most 1.33x, and groups from 1.5e-2 to
# 0.23 of max|g| for bf16 xla), and the global norm's relative distance
# (the first card run saw 7.1e-3 for both)
TRAIN_BF16_ENVELOPE = 2.0
TRAIN_BF16_NORM_TOL = 2e-2


def train_batch(torch, cfg):
    """Features, lengths and CTC targets of the training batch (numpy from
    a seed), on the card."""
    rng = np.random.default_rng(7)
    B, T = TRAIN_BATCH
    feat = rng.standard_normal((B, T, cfg.input_dim)).astype(np.float32)
    targets = rng.integers(1, cfg.output_dim, (B, max(TRAIN_LABELS))) \
        .astype(np.int32)
    tlens = np.array(TRAIN_LABELS, np.int32)
    return tuple(torch.from_numpy(a).cuda() for a in (
        feat, np.array(TRAIN_LENS, np.int32), targets, tlens))


def param_group(path):
    """The group of a parameter path in the gradient comparison: its
    module, down to a block's sublayer ("blocks/self_attn",
    "embed/blocks/conv_module", "after_norm", ...)."""
    parts = path.split("/")[:-1]
    return "/".join(parts[:3 if parts[0] == "embed" else 2])


def train_config(attn_impl, dtype="float32"):
    from m3asr_tpu_torch.train import step as ts
    return ts.TrainConfig(attn_impl=attn_impl, compute_dtype=dtype,
                          embed_ctc_weight=0.3, warmup_steps=1000)


def group_rel(got, ref):
    """max|got - ref| / max|ref| per parameter group."""
    groups = {}
    for k in ref:
        grp = groups.setdefault(param_group(k), [0.0, 0.0])
        grp[0] = max(grp[0], (got[k] - ref[k]).abs().max().item())
        grp[1] = max(grp[1], ref[k].abs().max().item())
    return {k: d / m if m > 0 else d for k, (d, m) in groups.items()}


def train_grads(torch, cfg, params, batch):
    """Gradients of one training batch from the same parameters, every
    run's tokens sent to the fp32 flash run's experts: fp32 flash against
    fp32 xla, and the bf16-compute flash step (K2/K3 in bf16, the casts
    back to the float32 masters) against fp32 flash, beside the bf16 xla
    step's distance from fp32 flash (what bf16 rounding alone gives)."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.train import step as ts
    from m3asr_tpu_torch.train.lr_scheduler import global_norm

    with GateRecorder(moe_mod) as rec:
        (loss_f, _), g_f = ts.value_and_grad(
            params, cfg, train_config("flash"), *batch)

    def pinned(attn_impl, dtype):
        with GateRecorder(moe_mod, replay=rec.calls):
            (loss, _), g = ts.value_and_grad(
                params, cfg, train_config(attn_impl, dtype), *batch)
        return loss.item(), g

    loss_x, g_x = pinned("xla", "float32")
    loss_f = loss_f.item()
    rel_loss = abs(loss_f - loss_x) / abs(loss_x)
    rels = group_rel(g_f, g_x)
    worst = max(rels, key=rels.get)
    ok = rel_loss <= 1e-5 and rels[worst] <= TRAIN_GRAD_TOL
    log(f"train fp32 flash vs xla (routing pinned): loss {loss_f:.6f}"
        f" vs {loss_x:.6f} (rel {rel_loss:.3e}, held to 1e-5); "
        f"gradients max|diff|/max|g| per group, held to {TRAIN_GRAD_TOL}: "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(rels.items()))
        + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL train: the flash step's loss or gradients "
                         "are off the xla step's")
    del g_x

    norm_f = global_norm(g_f.values()).item()
    found = {}
    for attn_impl in ("xla", "flash"):
        _, g_b = pinned(attn_impl, "bfloat16")
        norm_b = global_norm(g_b.values()).item()
        found[attn_impl] = (group_rel(g_b, g_f),
                            abs(norm_b - norm_f) / norm_f)
        del g_b
    (rels, rel_norm), (envelope, _) = found["flash"], found["xla"]
    ok = rel_norm <= TRAIN_BF16_NORM_TOL and all(
        v <= TRAIN_BF16_ENVELOPE * envelope[k] for k, v in rels.items())
    log(f"train bf16 flash vs fp32 flash gradients (routing pinned): "
        f"grad_norm {norm_f:.6f} fp32, rel {rel_norm:.3e} (bf16 xla "
        f"{found['xla'][1]:.3e}), held to {TRAIN_BF16_NORM_TOL}; "
        f"max|diff|/max|g| per group as flash (bf16 xla), held to "
        f"{TRAIN_BF16_ENVELOPE}x bf16 xla's: " + ", ".join(
            f"{k} {v:.2e} ({envelope[k]:.2e})"
            for k, v in sorted(rels.items()))
        + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("FAIL train: the bf16 step's gradients are off "
                         "the fp32 step's")
    del g_f
    torch.cuda.empty_cache()


def phase_train(torch, state, smi):
    """The flagship's CTC training step (make_train_step, embed CTC weight
    0.3 so that all 24 attention layers train). Returns K2's and K3's
    launches per dtype on the step's run."""
    from m3asr_tpu_torch.ops.flash_attention import flash_kernels
    from m3asr_tpu_torch.train import step as ts

    cfg, params = state["cfg"], state["params"]
    enc = cfg.encoder_conf
    n_attn = enc.embed_conf.num_blocks + enc.num_blocks
    batch = train_batch(torch, cfg)
    train_grads(torch, cfg, params, batch)

    opt = ts.make_optimizer(train_config("flash"))
    opt_state = ts.init_opt_state(opt, params)
    launches = {}
    for label, cfg_t, n_steps in (
            ("flash", train_config("flash"), 4),
            ("xla", train_config("xla"), 2),
            ("bf16 flash", train_config("flash", "bfloat16"), 1)):
        if cfg_t.compute_dtype == "float32":
            # the step itself must turn TF32 off (cuDNN's default is on)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        step = ts.make_train_step(cfg, cfg_t, opt, device="cuda")
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        if any(flags):
            raise SystemExit(f"FAIL train {label}: make_train_step left "
                             f"TF32 on (cuBLAS, cuDNN) {flags}")
        if cfg_t.compute_dtype == "float32":   # and each step call again
            torch.backends.cudnn.allow_tf32 = True
        p, s = params, opt_state
        reset_flash(flash_kernels)        # this run starts here
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for i in range(n_steps):
            t0 = time.perf_counter()
            p, s, m = step(p, s, *batch)
            loss = m["loss"].item()       # syncs
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            per_step = (flash_kernels.fwd_launches, flash_kernels.dq_launches,
                        flash_kernels.dkv_launches)
            want = (0, 0, 0) if label == "xla" else \
                ((i + 1) * n_attn,) * 3
            if per_step != want or not np.isfinite(loss):
                raise SystemExit(f"FAIL train {label}: step {i} launches "
                                 f"(K2, K3 dq, K3 dkv) {per_step}, want "
                                 f"{want}; loss {loss}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if (cfg_t.compute_dtype == "float32"
                and torch.backends.cudnn.allow_tf32):
            raise SystemExit(f"FAIL train {label}: the step ran with TF32 "
                             "turned on after make_train_step")
        log(f"train {label}: {n_steps} steps, losses "
            f"{[round(v, 6) for v in losses]}, grad_norm "
            f"{m['grad_norm'].item():.4f}; launches (K2, K3 dq, K3 dkv) "
            f"{per_step}, {n_attn} each per step; step times ms "
            f"{[round(v, 3) for v in ms]} (median "
            f"{float(np.median(ms)):.3f}); peak memory {peak:.3f} GiB; "
            f"{smi}")
        if label == "flash":
            launches["float32"] = per_step
            loss32 = losses[0]
            dev_ms = profiled_ms(  # one step, after the four above
                torch, lambda: step(params, opt_state, *batch), 1, warmup=0)
            log(f"device time train flash: {dev_ms:.3f} ms in one step "
                f"under torch.profiler, {dev_ms / np.median(ms):.3f} of the "
                f"median step; {smi}")
        elif label == "bf16 flash":
            launches["bfloat16"] = per_step
            rel = abs(losses[0] - loss32) / abs(loss32)
            log(f"train bf16 flash: loss {losses[0]:.6f} vs fp32 "
                f"{loss32:.6f}: rel {rel:.3e}, held to 2e-2 "
                f"{'OK' if rel <= 2e-2 else 'FAIL'}")
            if rel > 2e-2:
                raise SystemExit("FAIL train: the bf16 step's loss is off "
                                 "the fp32 step's")
        p = s = None
        torch.cuda.empty_cache()
    return launches


def cuda_time_ms(torch, fn, iters):
    """Mean device time of fn(i) over iters calls, after 3 warm-up
    calls. Callers rotate the layer with i, so every call reads weights
    that the previous 17 calls did not (L2 holds 50 MB; one layer's
    experts take 64/128 MB), as the main path's layer loop does."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def profiled_ms(torch, fn, iters, warmup=3):
    """Device time of one fn() call: the summed duration of the kernels
    and copies the card ran under torch.profiler over iters calls (after
    warmup calls), over iters. Unlike cuda_time_ms it leaves out the
    host's gaps between launches."""
    return profiled_events(torch, fn, iters, warmup)[0]


def profiled_events(torch, fn, iters, warmup=3):
    """profiled_ms and the number of device events it summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    return sum(us) / 1e3 / iters, len(us)


def paired_device_ms(torch, fa, fb, rounds=4, iters=20):
    """profiled_ms of fa and fb taken in turns (a b b a a b b a ...), so
    that the card's state drifts over both alike: the median and the
    range of each, as ((med, lo, hi), (med, lo, hi)). A round whose trace
    holds fewer device events than that function's fullest round lost
    some to the profiler (it happens on the card's machine) and is left
    out."""
    runs = ([], [])
    for i in range(rounds):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            runs[j].append(profiled_events(torch, (fa, fb)[j], iters))
    out = []
    for r in runs:
        full = max(n for _, n in r)
        t = [ms for ms, n in r if n == full]
        out.append((float(np.median(t)), min(t), max(t)))
    return tuple(out)


def short_name(kernel):
    """A device event's name without return type, namespace or
    arguments, at most 60 characters."""
    name = kernel.replace("void ", "", 1)
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip()[:60]


def device_time(torch, eng, feat, lens):
    """One request under torch.profiler: the summed duration of the
    kernels and copies the card ran (one stream, so they do not overlap),
    in ms, the five kernel names that took most of it, and the ms of each
    expert kernel it ran (expert_kernel: K1, K4-K8, their a8
    forms and the row-tile front)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.infer(feat, lens)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    runs = {}
    for name, us in by_name.items():
        kern = expert_kernel(name)
        if kern is not None:
            runs[kern] = runs.get(kern, 0.0) + us / 1e3
    return sum(by_name.values()) / 1e3, top, runs


def request_times(torch, eng, label, reqs, smi):
    """Median latency of 5 requests (host clock around infer, which ends
    in a device-to-host copy), peak device memory, and the device time of
    one request under torch.profiler with its largest kernels."""
    for feat, lens in reqs:
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng.infer(feat, lens)
            times.append((time.perf_counter() - t0) * 1e3)
        log(f"latency {label} {feat.shape[0]}x{feat.shape[1]}: median "
            f"{np.median(times):.3f} ms (min {min(times):.3f}, max "
            f"{max(times):.3f}, 5 runs), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; {smi}")
        dev_ms, top, runs = device_time(torch, eng, feat, lens)
        if dev_ms == 0:
            log("device time: not measured (the profiler recorded no "
                "device activity)")
            continue
        log(f"device time {label} {feat.shape[0]}x{feat.shape[1]}: "
            f"{dev_ms:.3f} ms in one request under torch.profiler, "
            f"{dev_ms / np.median(times):.3f} of the median latency; "
            "top kernels: " + "; ".join(
                f"{short_name(name)} {us / 1e3:.3f} ms" for name, us in top)
            + "".join(f"; {kern} ({KERNEL_NAMES[kern]}) {ms:.3f} ms"
                      for kern, ms in sorted(runs.items()))
            + f"; {smi}")


TIME_KINDS = ("router", "heavy")      # the routings of the kernel times


def time_quant_kernels(torch, smi):
    """K4 and K5 at the long requests' token counts (511, 1020) under the
    router's routing, and K6 at the short requests' (63, 127) under the
    router's and the heavy routing, each weight-only and a8: the wrapper
    call, its CUDA launches alone, the plain version, and the bound;
    beside each K6 row, K5's launches alone on the same tokens, gate and
    weights (its yardstick: the same tiles on the run-length layout).
    Weights are stacked over 6 layers and the layer rotates with each
    call, so a call finds its weights in device memory, not in the 50 MB
    L2, as the main path's layer loop does. Returns rows keyed by
    (kernel, a8, n, routing)."""
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import moe_q4, moe_runs
    gen = torch.Generator(device="cuda").manual_seed(5)
    n_layers = 6
    rows = {}
    lib_r, lib_q = kernels.MOE_RUNS.load(), kernels.MOE_Q4.load()
    stream = torch.cuda.current_stream().cuda_stream
    for bits in (8, 4):
        p = quant_experts(torch, bits, gen, n_layers)
        layers = [at_layer(p, i) for i in range(n_layers)]
        k1, k2 = ("w1_q4", "w2_q4") if bits == 4 else ("w1_q", "w2_q")
        w1 = p[k1].reshape((n_layers * E,) + tuple(p[k1].shape[2:]))
        w2 = p[k2].reshape((n_layers * E,) + tuple(p[k2].shape[2:]))
        s1 = [q["w1_scale"].reshape(E, -1, H) for q in layers]
        s2 = [q["w2_scale"].reshape(E, -1, D) for q in layers]
        b1, b2 = p["b1"], p["b2"]
        per_expert = (w1[0].numel() + w2[0].numel()
                      + 4 * (s1[0][0].numel() + s2[0][0].numel())
                      + 2 * (H + D))          # bytes: weights, scales, biases
        fmt = 1 if bits == 8 else 2
        cases = [("K4" if bits == 8 else "K5", n, "router")
                 for n in (511, 1020)]
        if bits == 4:
            cases += [("K6", n, kind) for n in (63, 127) for kind in TIME_KINDS]
        for kname, n, kind in cases:
            for a8 in (False, True):
                x = torch.randn(1, n, D, generator=gen, device="cuda") \
                    .to(torch.bfloat16)
                gate = routing(torch, kind, n, gen)
                active = n_active(torch, gate)
                t_bytes = (active * per_expert + 2 * n * D * 2 + n * 4) \
                    / HBM_BYTES_PER_S * 1e3
                t_ops = 4 * n * D * H / PEAK_OPS_PER_S[
                    "int8" if a8 else "bfloat16"] * 1e3
                # the run-length layout and scratch (K4/K5, and K6's
                # yardstick K5), and K6's
                lay = moe_runs.runs_layout(gate.reshape(n), E)
                x_pad = moe_runs._pad_tokens(x.reshape(n, D), lay,
                                             moe_runs.TILE)
                rows_n = lay.n_tiles * moe_runs.TILE
                x2, g2 = x.reshape(n, D), gate.reshape(n)
                front = torch.empty(lib_q.moe_q4_front_ints(n, E),
                                    dtype=torch.int32, device="cuda")
                hdt = torch.float32 if a8 else torch.bfloat16
                hid = torch.empty(max(rows_n, n), H, device="cuda",
                                  dtype=hdt)
                xq = torch.empty(max(rows_n, n), D, dtype=torch.int8,
                                 device="cuda")
                hq = torch.empty(max(rows_n, n), H, dtype=torch.int8,
                                 device="cuda")
                xs = torch.empty(max(rows_n, n), device="cuda")
                hs = torch.empty(max(rows_n, n), device="cuda")
                y = torch.empty_like(x_pad)

                def runs_raw(i):
                    j = i % n_layers
                    if lib_r.moe_runs_q(
                            fmt, int(a8), x_pad.data_ptr(),
                            w1.data_ptr(), s1[j].data_ptr(), s1[j].shape[1],
                            b1.data_ptr(), w2.data_ptr(), s2[j].data_ptr(),
                            s2[j].shape[1], b2.data_ptr(),
                            lay.tile_e.data_ptr(), lay.starts.data_ptr(),
                            lay.n_tiles, E, j, D, H, hid.data_ptr(),
                            xq.data_ptr(), xs.data_ptr(), hq.data_ptr(),
                            hs.data_ptr(), y.data_ptr(), stream):
                        raise SystemExit("FAIL times: moe_runs_q launch "
                                         "error")

                def dense_raw(i):
                    j = i % n_layers
                    if lib_q.moe_q4_dense(
                            int(a8), x2.data_ptr(), g2.data_ptr(), n,
                            w1.data_ptr(), s1[j].data_ptr(), s1[j].shape[1],
                            b1.data_ptr(), w2.data_ptr(), s2[j].data_ptr(),
                            s2[j].shape[1], b2.data_ptr(), E, j, D, H,
                            front.data_ptr(), hid.data_ptr(), xq.data_ptr(),
                            xs.data_ptr(), hq.data_ptr(), hs.data_ptr(),
                            y.data_ptr(), stream):
                        raise SystemExit("FAIL times: moe_q4_dense launch "
                                         "error")
                if kname == "K6":
                    kern = moe_q4.q4_kernel
                    plain = moe_q4.moe_experts_q4_reference
                    raw = dense_raw
                else:
                    kern = moe_runs.runs_q8_kernel if bits == 8 else \
                        moe_runs.runs_q4_kernel
                    plain = moe_runs.moe_experts_runs_reference
                    raw = runs_raw
                ms = cuda_time_ms(torch, lambda i: kern.launch(
                    layers[i % n_layers], x, gate, i % n_layers,
                    act_quant=a8), 60)
                alone = cuda_time_ms(torch, raw, 60)
                plain_ms = cuda_time_ms(torch, lambda i: plain(
                    layers[i % n_layers], x, gate, i % n_layers,
                    act_quant=a8), 6)
                bound = max(t_bytes, t_ops)
                rows[(kname, a8, n, kind)] = dict(
                    ms=ms, alone=alone, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
                yard = ""
                if kname == "K6":
                    k5 = cuda_time_ms(torch, runs_raw, 60)
                    rows[(kname, a8, n, kind)]["k5_alone"] = k5
                    yard = f", yardstick K5 alone {k5:.4f} ms"
                log(f"time {QUANT_NAMES[(kname, a8)]} ({kname}) n={n} {kind} "
                    f"active={active}: call {ms:.4f} ms (kernels alone "
                    f"{alone:.4f} ms{yard}), plain {plain_ms:.4f} ms, bound "
                    f"{bound:.4f} ms (bytes {t_bytes:.4f} / ops "
                    f"{t_ops:.4f}), library_ms none; {smi}")
    return rows


def time_stage_kernels(torch, smi):
    """K8 (fp32, bf16, int8) at the requests' token counts (63, 511, 1020)
    under the router's and the heavy routing, and K7 (weight-only on bf16
    and float32 activations, a8) under the router's: the wrapper call,
    its CUDA launches alone, the plain version, and the bound; beside each
    K8 row, K1's launches alone on the same tokens and gate (its
    yardstick: fp32 K1 for fp32 K8, bf16 K1 for bf16 and int8 K8; float
    K8 on K1's weights), beside each bf16 K7 row K5's (the same weights
    and arithmetic on the run-length layout's 32-row tiles) and K7's own
    launches on that layout (tile 32), which part the cost of the 64/128-row
    tiles' layout from that of K7's tile arithmetic. Six layers of
    weights, the layer rotating with each call, so that a call finds its
    weights in device memory, as the main path's layer loop does. Returns
    rows keyed by (variant name, n, routing)."""
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import moe_q4, moe_runs, moe_stream
    gen = torch.Generator(device="cuda").manual_seed(10)
    n_layers = 6
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}

    def record(name, n, kind, active, per_expert, elt_x, ops_type, ms,
               alone, plain_ms, yard=None, yard_name="K1", extra=""):
        t_bytes = (active * per_expert + 2 * n * D * elt_x + n * 4) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * n * D * H / PEAK_OPS_PER_S[ops_type] * 1e3
        bound = max(t_bytes, t_ops)
        rows[(name, n, kind)] = dict(
            ms=ms, alone=alone, plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            yard_alone=yard)
        log(f"time {name} n={n} {kind} active={active}: call {ms:.4f} ms "
            f"(kernels alone {alone:.4f} ms"
            + ("" if yard is None else
               f", yardstick {yard_name} alone {yard:.4f} ms")
            + extra + f"), plain {plain_ms:.4f} ms, bound {bound:.4f} ms (bytes "
            f"{t_bytes:.4f} / ops {t_ops:.4f}), library_ms none; {smi}")

    lib, lib_r = kernels.MOE_STREAM.load(), kernels.MOE_RUNS.load()
    for wtype, name in STREAM_NAMES.items():
        quant = wtype == "int8"
        xdt = torch.float32 if wtype == "float32" else torch.bfloat16
        code = 0 if xdt == torch.float32 else 1
        # K1's stacked weights in x's type; float K8 takes their layers
        pk = expert_weights(torch, xdt, gen, n_layers=n_layers)
        k1w1 = pk["w1"].reshape(n_layers * E, D, H)
        k1w2 = pk["w2"].reshape(n_layers * E, H, D)
        if quant:
            layers = stream_layers(torch, wtype, gen, n_layers)
        else:
            layers = [{"w1": pk["w1"][i], "w2": pk["w2"][i], "b1": pk["b1"],
                       "b2": pk["b2"]} for i in range(n_layers)]
        # the kernel's arguments per layer: float32 biases, (E, out) scales
        raw_args = []
        for p in layers:
            w1, w2 = (p["w1_q"], p["w2_q"]) if quant else (p["w1"], p["w2"])
            s1 = p["w1_scale"].reshape(E, H) if quant else None
            s2 = p["w2_scale"].reshape(E, D) if quant else None
            raw_args.append((w1, s1, p["b1"].float(), w2, s2,
                             p["b2"].float()))
        w_elt = layers[0]["w1_q" if quant else "w1"].element_size()
        # bytes per active expert: weights, scales, biases at their types
        per_expert = 2 * D * H * w_elt + (4 * (H + D) if quant else 0) \
            + layers[0]["b1"].element_size() * (H + D)
        for n in STAGE_TOKENS:
            for kind in TIME_KINDS:
                x = torch.randn(1, n, D, generator=gen,
                                device="cuda").to(xdt)
                gate = routing(torch, kind, n, gen)
                x2, g2 = x.reshape(n, D), gate.reshape(n)
                front = torch.empty(lib.moe_stream_front_ints(n, E),
                                    dtype=torch.int32, device="cuda")
                hid = torch.empty(n, H, dtype=xdt, device="cuda")
                y = torch.empty_like(x2)
                lay = moe_runs.runs_layout(g2, E)
                x_pad = moe_runs._pad_tokens(x2, lay, moe_runs.TILE)
                k1_hid = torch.empty(lay.n_tiles * moe_runs.TILE, H,
                                     dtype=xdt, device="cuda")
                y_pad = torch.empty_like(x_pad)

                def raw(i):
                    w1, s1, b1, w2, s2, b2 = raw_args[i % n_layers]
                    if lib.moe_stream(
                            code, int(quant), x2.data_ptr(), g2.data_ptr(),
                            n, w1.data_ptr(),
                            None if s1 is None else s1.data_ptr(),
                            b1.data_ptr(), w2.data_ptr(),
                            None if s2 is None else s2.data_ptr(),
                            b2.data_ptr(), E, D, H, front.data_ptr(),
                            hid.data_ptr(), y.data_ptr(), stream):
                        raise SystemExit("FAIL times: moe_stream launch "
                                         "error")

                def k1_raw(i):
                    if lib_r.moe_runs_f(
                            code, x_pad.data_ptr(), k1w1.data_ptr(),
                            pk["b1"].data_ptr(), k1w2.data_ptr(),
                            pk["b2"].data_ptr(), lay.tile_e.data_ptr(),
                            lay.starts.data_ptr(), lay.counts.data_ptr(),
                            lay.n_tiles, E, i % n_layers, D, H,
                            k1_hid.data_ptr(), y_pad.data_ptr(), stream):
                        raise SystemExit("FAIL times: moe_runs_f launch "
                                         "error")
                ms = cuda_time_ms(
                    torch, lambda i: moe_stream.stream_kernel.launch(
                        layers[i % n_layers], x, gate), 60)
                alone = cuda_time_ms(torch, raw, 60)
                yard = cuda_time_ms(torch, k1_raw, 60)
                plain_ms = cuda_time_ms(
                    torch,
                    lambda i: moe_stream.moe_experts_dense_stream_reference(
                        layers[i % n_layers], x, gate), 6)
                record(name, n, kind, n_active(torch, gate), per_expert,
                       x.element_size(),
                       "float32" if wtype == "float32" else "bfloat16", ms,
                       alone, plain_ms, yard)
        layers = raw_args = pk = k1w1 = k1w2 = None

    lib = kernels.MOE_Q4_TILED.load()
    p = quant_experts(torch, 4, gen, n_layers)
    layers = [at_layer(p, i) for i in range(n_layers)]
    w1 = p["w1_q4"].reshape(n_layers * E, D, H // 2)
    w2 = p["w2_q4"].reshape(n_layers * E, H, D // 2)
    s1 = [q["w1_scale"].reshape(E, -1, H) for q in layers]
    s2 = [q["w2_scale"].reshape(E, -1, D) for q in layers]
    b1, b2 = p["b1"].float(), p["b2"].float()
    per_expert = (w1[0].numel() + w2[0].numel()
                  + 4 * (s1[0][0].numel() + s2[0][0].numel())
                  + 2 * (H + D))              # packed weights, scales, biases
    for n in STAGE_TOKENS:
        tile = moe_q4.tiled_tile(n)
        for a8, xdt in ((False, torch.bfloat16), (True, torch.bfloat16),
                        (False, torch.float32)):
            x = torch.randn(1, n, D, generator=gen, device="cuda").to(xdt)
            gate = routing(torch, "router", n, gen)
            lay = moe_runs.runs_layout(gate.reshape(n), E, tile)
            x_pad = moe_runs._pad_tokens(x.reshape(n, D), lay, tile)
            rows_n = lay.n_tiles * tile
            # K5's run-length layout of the same tokens
            lay5 = moe_runs.runs_layout(gate.reshape(n), E)
            x_pad5 = moe_runs._pad_tokens(x.reshape(n, D), lay5,
                                          moe_runs.TILE)
            rows_n = max(rows_n, lay5.n_tiles * moe_runs.TILE)
            hid = torch.empty(rows_n, H, device="cuda", dtype=torch.float32
                              if a8 else xdt)
            xq = torch.empty(rows_n, D, dtype=torch.int8, device="cuda")
            hq = torch.empty(rows_n, H, dtype=torch.int8, device="cuda")
            xs = torch.empty(rows_n, device="cuda")
            hs = torch.empty(rows_n, device="cuda")
            y_pad = torch.empty(rows_n, D, device="cuda", dtype=xdt)
            code = 0 if xdt == torch.float32 else 1

            def raw(i):
                j = i % n_layers
                if lib.moe_q4_tiled(
                        code, int(a8), x_pad.data_ptr(), w1.data_ptr(),
                        s1[j].data_ptr(), s1[j].shape[1], b1.data_ptr(),
                        w2.data_ptr(), s2[j].data_ptr(), s2[j].shape[1],
                        b2.data_ptr(), lay.tile_e.data_ptr(),
                        lay.starts.data_ptr(), lay.counts.data_ptr(), tile,
                        lay.n_tiles, E, j, D, H, 0, 0.0, hid.data_ptr(),
                        xq.data_ptr(), xs.data_ptr(), hq.data_ptr(),
                        hs.data_ptr(), y_pad.data_ptr(), stream):
                    raise SystemExit("FAIL times: moe_q4_tiled launch error")

            def raw32(i):          # K7 on K5's layout: tile 32
                j = i % n_layers
                if lib.moe_q4_tiled(
                        code, int(a8), x_pad5.data_ptr(), w1.data_ptr(),
                        s1[j].data_ptr(), s1[j].shape[1], b1.data_ptr(),
                        w2.data_ptr(), s2[j].data_ptr(), s2[j].shape[1],
                        b2.data_ptr(), lay5.tile_e.data_ptr(),
                        lay5.starts.data_ptr(), lay5.counts.data_ptr(),
                        moe_runs.TILE, lay5.n_tiles, E, j, D, H, 0, 0.0,
                        hid.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                        hq.data_ptr(), hs.data_ptr(), y_pad.data_ptr(),
                        stream):
                    raise SystemExit("FAIL times: moe_q4_tiled launch error")

            def k5_raw(i):
                j = i % n_layers
                if lib_r.moe_runs_q(
                        2, int(a8), x_pad5.data_ptr(), w1.data_ptr(),
                        s1[j].data_ptr(), s1[j].shape[1], p["b1"].data_ptr(),
                        w2.data_ptr(), s2[j].data_ptr(), s2[j].shape[1],
                        p["b2"].data_ptr(), lay5.tile_e.data_ptr(),
                        lay5.starts.data_ptr(), lay5.n_tiles, E, j, D, H,
                        hid.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                        hq.data_ptr(), hs.data_ptr(), y_pad.data_ptr(),
                        stream):
                    raise SystemExit("FAIL times: moe_runs_q launch error")
            ms = cuda_time_ms(torch, lambda i: moe_q4.q4_tiled_kernel.launch(
                layers[i % n_layers], x, gate, layer=i % n_layers,
                act_quant=a8), 60)
            alone = cuda_time_ms(torch, raw, 60)
            yard = None if xdt == torch.float32 else \
                cuda_time_ms(torch, k5_raw, 60)
            at32 = cuda_time_ms(torch, raw32, 60)
            plain_ms = cuda_time_ms(
                torch, lambda i: moe_q4.moe_experts_q4_tiled_reference(
                    layers[i % n_layers], x, gate, layer=i % n_layers,
                    act_quant=a8), 6)
            record(TILED_F32 if xdt == torch.float32 else TILED_NAMES[a8],
                   n, "router", n_active(torch, gate), per_expert,
                   x.element_size(), "int8" if a8 else str(xdt)[6:], ms,
                   alone, plain_ms, yard, "K5",
                   f", K7 alone at tile 32 {at32:.4f} ms")
    return rows


FLASH_TIME_SHAPES = ((4, 255, 249), (1, 511, 511))   # (B, T = S, valid)


def time_flash_kernels(torch, smi):
    """K2 and K3 at the two attention shapes of the main path: the 4x1000
    request's (B=4, T=S=255, valid lengths 249) and the 1x2048 request's
    (B=1, T=S=511, all valid), MoE blocks (H=8, Dk=64) and embed blocks
    (H=4, Dk=128), f32 and bf16: the wrapper call, the CUDA launches alone
    (with each launch's tile rows and blocks), the plain version, one
    PyTorch call that computes the same function
    (scaled_dot_product_attention with a boolean key mask; its backward
    through autograd), and the bound; and the device time alone, under
    torch.profiler, of the wrapper call and of the PyTorch call, which
    the host's speed does not move, taken in turns (paired_device_ms).
    Returns rows keyed by (kernel, dtype, B, H)."""
    import torch.nn.functional as F
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(8)
    lib = kernels.FLASH.load()
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for B, T, n_valid in FLASH_TIME_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            code = 0 if dtype == torch.float32 else 1
            for Hh, Dk in FLASH_HEADS:
                D2, scale = 2 * Dk, Dk ** -0.5
                q2, k2, v, g, _, _, _ = flash_inputs(
                    torch, B, T, Hh, Dk, dtype, "lengths", gen)
                lens = torch.full((B,), n_valid, dtype=torch.int32,
                                  device="cuda")
                out, lse = fa.flash_kernels.forward(q2, k2, v, lens, scale,
                                                    return_lse=True)
                delta = (g.float() * out.float()).sum(-1, keepdim=True)
                out_k, dq2, dk2, dv = (torch.empty_like(t)
                                       for t in (out, q2, k2, v))
                args = (code, D2, Dk, q2.data_ptr(), k2.data_ptr(),
                        v.data_ptr())
                masks = (lens.data_ptr(), None, None, 0, B, Hh, T, T, scale)
                # the wrapper's tile heights: K2 and dQ per query, dK/dV
                # per key
                f_rows, (b_rows, _) = fa.launch_rows(q2, k2)
                grid = {"K2": f"{f_rows} rows, "
                              f"{B * Hh * -(-T // f_rows)} blocks",
                        "K3": f"{b_rows} rows, "
                              f"{B * Hh * -(-T // b_rows)} blocks each"}

                def fwd_raw(i):
                    if lib.flash_fwd(*args, *masks, f_rows, out_k.data_ptr(),
                                     None, stream):
                        raise SystemExit("FAIL times: flash_fwd launch error")

                def bwd_raw(i):
                    grads = (g.data_ptr(), lse.data_ptr(), delta.data_ptr())
                    if lib.flash_bwd_dq(*args, *grads, *masks, b_rows,
                                        dq2.data_ptr(), stream) or \
                            lib.flash_bwd_dkv(*args, *grads, *masks, b_rows,
                                              dk2.data_ptr(), dv.data_ptr(),
                                              stream):
                        raise SystemExit("FAIL times: flash_bwd launch error")

                key_mask = (torch.arange(T, device="cuda")[None, :]
                            < lens[:, None])[:, None, None, :]
                ql, kl, vl = (t.detach().requires_grad_(True)
                              for t in (q2, k2, v))
                lib_out = F.scaled_dot_product_attention(
                    ql, kl, vl, attn_mask=key_mask, scale=scale)
                elt = q2.element_size()
                # the work this run's data needs: valid query rows x valid
                # keys
                pairs = B * Hh * n_valid * n_valid
                times = {
                    "K2": dict(
                        ms=cuda_time_ms(
                            torch, lambda i: fa.flash_kernels.forward(
                                q2, k2, v, lens, scale), 50),
                        alone=cuda_time_ms(torch, fwd_raw, 50),
                        plain_ms=cuda_time_ms(
                            torch, lambda i: fa.flash_attention_reference(
                                q2, k2, v, lens, scale), 10),
                        library_ms=cuda_time_ms(
                            torch, lambda i: F.scaled_dot_product_attention(
                                q2, k2, v, attn_mask=key_mask, scale=scale),
                            50),
                        nbytes=elt * B * Hh * T * (2 * D2 + 2 * Dk) + 4 * B,
                        ops=2 * pairs * (D2 + Dk)),
                    "K3": dict(
                        ms=cuda_time_ms(
                            torch, lambda i: fa.flash_kernels.backward(
                                q2, k2, v, g, lse, delta, lens, scale), 50),
                        alone=cuda_time_ms(torch, bwd_raw, 50),
                        plain_ms=cuda_time_ms(
                            torch, lambda i: fa.flash_attention_bwd_reference(
                                q2, k2, v, g, lse, delta, lens, scale), 10),
                        library_ms=cuda_time_ms(
                            torch, lambda i: torch.autograd.grad(
                                lib_out, (ql, kl, vl), g, retain_graph=True),
                            50),
                        # read q2, k2, v, g, lse, delta; write dq2, dk2, dv
                        nbytes=(elt * B * Hh * T * (4 * D2 + 3 * Dk)
                                + 8 * B * Hh * T + 4 * B),
                        # scores again, dp, dv, dq, dk
                        ops=2 * pairs * (3 * D2 + 2 * Dk))}
                device = {
                    "K2": (lambda: fa.flash_kernels.forward(
                        q2, k2, v, lens, scale),
                           lambda: F.scaled_dot_product_attention(
                               q2, k2, v, attn_mask=key_mask, scale=scale)),
                    "K3": (lambda: fa.flash_kernels.backward(
                        q2, k2, v, g, lse, delta, lens, scale),
                           lambda: torch.autograd.grad(
                               lib_out, (ql, kl, vl), g, retain_graph=True))}
                for kname, r in times.items():
                    dev, lib_dev = (
                        "{:.4f} ms ({:.4f}-{:.4f})".format(*t)
                        for t in paired_device_ms(torch, *device[kname]))
                    t_bytes = r.pop("nbytes") / HBM_BYTES_PER_S * 1e3
                    t_ops = r.pop("ops") / PEAK_OPS_PER_S[dname] * 1e3
                    r["bound_ms"] = max(t_bytes, t_ops)
                    r["bound_by"] = ("bytes" if t_bytes >= t_ops
                                     else "operations")
                    rows[(kname, dname, B, Hh)] = r
                    log(f"time flash {kname} {dname} B={B} T={T} H={Hh} "
                        f"Dk={Dk} ({grid[kname]}): call {r['ms']:.4f} ms "
                        f"(kernels alone {r['alone']:.4f} ms, device "
                        f"{dev}), plain {r['plain_ms']:.4f} ms, "
                        f"scaled_dot_product_attention {r['library_ms']:.4f}"
                        f" ms (device {lib_dev}), bound "
                        f"{r['bound_ms']:.4f} ms (bytes {t_bytes:.4f} / ops "
                        f"{t_ops:.4f}); {smi}")
    return rows


K1_TIME_TOKENS = (63, 511, 1020)      # the requests' token counts


def time_k1(torch, smi):
    """K1 at the requests' token counts (router routing, layers rotated so
    weights come from device memory): the wrapper call, its two CUDA
    launches alone (printed with the column block, the live tiles and the
    live blocks of each launch), the plain version, and the bound.
    Returns rows keyed by (dtype, tokens)."""
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import moe_runs
    gen = torch.Generator(device="cuda").manual_seed(3)
    lib = kernels.MOE_RUNS.load()
    bn = lib.moe_runs_f_col_block()
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        p = expert_weights(torch, dtype, gen)
        w1 = p["w1"].reshape(L * E, D, H)
        w2 = p["w2"].reshape(L * E, H, D)
        for n in K1_TIME_TOKENS:
            x = torch.randn(1, n, D, generator=gen, device="cuda").to(dtype)
            gate = routing(torch, "router", n, gen)
            active = n_active(torch, gate)
            elt = x.element_size()
            nbytes = (active * (2 * D * H + H + D) * elt   # weights+biases
                      + 2 * n * D * elt + n * 4)           # x, y, gate
            ops = 4 * n * D * H
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS_PER_S[dname] * 1e3
            ms = cuda_time_ms(torch, lambda i: moe_runs.runs_kernel.launch(
                p, x, gate, i % L), 54)
            plain = cuda_time_ms(
                torch, lambda i: moe_runs.moe_experts_runs_reference(
                    p, x, gate, i % L), 18)
            # the two CUDA launches alone, without the layout prep
            lay = moe_runs.runs_layout(gate.reshape(n), E)
            x_pad = moe_runs._pad_tokens(x.reshape(n, D), lay,
                                         moe_runs.TILE)
            hid = torch.empty(lay.n_tiles * moe_runs.TILE, H, dtype=dtype,
                              device="cuda")
            y_pad = torch.empty_like(x_pad)
            live = int(lay.starts[-1])

            def raw(i):
                if lib.moe_runs_f(
                        0 if dtype == torch.float32 else 1,
                        x_pad.data_ptr(), w1.data_ptr(), p["b1"].data_ptr(),
                        w2.data_ptr(), p["b2"].data_ptr(),
                        lay.tile_e.data_ptr(), lay.starts.data_ptr(),
                        lay.counts.data_ptr(), lay.n_tiles, E, i % L, D, H,
                        hid.data_ptr(), y_pad.data_ptr(), stream):
                    raise SystemExit("FAIL times: launch error")
            alone = cuda_time_ms(torch, raw, 54)
            bound = max(t_bytes, t_ops)
            rows[(dname, n)] = dict(
                ms=ms, alone=alone, plain_ms=plain, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            log(f"time moe_runs_f {dname} n={n} active={active}: call "
                f"{ms:.4f} ms (kernels alone {alone:.4f} ms at column "
                f"block {bn}: {live} live tiles of {lay.n_tiles}, live "
                f"blocks GEMM1 {live * H // bn}, GEMM2 {live * D // bn}), "
                f"plain {plain:.4f} ms, bound {bound:.4f} ms (bytes "
                f"{t_bytes:.4f} / ops {t_ops:.4f}), library_ms none; {smi}")
    return rows


def phase_times(torch, state, smi):
    launches = state["launches"]
    rows = time_k1(torch, smi)

    for dtype, (eng, _) in state["engines"].items():
        request_times(torch, eng, dtype, state["requests"], smi)

    report = []
    for dname in ("float32", "bfloat16"):
        r = rows[(dname, 63)]
        report.append({
            "name": f"moe_runs_f[{dname}]", "route": "cuda",
            "source": "m3asr_tpu_torch/csrc/moe_runs.cu",
            "replaces": "m3asr_tpu/ops/pallas_moe_runs.py:350",
            "launches": launches[dname] + state["launches_stream"][dname],
            "max_abs_err": state["max_err"][dname],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    qrows = time_quant_kernels(torch, smi)
    for (kname, a8), name in QUANT_NAMES.items():
        mode = MODES[("int4" if kname != "K4" else "int8", a8)]
        r = qrows[(kname, a8, 63 if kname == "K6" else 511, "router")]
        report.append({
            "name": name, "route": "cuda",
            "source": "m3asr_tpu_torch/csrc/"
                      + ("moe_q4.cu" if kname == "K6" else "moe_runs.cu"),
            "replaces": "m3asr_tpu/ops/pallas_moe_q4.py:320"
                        if kname == "K6"
                        else "m3asr_tpu/ops/pallas_moe_runs.py:350",
            "launches": state["launches_q"][mode][kname] + (
                state["launches_stream"]["int4"]
                if (kname, a8) == ("K6", False) else 0),
            "max_abs_err": state["max_err_q"][(kname, a8)],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    frows = time_flash_kernels(torch, smi)
    for kname, fname, line in (("K2", "flash_fwd", 145),
                               ("K3", "flash_bwd", 377)):
        for dname in ("float32", "bfloat16"):
            r = frows[(kname, dname, 4, 8)]   # B=4, T=255, MoE blocks
            report.append({
                "name": f"{fname}[{dname}]", "route": "cuda",
                "source": "m3asr_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"m3asr_tpu/ops/pallas_attention.py:{line}",
                "launches": state["launches_flash"][(kname, dname)],
                "max_abs_err": state["max_err_flash"][(kname, dname)],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]})
    srows = time_stage_kernels(torch, smi)
    for name, n, source, line in (
            [(v, STAGE_TOKENS[0], "moe_stream.cu", "pallas_moe.py:147")
             for v in STREAM_NAMES.values()]
            + [(v, STAGE_TOKENS[1], "moe_q4_tiled.cu", "pallas_moe_q4.py:596")
               for v in TILED_NAMES.values()]):
        r = srows[(name, n, "router")]
        report.append({
            "name": name, "route": "cuda",
            "source": f"m3asr_tpu_torch/csrc/{source}",
            "replaces": f"m3asr_tpu/ops/{line}",
            "launches": state["launches_stage"][name],
            "max_abs_err": state["max_err_stage"][name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    return report


def main():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, smi = phase_device(torch)
    import m3asr_tpu_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(
            m3asr_tpu_torch.__file__))) != HERE:
        raise SystemExit("FAIL: m3asr_tpu_torch is not the checkout's own")
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import moe_runs
    phase_build(kernels)
    phase_kernel_front(torch)
    state = {"max_err": phase_kernel(torch, moe_runs),
             "max_err_q": phase_kernel_quant(torch),
             "max_err_flash": phase_kernel_flash(torch),
             "max_err_stage": phase_kernel_stage(torch)}
    state["launches"] = phase_serve(torch, state)
    state["launches_q"] = phase_serve_quant(torch, state, smi)
    state["launches_stage"] = phase_serve_stages(torch, state, smi)
    served = phase_serve_flash(torch, state, smi)
    phase_serve_graphs(torch, state, smi)
    state["launches_stream"] = phase_stream(torch, state, smi)
    trained = phase_train(torch, state, smi)
    # K2: serving's forwards and the training steps'; K3: the steps'
    state["launches_flash"] = {}
    for dname in ("float32", "bfloat16"):
        fwd, dq, dkv = trained[dname]
        if dq != dkv:
            raise SystemExit("FAIL: K3's two kernels launched unequally")
        state["launches_flash"][("K2", dname)] = served[dname] + fwd
        state["launches_flash"][("K3", dname)] = dq
    report = phase_times(torch, state, smi)
    log(smi)
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
