#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero with no
result line:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them.
2. build: every hand-written kernel, compiled by nvcc from csrc/ (one
   nvcc per source, all started together).
3. kernels against their plain PyTorch versions at the flagship widths
   (E=32, d=512, h=1024):
   K1 (float run-length, moe_runs_f): stacked L=18 at layers 0 and 17,
   fp32 and bf16, at 63/127/511/1535 tokens (the 256/512/2048/6144-frame
   buckets) under four routings. fp32: allclose(rtol 1e-5, atol 1e-5);
   bf16: max|diff| within 1e-2 of max|ref|.
   K4 (int8 run-length), K5 (int4 run-length) at 63 and 511 tokens, K6
   (int4 dense streamer) at 63 and 127, each weight-only and a8, random
   int weights stacked L=3 at layers 0 and 2, bf16 activations, under a
   router's skewed routing, all tokens on one expert, and half the
   experts empty; K5 and K6 also at d=320, h=640, where the two nibble
   halves of w2's packed columns meet inside one column block.
   Weight-only: max|diff| within 1e-2 of max|ref| (bf16 output and
   hidden, float32 sums in another order). a8: within 2e-2 (the integer
   sums are exact on both sides, but SiLU rounds differently in the two,
   which can move a hidden value to the next of its 127 levels).
4. serve, float: the flagship hier MoE conformer (6 embed blocks, 18 MoE
   blocks, 32 experts, vocabulary 5000; random weights from a seeded
   CUDA generator, routers randomised) in an fp32 and a bf16 Engine
   answers 1x206, 4x1000 and 1x2048 frames. Each forward must launch K1
   once per MoE block (18), and the logits must match the same engine
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
6. times: each kernel per call (CUDA events over many calls after
   warm-up, layers rotated so weights come from device memory) and its
   launches alone, at the main path's token counts, beside its bound and
   the plain version's time; the float engines' request latency, peak
   device memory and device time of one request under torch.profiler
   with the kernels that took most of it.

The line before the last is one JSON object describing each kernel
(route, source, launches on the main path, error, times, bound); the
last line is {"ok": true, "device": {...}}.
"""

import json
import os
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
TOKENS = (63, 127, 511, 1535)
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
            # ptxas -v: per entry function, its (mangled, shortened) name,
            # then its spills, then its registers and shared memory
            ptxas = []
            for ln in lib.log.splitlines():
                if "Compiling entry function" in ln:
                    name = ln.split("'")[1].replace("_ZN12_GLOBAL__N_1", "")
                    ptxas.append(name.replace("_ZN3moe", "")[:32])
                elif not ptxas:
                    continue
                elif "spill stores" in ln and not ln.strip().startswith(
                        "0 bytes stack frame, 0 bytes spill"):
                    ptxas[-1] += " SPILLS " + ln.strip()
                elif "registers" in ln:
                    ptxas[-1] += ": " + ln.split(":", 1)[1].strip()
            if lib.build_seconds is None:     # built by an earlier run
                log(f"build {lib.source}: already in {kernels.BUILD_DIR}")
                continue
            log(f"build {lib.source}: {lib.build_seconds:.2f} s, "
                f"{' '.join(lib.command[:4])} ...; ptxas: "
                + " | ".join(ptxas))
    log(f"build: all kernels in {time.perf_counter() - t0:.2f} s")


def expert_weights(torch, dtype, gen):
    """Stacked (L, E, d, h) / (L, E, h, d) weights, per-layer biases."""
    def u(*shape, scale):
        return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
                * scale).to(dtype)
    return {"w1": u(L, E, D, H, scale=0.5 * (6 / (D + H)) ** 0.5),
            "w2": u(L, E, H, D, scale=0.5 * (6 / (D + H)) ** 0.5),
            "b1": u(E, H, scale=0.1), "b2": u(E, D, scale=0.1)}


def routing(torch, kind, n, gen):
    """Gate indices (1, n): a random router over random catEmbed
    features (skewed but spread, as a real router), all tokens on one
    expert, half the experts empty, or the router result as is."""
    feats = torch.randn(n, 2 * D, generator=gen, device="cuda")
    router = torch.randn(2 * D, E, generator=gen, device="cuda") * 0.5
    logits = feats @ router
    if kind == "half_empty":
        logits[:, 1::2] = -1e30
    idx = logits.argmax(-1)
    if kind == "one_expert":
        idx = torch.full_like(idx, E - 1)
    return idx.to(torch.int32)[None]


def phase_kernel(torch, moe_runs):
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        p = expert_weights(torch, dtype, gen)
        worst = 0.0
        cases = [(n, kind) for n in TOKENS
                 for kind in ("router", "one_expert", "half_empty")]
        cases.append((5, "router"))                   # N < tile
        for n, kind in cases:
            for layer in (0, L - 1):
                x = torch.randn(1, n, D, generator=gen, device="cuda") \
                    .to(dtype)
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
                active = int((torch.bincount(gate.flatten().long(),
                                             minlength=E) > 0).sum())
                log(f"kernel moe_runs_f {str(dtype)[6:]} n={n} {kind} "
                    f"layer={layer} active={active}: max_abs_err={err:.3e}"
                    f" max|ref|={scale:.3e} {'OK' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit("FAIL kernel: moe_runs_f disagrees "
                                     "with its plain version")
                worst = max(worst, err)
        max_err[str(dtype)[6:]] = worst
    return max_err


def quant_experts(torch, bits, gen, n_layers, d=D, h=H):
    """Random quantized expert weights stacked (n_layers, E, ...): int8
    values, or random bytes (each byte holds two int4 values); float32
    scales (n_layers, E, [G,] 1, out) sized for outputs of order one,
    with 128-row groups for int4 where the contraction allows; bf16
    biases (E, out)."""
    rms = 73.3 if bits == 8 else 4.6       # rms of uniform int8 / int4

    def ints(*shape):
        return torch.randint(-127 if bits == 8 else -128, 128, shape,
                             generator=gen, device="cuda",
                             dtype=torch.int16).to(torch.int8)

    def scales(k, out):
        groups = k // 128 if bits == 4 and k % 128 == 0 and k > 128 else 1
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
    """K4, K5 and K6 against their plain versions; returns the worst
    max_abs_err of each (kernel, a8)."""
    from m3asr_tpu_torch.ops import moe_q4, moe_runs
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {}
    n_layers = 3

    def check(key, kern, plain, p, n, kind, layer, d=D):
        kname, a8 = key
        x = torch.randn(1, n, d, generator=gen, device="cuda") \
            .to(torch.bfloat16)
        gate = routing(torch, kind, n, gen)
        pl = at_layer(p, layer)
        got = kern.launch(pl, x, gate, layer, act_quant=a8)
        torch.cuda.synchronize()
        ref = plain(pl, x, gate, layer, act_quant=a8)
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        ok = err <= (2e-2 if a8 else 1e-2) * scale
        log(f"kernel {QUANT_NAMES[key]} ({kname}) d={d} n={n} {kind} "
            f"layer={layer} active={n_active(torch, gate)}: max_abs_err="
            f"{err:.3e} max|ref|={scale:.3e} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"FAIL kernel: {QUANT_NAMES[key]} disagrees "
                             "with its plain version")
        worst[key] = max(worst.get(key, 0.0), err)

    last = n_layers - 1
    for bits, kname in ((8, "K4"), (4, "K5")):
        p = quant_experts(torch, bits, gen, n_layers)
        kern = moe_runs.runs_q8_kernel if bits == 8 else \
            moe_runs.runs_q4_kernel
        for a8 in (False, True):
            for n in (63, 511):
                for kind in KINDS:
                    for layer in (0, last):
                        check((kname, a8), kern,
                              moe_runs.moe_experts_runs_reference, p, n,
                              kind, layer)
    for a8 in (False, True):
        for n in (63, 127):
            for kind in KINDS:
                for layer in (0, last):
                    check(("K6", a8), moe_q4.q4_kernel,
                          moe_q4.moe_experts_q4_reference, p, n, kind,
                          layer)
    # d=320: w2's packed columns hold columns j and j + 160, so the
    # column block [128, 192) takes low nibbles and high nibbles
    p = quant_experts(torch, 4, gen, 1, d=320, h=640)
    for a8 in (False, True):
        check(("K5", a8), moe_runs.runs_q4_kernel,
              moe_runs.moe_experts_runs_reference, p, 63, "router", 0, 320)
        check(("K6", a8), moe_q4.q4_kernel, moe_q4.moe_experts_q4_reference,
              p, 63, "router", 0, 320)
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
    from m3asr_tpu_torch.models import moe_conformer
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops.moe_runs import runs_kernel
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg = flagship_cfg()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = moe_conformer.init(cfg.encoder_conf, cfg.input_dim,
                                cfg.output_dim, gen, device="cuda")
    r = params["blocks"]["feed_forward"]["router"]
    r["kernel"] = torch.randn(r["kernel"].shape, generator=gen,
                              device="cuda") * 0.5
    rng = np.random.default_rng(2)
    reqs = [(rng.standard_normal((b, t, cfg.input_dim)).astype(np.float32),
             np.full((b,), t, np.int32)) for b, t in REQUESTS]
    engines = {}
    for dtype in ("float32", "bfloat16"):
        engines[dtype] = (
            Engine(cfg, params, EngineConfig(dtype=dtype), device="cuda"),
            Engine(cfg, params, EngineConfig(dtype=dtype, moe_impl="dense"),
                   device="cuda"))
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
        from m3asr_tpu_torch.ops import moe_q4, moe_runs
        inner = self.inner = self.moe_mod._dispatch

        def plain(p, x, gate_idx, impl):
            if impl == "runs_f" or impl.endswith("_runs"):
                return moe_runs.moe_experts_runs_reference(
                    p, x, gate_idx, act_quant="_a8" in impl)
            if impl in ("quant4_pallas", "quant4_a8"):
                return moe_q4.moe_experts_q4_reference(
                    p, x, gate_idx, act_quant=impl == "quant4_a8")
            return inner(p, x, gate_idx, impl)
        self.moe_mod._dispatch = plain
        return self

    def __exit__(self, *exc):
        self.moe_mod._dispatch = self.inner


def phase_serve_quant(torch, state, smi):
    """Serves the requests with the int8, w8a8, int4 and w4a8 engines;
    returns each mode's kernel launches on its run."""
    from m3asr_tpu_torch.ops import moe as moe_mod
    from m3asr_tpu_torch.ops import moe_q4, moe_runs
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

    wrappers = {"K1": moe_runs.runs_kernel, "K4": moe_runs.runs_q8_kernel,
                "K5": moe_runs.runs_q4_kernel, "K6": moe_q4.q4_kernel}
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
                         device="cuda")
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
        base = None                     # free this dtype's engines
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


def short_name(kernel):
    """A device event's name without return type, namespace or
    arguments, at most 60 characters."""
    name = kernel.replace("void ", "", 1)
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip()[:60]


def device_time(torch, eng, feat, lens):
    """One request under torch.profiler: the summed duration of the
    kernels and copies the card ran (one stream, so they do not overlap),
    in ms, and the five kernel names that took most of it."""
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
    return sum(by_name.values()) / 1e3, top


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
        dev_ms, top = device_time(torch, eng, feat, lens)
        if dev_ms == 0:
            log("device time: not measured (the profiler recorded no "
                "device activity)")
            continue
        log(f"device time {label} {feat.shape[0]}x{feat.shape[1]}: "
            f"{dev_ms:.3f} ms in one request under torch.profiler, "
            f"{dev_ms / np.median(times):.3f} of the median latency; "
            "top kernels: " + "; ".join(
                f"{short_name(name)} {us / 1e3:.3f} ms" for name, us in top)
            + f"; {smi}")


def time_quant_kernels(torch, smi):
    """K4 and K5 at the long requests' token counts (511, 1020) and K6 at
    the short one's (63), each weight-only and a8: the wrapper call, its
    CUDA launches alone, the plain version, and the bound. Weights are
    stacked over 6 layers and the layer rotates with each call, so a call
    finds its weights in device memory, not in the 50 MB L2, as the
    main path's layer loop does. Returns rows keyed by (kernel, a8, n)."""
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
        cases = [("K4" if bits == 8 else "K5", n) for n in (511, 1020)]
        if bits == 4:
            cases.append(("K6", 63))
        for kname, n in cases:
            for a8 in (False, True):
                x = torch.randn(1, n, D, generator=gen, device="cuda") \
                    .to(torch.bfloat16)
                gate = routing(torch, "router", n, gen)
                active = n_active(torch, gate)
                t_bytes = (active * per_expert + 2 * n * D * 2 + n * 4) \
                    / HBM_BYTES_PER_S * 1e3
                t_ops = 4 * n * D * H / PEAK_OPS_PER_S[
                    "int8" if a8 else "bfloat16"] * 1e3
                if kname == "K6":
                    kern, plain = moe_q4.q4_kernel, \
                        moe_q4.moe_experts_q4_reference
                    rows_n = n
                    x2, g2 = x.reshape(n, D), gate.reshape(n)
                else:
                    kern = moe_runs.runs_q8_kernel if bits == 8 else \
                        moe_runs.runs_q4_kernel
                    plain = moe_runs.moe_experts_runs_reference
                    lay = moe_runs.runs_layout(gate.reshape(n), E)
                    x2 = moe_runs._pad_tokens(x.reshape(n, D), lay,
                                              moe_runs.TILE)
                    rows_n = lay.n_tiles * moe_runs.TILE
                hid = torch.empty(rows_n, H, device="cuda",
                                  dtype=torch.float32 if a8
                                  else torch.bfloat16)
                xq = torch.empty(rows_n, D, dtype=torch.int8, device="cuda")
                hq = torch.empty(rows_n, H, dtype=torch.int8, device="cuda")
                xs = torch.empty(rows_n, device="cuda")
                hs = torch.empty(rows_n, device="cuda")
                y = torch.empty_like(x2)

                def raw(i):
                    j = i % n_layers
                    if kname == "K6":
                        err = lib_q.moe_q4_dense(
                            int(a8), x2.data_ptr(), g2.data_ptr(), n,
                            w1.data_ptr(), s1[j].data_ptr(), s1[j].shape[1],
                            b1.data_ptr(), w2.data_ptr(), s2[j].data_ptr(),
                            s2[j].shape[1], b2.data_ptr(), E, j, D, H,
                            hid.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                            hq.data_ptr(), hs.data_ptr(), y.data_ptr(),
                            stream)
                    else:
                        err = lib_r.moe_runs_q(
                            1 if bits == 8 else 2, int(a8), x2.data_ptr(),
                            w1.data_ptr(), s1[j].data_ptr(), s1[j].shape[1],
                            b1.data_ptr(), w2.data_ptr(), s2[j].data_ptr(),
                            s2[j].shape[1], b2.data_ptr(),
                            lay.tile_e.data_ptr(), lay.starts.data_ptr(),
                            lay.n_tiles, E, j, D, H, hid.data_ptr(),
                            xq.data_ptr(), xs.data_ptr(), hq.data_ptr(),
                            hs.data_ptr(), y.data_ptr(), stream)
                    if err:
                        raise SystemExit(f"FAIL times: launch error {err}")
                ms = cuda_time_ms(torch, lambda i: kern.launch(
                    layers[i % n_layers], x, gate, i % n_layers,
                    act_quant=a8), 60)
                alone = cuda_time_ms(torch, raw, 60)
                plain_ms = cuda_time_ms(torch, lambda i: plain(
                    layers[i % n_layers], x, gate, i % n_layers,
                    act_quant=a8), 6)
                bound = max(t_bytes, t_ops)
                rows[(kname, a8, n)] = dict(
                    ms=ms, alone=alone, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
                log(f"time {QUANT_NAMES[(kname, a8)]} ({kname}) n={n} "
                    f"active={active}: call {ms:.4f} ms (kernels alone "
                    f"{alone:.4f} ms), plain {plain_ms:.4f} ms, bound "
                    f"{bound:.4f} ms (bytes {t_bytes:.4f} / ops "
                    f"{t_ops:.4f}), library_ms none; {smi}")
    return rows


def phase_times(torch, state, smi):
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import moe_runs

    launches = state["launches"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        p = expert_weights(torch, dtype, gen)
        for n in (63, 511):
            x = torch.randn(1, n, D, generator=gen, device="cuda").to(dtype)
            gate = routing(torch, "router", n, gen)
            active = int((torch.bincount(gate.flatten().long(),
                                         minlength=E) > 0).sum())
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
            lib = kernels.MOE_RUNS.load()
            lay = moe_runs.runs_layout(gate.reshape(n), E)
            x_pad = moe_runs._pad_tokens(x.reshape(n, D), lay,
                                         moe_runs.TILE)
            hid = torch.empty(lay.n_tiles * moe_runs.TILE, H, dtype=dtype,
                              device="cuda")
            y_pad = torch.empty_like(x_pad)
            stream = torch.cuda.current_stream().cuda_stream
            w1 = p["w1"].reshape(L * E, D, H)
            w2 = p["w2"].reshape(L * E, H, D)

            def raw(i):
                if lib.moe_runs_f(
                        0 if dtype == torch.float32 else 1,
                        x_pad.data_ptr(), w1.data_ptr(), p["b1"].data_ptr(),
                        w2.data_ptr(), p["b2"].data_ptr(),
                        lay.tile_e.data_ptr(), lay.starts.data_ptr(),
                        lay.n_tiles, E, i % L, D, H, hid.data_ptr(),
                        y_pad.data_ptr(), stream):
                    raise SystemExit("FAIL times: launch error")
            kernel_only = cuda_time_ms(torch, raw, 54)
            bound = max(t_bytes, t_ops)
            rows[(dname, n)] = dict(
                ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            log(f"time moe_runs_f {dname} n={n} active={active}: "
                f"call {ms:.4f} ms (kernels alone {kernel_only:.4f} ms), "
                f"plain {plain:.4f} ms, bound {bound:.4f} ms "
                f"(bytes {t_bytes:.4f} / ops {t_ops:.4f}), "
                f"library_ms none; {smi}")

    for dtype, (eng, _) in state["engines"].items():
        request_times(torch, eng, dtype, state["requests"], smi)

    report = []
    for dname in ("float32", "bfloat16"):
        r = rows[(dname, 63)]
        report.append({
            "name": f"moe_runs_f[{dname}]", "route": "cuda",
            "source": "m3asr_tpu_torch/csrc/moe_runs.cu",
            "replaces": "m3asr_tpu/ops/pallas_moe_runs.py:350",
            "launches": launches[dname],
            "max_abs_err": state["max_err"][dname],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    qrows = time_quant_kernels(torch, smi)
    for (kname, a8), name in QUANT_NAMES.items():
        mode = MODES[("int4" if kname != "K4" else "int8", a8)]
        r = qrows[(kname, a8, 63 if kname == "K6" else 511)]
        report.append({
            "name": name, "route": "cuda",
            "source": "m3asr_tpu_torch/csrc/"
                      + ("moe_q4.cu" if kname == "K6" else "moe_runs.cu"),
            "replaces": "m3asr_tpu/ops/pallas_moe_q4.py:320"
                        if kname == "K6"
                        else "m3asr_tpu/ops/pallas_moe_runs.py:350",
            "launches": state["launches_q"][mode][kname],
            "max_abs_err": state["max_err_q"][(kname, a8)],
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
    state = {"max_err": phase_kernel(torch, moe_runs),
             "max_err_q": phase_kernel_quant(torch)}
    state["launches"] = phase_serve(torch, state)
    state["launches_q"] = phase_serve_quant(torch, state, smi)
    report = phase_times(torch, state, smi)
    log(smi)
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
