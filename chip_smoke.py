#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero with no
result line:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them.
2. build: every hand-written kernel, compiled by nvcc from csrc/ (one
   nvcc per source, all started together).
3. K1 against its plain PyTorch version at the flagship widths (E=32,
   d=512, h=1024, stacked L=18 at layers 0 and 17), fp32 and bf16, at
   63/127/511/1535 tokens (the 256/512/2048/6144-frame buckets) under
   four routings. fp32: allclose(rtol 1e-5, atol 1e-5); bf16: max|diff|
   within 1e-2 of max|ref|.
4. serve: the flagship hier MoE conformer (6 embed blocks, 18 MoE blocks,
   32 experts, vocabulary 5000; random weights from a seeded CUDA
   generator, routers randomised) in an fp32 and a bf16 Engine answers
   1x206, 4x1000 and 1x2048 frames. Each forward must launch K1 once
   per MoE block (18), and the logits must match the same engine with
   moe_impl="dense" on the valid region. fp32: allclose(1e-5, 1e-3).
   bf16 rounding sends tokens at router near-ties to other experts,
   differently in the two runs; those flips and the free-running
   max|diff| and argmax agreement are printed. The dense run is repeated
   with its tokens sent to the kernel run's experts and must meet
   max|diff| / max|ref| <= 0.05 on every valid frame (its per-frame
   argmax agreement is printed); against the fp32 logits the kernel
   path's mean distance must be
   within 1.5x the dense path's and its argmax agreement within three
   standard errors of the dense path's. Hypotheses are CTC-greedy
   decoded.
5. times: K1 per call (CUDA events over many calls after warm-up) at 63
   and 511 tokens beside its bound, the plain version's time, request
   latency (host clock around infer, which ends in a device-to-host
   copy), peak device memory, and the device time of one request under
   torch.profiler with the kernels that took most of it.

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
                  "bfloat16": 989e12}
E, D, H, L = 32, 512, 1024, 18
TOKENS = (63, 127, 511, 1535)
REQUESTS = ((1, 206), (4, 1000), (1, 2048))


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
            ptxas = [ln.strip() for ln in lib.log.splitlines()
                     if "registers" in ln or "spill" in ln]
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
    return per_dtype


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
        for feat, lens in state["requests"]:
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                eng.infer(feat, lens)          # ends in a D2H copy
                times.append((time.perf_counter() - t0) * 1e3)
            log(f"latency {dtype} {feat.shape[0]}x{feat.shape[1]}: median "
                f"{np.median(times):.3f} ms (min {min(times):.3f}, max "
                f"{max(times):.3f}, 5 runs), peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
                f"{smi}")
            dev_ms, top = device_time(torch, eng, feat, lens)
            if dev_ms == 0:
                log("device time: not measured (the profiler recorded no "
                    "device activity)")
                continue
            log(f"device time {dtype} {feat.shape[0]}x{feat.shape[1]}: "
                f"{dev_ms:.3f} ms in one request under torch.profiler, "
                f"{dev_ms / np.median(times):.3f} of the median latency; "
                "top kernels: " + "; ".join(
                    f"{short_name(name)} {us / 1e3:.3f} ms"
                    for name, us in top)
                + f"; {smi}")

    rep = {}
    for dname in ("float32", "bfloat16"):
        r = rows[(dname, 63)]
        rep[dname] = {
            "name": f"moe_runs_f[{dname}]", "route": "cuda",
            "source": "m3asr_tpu_torch/csrc/moe_runs.cu",
            "replaces": "m3asr_tpu/ops/pallas_moe_runs.py:350",
            "launches": launches[dname],
            "max_abs_err": state["max_err"][dname],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None}
    return [rep["float32"], rep["bfloat16"]]


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
    state = {"max_err": phase_kernel(torch, moe_runs)}
    state["launches"] = phase_serve(torch, state)
    report = phase_times(torch, state, smi)
    log(smi)
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
