#!/usr/bin/env python3
"""Same-call comparisons on one NVIDIA GPU that chip_smoke.py does not
make: two checkouts, or variants of one kernel, timed in turns in one
call, so that the card and its host are the same for both.

    python3 chip_compare.py serve-quant ROOT LABEL
    python3 chip_compare.py flash ROOT LABEL
    python3 chip_compare.py stages N [N ...]

serve-quant: for the checkout at ROOT (its own chip_smoke.py and
m3asr_tpu_torch), the int8, w8a8, int4 and w4a8 engines on the flagship's
seeded weights answer chip_smoke.py's three requests; each request's
device time under torch.profiler is the median of 3 after 2 warm-up
requests (min-max beside it). Then that checkout's time_quant_kernels
(K4, K5 and K6 per call and alone). Lines start with "pair LABEL".

flash: the checkout's time_flash_kernels (K2/K3 per call, alone and
device time, beside scaled_dot_product_attention).

stages: K4/K5 with both cp.async rings (moe_runs.cu's Q_STAGES_W and
Q_STAGES_A8, weight-only and a8) at N stages, each built by nvcc from a
copy of csrc/ under _trees/ with ptxas's register and spill lines
printed, checked against the plain version (weight-only within 1e-2 of
max|ref|, a8 within 2e-2; d=512 at 511 tokens and d=320 at 63), then
timed by time_quant_kernels, in the order given.

To compare a parent commit with the working tree, unpack it into a
git-ignored directory and run both in turns, for example:

    git archive PARENT | tar -x -C _trees/parent
    for x in parent change change parent; do
      d=.; [ $x = parent ] && d=_trees/parent
      python3 chip_compare.py serve-quant $d $x
    done
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def import_checkout(root):
    """chip_smoke of the checkout at root, with its m3asr_tpu_torch."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    if cs.HERE != root:
        raise SystemExit(f"FAIL: imported chip_smoke from {cs.HERE}, "
                         f"not {root}")
    return cs


def serve_quant(torch, root, label):
    cs = import_checkout(root)
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig
    _, smi = cs.phase_device(torch)
    kernels.MOE_RUNS.load()
    kernels.MOE_Q4.load()
    cfg, params = cs.flagship_params(torch)
    rng = np.random.default_rng(2)
    reqs = [(rng.standard_normal((b, t, cfg.input_dim)).astype(np.float32),
             np.full((b,), t, np.int32)) for b, t in cs.REQUESTS]
    for dtype in ("int8", "int4"):
        base = None
        for act_quant in (False, True):
            eng = Engine(cfg, params if base is None else base.params,
                         EngineConfig(dtype=dtype, act_quant=act_quant),
                         device="cuda")
            base = base or eng
            for feat, lens in reqs:
                for _ in range(2):
                    eng.infer(feat, lens)
                ms = [cs.device_time(torch, eng, feat, lens)[0]
                      for _ in range(3)]
                print(f"pair {label} {cs.MODES[(dtype, act_quant)]} "
                      f"{feat.shape[0]}x{feat.shape[1]}: device "
                      f"{np.median(ms):.3f} ms ({min(ms):.3f}-"
                      f"{max(ms):.3f}); {smi}", flush=True)
            eng = None
        base = None
        torch.cuda.empty_cache()
    cs.time_quant_kernels(torch, smi)


def flash(torch, root, label):
    cs = import_checkout(root)
    from m3asr_tpu_torch import kernels
    _, smi = cs.phase_device(torch)
    print(f"pair {label}: flash library {kernels.FLASH.build()}",
          flush=True)
    cs.time_flash_kernels(torch, smi)


def build_stages(kernels, stages):
    """moe_runs.cu with both rings at `stages`, built into
    _trees/stages<N>/; returns (library path, ptxas register and spill
    lines)."""
    out_dir = os.path.abspath(os.path.join("_trees", f"stages{stages}"))
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(kernels.CSRC, out_dir)
    src = os.path.join(out_dir, "moe_runs.cu")
    with open(src) as f:
        text, n = re.subn(r"Q_STAGES_W = \d+, Q_STAGES_A8 = \d+",
                          f"Q_STAGES_W = {stages}, Q_STAGES_A8 = {stages}",
                          f.read())
    if n != 1:
        raise SystemExit(f"FAIL: {n} ring-depth definitions in moe_runs.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, "libmoe_runs.so")
    r = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", lib,
                        src], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    return lib, [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                 if "registers" in ln or "spill" in ln]


def stages(torch, counts):
    cs = import_checkout(".")
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import moe_runs
    _, smi = cs.phase_device(torch)
    with ThreadPoolExecutor(len(set(counts))) as ex:
        built = dict(zip(sorted(set(counts)), ex.map(
            lambda n: build_stages(kernels, n), sorted(set(counts)))))
    libs = {}
    for n, (path, regs) in built.items():
        lib = ctypes.CDLL(path)
        kernels.MOE_RUNS._declare(lib)
        libs[n] = lib
        print(f"variant stages={n}: ptxas " + " | ".join(regs), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for n in counts:
        kernels.MOE_RUNS._lib = libs[n]      # the wrappers load this one
        for bits in (8, 4):
            kern = moe_runs.runs_q8_kernel if bits == 8 else \
                moe_runs.runs_q4_kernel
            for d, h, tokens in ((cs.D, cs.H, 511), (320, 640, 63)):
                p = cs.at_layer(cs.quant_experts(torch, bits, gen, 1, d=d,
                                                 h=h), 0)
                for a8 in (False, True):
                    x = torch.randn(1, tokens, d, generator=gen,
                                    device="cuda").to(torch.bfloat16)
                    gate = cs.routing(torch, "router", tokens, gen)
                    got = kern.launch(p, x, gate, 0, act_quant=a8)
                    ref = moe_runs.moe_experts_runs_reference(
                        p, x, gate, 0, act_quant=a8)
                    err = (got.float() - ref.float()).abs().max().item()
                    tol = (2e-2 if a8 else 1e-2) * \
                        ref.float().abs().max().item()
                    if not err <= tol:
                        raise SystemExit(f"FAIL stages={n} bits={bits} "
                                         f"a8={a8}: {err:.3e} > {tol:.3e}")
        print(f"variant stages={n}: checks OK", flush=True)
        cs.time_quant_kernels(torch, smi)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL device: torch.cuda.is_available() is false")
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "serve-quant":
        serve_quant(torch, *args)
    elif mode == "flash":
        flash(torch, *args)
    elif mode == "stages":
        stages(torch, [int(a) for a in args])
    else:
        raise SystemExit(f"unknown mode {mode!r}: serve-quant, flash, "
                         "stages")
    return 0


if __name__ == "__main__":
    sys.exit(main())
