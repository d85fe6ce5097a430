#!/usr/bin/env python3
"""Same-call comparisons on one NVIDIA GPU that chip_smoke.py does not
make: two checkouts, or variants of one kernel, timed in turns in one
call, so that the card and its host are the same for both.

    python3 chip_compare.py serve-quant ROOT LABEL
    python3 chip_compare.py serve-stream ROOT LABEL [WORD]
    python3 chip_compare.py flash ROOT LABEL
    python3 chip_compare.py stages N [N ...]
    python3 chip_compare.py libs PARENT_ROOT
    python3 chip_compare.py sass PARENT_ROOT

serve-quant: for the checkout at ROOT (its own chip_smoke.py and
m3asr_tpu_torch), the int8, w8a8, int4 and w4a8 engines on the flagship's
seeded weights answer chip_smoke.py's three requests; each request's
device time under torch.profiler is the median of 3 after 2 warm-up
requests (min-max beside it). Then that checkout's time_quant_kernels
(K4, K5 and K6 per call and alone). Lines start with "pair LABEL".

serve-stream: for the checkout at ROOT, the engines that reach K8, K6
and K7: fp32, bf16 and int8 with moe_impl="pallas" (K8) at 4x1000 and
1x2048, the int4 and w4a8 auto engines (K6) at 1x206, and the int4 and
w4a8 engines with moe_impl="tiled" (K7) at 4x1000 and 1x2048, on the
flagship's seeded weights. Each request's device time under
torch.profiler is the median of 3 after 2 warm-up requests (min-max
beside it), its latency the median of 5 (host clock), and its busy share
the one over the other. Then that checkout's time_stage_kernels (K8, K7)
and time_quant_kernels (K4-K6). With WORD, only the engines whose label
holds it (e.g. "tiled"), and no kernel times. Lines start with "pair
LABEL".

flash: the checkout's time_flash_kernels (K2/K3 per call, alone and
device time, beside scaled_dot_product_attention).

stages: K4/K5 with both cp.async rings (moe_runs.cu's Q_STAGES_W and
Q_STAGES_A8, weight-only and a8) at N stages, each built by nvcc from a
copy of csrc/ under _trees/ with ptxas's register and spill lines
printed, checked against the plain version (weight-only within 1e-2 of
max|ref|, a8 within 2e-2; d=512 at 511 tokens and d=320 at 63), then
timed by time_quant_kernels, in the order given.

libs: in one process, the parent's moe_runs.cu, moe_q4.cu, moe_q4_tiled.cu
and moe_stream.cu (built by nvcc from PARENT_ROOT's csrc/ under _trees/)
beside this checkout's, on the same inputs: K1, K4, K5, K6 and K8 must
give the same bits (the tiles they share with K7 took a clamp, a bias
type and K7's forms, all off for them), K7 a8 and float32 K7 too (exact
s32 sums; ascending-k FMAs on the same products), bf16 K7 within 1e-2 of
max|parent| (float32 sums in another order); and every kernel's
launches alone, parent and change in turns (parent, change, change,
parent), at the main path's token counts under the router's and (K6-K8)
the heavy routing, K7 with its clamp under the heavy routing.

sass: the parent's libraries (as libs builds them) and this checkout's,
each kernel instantiation's SASS (cuobjdump -sass, addresses and
comments stripped) compared by name: same, differs (with the counts of
instructions), or only on one side. Prints one line per library.

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
import time
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


# (label, EngineConfig settings, the requests it answers: indices of
# chip_smoke.REQUESTS)
STREAM_ENGINES = (
    ("float32 pallas", dict(dtype="float32", moe_impl="pallas"), (1, 2)),
    ("bfloat16 pallas", dict(dtype="bfloat16", moe_impl="pallas"), (1, 2)),
    ("int8 pallas", dict(dtype="int8", moe_impl="pallas"), (1, 2)),
    ("int4", dict(dtype="int4"), (0,)),
    ("w4a8", dict(dtype="int4", act_quant=True), (0,)),
    ("int4 tiled", dict(dtype="int4", moe_impl="tiled"), (1, 2)),
    ("w4a8 tiled", dict(dtype="int4", act_quant=True, moe_impl="tiled"),
     (1, 2)),
)


def serve_stream(torch, root, label, word=None):
    cs = import_checkout(root)
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig
    _, smi = cs.phase_device(torch)
    for lib in kernels.ALL:
        lib.load()
    cfg, params = cs.flagship_params(torch)
    rng = np.random.default_rng(2)
    reqs = [(rng.standard_normal((b, t, cfg.input_dim)).astype(np.float32),
             np.full((b,), t, np.int32)) for b, t in cs.REQUESTS]
    int4 = None             # the int4 experts, quantized once
    for name, settings, which in STREAM_ENGINES:
        if word is not None and word not in name:
            continue
        base = int4 if settings["dtype"] == "int4" else params
        eng = Engine(cfg, params if base is None else base,
                     EngineConfig(**settings), device="cuda")
        if settings["dtype"] == "int4" and int4 is None:
            int4 = eng.params
        for i in which:
            feat, lens = reqs[i]
            for _ in range(2):
                eng.infer(feat, lens)
            lat = []
            for _ in range(5):
                t0 = time.perf_counter()
                eng.infer(feat, lens)
                lat.append((time.perf_counter() - t0) * 1e3)
            dev = [cs.device_time(torch, eng, feat, lens) for _ in range(3)]
            ms = [d[0] for d in dev]
            _, top, kern = dev[int(np.argsort(ms)[1])]
            print(f"pair {label} {name} {feat.shape[0]}x{feat.shape[1]}: "
                  f"device {np.median(ms):.3f} ms ({min(ms):.3f}-"
                  f"{max(ms):.3f}), latency median {np.median(lat):.3f} ms "
                  f"({min(lat):.3f}-{max(lat):.3f}), busy "
                  f"{np.median(ms) / np.median(lat):.3f}; top kernels "
                  + ", ".join(f"{cs.short_name(k)} {us / 1e3:.3f} ms"
                              for k, us in top)
                  + "; expert kernels " + ", ".join(
                      f"{k} {v:.3f} ms" for k, v in sorted(kern.items()))
                  + f"; {smi}", flush=True)
        eng = None
        torch.cuda.empty_cache()
    int4 = params = None
    torch.cuda.empty_cache()
    if word is None:
        cs.time_stage_kernels(torch, smi)
        cs.time_quant_kernels(torch, smi)


def build_parent(kernels, root):
    """The parent's moe_runs.cu, moe_q4.cu, moe_q4_tiled.cu and
    moe_stream.cu, built by nvcc from root's csrc/ into
    _trees/libs_parent/ (all at once);
    returns {source: ctypes library}, declared with the C interfaces,
    which the parent shares."""
    out_dir = os.path.abspath(os.path.join("_trees", "libs_parent"))
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(os.path.join(os.path.abspath(root), "m3asr_tpu_torch",
                                 "csrc"), out_dir)
    sources = ("moe_runs.cu", "moe_q4.cu", "moe_q4_tiled.cu",
               "moe_stream.cu")

    def build(src):
        lib = os.path.join(out_dir, f"lib{src[:-3]}.so")
        r = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o",
                            lib, os.path.join(out_dir, src)],
                           capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(r.stdout + r.stderr)
        return lib
    with ThreadPoolExecutor(len(sources)) as ex:
        paths = dict(zip(sources, ex.map(build, sources)))
    libs = {src: ctypes.CDLL(path) for src, path in paths.items()}
    for lib in (kernels.MOE_RUNS, kernels.MOE_Q4, kernels.MOE_Q4_TILED,
                kernels.MOE_STREAM):
        lib._declare(libs[lib.source])
    return libs


def in_turns(cs, torch, fa, fb, iters=60):
    """Launches alone of fa (parent) and fb (change), timed in turns
    parent, change, change, parent: (parent's two, change's two) in ms."""
    a, b = [], []
    for f, dst in ((fa, a), (fb, b), (fb, b), (fa, a)):
        dst.append(cs.cuda_time_ms(torch, f, iters))
    return a, b


def libs(torch, parent_root):
    cs = import_checkout(".")
    from m3asr_tpu_torch import kernels
    from m3asr_tpu_torch.ops import moe_q4, moe_runs
    _, smi = cs.phase_device(torch)
    old = build_parent(kernels, parent_root)
    new = {lib.source: lib.load() for lib in
           (kernels.MOE_RUNS, kernels.MOE_Q4, kernels.MOE_Q4_TILED,
            kernels.MOE_STREAM)}
    gen = torch.Generator(device="cuda").manual_seed(13)
    stream = torch.cuda.current_stream().cuda_stream
    E, D, H = cs.E, cs.D, cs.H
    n_layers = 6

    def report(label, out_old, out_new, a, b, exact):
        diff = (out_old.float() - out_new.float()).abs().max().item()
        scale = out_old.float().abs().max().item()
        same = torch.equal(out_old, out_new)
        ok = same if exact else diff <= 1e-2 * scale
        print(f"libs {label}: parent alone {a[0]:.4f}/{a[1]:.4f} ms, change "
              f"{b[0]:.4f}/{b[1]:.4f} ms (parent/change "
              f"{sum(a) / sum(b):.3f}x); outputs "
              + ("bit-identical" if same else
                 f"max|diff| {diff:.3e} of max|parent| {scale:.3e}")
              + f" ({'held' if ok else 'FAIL'}: "
              f"{'bits' if exact else '1e-2'}); {smi}", flush=True)
        if not ok:
            raise SystemExit(f"FAIL libs {label}")

    # K1, K4, K5: the run-length layout, router routing
    for what in ("float32", "bfloat16", "int8", "int4"):
        if what in ("float32", "bfloat16"):
            dt = getattr(torch, what)
            p = cs.expert_weights(torch, dt, gen, n_layers=n_layers)
            modes = (None,)
        else:
            dt = torch.bfloat16
            bits = 8 if what == "int8" else 4
            p = cs.quant_experts(torch, bits, gen, n_layers)
            modes = (False, True)
        for n in (63, 511, 1020):
            x = torch.randn(1, n, D, generator=gen, device="cuda").to(dt)
            gate = cs.routing(torch, "router", n, gen)
            lay = moe_runs.runs_layout(gate.reshape(n), E)
            x_pad = moe_runs._pad_tokens(x.reshape(n, D), lay,
                                         moe_runs.TILE)
            rows = lay.n_tiles * moe_runs.TILE
            for a8 in modes:
                hdt = torch.float32 if a8 else dt
                scratch = [torch.empty(rows, H, device="cuda", dtype=hdt),
                           torch.empty(rows, D, dtype=torch.int8,
                                       device="cuda"),
                           torch.empty(rows, device="cuda"),
                           torch.empty(rows, H, dtype=torch.int8,
                                       device="cuda"),
                           torch.empty(rows, device="cuda")]
                ys = {k: torch.empty_like(x_pad) for k in ("old", "new")}

                def run(lib, y, i):
                    j = i % n_layers
                    if a8 is None:
                        w1 = p["w1"].reshape(n_layers * E, D, H)
                        w2 = p["w2"].reshape(n_layers * E, H, D)
                        err = lib.moe_runs_f(
                            0 if dt == torch.float32 else 1,
                            x_pad.data_ptr(), w1.data_ptr(),
                            p["b1"].data_ptr(), w2.data_ptr(),
                            p["b2"].data_ptr(), lay.tile_e.data_ptr(),
                            lay.starts.data_ptr(), lay.counts.data_ptr(),
                            lay.n_tiles, E, j, D, H, scratch[0].data_ptr(),
                            y.data_ptr(), stream)
                    else:
                        k1, k2 = ("w1_q4", "w2_q4") if bits == 4 else \
                            ("w1_q", "w2_q")
                        s1 = p["w1_scale"][j].reshape(E, -1, H)
                        s2 = p["w2_scale"][j].reshape(E, -1, D)
                        err = lib.moe_runs_q(
                            1 if bits == 8 else 2, int(a8), x_pad.data_ptr(),
                            p[k1].data_ptr(), s1.data_ptr(), s1.shape[1],
                            p["b1"].data_ptr(), p[k2].data_ptr(),
                            s2.data_ptr(), s2.shape[1], p["b2"].data_ptr(),
                            lay.tile_e.data_ptr(), lay.starts.data_ptr(),
                            lay.n_tiles, E, j, D, H,
                            *(t.data_ptr() for t in scratch),
                            y.data_ptr(), stream)
                    if err:
                        raise SystemExit(f"FAIL libs: launch error {err}")
                a, b = in_turns(
                    cs, torch,
                    lambda i: run(old["moe_runs.cu"], ys["old"], i),
                    lambda i: run(new["moe_runs.cu"], ys["new"], i))
                run(old["moe_runs.cu"], ys["old"], 0)
                run(new["moe_runs.cu"], ys["new"], 0)
                torch.cuda.synchronize()
                name = f"K1 {what}" if a8 is None else \
                    f"{'K4' if what == 'int8' else 'K5'} {what}" + \
                    (" a8" if a8 else "")
                report(f"{name} n={n} router",
                       moe_runs._unpad(ys["old"], lay),
                       moe_runs._unpad(ys["new"], lay), a, b, True)
        p = None
        torch.cuda.empty_cache()

    # K6: int4 weight-only and w4a8 at 63 and 127 tokens
    p = cs.quant_experts(torch, 4, gen, n_layers)
    for n in (63, 127):
        for kind in cs.TIME_KINDS:
            x = torch.randn(1, n, D, generator=gen, device="cuda") \
                .to(torch.bfloat16)
            gate = cs.routing(torch, kind, n, gen).reshape(n)
            front = torch.empty(new["moe_q4.cu"].moe_q4_front_ints(n, E),
                                dtype=torch.int32, device="cuda")
            for a8 in (False, True):
                scratch = [torch.empty(n, H, device="cuda", dtype=(
                               torch.float32 if a8 else torch.bfloat16)),
                           torch.empty(n, D, dtype=torch.int8, device="cuda"),
                           torch.empty(n, device="cuda"),
                           torch.empty(n, H, dtype=torch.int8, device="cuda"),
                           torch.empty(n, device="cuda")]
                ys = {k: torch.empty(n, D, dtype=torch.bfloat16,
                                     device="cuda") for k in ("old", "new")}

                def run(key, i):
                    j = i % n_layers
                    s1 = p["w1_scale"][j].reshape(E, -1, H)
                    s2 = p["w2_scale"][j].reshape(E, -1, D)
                    lib = (old if key == "old" else new)["moe_q4.cu"]
                    if lib.moe_q4_dense(
                            int(a8), x.data_ptr(), gate.data_ptr(), n,
                            p["w1_q4"].data_ptr(), s1.data_ptr(),
                            s1.shape[1], p["b1"].data_ptr(),
                            p["w2_q4"].data_ptr(), s2.data_ptr(),
                            s2.shape[1], p["b2"].data_ptr(), E, j, D, H,
                            front.data_ptr(),
                            *(t.data_ptr() for t in scratch),
                            ys[key].data_ptr(), stream):
                        raise SystemExit("FAIL libs: moe_q4_dense launch "
                                         "error")
                a, b = in_turns(cs, torch, lambda i: run("old", i),
                                lambda i: run("new", i))
                run("old", 0)
                run("new", 0)
                torch.cuda.synchronize()
                report(f"K6 {'w4a8' if a8 else 'int4'} n={n} {kind}",
                       ys["old"], ys["new"], a, b, True)
    p = None
    torch.cuda.empty_cache()

    # K8: fp32, bf16 and int8 weights at 63, 511 and 1020 tokens
    for wtype in cs.STREAM_NAMES:
        quant = wtype == "int8"
        xdt = torch.float32 if wtype == "float32" else torch.bfloat16
        layers = cs.stream_layers(torch, wtype, gen, n_layers)
        args = []
        for q in layers:
            w1, w2 = (q["w1_q"], q["w2_q"]) if quant else (q["w1"], q["w2"])
            args.append((w1.data_ptr(),
                         q["w1_scale"].reshape(E, H).data_ptr() if quant
                         else None, q["b1"].float(), w2.data_ptr(),
                         q["w2_scale"].reshape(E, D).data_ptr() if quant
                         else None, q["b2"].float()))
        for n in cs.STAGE_TOKENS:
            for kind in cs.TIME_KINDS:
                x = torch.randn(n, D, generator=gen, device="cuda").to(xdt)
                gate = cs.routing(torch, kind, n, gen).reshape(n)
                front = torch.empty(
                    new["moe_stream.cu"].moe_stream_front_ints(n, E),
                    dtype=torch.int32, device="cuda")
                hid = torch.empty(n, H, dtype=xdt, device="cuda")
                ys = {k: torch.empty_like(x) for k in ("old", "new")}

                def run(key, i):
                    w1, s1, b1, w2, s2, b2 = args[i % n_layers]
                    lib = (old if key == "old" else new)["moe_stream.cu"]
                    if lib.moe_stream(
                            0 if xdt == torch.float32 else 1, int(quant),
                            x.data_ptr(), gate.data_ptr(), n, w1, s1,
                            b1.data_ptr(), w2, s2, b2.data_ptr(), E, D, H,
                            front.data_ptr(), hid.data_ptr(),
                            ys[key].data_ptr(), stream):
                        raise SystemExit("FAIL libs: moe_stream launch "
                                         "error")
                a, b = in_turns(cs, torch, lambda i: run("old", i),
                                lambda i: run("new", i))
                run("old", 0)
                run("new", 0)
                torch.cuda.synchronize()
                report(f"K8 {wtype} n={n} {kind}", ys["old"], ys["new"], a,
                       b, True)
        layers = args = None
        torch.cuda.empty_cache()

    # K7: bf16 and float32 weight-only, w4a8, at 63, 511 and 1020 tokens
    # (tiles of 64, 64, 128 rows); the clamp under the heavy routing
    p = cs.quant_experts(torch, 4, gen, n_layers)
    b1, b2 = p["b1"].float(), p["b2"].float()
    for n in cs.STAGE_TOKENS:
        tile = moe_q4.tiled_tile(n)
        for kind in cs.TIME_KINDS:
            gate = cs.routing(torch, kind, n, gen).reshape(n)
            lay = moe_runs.runs_layout(gate, E, tile)
            rows = lay.n_tiles * tile
            clamp = int(kind == "heavy")
            for a8, xdt in ((False, torch.bfloat16), (True, torch.bfloat16),
                            (False, torch.float32)):
                x = torch.randn(n, D, generator=gen, device="cuda").to(xdt)
                x_pad = moe_runs._pad_tokens(x, lay, tile)
                scratch = [torch.empty(rows, H, device="cuda", dtype=(
                               torch.float32 if a8 else xdt)),
                           torch.empty(rows, D, dtype=torch.int8,
                                       device="cuda"),
                           torch.empty(rows, device="cuda"),
                           torch.empty(rows, H, dtype=torch.int8,
                                       device="cuda"),
                           torch.empty(rows, device="cuda")]
                ys = {k: torch.empty_like(x_pad) for k in ("old", "new")}

                def run(key, i):
                    j = i % n_layers
                    s1 = p["w1_scale"][j].reshape(E, -1, H)
                    s2 = p["w2_scale"][j].reshape(E, -1, D)
                    lib = (old if key == "old" else new)["moe_q4_tiled.cu"]
                    if lib.moe_q4_tiled(
                            0 if xdt == torch.float32 else 1, int(a8),
                            x_pad.data_ptr(), p["w1_q4"].data_ptr(),
                            s1.data_ptr(), s1.shape[1], b1.data_ptr(),
                            p["w2_q4"].data_ptr(), s2.data_ptr(),
                            s2.shape[1], b2.data_ptr(),
                            lay.tile_e.data_ptr(), lay.starts.data_ptr(),
                            lay.counts.data_ptr(), tile, lay.n_tiles, E, j,
                            D, H, clamp, 0.5,
                            *(t.data_ptr() for t in scratch),
                            ys[key].data_ptr(), stream):
                        raise SystemExit("FAIL libs: moe_q4_tiled launch "
                                         "error")
                a, b = in_turns(cs, torch, lambda i: run("old", i),
                                lambda i: run("new", i))
                run("old", 0)
                run("new", 0)
                torch.cuda.synchronize()
                what = "w4a8" if a8 else f"int4 {str(xdt)[6:]}"
                report(f"K7 {what} n={n} tile={tile} {kind}"
                       + (" upper_bound=0.5" if clamp else ""),
                       moe_runs._unpad(ys["old"], lay),
                       moe_runs._unpad(ys["new"], lay), a, b,
                       a8 or xdt == torch.float32)
    p = None
    torch.cuda.empty_cache()


def sass_functions(kernels, path):
    """{kernel name: its SASS instructions} of one built library."""
    out = subprocess.run([os.path.join(os.path.dirname(kernels.find_nvcc()),
                                       "cuobjdump"), "-sass", path],
                         capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            funcs[name] = []
        elif name and "/*" in ln and ";" in ln:
            funcs[name].append(ln.split("*/", 1)[1].split(";")[0].strip())
    return funcs


def sass(torch, parent_root):
    cs = import_checkout(".")
    from m3asr_tpu_torch import kernels
    build_parent(kernels, parent_root)

    def by_name(funcs):
        # anonymous-namespace kernels carry a per-build hash when mangled
        names = cs.demangle(list(funcs))
        return {n.replace("void ", "", 1).replace(
            "(anonymous namespace)::", "").split("(")[0].strip(): v
            for n, v in zip(names, funcs.values())}

    def names(ks):
        return ", ".join(sorted(ks))
    for lib in (kernels.MOE_RUNS, kernels.MOE_Q4, kernels.MOE_Q4_TILED,
                kernels.MOE_STREAM):
        old = by_name(sass_functions(kernels, os.path.join(
            "_trees", "libs_parent", f"lib{lib.source[:-3]}.so")))
        new = by_name(sass_functions(kernels, lib.build()))
        same = sorted(k for k in old if new.get(k) == old[k])
        diff = sorted(k for k in old if k in new and new[k] != old[k])
        print(f"sass {lib.source}: {len(same)} kernels the same as the "
              f"parent's ({names(same)}); differ: " + (", ".join(
                  f"{k} ({len(old[k])} -> {len(new[k])} instructions)"
                  for k in diff) or "none")
              + "; only the parent's: " + (names(set(old) - set(new))
                                           or "none")
              + "; only this checkout's: " + (names(set(new) - set(old))
                                              or "none"), flush=True)


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
    elif mode == "serve-stream":
        serve_stream(torch, *args)
    elif mode == "libs":
        libs(torch, *args)
    elif mode == "sass":
        sass(torch, *args)
    else:
        raise SystemExit(f"unknown mode {mode!r}: serve-quant, "
                         "serve-stream, flash, stages, libs, sass")
    return 0


if __name__ == "__main__":
    sys.exit(main())
