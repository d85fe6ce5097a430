"""ep/tp-sharded serving of the PyTorch port on gloo ranks against the
JAX package's sharded engines, on the CPU.

The fixture of tests/test_engine_ep.py (a hier MoE conformer: d=32, 4
heads, 2 MoE blocks of 8 experts, hidden 48, V=9) and an ExMarc model of
the same widths go, as the JAX package's parameter trees, to two worlds
of ranks started at once (2 and 4 processes of
tests/torch_dist_worker.py, a ``file://`` store under tmp_path, one
thread a rank). Each rank builds the port's Engine with the case's
``ep``/``tp`` (its shard of the tree, the forward's all-reduces) and
writes its outputs; the cases are then held one by one to JAX's
``Engine`` with the same settings on the 8 virtual CPU devices. Every
rank's output must equal rank 0's bit for bit. Tolerances (as
tests/test_engine_ep.py): fp32 allclose(rtol 1e-5, atol 1e-3) on the
valid region; bf16 and the quantized modes max|diff| within 0.05 of
max|ref|.

Sharded export: while the worlds start, one process
(``torch_dist_worker.py --build``) runs ``build --export`` with ``--ep 2
--attn_impl flash``, ``--tp 2``, ``--tp 2 --int4`` and ``--ep 2 --tp 2``
(every rank's program, traced in that process) and makes a dir whose
programs are another rank's and another mesh shape's. Each rank then
loads the dir (its own program) and its eager twin (the same dir
without ``exported/``): the two answer bit for bit, every rank runs its
loaded program, a program built for another rank or mesh shape is
refused with a warning, and rank 0 is held to the JAX engine's exported
sharded dir (saved and loaded on the 8 virtual CPU devices) by the same
tolerances.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from golden import torch_ref as G
from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.models import moe_conformer as j_model
from m3asr_tpu.models.registry import get_family
from m3asr_tpu.ops import moe as j_moe
from m3asr_tpu.runtime.engine import Engine as JEngine
from m3asr_tpu.runtime.engine import EngineConfig as JEngineConfig

from m3asr_tpu_torch import build as t_build
from m3asr_tpu_torch.checkpoint import flatten_tree
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.runtime.engine import LAYOUT_FILE, Engine, EngineConfig

from test_op_parity import allclose

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dist_worker.py")
JOIN_S = 300                 # a world's whole run
BUCKET = dict(bucket_lengths=(48,), bucket_batches=(2,))
QUANT_TOL = 0.05             # of max|ref|: bf16 and quantized modes


def hier_raw(proto="conformer_fmoe_localComm_catEmbed_domain_acc_hier"):
    return {"nnet_proto": proto, "input_dim": 16, "output_dim": 9,
            "model_conf": {"encoder_conf": {
                "attention_dim": 32, "attention_heads": 4, "num_blocks": 2,
                "embed_conf": {"attention_dim": 24, "attention_heads": 4,
                               "linear_units": 32, "num_blocks": 1},
                "moe_conf": {"num_experts": 8, "hidden_units": 48}}}}


def golden_model():
    """tests/test_engine_ep.py's golden twin."""
    torch.manual_seed(55)
    embed_conf = dict(attention_dim=24, attention_heads=4,
                      linear_units=32, num_blocks=1)
    return G.randomize_(G.HierMoEConformer(
        16, 9, attention_dim=32, attention_heads=4, num_blocks=2,
        num_experts=8, moe_hidden=48, embed_conf=embed_conf), seed=56)


def exmarc_params(cfg, seed=7):
    """The ExMarc model's numpy tree, every float leaf redrawn from a
    numpy seed (routers normal x 0.5, so tokens spread)."""
    tree = jax.tree.map(np.asarray, j_model.init(
        jax.random.PRNGKey(seed), cfg.encoder_conf, 16, 9))
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name.endswith("pe"):
            return a
        v = rng.standard_normal(a.shape) * (0.5 if "router" in name else 0.1)
        return (v + 1.0 if name.endswith("scale") else v).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, tree)


def case(name, settings, model="hier", kind="infer"):
    return {"name": name, "kind": kind, "model": model,
            "settings": settings}


def exported(name, settings):
    return dict(case(name, settings, kind="exported"), dir=name)


# the port's build --export (one process) of each exported case's dir
EXPORT_FLAGS = {"x_ep2flash": ["--ep", "2", "--attn_impl", "flash"],
                "x_tp2": ["--tp", "2"],
                "x_tp2_int4": ["--tp", "2", "--int4"],
                "x_ep2tp2": ["--ep", "2", "--tp", "2"]}
# x_tp2 with rank 0's program replaced by rank 1's and rank 1's by the
# ep2 x tp2 dir's rank 1
WRONG = {"name": "x_wrong", "from": "x_tp2", "files": {
    "2x48.cpu.r0of1x2.pt2": "x_tp2/exported/2x48.cpu.r1of1x2.pt2",
    "2x48.cpu.r1of1x2.pt2": "x_ep2tp2/exported/2x48.cpu.r1of2x2.pt2"}}


# world size -> the cases its ranks run
CASES = {
    2: [case("ep2", {"ep": 2}),
        case("tp2", {"tp": 2}),
        case("tp2_flash", {"tp": 2, "attn_impl": "flash"}),
        case("tp2_int4", {"tp": 2, "dtype": "int4"}),
        case("tp2_exmarc_int8", {"tp": 2, "dtype": "int8"}, "exmarc"),
        case("ep2_roundtrip", {"ep": 2}, kind="roundtrip"),
        {"name": "ffn_ragged", "kind": "ffn", "impl": "ragged"},
        {"name": "ffn_tiled", "kind": "ffn", "impl": "tiled"},
        {"name": "cli_ep2", "kind": "cli", "engine": "built_ep2",
         "ref": "ref1.npy"},
        exported("x_ep2flash", {"ep": 2, "attn_impl": "flash"}),
        exported("x_tp2", {"tp": 2}),
        exported("x_tp2_int4", {"tp": 2, "dtype": "int4"}),
        exported("x_wrong", {"tp": 2})],
    4: [case("ep4", {"ep": 4}),
        case("ep4_bf16", {"ep": 4, "dtype": "bfloat16"}),
        case("ep4_flash", {"ep": 4, "attn_impl": "flash"}),
        case("ep4_int8", {"ep": 4, "dtype": "int8"}),
        case("ep4_w8a8", {"ep": 4, "dtype": "int8", "act_quant": True}),
        case("ep4_int4", {"ep": 4, "dtype": "int4"}),
        case("tp4", {"tp": 4}),
        case("ep2tp2", {"ep": 2, "tp": 2}),
        case("ep2tp2_int8", {"ep": 2, "tp": 2, "dtype": "int8"}),
        case("ep2tp2_w8a8", {"ep": 2, "tp": 2, "dtype": "int8",
                             "act_quant": True}),
        case("ep2tp2_exmarc", {"ep": 2, "tp": 2}, "exmarc"),
        case("ep2tp2_int4_roundtrip", {"ep": 2, "tp": 2, "dtype": "int4"},
             kind="roundtrip"),
        exported("x_ep2tp2", {"ep": 2, "tp": 2})],
}
ENGINE_CASES = [c for n in CASES for c in CASES[n]
                if c["kind"] in ("infer", "roundtrip")]
ALL_CASES = [c for n in CASES for c in CASES[n]]
ROUNDTRIPS = [c for c in ENGINE_CASES if c["kind"] == "roundtrip"]
EXPORTED = [c for c in ALL_CASES if c["kind"] == "exported"]


def _inputs(rng):
    return (rng.standard_normal((2, 41, 16)).astype(np.float32),
            np.array([41, 27], np.int32))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' outputs and metadata, and the JAX references."""
    work = str(tmp_path_factory.mktemp("ranks"))
    m = golden_model()
    torch.save({f"encoder.{k}": v for k, v in m.state_dict().items()},
               os.path.join(work, "ckpt.pt"))
    models = {}
    for name, raw in (("hier", hier_raw()),
                      ("exmarc", hier_raw(
                          "conformer_fmoeExMarc_localComm_catEmbed"))):
        cfg = j_config(raw)
        params = (get_family(cfg.nnet_proto).convert(
            {k: v.numpy() for k, v in m.state_dict().items()}, cfg)
            if name == "hier" else exmarc_params(cfg))
        params = jax.tree.map(np.asarray, params)
        models[name] = (cfg, params)
        with open(os.path.join(work, f"{name}.yaml"), "w") as f:
            yaml.safe_dump(raw, f)
        np.savez(os.path.join(work, f"{name}.npz"), **flatten_tree(params))
    feat, lens = _inputs(np.random.default_rng(61))
    np.save(os.path.join(work, "feat.npy"), feat)
    np.save(os.path.join(work, "lens.npy"), lens)
    np.save(os.path.join(work, "feat1.npy"), feat[0, :33])
    # the expert-parallel FFN's layer: the first MoE block's experts
    ff = models["hier"][1]["blocks"]["feed_forward"]
    rng = np.random.default_rng(62)
    ffn = {k: ff[k][0] for k in ("w1", "b1", "w2", "b2")}
    ffn["router"] = rng.standard_normal(
        ff["router"]["kernel"][0].shape).astype(np.float32)
    ffn["x"] = rng.standard_normal((2, 11, 32)).astype(np.float32)
    ffn["embed"] = rng.standard_normal((2, 11, 24)).astype(np.float32)
    ffn["lengths"] = np.array([11, 7], np.int32)
    np.savez(os.path.join(work, "ffn.npz"), **ffn)
    # build --ep 2 (one process), and the unsharded engine's output
    args = ["-c", os.path.join(work, "hier.yaml"), "-m",
            os.path.join(work, "ckpt.pt"), "--buckets", "1x48", "--device",
            "cpu"]
    t_build.main(args + ["-o", os.path.join(work, "built_ep2"),
                         "--ep", "2"])
    t_build.main(args + ["-o", os.path.join(work, "built")])
    ref1, _ = Engine.load(os.path.join(work, "built"), device="cpu").infer(
        feat[:1, :33], np.array([33]))
    np.save(os.path.join(work, "ref1.npy"), ref1)
    # build --export of the exported cases' dirs, while the worlds run
    with open(os.path.join(work, "builds.json"), "w") as f:
        json.dump({"args": args[:4] + ["--buckets", "2x48", "--device",
                                       "cpu", "--export"],
                   "builds": [{"name": n, "flags": fl}
                              for n, fl in EXPORT_FLAGS.items()],
                   "mixes": [WRONG]}, f)
    procs = [(0, "build", subprocess.Popen(
        [sys.executable, WORKER, "--build", work],
        env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))]
    for n, cases in CASES.items():
        with open(os.path.join(work, f"cases_{n}.json"), "w") as f:
            json.dump(cases, f)
        for r in range(n):
            env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(r),
                       COORDINATOR_ADDRESS=f"file://{work}/store_{n}",
                       OMP_NUM_THREADS="1")
            for v in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE"):
                env.pop(v, None)
            procs.append((n, r, subprocess.Popen(
                [sys.executable, WORKER, work], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    try:
        refs = {}     # the JAX engines run while the ranks do
        jcfg = dict(donate_input=False, **BUCKET)
        for c in ENGINE_CASES:
            if c["name"] == "tp2_flash":
                continue              # held to the port's tp2 instead
            cfg, params = models[c["model"]]
            refs[c["name"]] = JEngine(cfg, params, JEngineConfig(
                **c["settings"], **jcfg)).infer(feat, lens)
        for c in EXPORTED:            # JAX's exported sharded round trip
            if c["name"] in EXPORT_FLAGS:
                cfg, params = models["hier"]
                d = os.path.join(work, "jax_" + c["name"])
                JEngine(cfg, params, JEngineConfig(**c["settings"], **jcfg)
                        ).save(d, raw_yaml=hier_raw(),
                               export_platforms=("cpu",))
                eng = JEngine.load(d)
                assert eng._exported_fn(2, 48) is not None
                refs[c["name"]] = eng.infer(feat, lens)
        x = {k: ffn[k] for k in ("x", "embed", "lengths")}
        refs["ffn"] = np.asarray(j_moe.moe_ffn(
            {**{k: ffn[k] for k in ("w1", "b1", "w2", "b2")},
             "router": {"kernel": ffn["router"]}}, x["x"], x["embed"],
            x["lengths"], impl="dense"))
    finally:
        logs = {}
        for n, r, p in procs:
            try:
                logs[(n, r)] = (p.communicate(timeout=JOIN_S)[0],
                                p.returncode)
            except subprocess.TimeoutExpired:
                p.kill()
                logs[(n, r)] = (p.communicate()[0], "timeout")
    for (n, r), (log, rc) in logs.items():
        assert rc == 0, f"world {n} rank {r}: {rc}\n{log[-3000:]}"
    refs["work"] = work
    outs = {n: [dict(np.load(os.path.join(work, f"out_{n}_{r}.npz")))
                for r in range(n)] for n in CASES}
    metas = {n: [json.load(open(os.path.join(work, f"meta_{n}_{r}.json")))
                 for r in range(n)] for n in CASES}
    return outs, metas, refs


def _world(name):
    return next(n for n, cs in CASES.items()
                if any(c["name"] == name for c in cs))


def _held(got, ref, out_len, settings):
    """The port's logits against the JAX engine's on the valid region."""
    fp32 = settings.get("dtype", "float32") == "float32"
    for b, L in enumerate(out_len):
        if fp32:
            allclose(got[b, :L], ref[b, :L])
        else:
            err = np.abs(got[b, :L] - ref[b, :L]).max()
            assert err <= QUANT_TOL * np.abs(ref[b, :L]).max(), (b, err)


@pytest.mark.parametrize("c", [c for c in ENGINE_CASES
                               if c["name"] != "tp2_flash"],
                         ids=lambda c: c["name"])
def test_sharded_engine_matches_jax(worlds, c):
    outs, metas, refs = worlds
    n = _world(c["name"])
    ref, ref_len = refs[c["name"]]
    got = outs[n][0][c["name"]]
    assert got.shape == ref.shape
    _held(got, ref, ref_len, c["settings"])
    meta = metas[n][0][c["name"]]
    want = ("dense" if c["settings"].get("dtype", "float32")
            in ("float32", "bfloat16") else
            "quant_a8" if c["settings"].get("act_quant") else "quant")
    assert meta["impl"] == want       # the JAX engine's mesh policy


@pytest.mark.parametrize("c", ALL_CASES, ids=lambda c: c["name"])
def test_ranks_bit_identical(worlds, c):
    """Every rank returns rank 0's bits (the outputs are replicated)."""
    outs, metas, _ = worlds
    n = _world(c["name"])
    keys = [k for k in outs[n][0] if k.split("__")[0] == c["name"]]
    for k in keys:
        for r in range(1, n):
            np.testing.assert_array_equal(outs[n][r][k], outs[n][0][k])
    if c["kind"] == "cli":
        assert "allclose(rtol=1e-05, atol=1e-03): True" in \
            metas[n][0][c["name"]]["stdout"]


@pytest.mark.parametrize("c", ROUNDTRIPS, ids=lambda c: c["name"])
def test_sharded_save_load_roundtrip(worlds, c):
    """save gathers the whole tree (rank 0 writes; int4 under tp keeps
    w1_q4c, as the JAX engine's dir); load re-shards on the ranks and
    serves the same bits."""
    outs, metas, _ = worlds
    n = _world(c["name"])
    np.testing.assert_array_equal(outs[n][0][c["name"] + "__loaded"],
                                  outs[n][0][c["name"]])
    leaves = metas[n][0][c["name"]]["loaded_leaves"]
    if c["settings"].get("tp", 1) > 1 and c["settings"].get("dtype") == "int4":
        assert "w1_q4c" in leaves and "w1_q4" not in leaves


def test_shards_are_local(worlds):
    """Each rank holds its slice: ep over experts, tp over the hidden
    (w1_q4c's tp axis of 1 under int4)."""
    _, metas, _ = worlds
    assert metas[4][0]["ep2tp2"]["local_w1"] == {"w1": [2, 4, 32, 24]}
    assert metas[4][0]["ep4"]["local_w1"] == {"w1": [2, 2, 32, 48]}
    assert metas[2][0]["tp2_int4"]["local_w1"] == {
        "w1_q4c": [2, 8, 32, 1, 12], "w1_scale": [2, 8, 1, 24]}


def test_tp_flash_falls_back_to_xla(worlds):
    """tp with attn_impl="flash" logs the JAX engine's warning and serves
    xla: the same bits as the tp xla engine."""
    outs, metas, _ = worlds
    meta = metas[2][0]["tp2_flash"]
    assert meta["attn_impl"] == "xla"
    assert any("falling back to attn_impl='xla'" in w
               for w in meta["warnings"])
    np.testing.assert_array_equal(outs[2][0]["tp2_flash"],
                                  outs[2][0]["tp2"])


@pytest.mark.parametrize("impl", ["ragged", "tiled"])
def test_ep_moe_ffn_matches_jax(worlds, impl):
    """parallel/ep.make_ep_moe_ffn on 2 ranks (each its 4 experts plus a
    zero dummy) against the JAX package's dense moe_ffn."""
    outs, _, refs = worlds
    allclose(outs[2][0]["ffn_" + impl], refs["ffn"], rtol=1e-5, atol=1e-5)


def test_build_ep_then_infer_on_ranks(worlds):
    """build --ep 2 (one process) then infer on 2 ranks: rank 0 prints the
    unsharded engine's allclose; the other rank prints nothing."""
    _, metas, _ = worlds
    assert "allclose(rtol=1e-05, atol=1e-03): True" in \
        metas[2][0]["cli_ep2"]["stdout"]
    assert metas[2][1]["cli_ep2"]["stdout"] == ""


def test_sharded_engine_without_a_group_raises():
    """ep*tp > 1 with no process group names the launcher (JAX: the
    device-count assert)."""
    cfg = t_config(hier_raw())
    with pytest.raises(RuntimeError,
                       match="torch.distributed.run --nproc-per-node 4"):
        Engine(cfg, {}, EngineConfig(ep=2, tp=2, **BUCKET), device="cpu")


@pytest.mark.parametrize("flags,match", [
    (["--ep", "2", "--fuse_qkv"], "fuse_qkv with ep/tp-sharded serving"),
    (["--tp", "2", "--int8", "--dense_quant"],
     "dense_quant with ep/tp-sharded serving"),
])
def test_build_refuses_as_jax(tmp_path, flags, match):
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump(hier_raw(), f)
    with pytest.raises(NotImplementedError, match=match):
        t_build.main(["-c", str(tmp_path / "cfg.yaml"), "-o",
                      str(tmp_path / "e"), "--device", "cpu", "--buckets",
                      "1x48"] + flags)


def test_build_exports_every_ranks_program(worlds):
    """build --export with --ep/--tp (once refused) writes one program a
    rank and bucket, each recording the rank and mesh shape it was
    traced for; the programs hold the all-reduces as operators."""
    work = worlds[2]["work"]
    for name, flags in EXPORT_FLAGS.items():
        ep = int(flags[flags.index("--ep") + 1]) if "--ep" in flags else 1
        tp = int(flags[flags.index("--tp") + 1]) if "--tp" in flags else 1
        files = sorted(os.listdir(os.path.join(work, name, "exported")))
        assert files == [f"2x48.cpu.r{r}of{ep}x{tp}.pt2"
                         for r in range(ep * tp)], name
        for r, fname in enumerate(files):
            extra = {LAYOUT_FILE: ""}
            prog = torch.export.load(os.path.join(
                work, name, "exported", fname), extra_files=extra)
            assert json.loads(extra[LAYOUT_FILE]) == {"rank": r, "ep": ep,
                                                      "tp": tp}
            assert any("mesh_all_reduce" in str(n.target)
                       for n in prog.graph.nodes)


@pytest.mark.parametrize("c", [c for c in EXPORTED
                               if c["name"] in EXPORT_FLAGS],
                         ids=lambda c: c["name"])
def test_exported_sharded_dir_runs_its_programs(worlds, c):
    """Every rank runs its own loaded program of the bucket
    (loaded_buckets) and answers bit for bit as the same dir without
    exported/ (the programs traced from the model code)."""
    outs, metas, _ = worlds
    n = _world(c["name"])
    for r in range(n):
        assert metas[n][r][c["name"]]["loaded"] == [[2, 48]], r
        np.testing.assert_array_equal(outs[n][r][c["name"]],
                                      outs[n][r][c["name"] + "__eager"])


@pytest.mark.parametrize("c", [c for c in EXPORTED
                               if c["name"] in EXPORT_FLAGS],
                         ids=lambda c: c["name"])
def test_exported_sharded_dir_matches_jax(worlds, c):
    """Rank 0's answer from its loaded program against the JAX engine's
    exported sharded dir (saved with its shardings, loaded on the
    virtual devices)."""
    outs, _, refs = worlds
    ref, ref_len = refs[c["name"]][:2]
    got = outs[_world(c["name"])][0][c["name"]]
    assert got.shape == np.asarray(ref).shape
    _held(got, np.asarray(ref), ref_len, c["settings"])


def test_program_of_another_rank_or_mesh_retraces(worlds):
    """A tp2 dir whose rank-0 program is rank 1's and whose rank-1 program
    is the ep2 x tp2 dir's rank 1 (each under this rank's file name):
    each rank warns naming the layout the program was built for, runs
    none of them, and answers as the eager twin."""
    outs, metas, _ = worlds
    want = {0: "built for rank 1 of ep 1 x tp 2, not rank 0",
            1: "built for rank 1 of ep 2 x tp 2, not rank 1"}
    for r, text in want.items():
        meta = metas[2][r]["x_wrong"]
        assert meta["loaded"] == []
        assert any(text in w and "retracing" in w
                   for w in meta["warnings"]), meta["warnings"]
        np.testing.assert_array_equal(outs[2][r]["x_wrong"],
                                      outs[2][r]["x_wrong__eager"])


def test_sharded_engine_refuses_other_families(tmp_path):
    """Only the moe_conformer family shards, as in the JAX engine."""
    raw = hier_raw("conformer")
    raw["model_conf"]["encoder_conf"] = {
        "attention_dim": 32, "attention_heads": 4, "num_blocks": 1,
        "linear_units": 32}
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump(raw, f)
    with pytest.raises(NotImplementedError, match="moe_conformer family"):
        t_build.main(["-c", str(tmp_path / "cfg.yaml"), "-o",
                      str(tmp_path / "e"), "--device", "cpu", "--buckets",
                      "1x48", "--tp", "2"])
