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
from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

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
         "ref": "ref1.npy"}],
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
             kind="roundtrip")],
}
ENGINE_CASES = [c for n in CASES for c in CASES[n]
                if c["kind"] in ("infer", "roundtrip")]
ALL_CASES = [c for n in CASES for c in CASES[n]]
ROUNDTRIPS = [c for c in ENGINE_CASES if c["kind"] == "roundtrip"]


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

    procs = []
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
    (["--ep", "2", "--export"], r"item 12c-ii \(sharded export\)"),
])
def test_build_refuses_as_jax(tmp_path, flags, match):
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump(hier_raw(), f)
    with pytest.raises(NotImplementedError, match=match):
        t_build.main(["-c", str(tmp_path / "cfg.yaml"), "-o",
                      str(tmp_path / "e"), "--device", "cpu", "--buckets",
                      "1x48"] + flags)


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
