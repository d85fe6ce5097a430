"""The engine's output contract in the PyTorch port against the JAX
engine, on the CPU: every ``decode_output`` (logits, log_softmax, argmax,
topk, beam) with and without ``return_hidden`` / ``return_taps``,
``infer_long``, ``warmup``, the frozen parameters of built bucket
programs, the declared eager-stage set, the build and infer CLIs with the
on-device decode outputs, ``router_probs`` and the bf16 positional scale.

A small hier MoE conformer (2 embed + 2 MoE blocks, d=64, E=4, V=32)
with every weight drawn from a numpy seed runs in both packages; the port
takes its plain expert path on the CPU. Ids, indices and lengths must be
equal; floats in float32 within allclose(rtol 1e-5, atol 1e-3), the
reference standard, with -inf (a dead beam's score) on the same entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.models import moe_conformer as j_model
from m3asr_tpu.ops import moe as j_moe
from m3asr_tpu.ops import positional as j_pos
from m3asr_tpu.runtime.engine import Engine as JEngine
from m3asr_tpu.runtime.engine import EngineConfig as JEngineConfig

from m3asr_tpu_torch import build as t_build
from m3asr_tpu_torch import infer as t_infer
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.decode import ctc as t_ctc
from m3asr_tpu_torch.ops import moe as t_moe
from m3asr_tpu_torch.ops import positional as t_pos
from m3asr_tpu_torch.runtime import engine as t_engine
from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

from test_op_parity import allclose

V = 32
BUCKET = dict(bucket_lengths=(64,), bucket_batches=(2,))
MODES = ("logits", "log_softmax", "argmax", "topk", "beam")
EXTRAS = {"plain": {}, "hidden": {"return_hidden": True},
          "taps": {"return_taps": True}}


def small_yaml():
    return {
        "nnet_proto": "conformer_aed_fmoe_localComm_catEmbed_domain_acc_hier",
        "input_dim": 20,
        "output_dim": V,
        "model_conf": {"encoder_conf": {
            "attention_dim": 64, "attention_heads": 4, "num_blocks": 2,
            "embed_conf": {"attention_dim": 64, "attention_heads": 4,
                           "linear_units": 64, "num_blocks": 2},
            "moe_conf": {"num_experts": 4, "hidden_units": 64}}},
    }


def random_params(seed=0):
    """The small model's numpy tree, every float leaf redrawn from a
    numpy seed (routers at normal x 0.5, so tokens spread)."""
    cfg = j_config(small_yaml())
    tree = jax.tree.map(np.asarray, j_model.init(
        jax.random.PRNGKey(seed), cfg.encoder_conf, 20, V))
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name.endswith("pe"):
            return a
        v = rng.standard_normal(a.shape) * (0.5 if "router" in name else 0.1)
        if name.endswith("scale"):
            v = v + 1.0
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, tree)


def inputs(seed=1, B=2, T=57, lens=(57, 31)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, 20)).astype(np.float32),
            np.array(lens, np.int32))


def engines(tree, **settings):
    """(JAX engine, port engine on the CPU) of the same settings."""
    je = JEngine(j_config(small_yaml()), tree,
                 JEngineConfig(donate_input=False, **settings))
    te = Engine(t_config(small_yaml()), tree, EngineConfig(**settings),
                device="cpu")
    return je, te


def assert_outputs_match(ref, got):
    """Two output tuples: same length, shapes and dtypes; integers equal,
    floats allclose(1e-5, 1e-3) with infinities on the same entries."""
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert r.shape == g.shape and r.dtype == g.dtype, \
            (r.shape, g.shape, r.dtype, g.dtype)
        if r.dtype.kind == "f":
            np.testing.assert_array_equal(np.isfinite(r), np.isfinite(g))
            fin = np.isfinite(r)
            allclose(g[fin], r[fin])
            np.testing.assert_array_equal(g[~fin], r[~fin])
        else:
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("extra", sorted(EXTRAS))
@pytest.mark.parametrize("mode", MODES)
def test_engine_outputs_match_jax(mode, extra):
    """Every decode_output, alone and with return_hidden / return_taps:
    the JAX engine's tuple, entry for entry (topk and beam with K=4)."""
    tree = random_params()
    feat, lens = inputs()
    je, te = engines(tree, decode_output=mode, decode_topk=4, **BUCKET,
                     **EXTRAS[extra])
    got = te.infer(feat, lens)
    assert_outputs_match(je.infer(feat, lens), got)
    if mode == "argmax":
        # the greedy hypotheses of the ids equal those of the logits
        te_l = Engine(t_config(small_yaml()), tree, EngineConfig(**BUCKET),
                      device="cpu")
        logits, out_len = te_l.infer(feat, lens)
        assert t_ctc.ctc_greedy_from_ids(got[0], got[1]) == \
            t_ctc.ctc_greedy_search(logits, out_len)


def test_out_mode_override_matches_the_mode_engine():
    """infer(out_mode=...) on a logits engine gives the same tuple as an
    engine built for that mode."""
    tree = random_params(2)
    feat, lens = inputs(3)
    base = Engine(t_config(small_yaml()), tree,
                  EngineConfig(decode_topk=3, **BUCKET), device="cpu")
    for mode in ("argmax", "topk", "beam"):
        ref = Engine(t_config(small_yaml()), tree,
                     EngineConfig(decode_output=mode, decode_topk=3,
                                  **BUCKET), device="cpu").infer(feat, lens)
        got = base.infer(feat, lens, out_mode=mode)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("setting", ["logits", "taps", "beam"])
def test_infer_long_matches_jax(setting):
    """A 200-frame utterance over buckets (32, 64): windows of 64 frames
    with 16 frames of context, stitched by center cuts. Logits, the taps
    and the beam engine's result (windows in topk mode, one host search
    over the stitched candidates) against the JAX engine's infer_long."""
    settings = {"logits": {}, "taps": {"return_taps": True},
                "beam": {"decode_output": "beam", "decode_topk": 4}}[setting]
    tree = random_params(4)
    feat = np.random.default_rng(5).standard_normal((200, 20)) \
        .astype(np.float32)
    je, te = engines(tree, bucket_lengths=(32, 64), bucket_batches=(1,),
                     **settings)
    ref = je.infer_long(feat, 200, overlap=16)
    got = te.infer_long(feat, 200, overlap=16)
    assert_outputs_match(ref, got)
    n = int(got[1][0])
    assert abs(n - ((200 - 1) // 2 - 1) // 2) <= 4
    # short inputs pass straight through to infer()
    short = te.infer_long(feat[:50], 50)
    direct = te.infer(feat[None, :50], np.array([50]))
    for s, d in zip(short, direct):
        np.testing.assert_array_equal(s, d)


def test_infer_long_stitches_its_own_windows():
    """The stitched logits are the center-cut rows of the engine's own
    window forwards, as documented."""
    tree = random_params(6)
    T, W, O, f = 150, 64, 16, 4
    feat = np.random.default_rng(7).standard_normal((T, 20)) \
        .astype(np.float32)
    eng = Engine(t_config(small_yaml()), tree,
                 EngineConfig(bucket_lengths=(W,), bucket_batches=(1,)),
                 device="cpu")
    assert eng.subsample_factor() == f
    out, out_len = eng.infer_long(feat, T, overlap=O)
    rows, s = [], 0
    while True:
        e = min(s + W, T)
        o, ol = eng.infer(feat[None, s:e], np.array([e - s]))
        lo = 0 if s == 0 else O // f
        hi = int(ol[0]) if e == T else min(int(ol[0]), (e - s - O) // f)
        rows.append(o[0, lo:hi])
        if e == T:
            break
        s += W - 2 * O
    np.testing.assert_array_equal(out[0], np.concatenate(rows))
    assert out.shape == (1, int(out_len[0]), V)


@pytest.mark.parametrize("mode", ["logits", "beam"])
def test_warmup_on_cpu_leaves_results_unchanged(mode):
    """warmup() on the CPU builds every bucket's eager program (no graph)
    and execute=True serves zeros; results before and after are equal."""
    tree = random_params(8)
    feat, lens = inputs(9)
    settings = dict(decode_output=mode, decode_topk=3,
                    bucket_lengths=(32, 64), bucket_batches=(1, 2))
    eng = Engine(t_config(small_yaml()), tree, EngineConfig(**settings),
                 device="cpu")
    before = eng.infer(feat, lens)
    eng.warmup(execute=True)
    progs = [eng.get_fn(b, t) for b, t in eng.buckets.all_buckets()]
    assert all(p.graph is None for p in progs)
    assert tuple(progs[-1].feat.shape) == (2, 64, 20)
    after = eng.infer(feat, lens)
    fresh = Engine(t_config(small_yaml()), tree, EngineConfig(**settings),
                   device="cpu").infer(feat, lens)
    for b, a, f in zip(before, after, fresh):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(f, b)


def test_params_and_prior_freeze_once_a_program_exists():
    """Bucket programs read params and the prior as built (CUDA graphs at
    fixed addresses): replacing either afterwards raises; before, it is
    allowed (Engine.load sets the prior so)."""
    tree = random_params(10)
    eng = Engine(t_config(small_yaml()), tree, EngineConfig(**BUCKET),
                 device="cpu")
    eng.neg_log_prior = torch.zeros(V)
    eng.get_fn(2, 64)
    with pytest.raises(RuntimeError, match="frozen"):
        eng.neg_log_prior = None
    with pytest.raises(RuntimeError, match="frozen"):
        eng.params = {}


def test_host_sync_stages_are_the_declared_set():
    """Exactly the stages that read group sizes on the host run eager on
    the card: capacity, ragged, ragged_padded and quant_capacity."""
    assert t_moe.HOST_SYNC_STAGES == {"capacity", "ragged", "ragged_padded",
                                      "quant_capacity"}
    stages = set().union(*t_engine._RUNS_ON.values())
    assert t_moe.HOST_SYNC_STAGES <= stages


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_probs_matches_jax(dtype):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 40)).astype(np.float32)
    p = {"kernel": rng.standard_normal((40, 4)).astype(np.float32),
         "bias": rng.standard_normal(4).astype(np.float32)}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = j_moe.router_probs({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x, jdt))
    tdt = getattr(torch, dtype)
    got = t_moe.router_probs({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x).to(tdt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("d", [64, 512])
def test_rel_positional_encoding_bf16_bit_equal_to_jax(d):
    """The scale is sqrt(d) rounded to bf16 first (22.625 for d=512), as
    in the JAX package: scaled inputs and pos_emb are bit-equal."""
    x = np.random.default_rng(12).standard_normal((2, 37, d)) \
        .astype(np.float32)
    pe = j_pos.sinusoid_table(d)
    rx, rpe = j_pos.rel_positional_encoding(pe, jnp.asarray(x, jnp.bfloat16))
    gx, gpe = t_pos.rel_positional_encoding(
        torch.from_numpy(np.array(pe)), torch.from_numpy(x).bfloat16())

    def bits(a):
        return np.asarray(a).view(np.uint16)
    np.testing.assert_array_equal(gx.view(torch.int16).numpy()
                                  .view(np.uint16), bits(rx))
    np.testing.assert_array_equal(gpe.view(torch.int16).numpy()
                                  .view(np.uint16), bits(rpe))


@pytest.mark.parametrize("mode", ["argmax", "topk", "beam"])
def test_build_and_infer_cli_decode_outputs(tmp_path, capsys, mode):
    """build --decode_output MODE (with its warm-up) and infer -d greedy /
    beam decode from the on-device outputs: the hypotheses equal the host
    decodes of a logits engine on the same weights (greedy; the dense
    prefix beam of width 4)."""
    cfg_path = tmp_path / "cfg.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(small_yaml(), f)
    feat, lens = inputs(13, lens=(57, 57))
    np.save(tmp_path / "feat.npy", feat)
    args = ["-c", str(cfg_path), "--buckets", "2x64", "--device", "cpu"]
    t_build.main(args + ["-o", str(tmp_path / "e"), "--decode_output", mode,
                         "--decode_topk", "4"])
    t_build.main(args + ["-o", str(tmp_path / "l"), "--skip-warmup"])
    out = capsys.readouterr().out
    assert out.count("warming up") == 1
    eng = Engine.load(str(tmp_path / "e"), device="cpu")
    assert (eng.cfg.decode_output, eng.cfg.decode_topk) == (mode, 4)

    logits, out_len = Engine.load(str(tmp_path / "l"), device="cpu") \
        .infer(feat, lens)
    lp = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
    greedy = t_ctc.ctc_greedy_search(logits, out_len)
    beam = [list(t_ctc.ctc_prefix_beam_search(lp[b], int(out_len[b]),
                                              4)[0][0]) for b in range(2)]
    for decode, want in (("greedy", greedy), ("beam", beam)):
        if mode == "argmax" and decode == "beam":
            continue
        if mode == "beam":
            want = beam             # the engine's own search, width 4
        t_infer.main(["-p", str(tmp_path / "e"), "-i",
                      str(tmp_path / "feat.npy"), "-d", decode, "-b", "4",
                      "--device", "cpu"])
        printed = capsys.readouterr().out
        for b, hyp in enumerate(want):
            assert f"utt{b} hyp: {hyp}" in printed, printed
