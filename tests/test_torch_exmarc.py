"""The ExMarc ("Expert-Macaron") protos in the PyTorch port against the
JAX package, on the CPU: both FFN positions of every MoE block are
catEmbed MoE FFNs (``conformer_fmoeExMarc_localComm_catEmbed`` and its
AED wrapper).

A small ExMarc model (1 embed + 2 MoE blocks, d=32, E=4, h=48, V=11)
runs in both packages on the same numpy-seeded weights, or on a golden
torch twin's checkpoint (``tests/golden/torch_ref.py`` blocks with
``moe_macaron=True``). The port takes its plain expert paths on the CPU.
Tolerances: float32 allclose(rtol 1e-5, atol 1e-3), the reference
standard; bf16 and the quantized modes within 0.05 of max|ref| against
the JAX engine in the same mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import build as j_build
import recognize as j_recognize
from golden import torch_ref as G
from m3asr_tpu import checkpoint as j_ckpt
from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.models import moe_conformer as j_model
from m3asr_tpu.models import layers as j_layers
from m3asr_tpu.models.layers import conformer_block as j_block
from m3asr_tpu.runtime.engine import Engine as JEngine
from m3asr_tpu.runtime.engine import EngineConfig as JEngineConfig
from m3asr_tpu.train import step as j_step

from m3asr_tpu_torch import build as t_build
from m3asr_tpu_torch import checkpoint as t_ckpt
from m3asr_tpu_torch import infer as t_infer
from m3asr_tpu_torch import recognize as t_recognize
from m3asr_tpu_torch.checkpoint import (flatten_tree, params_from_jax,
                                        params_to_numpy)
from m3asr_tpu_torch.config import MoEEncoderConfig
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.io.kaldi_io import ArkWriter
from m3asr_tpu_torch.models import moe_conformer as t_model
from m3asr_tpu_torch.models import streaming as t_streaming
from m3asr_tpu_torch.models import layers as t_layers
from m3asr_tpu_torch.models.layers import conformer_block as t_block
from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig
from m3asr_tpu_torch.runtime.streaming_batch import StreamBatcher
from m3asr_tpu_torch.runtime.streaming_session import StreamingSession
from m3asr_tpu_torch.train import step as t_step

from test_op_parity import allclose, valid_region

V = 11
PROTO = "conformer_fmoeExMarc_localComm_catEmbed"
AED_PROTO = "conformer_aed_fmoeExMarc_localComm_catEmbed"
BUCKET = dict(bucket_lengths=(64,), bucket_batches=(2,))
DECODERS = ("decoder", "decoder_1", "decoder_2")


def small_yaml(proto=AED_PROTO):
    return {
        "nnet_proto": proto, "input_dim": 20, "output_dim": V,
        "model_conf": {"encoder_conf": {
            "attention_dim": 32, "attention_heads": 4, "num_blocks": 2,
            "embed_conf": {"attention_dim": 24, "attention_heads": 4,
                           "linear_units": 32, "num_blocks": 1},
            "moe_conf": {"num_experts": 4, "hidden_units": 48}}},
    }


def random_params(seed=0):
    """Numpy tree of the small ExMarc model, every float leaf redrawn
    from a numpy seed (routers at normal x 0.5, so tokens spread)."""
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


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 57, 20)).astype(np.float32),
            np.array([57, 31], np.int32))


def golden_model():
    """The golden hier MoE conformer with ExMarc blocks (MoE macaron)."""
    torch.manual_seed(40)
    m = G.HierMoEConformer(
        20, V, attention_dim=32, attention_heads=4, num_blocks=2,
        num_experts=4, moe_hidden=48,
        embed_conf=dict(attention_dim=24, attention_heads=4,
                        linear_units=32, num_blocks=1))
    m.blocks = torch.nn.ModuleList([G.ConformerEncoderLayer(
        32, 4, 48, moe=True, embed_dim=24, num_experts=4, moe_hidden=48,
        moe_macaron=True) for _ in range(2)])
    return G.randomize_(m, seed=41)


def _rel(a, b):
    return np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)) \
        .max() / np.abs(np.asarray(b, np.float32)).max()


# ---------------------------------------------------------------------------
# the block, the converters, the init tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["dense", "runs_f"])
def test_block_matches_jax_and_golden(impl):
    """One ExMarc block (golden twin, moe_macaron=True) converted by the
    port: its forward against the twin and against the JAX block on the
    same parameters, allclose(1e-5, 1e-3) on the valid rows."""
    torch.manual_seed(110)
    m = G.randomize_(G.ConformerEncoderLayer(
        32, 4, 64, moe=True, embed_dim=8, num_experts=4, moe_hidden=32,
        moe_macaron=True), seed=111)
    g = torch.Generator().manual_seed(112)
    x = torch.randn(2, 15, 32, generator=g)
    embed = torch.randn(2, 15, 8, generator=g)
    lens = [15, 10]
    pe = G.RelPositionalEncoding(32).pe[0, :15]
    with torch.no_grad():
        ref = m(x, torch.tensor(lens), pe[None], embed=embed).numpy()
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    cfg = MoEEncoderConfig(attention_dim=32, attention_heads=4, exmarc=True)
    p = t_ckpt.to_torch(t_ckpt.convert_block(t_ckpt.StateDict(sd), cfg,
                                             moe=True))
    assert "router" in p["feed_forward_macaron"]
    with torch.no_grad():
        got = t_block(p, x, torch.tensor(lens), pe, num_heads=4, moe=True,
                      moe_macaron=True, embed=embed, moe_impl=impl).numpy()
    allclose(valid_region(got, lens), valid_region(ref, lens))
    jp = jax.tree.map(jnp.asarray, params_to_numpy(p))
    jout = j_block(jp, jnp.asarray(x.numpy()), jnp.array(lens),
                   jnp.asarray(pe.numpy()), num_heads=4, moe=True,
                   moe_macaron=True, embed=jnp.asarray(embed.numpy()))
    allclose(valid_region(got, lens), valid_region(np.asarray(jout), lens))


@pytest.mark.parametrize("wrapped", [False, True])
def test_converters_bare_and_aed_wrapped(wrapped):
    """The golden ExMarc checkpoint, bare or under ``encoder.``: the
    port's tree equals the JAX converter's leaf for leaf, every key is
    consumed, and the port's forward matches the golden model's."""
    m = golden_model()
    pre = "encoder." if wrapped else ""
    sd = {pre + k: v for k, v in m.state_dict().items()}
    proto = AED_PROTO if wrapped else PROTO
    tcfg, jcfg = t_config(small_yaml(proto)), j_config(small_yaml(proto))
    assert tcfg.encoder_conf.exmarc and jcfg.encoder_conf.exmarc
    tracked = t_ckpt.TrackedDict(sd)
    params = t_ckpt.convert_encoder(tracked, tcfg)
    assert t_ckpt.check_consumed(tracked, strict=True, log=lambda *_: 0) \
        == []
    ref = flatten_tree(jax.tree.map(np.asarray, j_ckpt.convert_encoder(
        {k: v.numpy() for k, v in sd.items()}, jcfg)))
    got = flatten_tree(params_to_numpy(params))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    feat, lens = inputs()
    with torch.no_grad():
        want, want_len = m(torch.from_numpy(feat), torch.from_numpy(lens))
        out, out_len = t_model.forward(params, tcfg.encoder_conf,
                                       torch.from_numpy(feat),
                                       torch.from_numpy(lens),
                                       moe_impl="runs_f")
    np.testing.assert_array_equal(out_len.numpy(), want_len.numpy())
    allclose(valid_region(out.numpy(), out_len),
             valid_region(want.numpy(), out_len))


def test_init_tree_has_the_jax_paths_and_shapes():
    """The port's seeded init of an ExMarc model: the JAX tree's paths and
    shapes, with both FFN positions stacked (L, E, ...) experts."""
    tcfg = t_config(small_yaml())
    ours = flatten_tree(params_to_numpy(t_model.init(
        tcfg.encoder_conf, 20, V, torch.Generator().manual_seed(0))))
    ref = flatten_tree(random_params())
    assert {k: v.shape for k, v in ours.items()} == \
        {k: v.shape for k, v in ref.items()}
    for pos in ("feed_forward", "feed_forward_macaron"):
        assert ours[f"blocks/{pos}/w1"].shape == (2, 4, 32, 48)
        assert ours[f"blocks/{pos}/router/kernel"].shape == (2, 56, 4)
    # one block alone, with a router bias: JAX's init_conformer_block tree
    kw = dict(moe=True, moe_embed_dim=24, moe_num_experts=4, moe_hidden=48,
              router_with_bias=True, moe_macaron=True)
    block = flatten_tree(params_to_numpy(t_layers.init_conformer_block(
        torch.Generator().manual_seed(1), 32, 4, 64, **kw)))
    jblock = flatten_tree(jax.tree.map(
        np.asarray, j_layers.init_conformer_block(jax.random.PRNGKey(1), 32,
                                                  4, 64, **kw)))
    assert {k: v.shape for k, v in block.items()} == \
        {k: v.shape for k, v in jblock.items()}
    assert "feed_forward_macaron/router/bias" in block


# ---------------------------------------------------------------------------
# the model under each expert stage, with taps, hidden and router probs
# ---------------------------------------------------------------------------

def _jax_forward(tree, **kw):
    cfg = j_config(small_yaml())
    feat, lens = inputs()
    return jax.jit(lambda p, x, l: j_model.forward(
        p, cfg.encoder_conf, x, l, moe_impl="dense", hier_taps=True,
        return_router_probs=True, return_hidden=True))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(feat),
            jnp.asarray(lens))


@pytest.mark.parametrize("impl", ["dense", "runs_f", "tiled", "ragged",
                                  "ragged_padded", "capacity", "pallas"])
def test_model_stages_match_jax(impl):
    """The 2+2-block model with every float stage (K1 ``runs_f`` and K8
    ``pallas`` as their plain versions) against the JAX forward: logits,
    the hier taps, the final FFN's router probabilities (L, B, T', E)
    and the hidden, allclose(1e-5, 1e-3) on the valid region."""
    tree = random_params()
    ref = _jax_forward(tree)
    feat, lens = inputs()
    with torch.inference_mode():
        got = t_model.forward(
            params_from_jax(tree), t_config(small_yaml()).encoder_conf,
            torch.from_numpy(feat), torch.from_numpy(lens), moe_impl=impl,
            hier_taps=True, return_router_probs=True, return_hidden=True)
    assert len(got) == len(ref) == 7
    out_len = got[1]
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref[1]))
    for i in (0, 2, 3, 4, 6):
        allclose(valid_region(got[i].numpy(), out_len),
                 valid_region(np.asarray(ref[i]), out_len))
    assert got[5].shape == (2, 2, 13, 4)
    for layer in range(2):
        allclose(valid_region(got[5][layer].numpy(), out_len),
                 valid_region(np.asarray(ref[5][layer]), out_len))


# ---------------------------------------------------------------------------
# every engine mode against the JAX engine
# ---------------------------------------------------------------------------

# (port engine settings, JAX engine settings, bound on max|diff|/max|ref|
# or None for allclose(1e-5, 1e-3))
ENGINE_MODES = {
    "fp32": (dict(), dict(), None),
    "bf16": (dict(dtype="bfloat16"), dict(dtype="bfloat16"), 0.05),
    "int8": (dict(dtype="int8"), dict(dtype="int8"), 0.05),
    "int4": (dict(dtype="int4"), dict(dtype="int4"), 0.05),
    "w8a8": (dict(dtype="int8", act_quant=True),
             dict(dtype="int8", act_quant=True), 0.05),
    "w4a8": (dict(dtype="int4", act_quant=True),
             dict(dtype="int4", act_quant=True), 0.05),
    "flash": (dict(attn_impl="flash"), dict(), None),
    "fuse_qkv": (dict(fuse_qkv=True), dict(fuse_qkv=True), None),
    "int4_dense_quant": (dict(dtype="int4", dense_quant=True),
                         dict(dtype="int4", dense_quant=True), 0.05),
    "pallas": (dict(moe_impl="pallas"), dict(moe_impl="dense"), None),
    "int4_tiled": (dict(dtype="int4", moe_impl="tiled"),
                   dict(dtype="int4", moe_impl="tiled"), 0.05),
    "argmax_taps": (dict(decode_output="argmax", return_taps=True),
                    dict(decode_output="argmax", return_taps=True), None),
    "topk_hidden": (dict(decode_output="topk", decode_topk=4,
                         return_hidden=True),
                    dict(decode_output="topk", decode_topk=4,
                         return_hidden=True), None),
    "beam": (dict(decode_output="beam", decode_topk=4),
             dict(decode_output="beam", decode_topk=4), None),
}


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
def test_engine_mode_matches_jax(mode):
    """Each engine mode on the ExMarc model against the JAX engine in the
    same mode (the port's ``pallas``, K8's plain version, against JAX's
    ``dense``; its flash, K2's plain version, against JAX's XLA
    attention): integer outputs equal, floats within the mode's bound on
    the valid region. Quantized engines quantize both expert positions
    and leave them to ``dense_quant``."""
    ours, theirs, bound = ENGINE_MODES[mode]
    tree = random_params()
    feat, lens = inputs()
    jeng = JEngine(j_config(small_yaml()), tree,
                   JEngineConfig(donate_input=False, **BUCKET, **theirs))
    teng = Engine(t_config(small_yaml()), tree,
                  EngineConfig(**BUCKET, **ours), device="cpu")
    ref, got = jeng.infer(feat, lens), teng.infer(feat, lens)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert r.shape == g.shape, (r.shape, g.shape)
        if r.dtype.kind != "f":
            np.testing.assert_array_equal(g, r)
        elif bound is None:
            fin = np.isfinite(r)
            np.testing.assert_array_equal(np.isfinite(g), fin)
            allclose(g[fin], r[fin])
        else:
            assert _rel(g, r) < bound, (mode, _rel(g, r))
    blocks = teng.params["blocks"]
    for pos in ("feed_forward", "feed_forward_macaron"):
        keys = set(blocks[pos])
        if teng.quant_bits == 8:
            assert {"w1_q", "w2_q"} <= keys and "w1" not in keys
        elif teng.quant_bits == 4:
            assert {"w1_q4", "w2_q4"} <= keys and "w1" not in keys
        assert "kernel" in blocks[pos]["router"]


def test_quantized_tree_is_not_quantized_again():
    """An int4 engine handed another int4 engine's tree keeps it: both
    expert positions' packed bytes are the same tensors' values."""
    tree = random_params()
    cfg = t_config(small_yaml())
    first = Engine(cfg, tree, EngineConfig(dtype="int4", **BUCKET),
                   device="cpu")
    again = Engine(cfg, first.params, EngineConfig(dtype="int4", **BUCKET),
                   device="cpu")
    for pos in ("feed_forward", "feed_forward_macaron"):
        for k in ("w1_q4", "w2_q4", "w1_scale"):
            assert torch.equal(first.params["blocks"][pos][k],
                               again.params["blocks"][pos][k])


# ---------------------------------------------------------------------------
# the build and infer CLIs, the CTC step, AED recognition
# ---------------------------------------------------------------------------

def _write_checkpoint(d):
    sd = {f"encoder.{k}": v for k, v in golden_model().state_dict().items()}
    for i, name in enumerate(DECODERS):
        dec = G.randomize_(G.TransformerDecoder(
            V, 32, attention_heads=4, linear_units=48, num_blocks=1),
            seed=99 + i)
        sd.update({f"{name}.{k}": v for k, v in dec.state_dict().items()})
    torch.save(sd, d / "ckpt.pt")
    raw = small_yaml()
    raw["model_conf"]["decoder_conf"] = {
        "attention_heads": 4, "linear_units": 48, "num_blocks": 1}
    with open(d / "cfg.yaml", "w") as f:
        yaml.safe_dump(raw, f)


def _jax_call(fn, ns):
    cache = jax.config.jax_compilation_cache_dir
    try:
        return fn(ns)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("exmarc")
    _write_checkpoint(d)
    rng = np.random.RandomState(0)
    with ArkWriter(str(d / "feats.ark")) as w:
        for i in range(3):
            w.write(f"utt{i}", rng.randn(30 + 5 * i, 20).astype(np.float32))
    np.save(d / "feat.npy", rng.randn(2, 57, 20).astype(np.float32))
    common = ["-c", str(d / "cfg.yaml"), "-m", str(d / "ckpt.pt"),
              "--buckets", "2x64", "--skip-warmup"]
    t_build.main(common + ["-o", str(d / "port"), "--strict", "--device",
                           "cpu"])
    ns = t_build.parse_args(common + ["-o", str(d / "root")])
    ns.export_platforms = "tpu,cpu"
    _jax_call(j_build.main, ns)
    return d


def test_build_dirs_equal_and_infer_cli_matches_jax(work, capsys):
    """The port's build and the JAX build.py write the same params.npz and
    decoders.npz; the port's infer CLI on its dir prints the JAX engine's
    logits within allclose(1e-5, 1e-3)."""
    for name in ("params.npz", "decoders.npz"):
        with np.load(work / "port" / name) as a, \
                np.load(work / "root" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    feat = np.load(work / "feat.npy")
    ref, _ = JEngine.load(str(work / "root")).infer(
        feat, np.array([57, 57], np.int32))
    np.save(work / "ref.npy", np.asarray(ref))
    capsys.readouterr()
    t_infer.main(["-p", str(work / "port"), "-i", str(work / "feat.npy"),
                  "-o", str(work / "ref.npy"), "--device", "cpu"])
    assert "allclose(rtol=1e-05, atol=1e-03): True" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["-d", "greedy"], ["-d", "beam", "-b", "4"],
                                   ["-d", "rescore", "-b", "4"],
                                   ["-d", "rescore", "-b", "4",
                                    "--hier_rescore"],
                                   ["-d", "attention", "-b", "3"]],
                         ids=["greedy", "beam", "rescore", "hier_rescore",
                              "attention"])
def test_aed_recognition_matches_jax(work, capsys, flags):
    """conformer_aed_fmoeExMarc_localComm_catEmbed with its three AED
    decoders: every recognizer mode prints the JAX recognizer's
    transcripts on the port-built dir."""
    argv = ["-p", str(work / "port"), "-i", str(work / "feats.ark"),
            "--feat_dim", "20", "--batch_size", "2"] + flags
    _jax_call(j_recognize.main, t_recognize.parse_args(argv))
    ref = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    t_recognize.main(argv + ["--device", "cpu"])
    got = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert got == ref and len(got) == 3


def test_ctc_step_matches_jax():
    """The ported hier-MoE CTC step on the ExMarc model: loss and every
    gradient leaf (both expert positions included) against
    jax.value_and_grad of the JAX loss_fn's hier MoE branch, float32: the
    loss within rtol 1e-5, each leaf within 1e-3 of its max|g| plus 1e-5
    of the largest."""
    tree = random_params(2)
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((2, 53, 20)).astype(np.float32)
    lens = np.array([53, 37], np.int32)
    targets = rng.integers(1, V, (2, 5)).astype(np.int32)
    tlens = np.array([5, 3], np.int32)
    # the JAX loss_fn picks its hier MoE branch by proto name and sends
    # the ExMarc names to the dense conformer branch (KeyError on the MoE
    # macaron tree): hold the port to that branch run on the ExMarc config
    jcfg = j_config(small_yaml())
    jcfg.nnet_proto = "conformer_aed_fmoe_localComm_catEmbed"
    assert jcfg.encoder_conf.exmarc
    (ref_loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: j_step.loss_fn(p, jcfg, j_step.TrainConfig(), feat, lens,
                                 targets, tlens), has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    ref = flatten_tree(jax.tree.map(np.asarray, g))
    (loss, _), got = t_step.value_and_grad(
        params_from_jax(tree), t_config(small_yaml()), t_step.TrainConfig(),
        *map(torch.from_numpy, (feat, lens, targets, tlens)))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    assert sorted(got) == sorted(ref)
    assert "blocks/feed_forward_macaron/w1" in got
    top = max(np.abs(r).max() for r in ref.values())
    for k in ref:
        err = np.abs(got[k].numpy() - ref[k]).max()
        assert err <= 1e-3 * np.abs(ref[k]).max() + 1e-5 * top, (k, err)


# ---------------------------------------------------------------------------
# streams are refused
# ---------------------------------------------------------------------------

def test_streams_are_refused_naming_exmarc(work):
    """An ExMarc stream (the JAX chunk block runs the dense FFN on the
    MoE macaron tree and fails): the session, the batcher and the chunk
    forward raise ValueError naming exmarc; the server answers a stream
    start with that reason and still serves offline requests."""
    from m3asr_tpu_torch import serve as t_serve
    cfg = t_config(small_yaml())
    params = params_from_jax(random_params())
    with pytest.raises(ValueError, match="exmarc"):
        t_streaming.check_stream_supported(cfg.encoder_conf)
    with pytest.raises(ValueError, match="exmarc"):
        StreamingSession(params, cfg.encoder_conf, moe=True)
    with pytest.raises(ValueError, match="exmarc"):
        StreamBatcher(params, cfg.encoder_conf, input_dim=20, moe=True,
                      slots=2)
    args = t_serve.parser().parse_args(["-p", str(work / "port"),
                                        "--device", "cpu"])
    state = t_serve._build_runtime(args)
    try:
        assert "exmarc" in state["stream_error"]
        out, out_len = state["engine"].infer(np.load(work / "feat.npy"),
                                             np.array([57, 40], np.int32))
        assert out.shape == (2, 13, V) and np.isfinite(out).all()
    finally:
        state["batcher"].close()
