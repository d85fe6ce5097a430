"""The dense conformer protos of the PyTorch port against the JAX package,
on the CPU: every input layer (conv2d, conv2d6, conv2d8, linear) under
each positional type (rel_pos, abs_pos, no_pos), with and without the
LayerNorm after the input layer; the seeded init; the converter from a
reference-format state dict (bare and AED-wrapped); the family of every
dense proto; the engine through ``build`` / ``Engine`` / ``infer`` in
float32, bf16, flash, fuse_qkv, dense_quant and int8 (which quantizes no
expert: there is none); and the dense streams, which run the conv2d /
rel_pos front end only.

Small encoders: d=32, 4 heads, 48 linear units, 2 blocks, input 20 (40
for the linear front end's own test), vocabulary 11. Parameters are
drawn by the port's init and redrawn from a numpy seed (normal x 0.1,
norm scales about 1), or converted from golden torch modules
(``tests/golden/torch_ref.py``). Tolerances: float32 allclose(rtol 1e-5,
atol 1e-3), the reference's own; bf16 and int8 engines within 0.05 of
max|ref| against JAX in the same mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from golden import torch_ref as G

import build as j_build
from m3asr_tpu.config import EncoderConfig as JEncoderConfig
from m3asr_tpu.config import DENSE_CONFORMER_PROTOS as J_DENSE
from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.models import conformer as j_conformer
from m3asr_tpu.models.registry import get_family as j_family
from m3asr_tpu.ops import masking as j_masking
from m3asr_tpu.runtime import engine as j_engine
from m3asr_tpu.runtime import streaming_session as j_session

from m3asr_tpu_torch import build as t_build
from m3asr_tpu_torch import checkpoint as t_ckpt
from m3asr_tpu_torch import infer as t_infer
from m3asr_tpu_torch.checkpoint import params_to_numpy, to_torch
from m3asr_tpu_torch.config import DENSE_CONFORMER_PROTOS
from m3asr_tpu_torch.config import EncoderConfig
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.models import conformer as t_conformer
from m3asr_tpu_torch.models.registry import get_family as t_family
from m3asr_tpu_torch.runtime import streaming_session as t_session
from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

from test_op_parity import allclose, valid_region
from test_torch_dfsmn_engine import _jax_call

IN, OUT = 20, 11
SMALL = dict(attention_dim=32, attention_heads=4, linear_units=48,
             num_blocks=2)
LAYERS = ("conv2d", "conv2d6", "conv2d8", "linear")
POS = ("rel_pos", "abs_pos", "no_pos")
LENS = np.array([61, 40], np.int32)
BUCKET = dict(bucket_lengths=(64,), bucket_batches=(2,))


def cfgs(**kw):
    kw = dict(SMALL, **kw)
    return JEncoderConfig(**kw), EncoderConfig(**kw)


def redraw(tree, seed):
    """Every float leaf of a numpy tree redrawn from a numpy seed: normal
    x 0.1, norm scales about 1."""
    rng = np.random.default_rng(seed)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        v = rng.standard_normal(node.shape) * 0.1
        if name == "scale":
            v = v + 1.0
        return v.astype(np.float32) if node.dtype.kind == "f" else node
    return walk(tree, "")


def seeded_tree(tcfg, seed, input_dim=IN):
    g = torch.Generator().manual_seed(seed)
    return redraw(params_to_numpy(t_conformer.init(tcfg, input_dim, OUT,
                                                   g)), seed)


def jtree(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype)
                        if a.dtype.kind == "f" else jnp.asarray(a), tree)


def feats(seed=3, T=61, dim=IN):
    return np.random.default_rng(seed).standard_normal((2, T, dim)) \
        .astype(np.float32)


def held(got, ref, lens, fp32):
    g = valid_region(np.asarray(got, np.float32), lens)
    r = valid_region(np.asarray(ref, np.float32), lens)
    if fp32:
        allclose(g, r)
    else:
        assert np.abs(g - r).max() <= 0.05 * np.abs(r).max()


# ---------------------------------------------------------------------------
# front ends, init, converter, families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", POS)
@pytest.mark.parametrize("layer", LAYERS)
def test_forward_matches_jax(layer, pos):
    """Each input layer x positional type (with the LayerNorm after the
    input layer on rel_pos): logits, lengths and the after_norm'd hidden
    equal JAX's on the valid frames."""
    norm = pos == "rel_pos"
    jc, tc = cfgs(input_layer=layer, pos_enc_layer_type=pos,
                  subsampling_feat_norm=norm)
    tree = seeded_tree(tc, LAYERS.index(layer) * 3 + POS.index(pos))
    assert ("subsampling_layer_norm" in tree) == norm
    assert ("linear_pos" in tree["blocks"]["self_attn"]) == (pos != "no_pos")
    x = feats()
    ref = j_conformer.forward(jtree(tree), jc, jnp.asarray(x),
                              jnp.asarray(LENS), output_embed=True)
    got = t_conformer.forward(to_torch(tree), tc, torch.from_numpy(x),
                              torch.from_numpy(LENS), output_embed=True)
    lens = np.asarray(ref[1])
    np.testing.assert_array_equal(got[1].numpy(), lens)
    for g, r in ((got[0], ref[0]), (got[2], ref[2])):
        allclose(valid_region(g.numpy(), lens), valid_region(r, lens))


@pytest.mark.parametrize("pos", POS)
@pytest.mark.parametrize("layer", LAYERS[:3])
def test_init_has_the_jax_tree(layer, pos):
    """The port's seeded init has the JAX init's paths, shapes and dtypes
    (the JAX package has no init for the linear front end)."""
    jc, tc = cfgs(input_layer=layer, pos_enc_layer_type=pos)
    ref = jax.tree_util.tree_flatten_with_path(j_conformer.init(
        jax.random.PRNGKey(0), jc, IN, OUT))[0]
    got = jax.tree_util.tree_flatten_with_path(params_to_numpy(
        t_conformer.init(tc, IN, OUT, torch.Generator().manual_seed(0))))[0]
    assert [(jax.tree_util.keystr(p), np.shape(a)) for p, a in got] == \
        [(jax.tree_util.keystr(p), np.shape(a)) for p, a in ref]


def golden_state_dict(layer, pos, prefix=""):
    """A reference-format state dict of a dense conformer with the given
    input layer, positional type (no_pos: plain attention, no linear_pos
    or pos biases) and a LayerNorm after the input layer."""
    torch.manual_seed(40)
    m = G.randomize_(G.DenseConformer(IN, OUT, **SMALL), seed=41)
    sd = {k: v for k, v in m.state_dict().items()
          if not k.startswith("subsampling.")}
    sub = {"conv2d": lambda: G.Conv2dSubsampling4(IN, 32),
           "conv2d6": lambda: G.Conv2dSubsampling6(IN, 32),
           "conv2d8": lambda: G.Conv2dSubsampling8(IN, 32),
           "linear": lambda: torch.nn.Sequential(torch.nn.Sequential(
               torch.nn.Linear(IN, 32), torch.nn.LayerNorm(32)))[0]}[layer]
    s = G.randomize_(sub(), seed=42)
    prefix_sub = "subsampling.out." if layer == "linear" else "subsampling."
    sd.update({prefix_sub + k: v for k, v in s.state_dict().items()})
    ln = G.randomize_(torch.nn.LayerNorm(32), seed=43)
    sd.update({"subsampling_layer_norm." + k: v
               for k, v in ln.state_dict().items()})
    if pos == "no_pos":
        sd = {k: v for k, v in sd.items()
              if not any(n in k for n in ("linear_pos", "pos_bias"))}
    return {prefix + k: v.numpy() for k, v in sd.items()}


def proto_yaml(proto="conformer", layer="conv2d", pos="rel_pos", **extra):
    enc = dict(SMALL, input_layer=layer, pos_enc_layer_type=pos,
               cnn_module_kernel=15, **extra)
    if "aed" in proto:
        model_conf = {"encoder_conf": enc,
                      "decoder_conf": {"attention_heads": 4,
                                       "linear_units": 48,
                                       "num_blocks": 1}}
    else:
        model_conf = enc
    return {"nnet_proto": proto, "input_dim": IN, "output_dim": OUT,
            "model_conf": model_conf}


@pytest.mark.parametrize("proto,layer,pos", [
    ("conformer", "conv2d", "rel_pos"), ("conformer2", "conv2d6", "abs_pos"),
    ("conformer_embed", "conv2d8", "no_pos"),
    ("conformer_aed", "linear", "rel_pos")])
def test_convert_matches_jax(proto, layer, pos):
    """A reference state dict (bare, or under the AED wrapper's
    ``encoder.`` prefix) through both families' converters: the same
    tree, leaf for leaf, the front end's LayerNorm included; its forward
    (subsampling_feat_norm on) equals JAX's."""
    raw = proto_yaml(proto, layer, pos, subsampling_feat_norm=True)
    sd = golden_state_dict(layer, pos,
                           "encoder." if "aed" in proto else "")
    mj, mt = j_config(raw), t_config(raw)
    ref = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        np.asarray, j_family(proto).convert(dict(sd), mj)))[0]
    tree = t_family(proto).convert(dict(sd), mt)
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in ref]
    for (_, a), (p, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))
    x = feats(T=61)
    r = j_family(proto).forward(jtree(tree), mj, jnp.asarray(x),
                                jnp.asarray(LENS))
    o = t_family(proto).forward(to_torch(tree), mt, torch.from_numpy(x),
                                torch.from_numpy(LENS))
    lens = np.asarray(r[1])
    allclose(valid_region(o[0].numpy(), lens), valid_region(r[0], lens))


@pytest.mark.parametrize("proto", sorted(J_DENSE))
def test_every_dense_proto_resolves(proto):
    """Every dense proto: the config parses in both packages to the same
    encoder settings and resolves to the conformer family in both."""
    assert proto in DENSE_CONFORMER_PROTOS
    raw = proto_yaml(proto)
    assert t_family(proto).name == j_family(proto).name == "conformer"
    ej, et = j_config(raw).encoder_conf, t_config(raw).encoder_conf
    for name in ("attention_dim", "num_blocks", "input_layer",
                 "pos_enc_layer_type", "linear_units"):
        assert getattr(ej, name) == getattr(et, name)


def test_other_front_end_names_raise():
    _, tc = cfgs(input_layer="conv3d")
    with pytest.raises(ValueError, match="input_layer"):
        t_conformer.check_supported(tc)
    with pytest.raises(ValueError, match="input_layer"):
        t_ckpt.convert_subsampling(t_ckpt.StateDict({}), "conv3d")


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _write(tmp_path, layer="conv2d", pos="rel_pos"):
    sd = golden_state_dict(layer, pos)
    del sd["subsampling_layer_norm.weight"], sd["subsampling_layer_norm.bias"]
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "ckpt.pt")
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump(proto_yaml(layer=layer, pos=pos), f)
    return str(tmp_path / "ckpt.pt"), str(tmp_path / "cfg.yaml")


MODES = {"float32": [], "bfloat16": ["-f"], "int8": ["--int8"]}


@pytest.mark.parametrize("mode", list(MODES))
def test_build_infer_cli_matches_jax(mode, tmp_path, capsys):
    """The port's build CLI (--strict) and the JAX build.py write engine
    dirs of the same paths and values; the port's engine answers as the
    JAX engine (int8: no experts, so a bf16 engine); each dir loads in the
    other package; the port's infer CLI checks its output against a saved
    reference (float32)."""
    ckpt, cfg = _write(tmp_path)
    args = ["-c", cfg, "-m", ckpt, "--buckets", "2x64", "--skip-warmup",
            *MODES[mode]]
    t_build.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu",
                         "--strict"])
    ns = t_build.parse_args(args + ["-o", str(tmp_path / "jax")])
    ns.export_platforms = "tpu,cpu"
    _jax_call(j_build.main, ns)
    with np.load(tmp_path / "port" / "params.npz") as a, \
            np.load(tmp_path / "jax" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    x = feats()
    port = Engine.load(str(tmp_path / "port"), device="cpu")
    jeng = _jax_call(j_engine.Engine.load, str(tmp_path / "jax"))
    ref = jeng.infer(x, LENS)
    got = port.infer(x, LENS)
    np.testing.assert_array_equal(got[1], ref[1])
    held(got[0], ref[0], ref[1], mode == "float32")
    cross = Engine.load(str(tmp_path / "jax"), device="cpu").infer(x, LENS)
    np.testing.assert_array_equal(cross[0], got[0])
    if mode == "float32":
        np.save(tmp_path / "feat.npy", x[0])
        np.save(tmp_path / "ref.npy", ref[0][:1])
        capsys.readouterr()
        t_infer.main(["-p", str(tmp_path / "port"), "-i",
                      str(tmp_path / "feat.npy"), "-o",
                      str(tmp_path / "ref.npy"), "-d", "greedy",
                      "--device", "cpu"])
        out = capsys.readouterr().out
        assert "allclose(rtol=1e-05, atol=1e-03): True" in out


@pytest.mark.parametrize("settings", [
    dict(attn_impl="flash"), dict(fuse_qkv=True),
    dict(dense_quant=True, dtype="bfloat16"),
    dict(return_hidden=True, decode_output="argmax"),
    dict(attn_impl="flash", dtype="bfloat16")])
def test_engine_settings_match_jax(settings):
    """Engines on converted weights with flash (K2's plain version against
    JAX's kernel in interpret mode), fuse_qkv, dense_quant, the hidden
    and argmax outputs: each against the JAX engine with the same
    settings."""
    raw = proto_yaml()
    params = j_family("conformer").convert(golden_state_dict("conv2d",
                                                             "rel_pos"),
                                           j_config(raw))
    jeng = j_engine.Engine(j_config(raw), params, j_engine.EngineConfig(
        donate_input=False, **BUCKET, **settings))
    eng = Engine(t_config(raw), jax.tree.map(np.asarray, params),
                 EngineConfig(**BUCKET, **settings), device="cpu")
    x = feats()
    ref, got = jeng.infer(x, LENS), eng.infer(x, LENS)
    fp32 = settings.get("dtype", "float32") == "float32"
    np.testing.assert_array_equal(got[1], ref[1])
    if settings.get("decode_output") == "argmax":
        lens = ref[1]
        for a, b in zip(valid_region(got[0], lens), valid_region(ref[0],
                                                                 lens)):
            np.testing.assert_array_equal(a, b)
        held(got[3], ref[3], lens, True)
    else:
        held(got[0], ref[0], ref[1], fp32)


def test_port_init_serves_every_front_end():
    """Engines on the port's seeded init for conv2d6 / abs_pos and linear
    / no_pos with the front end's LayerNorm: finite logits of the
    subsampled lengths, equal to the family's forward called directly."""
    for layer, pos in (("conv2d6", "abs_pos"), ("linear", "no_pos")):
        raw = proto_yaml(layer=layer, pos=pos, subsampling_feat_norm=True)
        mc = t_config(raw)
        params = t_family("conformer").init(mc,
                                            torch.Generator().manual_seed(5))
        assert "subsampling_layer_norm" in params
        eng = Engine(mc, params, EngineConfig(**BUCKET), device="cpu")
        x = feats()
        out, out_len = eng.infer(x, LENS)
        want = {"conv2d6": np.asarray(j_masking.subsampling6_length(
            jnp.asarray(LENS))), "linear": LENS}[layer]
        np.testing.assert_array_equal(out_len, want)
        direct = t_conformer.forward(params, mc.encoder_conf,
                                     torch.from_numpy(x),
                                     torch.from_numpy(LENS))[0].numpy()
        held(out, direct, out_len, True)
        assert eng.subsample_factor() == {"conv2d6": 6, "linear": 1}[layer]


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def test_dense_stream_matches_jax_session():
    """A dense conformer (conv2d, rel_pos) StreamingSession with moe=False,
    chunk 4, two left chunks, pushed in pieces: equal to the JAX
    session."""
    raw = proto_yaml()
    tree = jax.tree.map(np.asarray, j_family("conformer").convert(
        golden_state_dict("conv2d", "rel_pos"), j_config(raw)))
    x = feats(7, T=120)[:1]
    js = j_session.StreamingSession(jtree(tree), j_config(raw).encoder_conf,
                                    chunk_size=4, num_left_chunks=2)
    ts = t_session.StreamingSession(to_torch(tree),
                                    t_config(raw).encoder_conf,
                                    chunk_size=4, num_left_chunks=2)
    outs = {}
    for name, s in (("jax", js), ("port", ts)):
        o, i = [], 0
        for n in (23, 40, 9, 48):
            o += s.push(x[:, i:i + n])
            i += n
        o += s.finish()
        outs[name] = np.concatenate(o, 1)
    assert outs["port"].shape == outs["jax"].shape
    allclose(outs["port"], outs["jax"])


@pytest.mark.parametrize("setting", [
    dict(input_layer="conv2d6"), dict(input_layer="linear"),
    dict(pos_enc_layer_type="abs_pos"), dict(pos_enc_layer_type="no_pos"),
    dict(subsampling_feat_norm=True)])
def test_streams_refuse_other_front_ends(setting):
    """The chunk forwards run conv2d with rel_pos and no front-end norm
    (the JAX chunk front end runs that whatever the config says): a
    session, a batcher and the server refuse any other with ValueError
    naming the setting."""
    from m3asr_tpu_torch.runtime.streaming_batch import StreamBatcher
    import m3asr_tpu_torch.serve as serve
    raw = proto_yaml(**setting) if "input_layer" not in setting and \
        "pos_enc_layer_type" not in setting else proto_yaml(
            layer=setting.get("input_layer", "conv2d"),
            pos=setting.get("pos_enc_layer_type", "rel_pos"))
    mc = t_config(raw)
    params = t_family("conformer").init(mc, torch.Generator().manual_seed(6))
    name = next(iter(setting))
    with pytest.raises(ValueError, match=name):
        t_session.StreamingSession(params, mc.encoder_conf)
    with pytest.raises(ValueError, match=name):
        StreamBatcher(params, mc.encoder_conf, input_dim=IN)
    eng = Engine(mc, params, EngineConfig(**BUCKET), device="cpu")
    args = serve.parser().parse_args(["-p", "unused"])
    state = serve._build_runtime(args, engine=eng)
    state["batcher"].close()
    assert state["stream_pool"] is None and name in state["stream_error"]


def test_server_streams_dense_conformer_engines():
    """A dense conformer engine served in process gets a StreamBatcher
    (moe=False) per (chunk, left); a stream's greedy partials equal the
    ones decoded from a direct single session's logits."""
    import m3asr_tpu_torch.serve as serve
    from m3asr_tpu_torch.runtime.streaming_batch import (
        BatchedStreamingSession)
    raw = proto_yaml()
    mc = t_config(raw)
    params = to_torch(jax.tree.map(np.asarray, j_family("conformer").convert(
        golden_state_dict("conv2d", "rel_pos"), j_config(raw))))
    eng = Engine(mc, params, EngineConfig(**BUCKET), device="cpu")
    args = serve.parser().parse_args(["-p", "unused", "--stream_slots", "2",
                                      "--stream_topk", "0"])
    state = serve._build_runtime(args, engine=eng)
    try:
        sess = state["stream_pool"].acquire((4, 2))
        assert isinstance(sess, BatchedStreamingSession)
        assert not sess.batcher.moe
        x = feats(8, T=90)[:1]
        dec = serve._StreamDecode(sess)
        dec.update(sess.push(x[:, :50]))
        dec.update(sess.push(x[:, 50:]))
        dec.update(sess.finish())
        direct = t_session.StreamingSession(eng.params, mc.encoder_conf,
                                            chunk_size=4, num_left_chunks=2)
        ref = serve._StreamDecode(None)
        ref.update(direct.push(x) + direct.finish())
        assert dec.frames == ref.frames > 0
        assert dec.result() == ref.result()
    finally:
        state["batcher"].close()
        for b in state["stream_batchers"].values():
            b.close()
