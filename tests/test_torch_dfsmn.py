"""The DFSMN families of the PyTorch port against the JAX package.

Layers (cFSMN in its first and skip forms, the memory-slot attention
with and without a chunk mask, ``flash_attn_mem`` on K2's plain version
against the JAX kernel in interpret mode), the MoE cFSMN layer under
every name of its expert-stage table, the ReLU + clamp plain versions of
K1 and K4-K7 against the JAX kernels (interpret mode) under skewed
routing, experts with no tokens and a layer index, and the six protos'
forwards from golden torch state dicts (``tests/golden/torch_ref.py``)
converted by both packages' converters.

Inputs are made from numpy seeds. Small sizes: memory 16-32, hidden
24-64, 4 heads, 8 memory slots, 2 blocks of 2-3 cFSMN, 4 experts, T <=
48. Tolerances: float32 allclose(rtol 1e-5, atol 1e-3), the reference's
own; quantized stages within 0.05 of max|ref| against JAX in the same
mode; the kernels' plain versions at the JAX package's own kernel bounds
(stated at each)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import torch_ref as G

from m3asr_tpu import checkpoint as j_ckpt
from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.models import dfsmn as j_dfsmn
from m3asr_tpu.models.registry import get_family as j_family
from m3asr_tpu.ops import positional as j_pos
from m3asr_tpu.ops import quant as j_quant
from m3asr_tpu.ops.masking import subsequent_chunk_mask as j_chunk_mask
from m3asr_tpu.ops.pallas_attention import flash_attn_mem as j_flash_mem
from m3asr_tpu.ops.pallas_moe_q4 import (moe_experts_pallas_q4,
                                         moe_experts_pallas_q4_tiled)
from m3asr_tpu.ops.pallas_moe_runs import moe_experts_pallas_runs

from m3asr_tpu_torch import checkpoint as t_ckpt
from m3asr_tpu_torch.checkpoint import params_from_jax
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.models import dfsmn as t_dfsmn
from m3asr_tpu_torch.models.registry import get_family as t_family
from m3asr_tpu_torch.ops.flash_attention import flash_attn_mem
from m3asr_tpu_torch.ops.moe_q4 import q4_kernel, q4_tiled_kernel
from m3asr_tpu_torch.ops.moe_runs import (runs_kernel, runs_q4_kernel,
                                          runs_q8_kernel)

from test_op_parity import allclose, valid_region
import test_torch_quant as TQ
import test_torch_stages as TS

LENS = np.array([23, 15], np.int32)
ROUTER_SCALE = 5.0


def tree_j(tree, dtype=jnp.float32):
    """A numpy tree (lists kept) as JAX arrays, float leaves in dtype."""
    return jax.tree.map(lambda a: jnp.asarray(a, dtype)
                        if a.dtype.kind == "f" else jnp.asarray(a), tree)


def redrawn(tree, seed):
    """Every float leaf of a JAX init tree redrawn from a numpy seed:
    normal x 0.1, norm scales about 1, routers normal x ROUTER_SCALE. The
    routers are decisive so that no token sits at a near-tie of two
    experts, where float rounding (bf16, and JAX's jit against eager)
    picks either."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        a = np.asarray(a)
        v = rng.standard_normal(a.shape) * (
            ROUTER_SCALE if "router" in name else 0.1)
        if name.endswith("scale"):
            v = v + 1.0
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def valid(a, lens=LENS):
    return valid_region(np.asarray(a, np.float32), lens)


def golden_cfsmn(first, seed):
    in_dim = 12 if first else 16
    return G.randomize_(G.CFSMNLayer(in_dim, 24, 16, skip_connect=not first,
                                     upper_bound=None if first else 1.0),
                        seed=seed), in_dim


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first", [True, False])
def test_cfsmn_layer_matches_jax(first):
    """cFSMN layer (0, 0) (no skip, no clamp) and a later one (skip,
    clamp at 1.0) from a golden layer's state dict through both
    converters, with mixed lengths: the port equals JAX and the golden
    torch layer on the valid frames."""
    m, in_dim = golden_cfsmn(first, 30 + first)
    x = np.random.default_rng(31).standard_normal(
        (2, 23, in_dim)).astype(np.float32)
    cfg_j = j_dfsmn.FsmnConfig(upper_bound=None if first else 1.0,
                               skip_connect=not first)
    cfg_t = t_dfsmn.FsmnConfig(upper_bound=None if first else 1.0,
                               skip_connect=not first)
    jp = j_ckpt.convert_cfsmn(j_ckpt.StateDict(m.state_dict()))
    tp = t_ckpt.to_torch(t_ckpt.convert_cfsmn(
        t_ckpt.StateDict(m.state_dict())))
    ref = j_dfsmn.cfsmn_layer(tree_j(jp), jnp.asarray(x), jnp.asarray(LENS),
                              cfg_j)
    got = t_dfsmn.cfsmn_layer(tp, torch.from_numpy(x),
                              torch.from_numpy(LENS), cfg_t)
    allclose(valid(got), valid(ref))
    with torch.no_grad():
        gold = m(torch.from_numpy(x), torch.from_numpy(LENS))
    allclose(valid(got), valid(gold))


@pytest.mark.parametrize("chunk", [None, 4])
def test_attn_mem_layer_matches_jax(chunk):
    """The memory-slot attention (plain path) from a golden layer, with
    mixed lengths, with and without a (T, T) chunk mask: the port equals
    JAX; unmasked, the golden torch layer too."""
    m = G.randomize_(G.AttnMemLayer(16, 4, 8), seed=32)
    x = np.random.default_rng(33).standard_normal((2, 23, 16)) \
        .astype(np.float32)
    jp = j_ckpt.convert_attn_mem(j_ckpt.StateDict(m.state_dict()))
    tp = t_ckpt.to_torch(t_ckpt.convert_attn_mem(
        t_ckpt.StateDict(m.state_dict())))
    mask = None if chunk is None else np.array(j_chunk_mask(23, chunk))
    ref = j_dfsmn.attn_mem_layer(
        tree_j(jp), jnp.asarray(x), jnp.asarray(LENS), 4, 8,
        attn_mask=None if mask is None else jnp.asarray(mask))
    got = t_dfsmn.attn_mem_layer(
        tp, torch.from_numpy(x), torch.from_numpy(LENS), 4, 8,
        attn_mask=None if mask is None else torch.from_numpy(mask))
    allclose(valid(got), valid(ref))
    if chunk is None:
        with torch.no_grad():
            gold = m(torch.from_numpy(x), torch.from_numpy(LENS))
        allclose(valid(got), valid(gold))


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("lengths", [True, False])
def test_flash_attn_mem_matches_jax_kernel(chunk, lengths):
    """flash_attn_mem on K2's plain version (CPU) against the JAX
    flash_attn_mem in interpret mode, with and without lengths and a
    4-frame chunk window (memory slots attendable to every row): float32
    sums in another order, rtol 1e-5 / atol 1e-5; and within the same
    bound of the port's plain attention."""
    m = G.randomize_(G.AttnMemLayer(16, 4, 8), seed=34)
    x = np.random.default_rng(35).standard_normal((2, 23, 16)) \
        .astype(np.float32)
    jp = j_ckpt.convert_attn_mem(j_ckpt.StateDict(m.state_dict()))
    tp = t_ckpt.to_torch(t_ckpt.convert_attn_mem(
        t_ckpt.StateDict(m.state_dict())))
    mask = None if chunk is None else np.array(j_chunk_mask(23, chunk))
    lens = LENS if lengths else np.array([23, 23], np.int32)
    ref = j_flash_mem(tree_j(jp), jnp.asarray(x),
                      jnp.asarray(LENS) if lengths else None, 4, 8,
                      interpret=True,
                      attn_mask=None if mask is None else jnp.asarray(mask))
    tmask = None if mask is None else torch.from_numpy(mask)
    tlen = torch.from_numpy(LENS) if lengths else None
    got = flash_attn_mem(tp, torch.from_numpy(x), tlen, 4, 8,
                         attn_mask=tmask)
    np.testing.assert_allclose(valid(got, lens), valid(ref, lens),
                               rtol=1e-5, atol=1e-5)
    plain = t_dfsmn.attn_mem_layer(tp, torch.from_numpy(x), tlen, 4, 8,
                                   attn_mask=tmask)
    np.testing.assert_allclose(valid(got, lens), valid(plain, lens),
                               rtol=1e-5, atol=1e-5)


def test_position_table_past_max_len():
    """The DFSMN forward adds positions past the 5000 rows of the JAX
    package's table (whose DFSMN forward cannot run T > 5000): rows
    below 5000 are JAX's, and the extended table is the same formula."""
    pe = t_dfsmn.position_table(16, 6144, torch.float32, "cpu")
    assert pe.shape == (6144, 16)
    np.testing.assert_array_equal(pe[:5000].numpy(),
                                  np.asarray(j_pos.sinusoid_table(16)))
    np.testing.assert_array_equal(
        pe.numpy(), np.asarray(j_pos.sinusoid_table(16, max_len=6144)))


# ---------------------------------------------------------------------------
# the MoE cFSMN layer under its stage table
# ---------------------------------------------------------------------------

def _quant_bits(impl):
    if impl.startswith("quant4"):
        return 4
    return 8 if impl.startswith("quant") else None


# (ln_before_router, keep_expert_output) cycled over the stages
_LAYER_FLAGS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("impl", t_dfsmn.DFSMN_MOE_STAGES)
def test_cfsmn_moe_layer_every_stage(impl):
    """The MoE cFSMN layer (d=32, h=64, embed 16, 4 experts, relu
    clamped at 1.0, w1 redrawn x 3 so that many hidden values reach the
    clamp) under each name of the DFSMN dispatch table, with
    ln_before_router and keep_expert_output cycled over the names, mixed
    lengths. Quantized names take the weights as the JAX package
    quantizes them (int4 names int4, the rest int8). float32: allclose
    (1e-5, 1e-3); quantized: within 0.05 of max|ref| (the Pallas kernels'
    own float rounding, and a8's steps)."""
    ln, keep = _LAYER_FLAGS[t_dfsmn.DFSMN_MOE_STAGES.index(impl) % 4]
    jp = redrawn(j_dfsmn.init_cfsmn_moe(jax.random.PRNGKey(0), 32, 64, 16,
                                        4, 4, 1, ln_before_router=ln,
                                        rand_init_router=True), 36)
    jp["w1"] = jp["w1"] * 3
    bits = _quant_bits(impl)
    if bits is not None:
        jp = jax.tree.map(np.asarray, j_quant.quantize_moe_params(
            tree_j(jp), bits=bits))
    rng = np.random.default_rng(37)
    x = rng.standard_normal((2, 23, 32)).astype(np.float32)
    emb = rng.standard_normal((2, 23, 16)).astype(np.float32)
    jcfg = j_dfsmn.FsmnConfig(upper_bound=1.0, skip_connect=True)
    tcfg = t_dfsmn.FsmnConfig(upper_bound=1.0, skip_connect=True)
    ref = j_dfsmn.cfsmn_moe_layer(
        tree_j(jp), jnp.asarray(x), jnp.asarray(emb), jnp.asarray(LENS),
        jcfg, moe_impl=impl, ln_before_router=ln, keep_expert_output=keep)
    got = t_dfsmn.cfsmn_moe_layer(
        params_from_jax(jp), torch.from_numpy(x), torch.from_numpy(emb),
        torch.from_numpy(LENS), tcfg, moe_impl=impl, ln_before_router=ln,
        keep_expert_output=keep)
    if bits is None:
        allclose(valid(got), valid(ref))
    else:
        r = valid(ref)
        assert np.abs(valid(got) - r).max() <= 0.05 * np.abs(r).max()


@pytest.mark.parametrize("impl", ["pallas", "capacity", "ragged_padded",
                                  "quant_capacity", "quant_pallas", "bogus"])
def test_cfsmn_moe_layer_refuses_names_outside_table(impl):
    """Names outside the DFSMN table raise ValueError, as in JAX (which
    lists the table in its message)."""
    jp = redrawn(j_dfsmn.init_cfsmn_moe(jax.random.PRNGKey(1), 32, 64, 16,
                                        4, 4, 1), 38)
    x = jnp.zeros((1, 5, 32))
    cfg = j_dfsmn.FsmnConfig(upper_bound=1.0, skip_connect=True)
    with pytest.raises(ValueError, match="DFSMN-MoE"):
        j_dfsmn.cfsmn_moe_layer(tree_j(jp), x, jnp.zeros((1, 5, 16)), None,
                                cfg, moe_impl=impl)
    with pytest.raises(ValueError, match="DFSMN-MoE"):
        t_dfsmn.cfsmn_moe_layer(
            params_from_jax(jp), torch.zeros(1, 5, 32),
            torch.zeros(1, 5, 16), None,
            t_dfsmn.FsmnConfig(upper_bound=1.0, skip_connect=True),
            moe_impl=impl)


# ---------------------------------------------------------------------------
# ReLU + clamp plain versions of K1 and K4-K7 against the JAX kernels
# ---------------------------------------------------------------------------

# kernel -> (weights, a8)
RELU_KERNELS = {"K1": ("f", False), "K4": (8, False), "K4 a8": (8, True),
                "K5": (4, False), "K5 a8": (4, True), "K6": ("q4d", False),
                "K6 a8": ("q4d", True), "K7": ("q4t", False),
                "K7 a8": ("q4t", True)}
UPPER = 1.0


def _layer_slice(tree, layer, weights):
    """This layer's scales (the weights stay stacked)."""
    return {k: v[layer] if k.endswith("_scale") and k not in weights else v
            for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["skewed", "gap", "layer"])
@pytest.mark.parametrize("kernel", list(RELU_KERNELS))
def test_relu_kernel_plain_matches_jax(kernel, kind):
    """The ReLU instantiations' plain versions, hidden clamped at 1.0,
    against the JAX kernels with activation=relu and upper_bound (interpret
    mode): skewed routing, experts with no tokens, and stacked (L, E, ...)
    weights with a layer index. Bounds, as for their SiLU forms
    (tests/test_torch_moe.py, test_torch_quant.py, test_torch_stages.py):
    K1 float32 rtol 1e-5 / atol 1e-6; weight-only int rtol 1e-3 / atol
    1e-4 (K7's rtol 1e-5 / atol 1e-5); a8 one hidden step, 3e-2 max|y| /
    127."""
    fmt, a8 = RELU_KERNELS[kernel]
    L = 2 if kind == "layer" else None
    kw = {} if L is None else {"layer": 1}
    jkw = {k: jnp.int32(v) for k, v in kw.items()}
    relu = dict(activation=jax.nn.relu, upper_bound=UPPER)
    trelu = dict(activation="relu", upper_bound=UPPER)
    route = "skewed" if kind == "layer" else kind
    if fmt in ("f", 8, 4, "q4d"):
        p = TQ.float_experts(40, L=L)
        p["w1"] = p["w1"] * 8          # hidden values past the clamp
        rng = np.random.default_rng(41)
        x = rng.standard_normal((1, 40, TQ.D)).astype(np.float32)
        gate = TQ.routing(route, 40, 42)[None].astype(np.int32)
        if fmt == "f":
            jp, tp = tree_j(p), params_from_jax(p)
        else:
            jp, tp = TQ.quantized(p, 8 if fmt == 8 else 4)
            wk = ("w1_q", "w2_q") if fmt == 8 else ("w1_q4", "w2_q4")
            if L is not None:
                jp, tp = _layer_slice(jp, 1, wk), _layer_slice(tp, 1, wk)
        if fmt == "q4d":
            ref = moe_experts_pallas_q4(jp, jnp.asarray(x),
                                        jnp.asarray(gate), chunk=2,
                                        act_quant=a8, interpret=True,
                                        **relu, **jkw)
            got = q4_kernel(tp, torch.from_numpy(x), torch.from_numpy(gate),
                            act_quant=a8, **trelu, **kw)
        else:
            ref = moe_experts_pallas_runs(jp, jnp.asarray(x),
                                          jnp.asarray(gate), tile=16,
                                          chunk=2, act_quant=a8,
                                          interpret=True, **relu, **jkw)
            kern = {"f": runs_kernel, 8: runs_q8_kernel,
                    4: runs_q4_kernel}[fmt]
            got = kern(tp, torch.from_numpy(x), torch.from_numpy(gate),
                       act_quant=a8, **trelu, **kw)
        tol = (dict(rtol=1e-5, atol=1e-6) if fmt == "f"
               else TQ._tol(np.asarray(ref), a8))
    else:
        p = TS.experts(43, L=L)
        p["w1"] = p["w1"] * 8
        jp, tp = TS.quantized(p, 4)
        if L is not None:
            wk = ("w1_q4", "w2_q4")
            jp, tp = _layer_slice(jp, 1, wk), _layer_slice(tp, 1, wk)
        x = TS.inputs(44)
        gate = TS.routing(route, (2, 13), 45)
        ref = moe_experts_pallas_q4_tiled(jp, jnp.asarray(x),
                                          jnp.asarray(gate), tile=64,
                                          act_quant=a8, interpret=True,
                                          **relu, **jkw)
        got = q4_tiled_kernel(tp, torch.from_numpy(x),
                              torch.from_numpy(gate), tile=64, act_quant=a8,
                              **trelu, **kw)
        tol = TS._tol(np.asarray(ref), a8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    for k in (runs_kernel, runs_q8_kernel, runs_q4_kernel, q4_kernel,
              q4_tiled_kernel):
        assert k.launches == 0          # the CPU takes the plain versions


def test_relu_a8_zero_hidden_rows_take_unit_scale():
    """a8 with ReLU: a row whose hidden is all zero after the ReLU (here
    every b1 very negative) takes the activation scale 1.0, as the JAX
    kernel's _quant_rows does, and comes out exactly zero (no bias on
    w2), with no NaN."""
    p = TQ.float_experts(46)
    p["b1"] = np.full_like(p["b1"], -1e3)
    p.pop("b2")
    _, tp = TQ.quantized(p, 8)
    x = torch.from_numpy(np.random.default_rng(47).standard_normal(
        (1, 20, TQ.D)).astype(np.float32))
    gate = torch.from_numpy(TQ.routing("skewed", 20, 48)[None]
                            .astype(np.int32))
    got = runs_q8_kernel(tp, x, gate, act_quant=True, activation="relu",
                         upper_bound=1.0)
    assert torch.isfinite(got).all() and (got == 0).all()


def test_kernels_refuse_clamped_silu_on_the_card_path():
    """K1 and K4-K6 compile the clamp into their ReLU instantiations
    only: a SiLU call with upper_bound raises before any launch (and an
    unknown activation raises everywhere)."""
    from m3asr_tpu_torch.ops.moe_runs import kernel_act
    assert kernel_act("relu", 1.0) == (2, 1, 1.0)
    assert kernel_act("swish", None) == (1, 0, 0.0)
    with pytest.raises(ValueError, match="ReLU"):
        kernel_act("swish", 1.0)
    with pytest.raises(ValueError, match="activation"):
        kernel_act("gelu", None)


# ---------------------------------------------------------------------------
# the six protos, from golden state dicts through both converters
# ---------------------------------------------------------------------------

IN, OUT = 12, 7
SAN = dict(num_block=2, fsmn_each_block=3, hidden_dim=32, memory_dim=16,
           num_head=4, num_memory=8)
EMBED = dict(num_block=1, fsmn_each_block=2, hidden_dim=24, memory_dim=16,
             num_head=4, num_memory=8)


def proto_yaml(proto):
    conf = {"fsmn_layers": 3, "hidden_dim": 32, "memory_dim": 16} \
        if proto == "dfsmn_base_res" else dict(SAN)
    if "fmoe" in proto:
        conf = {"num_block": 2, "fsmn_each_block": 3,
                "fsmn_conf": {"hidden_dim": 32, "memory_dim": 16},
                "san_conf": {"num_head": 4, "num_memory": 8},
                "moe_conf": {"num_experts": 4}, "embed_conf": dict(EMBED)}
    return {"nnet_proto": proto, "input_dim": IN, "output_dim": OUT,
            "model_conf": conf}


def _prefixed(prefix, module):
    return {f"{prefix}{k}": v for k, v in module.state_dict().items()}


def golden_state_dict(proto, seed=50):
    """A reference state dict of the proto, assembled from the golden
    torch modules (random values), and the golden Net where there is
    one."""
    torch.manual_seed(seed)
    if proto == "dfsmn_base_res":
        sd = {}
        for i in range(3):
            m = G.randomize_(G.CFSMNLayer(IN if i == 0 else 16, 32, 16,
                                          skip_connect=i > 0,
                                          upper_bound=None if i == 0
                                          else 1.0), seed=seed + i)
            sd.update(_prefixed(f"fsmn_layers.{i}.", m))
        out = G.randomize_(torch.nn.Linear(16, OUT), seed=seed + 9)
        sd.update(_prefixed("out_linear.", out))
        return sd, None
    if proto == "dfsmn_san_res_embed_domain_acc":
        net = G.randomize_(G.DfsmnSanDomainAccNet(IN, OUT, **SAN), seed)
        return net.state_dict(), net
    if "fmoe" not in proto:
        net = G.randomize_(G.DfsmnSanNet(IN, OUT, **SAN), seed)
        return net.state_dict(), net
    embed = G.randomize_(G.DfsmnSanNet(IN, OUT, **EMBED), seed)
    sd = _prefixed("embed.", embed)
    for i in range(2):
        for j in range(3):
            pre = f"blocks_sw.{i}.fsmn_layers.{j}."
            if i == 0 and j == 0:
                m = G.CFSMNLayer(IN, 32, 16)
            else:
                m = G.CFSMNMoELayer(16, 16, 32, 4)
            m = G.randomize_(m, seed=seed + 10 * i + j + 1)
            if hasattr(m, "rooter_weights"):
                with torch.no_grad():      # decisive routers (redrawn)
                    m.rooter_weights.mul_(ROUTER_SCALE / 0.1)
            sd.update(_prefixed(pre, m))
        attn = G.randomize_(G.AttnMemLayer(16, 4, 8), seed=seed + 30 + i)
        sd.update(_prefixed(f"blocks_sw.{i}.attn_layer.attn_layer.", attn))
        ln = G.randomize_(torch.nn.LayerNorm(16), seed=seed + 40 + i)
        sd.update(_prefixed(f"blocks_sw.{i}.attn_layer.ln_layer.", ln))
    sd.update(_prefixed("out_linear_sw.", G.randomize_(
        torch.nn.Linear(16, OUT), seed=seed + 50)))
    return sd, None


PROTOS = ["dfsmn_base_res", "dfsmn_san_res", "dfsmn_san_res_embed",
          "dfsmn_san_res_embed_domain_acc",
          "dfsmn_base_fmoe_localComm_catEmbed",
          "dfsmn_san_fmoe_localComm_catEmbed"]


@pytest.mark.parametrize("proto", PROTOS)
def test_proto_forward_matches_jax(proto):
    """Each proto's forward from a golden state dict converted by both
    packages' converters (the port's consuming every key), with mixed
    lengths: logits, the pre-out_linear hidden (but dfsmn_base_res, which
    refuses one in both), the domain/accent pooled heads, against JAX;
    the golden Net's logits where there is one (at full length for the
    domain/accent proto, whose reference pools over padding)."""
    raw = proto_yaml(proto)
    jc, tc = j_config(raw), t_config(raw)
    sd, net = golden_state_dict(proto)
    jp = j_family(proto).convert(sd, jc)
    tracked = t_ckpt.TrackedDict({k: v.numpy() for k, v in sd.items()})
    tp = t_ckpt.to_torch(t_family(proto).convert(tracked, tc))
    assert t_ckpt.unconsumed_keys(tracked) == []
    x = np.random.default_rng(51).standard_normal((2, 23, IN)) \
        .astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jl, tl = jnp.asarray(LENS), torch.from_numpy(LENS)
    kw = {"moe_impl": "dense"} if "fmoe" in proto else {}
    hid = "return_hidden" if "fmoe" in proto else "output_embed"
    with torch.inference_mode():
        got = t_family(proto).forward(tp, tc, tx, tl, **kw)
        ref = j_family(proto).forward(jp, jc, jx, jl, **kw)
        allclose(valid(got[0]), valid(ref[0]))
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
        if proto == "dfsmn_base_res":
            for fam, p, c, a, b in ((t_family, tp, tc, tx, tl),
                                    (j_family, jp, jc, jx, jl)):
                with pytest.raises(ValueError, match="dfsmn_base_res"):
                    fam(proto).forward(p, c, a, b, **{hid: True})
        else:
            g = t_family(proto).forward(tp, tc, tx, tl, **kw, **{hid: True})
            r = j_family(proto).forward(jp, jc, jx, jl, **kw, **{hid: True})
            assert len(g) == len(r) == 3
            allclose(valid(g[2]), valid(r[2]))
        if proto == "dfsmn_san_res_embed_domain_acc":
            g = t_family(proto).forward(tp, tc, tx, tl, domain_acc=True)
            r = j_family(proto).forward(jp, jc, jx, jl, domain_acc=True)
            for a, b in zip(g[2:], r[2:]):
                allclose(a, b)
        if net is not None:
            full = np.array([23, 23], np.int32)
            gold = net(tx, torch.from_numpy(full))[0]
            mine = t_family(proto).forward(tp, tc, tx,
                                           torch.from_numpy(full))[0]
            allclose(mine, gold)


@pytest.mark.parametrize("proto", PROTOS)
def test_proto_init_tree_matches_jax(proto):
    """The port's seeded init gives the JAX init's tree: the same paths,
    shapes and per-layer lists (so a synthetic model is the converter's
    tree), with the routers zero unless rand_init_router."""
    raw = proto_yaml(proto)
    g = torch.Generator().manual_seed(0)
    tp = t_family(proto).init(t_config(raw), g)
    jp = j_family(proto).init(jax.random.PRNGKey(0), j_config(raw))
    tflat = t_ckpt.flatten_tree(t_ckpt.params_to_numpy(tp))
    jflat = t_ckpt.flatten_tree(jax.tree.map(np.asarray, jp))
    assert {k: v.shape for k, v in tflat.items()} == \
        {k: v.shape for k, v in jflat.items()}
    routers = [v for k, v in tflat.items() if "router" in k]
    assert all((r == 0).all() for r in routers)
    assert len(routers) == (5 if "fmoe" in proto else 0)
