"""The port's parallel layouts and host-side sharding against the JAX
package, on the CPU: ``m3asr_tpu_torch/parallel`` (mesh coordinates,
the per-leaf sharding specs, the env contract of ``initialize``),
``ops/quant.repack_int4_tp`` / ``unpack_int4_tp`` and
``checkpoint.shard_experts`` / ``gather_expert_shards``.

The JAX side runs on the 8 virtual CPU devices of conftest.py. A spec is
compared leaf by leaf as the tuple of axis names of JAX's PartitionSpec,
padded with trailing Nones to the leaf's rank. Layout meshes need no
process group (``make_mesh(world_size=, rank=)``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from m3asr_tpu import checkpoint as j_ckpt
from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.models import moe_conformer as j_model
from m3asr_tpu.ops import quant as j_quant
from m3asr_tpu.parallel import distributed as j_dist
from m3asr_tpu.parallel import mesh as j_mesh

import torch

from m3asr_tpu_torch import checkpoint as t_ckpt
from m3asr_tpu_torch.ops import quant as t_quant
from m3asr_tpu_torch.parallel import distributed as t_dist
from m3asr_tpu_torch.parallel import mesh as t_mesh

from test_torch_engine_ep import exmarc_params, hier_raw


def _hier(proto="conformer_fmoe_localComm_catEmbed_domain_acc_hier"):
    cfg = j_config(hier_raw(proto))
    return jax.tree.map(np.asarray, j_model.init(
        jax.random.PRNGKey(3), cfg.encoder_conf, 16, 9))


def _quantized(tree, bits):
    tree = dict(tree, blocks=dict(tree["blocks"]))
    tree["blocks"]["feed_forward"] = jax.tree.map(
        np.asarray, j_quant.quantize_moe_params(
            tree["blocks"]["feed_forward"], bits=bits))
    return tree


def _grouped():
    """Grouped int4 scales (in = 256 > 128): stacked (L, E, G, 1, out)
    beside a flat (E, G, 1, out) node whose rank equals the stacked
    per-column int8 scales' (L, E, 1, out)."""
    rng = np.random.default_rng(4)
    w = {n: rng.standard_normal((2, 4, 256, 256)).astype(np.float32)
         for n in ("w1", "w2")}
    stacked4 = jax.tree.map(np.asarray, j_quant.quantize_moe_params(
        dict(w, router={"kernel": np.zeros((8, 4), np.float32)}), bits=4))
    stacked8 = jax.tree.map(np.asarray, j_quant.quantize_moe_params(
        dict(w, router={"kernel": np.zeros((8, 4), np.float32)}), bits=8))
    flat4 = jax.tree.map(np.asarray, j_quant.quantize_moe_params(
        {n: v[0] for n, v in w.items()}, bits=4))
    return {"blocks": {"feed_forward": stacked4, "macaron": stacked8},
            "flat": flat4}


def _tp_repacked(tp=2):
    tree = _grouped()
    ff = dict(tree["blocks"]["feed_forward"])
    ff["w1_q4c"] = j_quant.repack_int4_tp(ff.pop("w1_q4"), tp)
    tree["blocks"]["feed_forward"] = ff
    return tree


def _dfsmn_list():
    """A DFSMN-style tree: blocks as a list (no L axis) and an embed."""
    rng = np.random.default_rng(5)

    def layer():
        return {"fsmn": {"kernel": rng.standard_normal((8, 8))},
                "moe": {"w1": rng.standard_normal((4, 8, 16)),
                        "b1": rng.standard_normal((4, 16)),
                        "w2": rng.standard_normal((4, 16, 8)),
                        "b2": rng.standard_normal((4, 8)),
                        "router": {"kernel": rng.standard_normal((8, 4))}}}
    return {"blocks": [layer(), layer()],
            "embed": {"blocks": [layer()]}}


TREES = {
    "hier": lambda: _hier(),
    "exmarc": lambda: exmarc_params(j_config(hier_raw(
        "conformer_fmoeExMarc_localComm_catEmbed"))),
    "int8": lambda: _quantized(_hier(), 8),
    "int4": lambda: _quantized(_hier(), 4),
    "int4_grouped": _grouped,
    "int4_tp_repacked": _tp_repacked,
    "dfsmn_list": _dfsmn_list,
}
# (layout function, mesh (pp, dp, ep, tp), kwargs)
LAYOUTS = {
    "moe": ("moe_param_sharding", (1, 2, 4, 1), {}),
    "tp": ("param_sharding", (1, 1, 4, 2), {"tp": True}),
    "tp_pp": ("param_sharding", (2, 1, 2, 2), {"tp": True, "pp": True}),
    "zero": ("zero_sharding", (1, 4, 2, 1), {"min_size": 64}),
    "zero_tp": ("zero_sharding", (1, 2, 2, 2), {"tp": True,
                                                "min_size": 64}),
}


def _jax_mesh(pp, dp, ep, tp):
    return j_mesh.make_mesh(dp=dp, ep=ep, tp=tp, pp=pp,
                            devices=jax.devices()[:pp * dp * ep * tp])


def _padded(spec, leaf):
    spec = tuple(spec)
    return spec + (None,) * (np.ndim(leaf) - len(spec))


def _compare(tree, jspecs, tspecs):
    jflat = jax.tree_util.tree_flatten_with_path(tree)[0]
    jsp = jax.tree_util.tree_leaves(
        jspecs, is_leaf=lambda x: hasattr(x, "spec"))
    tsp = jax.tree_util.tree_leaves(
        tspecs, is_leaf=lambda x: isinstance(x, tuple))
    assert len(jflat) == len(jsp) == len(tsp)
    for (path, leaf), js, ts in zip(jflat, jsp, tsp):
        assert _padded(ts, leaf) == _padded(js.spec, leaf), \
            (jax.tree_util.keystr(path), ts, js.spec)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("tree_name", sorted(TREES))
def test_param_specs_equal_jax(tree_name, layout):
    tree = TREES[tree_name]()
    fn, (pp, dp, ep, tp), kw = LAYOUTS[layout]
    jm = _jax_mesh(pp, dp, ep, tp)
    tm = t_mesh.make_mesh(dp=dp, ep=ep, tp=tp, pp=pp,
                          world_size=pp * dp * ep * tp, rank=0)
    _compare(tree, getattr(j_mesh, fn)(jm, tree, **kw),
             getattr(t_mesh, fn)(tm, tree, **kw))


@pytest.mark.parametrize("tree_name", ["hier", "int8", "dfsmn_list"])
def test_bmuf_stacked_specs_equal_jax(tree_name):
    tree = TREES[tree_name]()
    stacked = jax.tree.map(lambda a: np.stack([a, a]), tree)
    jm = _jax_mesh(1, 2, 4, 1)
    tm = t_mesh.make_mesh(dp=2, ep=4, world_size=8, rank=0)
    _compare(stacked, j_mesh.bmuf_stacked_sharding(jm, stacked),
             t_mesh.bmuf_stacked_sharding(tm, stacked))


def test_input_specs_equal_jax():
    jm = _jax_mesh(1, 2, 4, 1)
    tm = t_mesh.make_mesh(dp=2, ep=4, world_size=8, rank=0)
    for name in ("batch_sharding", "feat_sharding", "replicated"):
        assert getattr(t_mesh, name)(tm) == \
            tuple(getattr(j_mesh, name)(jm).spec), name


@pytest.mark.parametrize("shape", [
    dict(ep=4), dict(tp=4), dict(ep=2, tp=2), dict(pp=2, dp=2, ep=2)],
    ids=lambda s: "_".join(f"{k}{v}" for k, v in s.items()))
def test_mesh_coordinates_equal_jax_grid(shape):
    """Rank r sits where device r sits in JAX's (pp, dp, sp, ep, tp)
    device grid."""
    n = int(np.prod(list(shape.values())))
    dp = shape.get("dp", 1)
    jm = j_mesh.make_mesh(devices=jax.devices()[:n], **dict(shape, dp=dp))
    ids = np.vectorize(lambda d: d.id)(np.asarray(jm.devices))
    for r in range(n):
        tm = t_mesh.make_mesh(world_size=n, rank=r, **dict(shape, dp=dp))
        pos = tuple(int(i[0]) for i in np.nonzero(ids == jax.devices()[r].id))
        assert tuple(tm.coords[a] for a in jm.axis_names) == pos


def test_shard_tree_takes_jax_device_block():
    """A rank's block of a leaf is the one JAX places on that device."""
    tm = t_mesh.make_mesh(dp=1, ep=2, tp=2, world_size=4, rank=3)
    jm = _jax_mesh(1, 1, 2, 2)
    w = np.arange(2 * 4 * 6 * 8, dtype=np.float32).reshape(2, 4, 6, 8)
    tree = {"blocks": {"feed_forward": {"w1": w}}}
    specs = t_mesh.param_sharding(tm, tree, tp=True)
    got = t_mesh.shard_tree(tree, specs, tm)["blocks"]["feed_forward"]["w1"]
    arr = jax.device_put(w, j_mesh.param_sharding(jm, tree, tp=True)[
        "blocks"]["feed_forward"]["w1"])
    dev = jax.devices()[3]
    want = next(np.asarray(s.data) for s in arr.addressable_shards
                if s.device == dev)
    np.testing.assert_array_equal(got, want)


def test_repack_int4_tp_bit_equal_to_jax():
    rng = np.random.default_rng(6)
    q = rng.integers(-8, 8, size=(3, 16, 64)).astype(np.int8)
    packed = j_quant.pack_int4(q)
    np.testing.assert_array_equal(t_quant.pack_int4(q), packed)
    for tp in (1, 2, 4):
        jr = j_quant.repack_int4_tp(packed, tp)
        tr = t_quant.repack_int4_tp(packed, tp)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(
            t_quant.unpack_int4_tp(torch.from_numpy(tr), torch.float32)
            .numpy(), np.asarray(j_quant.unpack_int4_tp(jr, jnp.float32)))
        np.testing.assert_array_equal(
            t_quant.unpack_int4_tp(torch.from_numpy(tr), torch.float32)
            .numpy(), q.astype(np.float32))


def test_q4c_dequant_bit_equal_to_jax():
    """_deq of tp-chunked int4 (and a rank's chunk of it) equals JAX's."""
    rng = np.random.default_rng(7)
    p = jax.tree.map(np.asarray, j_quant.quantize_moe_params(
        {"w1": rng.standard_normal((4, 256, 64)).astype(np.float32),
         "w2": rng.standard_normal((4, 64, 256)).astype(np.float32)},
        bits=4))
    p["w1_q4c"] = j_quant.repack_int4_tp(p.pop("w1_q4"), 2)
    want = np.asarray(j_quant._deq(p, "w1", jnp.float32))
    tp = {k: torch.tensor(v) for k, v in p.items()}
    np.testing.assert_array_equal(
        t_quant._deq(tp, "w1", torch.float32).numpy(), want)
    half = {"w1_q4c": tp["w1_q4c"][..., 1:, :],
            "w1_scale": tp["w1_scale"][..., 32:]}
    np.testing.assert_array_equal(
        t_quant._deq(half, "w1", torch.float32).numpy(), want[..., 32:])


def test_expert_shards_bit_equal_to_jax():
    rng = np.random.default_rng(8)
    sd = {"encoder.encoders.0.feed_forward.experts.htoh4.weight":
          rng.standard_normal((8, 6, 4)).astype(np.float32),
          "encoder.encoders.0.feed_forward.gate.weight":
          rng.standard_normal((8, 4)).astype(np.float32)}
    shards = []
    for r in range(4):
        js, ts = j_ckpt.shard_experts(sd, r, 4), t_ckpt.shard_experts(sd, r, 4)
        assert js.keys() == ts.keys()
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k])
        shards.append(ts)
    jg = j_ckpt.gather_expert_shards(shards)
    tg = t_ckpt.gather_expert_shards(shards)
    for k in sd:
        np.testing.assert_array_equal(tg[k], jg[k])
        np.testing.assert_array_equal(tg[k], sd[k])


_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
        "COORDINATOR_ADDRESS", "LOCAL_WORLD_SIZE", "LOCAL_RANK")


def test_initialize_noop_without_env(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    assert t_dist.initialize() is False


@pytest.mark.parametrize("env,method", [
    ({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234"},
     "tcp://10.0.0.1:1234"),
    ({"MASTER_ADDR": "10.0.0.1"}, "tcp://10.0.0.1:8476"),
    ({"COORDINATOR_ADDRESS": "file:///tmp/store"}, "file:///tmp/store"),
])
def test_initialize_env_parsing(monkeypatch, env, method):
    """The env maps onto init_process_group as it maps onto
    jax.distributed.initialize (tests/test_distributed.py); the ranks
    share no card here, so the backend is gloo."""
    import torch.distributed as dist
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    for k, v in dict(env, WORLD_SIZE="4", RANK="2").items():
        monkeypatch.setenv(k, v)
    calls, jcalls = {}, {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: jcalls.update(kw))
    assert t_dist.initialize() is True
    assert (calls["init_method"], calls["world_size"], calls["rank"]) == \
        (method, 4, 2)
    assert calls["backend"] == ("nccl" if torch.cuda.device_count() >= 4
                                else "gloo")
    j_dist.initialize()
    want = method.split("://")[1] if method.startswith("tcp") else \
        env["COORDINATOR_ADDRESS"]
    assert (jcalls["coordinator_address"], jcalls["num_processes"],
            jcalls["process_id"]) == (want, 4, 2)


def test_process_local_batch_and_host_slices():
    tm = t_mesh.make_mesh(ep=2, world_size=8, rank=5)      # dp=4
    assert tm.shape["dp"] == 4 and tm.coord("dp") == 2
    assert t_dist.process_local_batch(tm, 8) == \
        j_dist.process_local_batch(j_dist.global_mesh(ep=2), 8)
    batch = {"data": np.arange(8 * 3).reshape(8, 3), "lens": np.arange(8)}
    got = t_dist.shard_host_batch(tm, batch)
    np.testing.assert_array_equal(got["data"], batch["data"][4:6])
    np.testing.assert_array_equal(got["lens"], [4, 5])
