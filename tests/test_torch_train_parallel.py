"""Parallel training of the PyTorch port (``train/parallel.py``,
``parallel/collectives.py``, ``parallel/sp.py``, ``parallel/pp.py``,
``parallel/fsdp.py``, the CLI's mesh) on gloo ranks, against the JAX
package's unsharded step, on the CPU.

The tiny hier MoE conformer of tests/test_tp_sp.py (d=32, 4 heads, 2 MoE
blocks of 4 experts, hidden 64, one embed block; three AED decoders of
one block for the hier recipe) goes, as the JAX package's parameter
tree, to a 4-rank and a 2-rank world started at once (processes of
tests/torch_train_worker.py on a ``file://`` store, one thread a rank).
Each sharded mode takes its first step on one global batch of 4
utterances (41 frames: T' = 9, which sp = 2 does not divide) and is held
to JAX's ``value_and_grad`` and JAX's step of the same numpy inputs
(SGD with a momentum trace, clip 5: the norm is about 17, so the clip
reads the sharded norm): the loss and metrics within rtol 1e-5, every
leaf's gradient gathered from the ranks allclose(rtol 1e-5, atol 1e-5),
the updated tree within 1e-4 of each leaf's max|ref|. A tp or ep step
without the identity-forward / sum-backward collective gives partial
gradients of every leaf upstream of the split and fails here. Ranks that
hold the same block of a leaf hold the same bits after every update.
ZeRO-1 and FSDP after three steps equal the replicated run, each rank
holding 1/dp of the split moments; BMUF with a replica a rank equals
JAX's vmapped recipe (tests/test_bmuf_recipe.py's model and batches);
``dryrun_multichip(4)`` passes; the CLI trains under
``torch.distributed.run`` (2 ranks ``--ep 2``, 4 ranks ``--tp 2 --pp
2``) and one process resumes from its checkpoint; the CLI refuses what
the root train.py refuses, in its words.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.models import aed as j_aed
from m3asr_tpu.models import moe_conformer as j_model
from m3asr_tpu.models.registry import get_family as j_family
from m3asr_tpu.train import lr_scheduler as j_lr
from m3asr_tpu.train import step as j_step
from m3asr_tpu.train.bmuf import BmufRecipe as JBmuf

from m3asr_tpu_torch.checkpoint import flatten_tree
from m3asr_tpu_torch.train import cli

from test_torch_train_cli import _arks, write_int_vectors  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_train_worker.py")
JOIN_S = 300                 # a world's whole run
SGD = ("constant", {}, 0.05, "sgd", {"momentum": 0.9})
HIER_KW = dict(ce_weight=0.5, router_l1_weight=0.01,
               router_importance_weight=0.02, loss_scale=1.0)


def tiny_raw(proto="conformer_aed_fmoe_localComm_catEmbed_domain_acc_hier"):
    return {"nnet_proto": proto, "input_dim": 20, "output_dim": 31,
            "model_conf": {
                "encoder_conf": {
                    "attention_dim": 32, "attention_heads": 4,
                    "num_blocks": 2,
                    "embed_conf": {"attention_dim": 32, "attention_heads": 4,
                                   "linear_units": 32, "num_blocks": 1},
                    "moe_conf": {"num_experts": 4, "hidden_units": 64},
                    "output_dim_domain": 3, "output_dim_acc": 4},
                "decoder_conf": {"attention_heads": 4, "linear_units": 48,
                                 "num_blocks": 1}}}


BMUF_RAW = {"nnet_proto": "conformer", "input_dim": 8, "output_dim": 5,
            "model_conf": {"encoder_conf": {
                "attention_dim": 16, "attention_heads": 4,
                "linear_units": 24, "num_blocks": 1}}}


def _redraw(tree, seed):
    """Every float leaf redrawn from a numpy seed (routers normal x 0.5,
    so tokens spread; norm scales around 1)."""
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name.endswith("pe"):
            return np.asarray(a)
        v = rng.standard_normal(a.shape) * (0.5 if "router" in name
                                            else 0.1)
        return (v + 1.0 if name.endswith("scale") else v).astype(np.float32)
    return jax.tree_util.tree_map_with_path(redraw, tree)


def trees():
    """{model: numpy tree}: the CTC model, the hier recipe's tree (the
    encoder, three decoders, the domain/accent heads), BMUF's model."""
    cfg = j_config(tiny_raw())
    enc = _redraw(j_model.init(jax.random.PRNGKey(0), cfg.encoder_conf, 20,
                               31), 0)
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    hier = {"encoder": enc}
    for k, name in zip(keys, ("decoder", "decoder_1", "decoder_2")):
        hier[name] = _redraw(j_aed.init(k, cfg.decoder_conf, 31, 32), 2)
    hier.update(_redraw(j_step.init_domain_acc_heads(keys[3], 32, 3, 4), 3))
    bcfg = j_config(BMUF_RAW)
    bm = jax.tree.map(np.asarray, j_family(bcfg.nnet_proto).init(
        jax.random.PRNGKey(0), bcfg))
    return {"ctc": enc, "hier": hier, "bmuf": bm}


def global_batch():
    rng = np.random.default_rng(3)
    return {"feat": rng.standard_normal((4, 41, 20)).astype(np.float32),
            "lens": np.array([41, 36, 32, 20], np.int32),
            "tg": rng.integers(1, 30, (4, 5)).astype(np.int32),
            "tl": np.array([5, 3, 4, 2], np.int32),
            "aed": rng.integers(1, 30, (4, 6)).astype(np.int32),
            "alens": np.array([6, 2, 5, 3], np.int32),
            "dom": np.array([0, 2, 1, 2], np.int32),
            "acc": np.array([3, 1, 0, 2], np.int32)}


def bmuf_batches(steps=4, dp=2, b=2, T=41, U=3):
    """tests/test_bmuf_recipe.py's batches, a (steps, dp) grid, at 41
    frames instead of 19: 19 frames leave 4 after subsampling, too few
    for some label triples (1 1 1 needs 5), whose CTC loss then takes
    optax's -1e5 path (about 5e4), where float32 keeps three digits of a
    gradient."""
    rng = np.random.RandomState(0)
    return {"feat": rng.randn(steps, dp, b, T, 8).astype(np.float32),
            "lens": np.full((steps, dp, b), T, np.int32),
            "tg": rng.randint(1, 5, (steps, dp, b, U)).astype(np.int32),
            "tl": np.full((steps, dp, b), U, np.int32)}


def step_case(name, mesh, model="ctc", **kw):
    return {"name": name, "kind": "step", "model": model, "mesh": mesh,
            **kw}


# world size -> its cases; "ref" names the JAX reference a case is held to
CASES = {
    4: [step_case("dp4", {"dp": 4}, steps=3, ref="plain"),
        step_case("dp2_ep2", {"dp": 2, "ep": 2}, ref="plain"),
        step_case("dp2_tp2", {"dp": 2, "tp": 2}, par={"tp": True},
                  ref="plain"),
        step_case("dp2_sp2_flash", {"dp": 2, "sp": 2},
                  tcfg={"attn_impl": "flash"}, ref="plain"),
        step_case("pp2_dp2_m3", {"pp": 2, "dp": 2},
                  par={"pp": True, "pp_microbatches": 3}, ref="plain"),
        step_case("dp4_zero1", {"dp": 4}, par={"zero1": True}, steps=3,
                  ref="plain"),
        step_case("dp2_ep2_fsdp", {"dp": 2, "ep": 2}, par={"fsdp": True},
                  steps=3, ref="plain"),
        step_case("dp2_ep2_accum2", {"dp": 2, "ep": 2},
                  tcfg={"accum_steps": 2}, ref="accum"),
        step_case("hier_dp2_ep2", {"dp": 2, "ep": 2}, model="hier",
                  hier=True, tcfg=HIER_KW, ref="hier"),
        step_case("dp2_sp2_specaug", {"dp": 2, "sp": 2},
                  tcfg={"spec_aug": True,
                        "spec_aug_conf": {"max_t": 5, "max_f": 3}},
                  generator=True, port_ref=True),
        {"name": "dryrun", "kind": "dryrun"}],
    2: [{"name": "bmuf_dp2", "kind": "bmuf", "model": "bmuf",
         "mesh": {"dp": 2}, "sync_period": 2, "block_momentum": 0.5,
         "block_lr": 0.9},
        step_case("sp2", {"dp": 1, "sp": 2}, ref="plain"),
        # every leaf of 64 values and more split, the blocks' layer axis
        # among them: a layer lives on one dp rank
        step_case("dp2_fsdp_layers", {"dp": 2},
                  par={"fsdp": True, "zero_min_size": 64}, ref="plain"),
        step_case("ep2", {"dp": 1, "ep": 2}, ref="plain")],
}
STEP_CASES = [c for n in CASES for c in CASES[n] if c.get("ref")]


def _env(work, n, rank, store):
    env = dict(os.environ, COORDINATOR_ADDRESS=f"file://{store}",
               WORLD_SIZE=str(n), RANK=str(rank), OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(HERE))
    for k in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    return env


def _start_world(work, n):
    store = os.path.join(work, f"store_{n}")
    with open(os.path.join(work, f"cases_{n}.json"), "w") as f:
        json.dump(CASES[n], f)
    return [subprocess.Popen([sys.executable, WORKER, work],
                             env=_env(work, n, r, store),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(n)]


def _join(procs):
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=JOIN_S)
        logs.append((p.returncode, out.decode(errors="replace")))
    for rc, log in logs:
        assert rc == 0, log[-4000:]
    return logs


def _cli_world(work, n, out, *flags):
    """A CLI run under torch.distributed.run (its own rendezvous)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", "-m", "m3asr_tpu_torch.train",
           *_cli_argv(work, out), *flags]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(HERE))
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def _cli_argv(work, out):
    return ["--config", os.path.join(work, "cli.yaml"), "--output_dir",
            str(out), "--tr_rspecifier", os.path.join(work, "tr.ark"),
            "--tr_labels", os.path.join(work, "tr_labels.ark"),
            "--device", "cpu", "--max_epochs", "1"]


def _jax_refs(tr, batch):
    """JAX's (loss, metrics, flat grads, flat updated tree) of each
    reference: the CTC step, with two accumulated microbatches, and the
    hier recipe with the heads; one value_and_grad jit and one step jit
    each."""
    b4 = tuple(batch[k] for k in ("feat", "lens", "tg", "tl"))
    b8 = b4 + tuple(batch[k] for k in ("aed", "alens", "dom", "acc"))
    refs = {}
    for name, hier, kw in (("plain", False, {}),
                           ("accum", False, {"accum_steps": 2}),
                           ("hier", True, HIER_KW)):
        cfg = j_config(tiny_raw())
        tree = jax.tree.map(jnp.asarray, tr["hier" if hier else "ctc"])
        jopt = j_lr.build_optimizer(*SGD, max_grad_norm=5.0)
        if hier:
            tcfg = j_step.HierTrainConfig(**kw)

            def loss(p, mb, r=None):
                return j_step.hier_aed_loss_fn(
                    p, cfg, tcfg, *mb[:6], domain_targets=mb[6],
                    acc_targets=mb[7])
            step = j_step.make_hier_train_step(cfg, tcfg, jopt,
                                               with_domain_acc=True)
            args = b8
        else:
            tcfg = j_step.TrainConfig(**kw)

            def loss(p, mb, r=None):
                return j_step.loss_fn(p, cfg, tcfg, *mb)
            step = j_step.make_train_step(cfg, tcfg, jopt)
            args = b4
        if kw.get("accum_steps", 1) > 1:
            vg = jax.jit(lambda p: j_step._accum_value_and_grad(
                loss, p, args, None, kw["accum_steps"]))
        else:
            vg = jax.jit(jax.value_and_grad(lambda p: loss(p, args),
                                            has_aux=True))
        (l, m), g = vg(tree)
        new, _, jm = jax.jit(step)(tree, jopt.init(tree), *args)
        refs[name] = (float(l), {k: float(v) for k, v in m.items()},
                      flatten_tree(jax.tree.map(np.asarray, g)),
                      flatten_tree(jax.tree.map(np.asarray, new)),
                      float(jm["grad_norm"]))
    return refs


def _jax_bmuf(tree, b, sync_period=2, block_momentum=0.5, block_lr=0.9):
    cfg = j_config(BMUF_RAW)
    jopt = j_lr.build_optimizer(*SGD, max_grad_norm=-1)
    p = jax.tree.map(jnp.asarray, tree)
    state = JBmuf.stack(jopt.init(p), 2)
    stacked = JBmuf.stack(p, 2)
    recipe = JBmuf(stacked, sync_period, block_momentum=block_momentum,
                   block_lr=block_lr)
    step = jax.jit(jax.vmap(j_step.make_train_step(
        cfg, j_step.TrainConfig(), jopt)))
    for i in range(b["feat"].shape[0]):
        stacked, state, _ = step(stacked, state,
                                 *(b[k][i] for k in ("feat", "lens", "tg",
                                                     "tl")))
        if (i + 1) % sync_period == 0:
            stacked, ok = recipe.sync(stacked)
            assert ok
    return flatten_tree(jax.tree.map(np.asarray, stacked))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's outputs (case npz and per-rank metadata), the JAX
    references, and the CLI worlds' output dirs."""
    work = str(tmp_path_factory.mktemp("train_ranks"))
    tr = trees()
    for name, raw in (("ctc", tiny_raw()), ("hier", tiny_raw()),
                      ("bmuf", BMUF_RAW)):
        with open(os.path.join(work, f"{name}.json"), "w") as f:
            json.dump(raw, f)
        np.savez(os.path.join(work, f"{name}.npz"), **flatten_tree(tr[name]))
    batch = global_batch()
    np.savez(os.path.join(work, "batch.npz"), **batch)
    bb = bmuf_batches()
    np.savez(os.path.join(work, "bmuf_batch.npz"), **bb)
    # the CLI's data and config: 2 utterances, batch 2 -> one step
    from pathlib import Path
    rng = np.random.default_rng(0)
    _arks(Path(work), "tr", 2, rng)
    raw = tiny_raw("conformer_fmoe_localComm_catEmbed")
    raw.update(loader_conf={"feat_dim": 20, "batch_size": 2}, log_period=1,
               save_period=1, lr=2e-3, schedule_conf={"warmup_steps": 4})
    with open(os.path.join(work, "cli.yaml"), "w") as f:
        yaml.safe_dump(raw, f)
    procs = {n: _start_world(work, n) for n in CASES}
    clis = {"ep2": _cli_world(work, 2, os.path.join(work, "cli_ep2"),
                              "--ep", "2"),
            "tp2pp2": _cli_world(work, 4, os.path.join(work, "cli_tp2pp2"),
                                 "--tp", "2", "--pp", "2")}
    refs = _jax_refs(tr, batch)
    bmuf_ref = _jax_bmuf(tr["bmuf"], bb)
    logs = {n: _join(p) for n, p in procs.items()}
    cli_logs = {k: _join([p]) for k, p in clis.items()}
    meta = {n: [json.load(open(os.path.join(work, f"meta_{n}_{r}.json")))
                for r in range(n)] for n in CASES}
    return {"work": work, "refs": refs, "bmuf_ref": bmuf_ref,
            "meta": meta, "logs": logs, "cli_logs": cli_logs}


def _case(worlds, name):
    with np.load(os.path.join(worlds["work"], f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


def _group(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def _assert_tree_close(got, ref, rel=1e-4):
    assert sorted(got) == sorted(ref)
    for k in ref:
        tol = rel * max(np.abs(ref[k]).max(), 1e-3)
        assert np.abs(got[k] - ref[k]).max() <= tol, k


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: c["name"])
def test_sharded_first_step_matches_jax(worlds, case):
    """The case's loss, metrics, gathered gradients and updated tree
    against JAX's unsharded step on the same global batch; no leaf's
    block differs in bits between the ranks that hold it."""
    res = _case(worlds, case["name"])
    l, m, g, new, gn = worlds["refs"][case["ref"]]
    np.testing.assert_allclose(res["loss"], l, rtol=1e-5)
    np.testing.assert_allclose(res["norm"], gn, rtol=1e-5)
    got_m = _group(res, "m/")
    assert sorted(got_m) == sorted(m)
    for k in m:
        np.testing.assert_allclose(got_m[k], m[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    grads = _group(res, "grad/")
    assert sorted(grads) == sorted(g)
    for k in g:
        np.testing.assert_allclose(grads[k], g[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    _assert_tree_close(_group(res, "p1/"), new)
    n = next(w for w in CASES if case in CASES[w])
    for meta in worlds["meta"][n]:
        assert meta[case["name"]]["mismatch"] == []


def test_spec_augment_draws_for_the_global_batch(worlds):
    """dp2 x sp2 with SpecAugment on the device: the masks are drawn for
    the global batch from the step's generator and cut over dp, so the
    step equals the port's one-rank step with the same generator."""
    res = _case(worlds, "dp2_sp2_specaug")
    np.testing.assert_allclose(res["loss"], res["ref_loss"], rtol=1e-5)
    grads, ref = _group(res, "grad/"), _group(res, "ref_grad/")
    assert sorted(grads) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(grads[k], ref[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["dp4_zero1", "dp2_ep2_fsdp"])
def test_zero1_and_fsdp_match_replicated_run(worlds, name):
    """Three steps with the moments (ZeRO-1) or the parameters too (FSDP)
    split over dp equal three replicated dp4 steps, and every rank holds
    1/dp of each split moment (w1 and the attention kernels among
    them)."""
    _assert_tree_close(_group(_case(worlds, name), "p3/"),
                       _group(_case(worlds, "dp4"), "p3/"))
    dp = {"dp4_zero1": 4, "dp2_ep2_fsdp": 2}[name]
    full = _group(_case(worlds, "dp4"), "p1/")
    for meta in worlds["meta"][4]:
        m = meta[name]
        split = [k for k, s in m["moment_dp"].items() if s]
        assert "blocks/feed_forward/w1" in split
        assert "blocks/self_attn/linear_q/kernel" in split
        for k in split:
            expert = k.split("/")[-1] in ("w1", "b1", "w2", "b2")
            ep = 2 if name.endswith("fsdp") and expert else 1
            assert np.prod(m["moments"][k]) * dp * ep == full[k].size, k


def test_bmuf_replicas_on_ranks_match_jax_vmapped_recipe(worlds):
    """Two BMUF replicas, one a rank, each stepping on its own slice with
    local normalization, synced every 2 steps (block momentum 0.5, block
    lr 0.9): the stacked tree after 4 steps equals JAX's vmapped recipe
    within 1e-4 of each leaf's max|ref|."""
    got = _group(_case(worlds, "bmuf_dp2"), "p/")
    _assert_tree_close(got, worlds["bmuf_ref"])
    losses = [m["bmuf_dp2"]["losses"] for m in worlds["meta"][2]]
    assert losses[0] != losses[1]      # the replicas saw different data


def test_dryrun_multichip_on_four_ranks(worlds):
    """dryrun_multichip(4): the four shardings' losses agree, and the
    ep x tp engine equals one rank's."""
    meta = worlds["meta"][4][0]["dryrun"]
    losses = [v[0] for k, v in meta.items() if k != "serving_err"]
    assert len(losses) == 4 and max(losses) - min(losses) < 1e-3
    assert meta["serving_err"] < 1e-4


@pytest.mark.parametrize("name", ["ep2", "tp2pp2"])
def test_cli_trains_on_ranks_and_resumes_in_one_process(worlds, tmp_path,
                                                        name):
    """The CLI under torch.distributed.run (2 ranks --ep 2; 4 ranks --tp 2
    --pp 2) takes its step and writes one checkpoint with the whole tree
    in the one-process layout; one process resumes from it: its run
    starts at step 1 from those parameters, bit for bit."""
    out = os.path.join(worlds["work"], f"cli_{name}")
    log = worlds["cli_logs"][name][0][1]
    assert "training done" in log, log[-3000:]
    with open(os.path.join(out, "checkpoint_final.pkl"), "rb") as f:
        saved = pickle.load(f)
    assert saved["global_step"] == 1
    w1 = saved["params"]["blocks"]["feed_forward"]["w1"]
    assert w1.shape == (2, 4, 32, 64)               # whole, not a shard
    assert saved["opt_state"]["mu"]["blocks/feed_forward/w1"].shape == \
        w1.shape
    argv = _cli_argv(worlds["work"], out)
    argv[argv.index("--max_epochs") + 1] = "2"
    from m3asr_tpu_torch.train import trainer as t_trainer
    seen = {}
    orig = t_trainer.Trainer.load_checkpoint

    def spy(self, tag="last"):
        ok = orig(self, tag)
        seen["params"] = {k: v.numpy().copy() for k, v in
                          flatten_tree(self.params).items()}
        return ok
    t_trainer.Trainer.load_checkpoint = spy
    try:
        t = cli.main(argv + ["--resume"])
    finally:
        t_trainer.Trainer.load_checkpoint = orig
    assert t.global_step == 2
    want = flatten_tree(saved["params"])
    for k, v in want.items():
        np.testing.assert_array_equal(seen["params"][k], v, err_msg=k)


@pytest.mark.parametrize("flags,words", [
    (["--pp", "2"], "--pp supports the non-hier recipes"),
    (["--tp", "2"], "--tp with attn_impl=flash is unsupported"),
    (["--bmuf", "--sp", "2"], "--bmuf composes with dp/ep only"),
    (["--ep", "2"], "torch.distributed.run --nproc-per-node 2"),
])
def test_cli_refuses_meshes_in_jax_words(tmp_path, flags, words):
    """The meshes the root train.py refuses for the hier flash recipe,
    and a mesh larger than the world (one process here), exit naming the
    reason; the world's message names the launch command."""
    from test_torch_train_cli import _argv, hier_yaml
    d = tmp_path
    rng = np.random.default_rng(0)
    _arks(d, "tr", 2, rng)
    _arks(d, "cv", 1, rng)
    raw = hier_yaml()
    raw["model_conf"]["encoder_conf"].update(output_dim_domain=3,
                                             output_dim_acc=4)
    raw.update(loader_conf={"feat_dim": 20, "batch_size": 2},
               attn_impl="flash")
    with open(d / "cfg.yaml", "w") as f:
        yaml.safe_dump(raw, f)
    with pytest.raises(SystemExit, match=words.replace("-", r"\-")):
        cli.main(_argv(d, d / "exp", *flags))


@pytest.mark.parametrize("proto,flags,words", [
    ("dfsmn_san_res", ["--sp", "2"], "DFSMN protos train with dp/ep"),
    ("conformer", ["--pp", "2"], "--pp supports the MoE conformer protos"),
])
def test_cli_refuses_meshes_by_family(tmp_path, proto, flags, words):
    """tp/sp/pp on a DFSMN proto and pp off the MoE conformers exit in
    the root train.py's words."""
    from test_torch_train_cli import DFSMN_YAML, _argv
    d = tmp_path
    rng = np.random.default_rng(0)
    _arks(d, "tr", 2, rng)
    _arks(d, "cv", 1, rng)
    if "dfsmn" in proto:
        raw = dict(DFSMN_YAML, nnet_proto=proto)
    else:
        raw = dict(BMUF_RAW, input_dim=20)
    raw = dict(raw, loader_conf={"feat_dim": 20, "batch_size": 2})
    with open(d / "cfg.yaml", "w") as f:
        yaml.safe_dump(raw, f)
    with pytest.raises(SystemExit, match=words.replace("-", r"\-")):
        cli.main(_argv(d, d / "exp", *flags, hier=False))


def test_collectives_without_native_ops_match_native():
    """The forms gloo takes on the card (all-gather, reduce-scatter and
    the stage hand-off through all-reduces) equal the native ops: a
    2-rank gloo world on the CPU runs both and compares (the worker's
    check, in one process pair)."""
    code = r'''
import os, sys, torch, torch.distributed as dist
sys.path.insert(0, os.environ["REPO"])
from m3asr_tpu_torch.parallel import collectives as c
from m3asr_tpu_torch.parallel.mesh import make_mesh
dist.init_process_group("gloo", init_method=os.environ["STORE"],
                        world_size=2, rank=int(os.environ["RANK"]))
mesh = make_mesh(dp=1, sp=2)
r = mesh.coord("sp")
x = torch.arange(12.0).reshape(2, 3, 2) * (r + 1)
nat = (c.all_gather(mesh, x, "sp", 1), c.reduce_scatter(mesh, x, "sp", 2),
       c.send_next(mesh, x, "sp"), c.send_next(mesh, x, "sp", back=True))
c.native = lambda t: False
alt = (c.all_gather(mesh, x, "sp", 1), c.reduce_scatter(mesh, x, "sp", 2),
       c.send_next(mesh, x, "sp"), c.send_next(mesh, x, "sp", back=True))
for a, b in zip(nat, alt):
    assert torch.equal(a, b), (a, b)
assert nat[0].shape == (2, 6, 2) and nat[1].shape == (2, 3, 1)
assert torch.equal(nat[2], torch.zeros_like(x) if r == 0 else x / 2)
print("ok")
'''
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, REPO=os.path.dirname(HERE),
                   STORE=f"file://{d}/store")
        procs = [subprocess.Popen([sys.executable, "-c", code],
                                  env=dict(env, RANK=str(r)),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for r in range(2)]
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0 and b"ok" in out, out.decode()[-2000:]
