"""The kernels as ``torch.library`` custom operators, and the engine's
per-bucket ``torch.export`` programs (``build --export``), on the CPU.

Every operator of ``m3asr_tpu_torch/ops/library.py`` passes
``torch.library.opcheck`` (schema, fake implementation against the CPU
one, no mutation or aliasing) on small numpy-seeded inputs. An engine
dir built with exported programs loads them (not a retrace) and answers
bit for bit as its retraced twin; programs for another device, or that
cannot be read, log a warning and the bucket retraces; a bucket whose
expert stage reads the host is refused. ``build --export`` then
``infer`` matches the JAX engine at allclose(1e-5, 1e-3).
"""

import logging

import numpy as np
import pytest
import torch

from m3asr_tpu_torch import build as t_build
from m3asr_tpu_torch import infer as t_infer
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.ops import flash_attention, moe_q4, moe_runs
from m3asr_tpu_torch.ops import moe_stream
from m3asr_tpu_torch.ops.library import OPS
from m3asr_tpu_torch.ops.quant import quantize_moe_params
from m3asr_tpu_torch.ops.row_tiles import front_ints
from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig

from test_torch_engine import _write_inputs
from test_torch_exmarc import (BUCKET, inputs, random_params, small_yaml)
from test_runtime import small_yaml as engine_yaml

E, D, H = 4, 64, 128


def _experts(seed, stacked=False):
    rng = np.random.default_rng(seed)
    lead = (2, E) if stacked else (E,)
    p = {"w1": rng.standard_normal(lead + (D, H)) * 0.05,
         "b1": rng.standard_normal((E, H)) * 0.1,
         "w2": rng.standard_normal(lead + (H, D)) * 0.05,
         "b2": rng.standard_normal((E, D)) * 0.1}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}


def _x_gate(seed, dtype=torch.float32, n_experts=E):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, 9, D)).astype(np.float32))
    gate = torch.from_numpy(rng.integers(0, n_experts, (2, 9))
                            .astype(np.int32))
    gate[1, 6:] = 0
    return x.to(dtype), gate


def _quant(p, bits):
    q = quantize_moe_params({k: v.numpy() for k, v in p.items()}, bits=bits)
    return {k: torch.as_tensor(v) for k, v in q.items()}


def _op_cases():
    """(operator name, argument tuple) pairs covering each operator's
    formats: stacked weights with a layer index, the a8 variants,
    optional biases and the LSE."""
    cases = []
    x, gate = _x_gate(1)
    xb = x.to(torch.bfloat16)
    f, fs = _experts(2), _experts(3, stacked=True)
    cases += [
        ("moe_runs_f", (x, gate, f["w1"], f["b1"], f["w2"], f["b2"], None,
                        "swish", None)),
        ("moe_runs_f", (x, gate, fs["w1"], fs["b1"], fs["w2"], None, 1,
                        "relu", 1.0)),
    ]
    q8, q4 = _quant(f, 8), _quant(f, 4)
    for fmt, q, w in (("q8", q8, ("w1_q", "w2_q")),
                      ("q4", q4, ("w1_q4", "w2_q4"))):
        for a8 in (False, True):
            cases.append(("moe_runs_q", (
                xb, gate, q[w[0]], q["w1_scale"], q["b1"].bfloat16(),
                q[w[1]], q["w2_scale"], q["b2"].bfloat16(), fmt, None, a8,
                "swish", None)))
    t4 = (q4["w1_q4"], q4["w1_scale"], q4["b1"].bfloat16(), q4["w2_q4"],
          q4["w2_scale"], q4["b2"].bfloat16())
    for a8 in (False, True):
        cases.append(("moe_q4_dense", (xb, gate, *t4, None, a8, "swish",
                                       None)))
        cases.append(("moe_q4_tiled", (xb, gate, *t4, None, a8, 64,
                                       "swish", None)))
    cases += [
        ("moe_stream", (x, gate, f["w1"], None, f["b1"], f["w2"], None,
                        f["b2"])),
        ("moe_stream", (xb, gate, q8["w1_q"], q8["w1_scale"], None,
                        q8["w2_q"], q8["w2_scale"], None)),
        ("moe_q4_row_tiles", (gate, E)),
        ("moe_stream_row_tiles", (gate.reshape(-1), E)),
    ]
    rng = np.random.default_rng(4)
    q2 = torch.from_numpy(rng.standard_normal((2, 2, 7, 128))
                          .astype(np.float32))
    k2 = torch.from_numpy(rng.standard_normal((2, 2, 7, 128))
                          .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 7, 64))
                         .astype(np.float32))
    lens = torch.tensor([7, 4], dtype=torch.int32)
    lo = torch.zeros((2, 7), dtype=torch.int32)
    hi = torch.full((2, 7), 5, dtype=torch.int32)
    cases += [
        ("flash_fwd", (q2, k2, v, lens, None, None, 0.125, 0, True, None)),
        ("flash_fwd", (q2.bfloat16(), k2.bfloat16(), v.bfloat16(), None, lo,
                       hi, 0.125, 2, False, None)),
    ]
    return cases


CASES = _op_cases()


def test_every_kernel_is_a_registered_operator():
    """The inference entry points of K1, K4/K5, K6, K7, K8, K2 and both
    row-tile fronts are ``m3asr::`` operators, each with a case here."""
    assert set(OPS) == {"moe_runs_f", "moe_runs_q", "moe_q4_dense",
                        "moe_q4_tiled", "moe_stream", "moe_q4_row_tiles",
                        "moe_stream_row_tiles", "flash_fwd"}
    assert {name for name, _ in CASES} == set(OPS)
    assert hasattr(torch.ops.m3asr, "moe_runs_f")


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_opcheck(i):
    """torch.library.opcheck: the schema, the fake implementation's
    shapes and dtypes against the CPU one, no mutated or aliased input;
    the CPU operator equals the plain version it wraps."""
    name, args = CASES[i]
    torch.library.opcheck(OPS[name], args)
    out = OPS[name](*args)
    if name == "moe_runs_f" and args[6] is None:
        ref = moe_runs.moe_experts_runs_reference(
            {"w1": args[2], "b1": args[3], "w2": args[4], "b2": args[5]},
            args[0], args[1])
        assert torch.equal(out, ref)
    if name.endswith("row_tiles"):
        assert out.shape == (front_ints(args[0].numel(), E),)
    if name == "flash_fwd":
        assert out[1].shape == ((2, 2, 7, 1) if args[8] else (0,))
    for k in (moe_runs.runs_kernel, moe_runs.runs_q8_kernel,
              moe_runs.runs_q4_kernel, moe_q4.q4_kernel,
              moe_q4.q4_tiled_kernel, moe_stream.stream_kernel):
        assert k.launches == 0
    assert flash_attention.flash_kernels.fwd_launches == 0


# ---------------------------------------------------------------------------
# exported engines
# ---------------------------------------------------------------------------

SETTINGS = {"fp32": {}, "bf16": dict(dtype="bfloat16"),
            "int8": dict(dtype="int8"), "int4": dict(dtype="int4"),
            "flash": dict(attn_impl="flash"),
            "beam_taps": dict(decode_output="beam", decode_topk=4,
                              return_taps=True)}


@pytest.mark.parametrize("mode", sorted(SETTINGS))
def test_exported_engine_equals_its_retraced_twin(tmp_path, mode):
    """An ExMarc engine saved with its program for the CPU: a fresh
    Engine.load runs the loaded program (loaded_buckets) and answers bit
    for bit as the engine that traced the model code; the program holds
    no weights (it is far smaller than params.npz)."""
    eng = Engine(t_config(small_yaml()), random_params(),
                 EngineConfig(**BUCKET, **SETTINGS[mode]), device="cpu")
    eng.save(str(tmp_path), export_devices=("cpu",))
    prog = tmp_path / "exported" / "2x64.cpu.pt2"
    assert prog.stat().st_size < (tmp_path / "params.npz").stat().st_size
    loaded = Engine.load(str(tmp_path), device="cpu")
    feat, lens = inputs()
    ref, got = eng.infer(feat, lens), loaded.infer(feat, lens)
    assert loaded.loaded_buckets == {(2, 64)} and not eng.loaded_buckets
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    # another output mode runs on the same program
    other = loaded.infer(feat, lens, out_mode="argmax")
    np.testing.assert_array_equal(other[0], eng.infer(feat, lens,
                                                      "argmax")[0])


def test_programs_for_another_device_or_unreadable_retrace(tmp_path, caplog):
    """A dir holding only a program for another device, or a corrupt
    program, loads with a warning naming the file; the bucket is traced
    from the model code and answers as the plain engine."""
    eng = Engine(t_config(small_yaml()), random_params(),
                 EngineConfig(**BUCKET), device="cpu")
    eng.save(str(tmp_path), export_devices=("cpu",))
    feat, lens = inputs()
    ref = eng.infer(feat, lens)
    exp = tmp_path / "exported"
    (exp / "2x64.cpu.pt2").rename(exp / "2x64.cuda.pt2")
    for label in ("another device", "unreadable"):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="m3asr_tpu_torch"):
            loaded = Engine.load(str(tmp_path), device="cpu")
            got = loaded.infer(feat, lens)
        assert not loaded.loaded_buckets
        assert "retracing" in caplog.text and "2x64" in caplog.text, label
        np.testing.assert_array_equal(got[0], ref[0])
        (exp / "2x64.cpu.pt2").write_bytes(b"not a program")


def test_host_sync_stage_is_not_exported(tmp_path):
    """A bucket whose expert stage reads group sizes on the host cannot
    be exported: ValueError naming the stage."""
    eng = Engine(t_config(small_yaml()), random_params(),
                 EngineConfig(moe_impl="ragged", **BUCKET), device="cpu")
    with pytest.raises(ValueError, match="ragged"):
        eng.export_bucket(2, 64)
    with pytest.raises(ValueError, match="ragged"):
        eng.save(str(tmp_path), export_devices=("cpu",))


def test_build_export_then_infer_matches_jax(tmp_path, capsys):
    """``build --export`` writes the program of each bucket for the build
    device; ``infer -p`` serves from it and prints the JAX engine's
    logits within allclose(1e-5, 1e-3)."""
    feat = _write_inputs(tmp_path)
    t_build.main(["-c", str(tmp_path / "cfg.yaml"), "-m",
                  str(tmp_path / "ckpt.pt"), "-o", str(tmp_path / "e"),
                  "--buckets", "2x64", "--device", "cpu", "--export"])
    assert (tmp_path / "e" / "exported" / "2x64.cpu.pt2").is_file()
    from test_torch_engine import _jax_engine
    ref, _ = _jax_engine().infer(feat, np.array([57, 57], np.int32))
    np.save(tmp_path / "ref.npy", np.asarray(ref))
    capsys.readouterr()
    t_infer.main(["-p", str(tmp_path / "e"), "-i",
                  str(tmp_path / "feat.npy"), "-o", str(tmp_path / "ref.npy"),
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert "exported programs run: 2x64" in out
    assert "allclose(rtol=1e-05, atol=1e-03): True" in out
    assert engine_yaml()["nnet_proto"] in (tmp_path / "e" /
                                           "config.yaml").read_text()
    with pytest.raises(ValueError, match="cuda"):
        t_build.main(["-c", str(tmp_path / "cfg.yaml"), "-o",
                      str(tmp_path / "f"), "--buckets", "2x64", "--device",
                      "cpu", "--skip-warmup", "--export",
                      "--export_platforms", "cuda"])
