"""The PyTorch port's recognizer (``python -m m3asr_tpu_torch.recognize``)
against the JAX package's root ``recognize.py``, on the CPU.

One checkpoint holds the small hier MoE conformer (tests/test_runtime.py)
and three AED decoders (decoder, decoder_1, decoder_2), as in
tests/test_recognize_cli.py. The port's ``build`` and the root
``build.py`` each make an engine dir from it (both called in process);
the two dirs must hold the same weights and decoders, bit for bit, and
the port's ``build --strict`` must consume every key. Then every flow of
the recognizer runs in process: the JAX recognizer on the port-built dir
(so it reads the port's ``decoders.npz``), the port's on both dirs. The
printed transcripts and the CER, utterance and frame counts of the stats
line must be equal.
"""

import json
import struct
import wave

import jax
import numpy as np
import pytest
import torch
import yaml

import build as j_build
import recognize as j_recognize
from golden import torch_ref as G

from m3asr_tpu_torch import build as t_build
from m3asr_tpu_torch import recognize as t_recognize
from m3asr_tpu_torch.io.kaldi_io import ArkWriter

from test_runtime import golden_model, small_yaml

V = 11
DECODERS = ("decoder", "decoder_1", "decoder_2")


def _write_wav(path, samples):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(samples.astype(np.int16).tobytes())


def _port_build(ckpt, cfg, out, *flags):
    t_build.main(["-c", str(cfg), "-m", str(ckpt), "-o", str(out),
                  "--buckets", "2x64", "--skip-warmup", "--device", "cpu",
                  *flags])


def _jax_call(fn, ns):
    """Run a JAX CLI main in process; it points the JAX compilation cache
    at the engine dir, so put the test process's setting back after."""
    cache = jax.config.jax_compilation_cache_dir
    try:
        return fn(ns)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("recognize")
    sd = {f"encoder.{k}": v
          for k, v in golden_model().state_dict().items()}
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

    rng = np.random.RandomState(0)
    with ArkWriter(str(d / "feats.ark")) as w:
        for i in range(3):
            w.write(f"utt{i}", rng.randn(30 + 5 * i, 20).astype(np.float32))
    with ArkWriter(str(d / "long.ark")) as w:
        w.write("uttL", rng.randn(150, 20).astype(np.float32))
        w.write("uttS", rng.randn(40, 20).astype(np.float32))
    with open(d / "labels.ark", "wb") as f:
        for i, lab in enumerate(([1, 2], [3], [2, 2, 4])):
            f.write(f"utt{i} ".encode() + b"\x00B\x04"
                    + struct.pack("<i", len(lab)))
            for x in lab:
                f.write(b"\x04" + struct.pack("<i", x))
    data = np.random.RandomState(4).randn(300, 20)
    (d / "cmvn.txt").write_text(
        "[\n " + " ".join(map(str, data.sum(0))) + f" {len(data)}\n "
        + " ".join(map(str, (data ** 2).sum(0))) + " 0 ]\n")
    (d / "ctx.txt").write_text("1 2\n3\n")
    (d / "units").write_text("".join(f"u{i} {i}\n" for i in range(V)))
    (d / "lm.arpa").write_text(
        "\\data\\\nngram 1=4\n\n\\1-grams:\n"
        "-0.5 1 -0.3\n-0.7 2 -0.2\n-1.0 <s> -0.1\n-0.9 </s>\n\n\\end\\\n")
    with open(d / "wav.scp", "w") as f:
        for i in range(2):
            t = np.arange(5600) / 16000.0
            _write_wav(d / f"w{i}.wav", 6000 * np.sin(
                2 * np.pi * (300 + 250 * i) * t) + 200 * rng.randn(5600))
            f.write(f"wav{i} {d / f'w{i}.wav'}\n")

    ckpt, cfg = d / "ckpt.pt", d / "cfg.yaml"
    _port_build(ckpt, cfg, d / "port", "--strict")
    ns = t_build.parse_args(["-c", str(cfg), "-m", str(ckpt), "-o",
                             str(d / "root"), "--buckets", "2x64",
                             "--skip-warmup"])
    ns.export_platforms = "tpu,cpu"
    _jax_call(j_build.main, ns)
    for out in ("topk", "beam"):
        _port_build(ckpt, cfg, d / out, "--decode_output", out,
                    "--decode_topk", "4")
    return d


def test_build_dirs_equal_and_strict(work, capsys):
    """Both builds write the same params.npz and decoders.npz (the JAX
    flat paths, bit-equal); the port's --strict build consumed every
    key, decoders included."""
    for name in ("params.npz", "decoders.npz"):
        with np.load(work / "port" / name) as a, \
                np.load(work / "root" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with np.load(work / "port" / "decoders.npz") as z:
        assert {k.split("/")[0] for k in z.files} == set(DECODERS)
    _port_build(work / "ckpt.pt", work / "cfg.yaml", work / "strict",
                "--strict", "-cmvn", str(work / "cmvn.txt"))
    out = capsys.readouterr().out
    assert "keys consumed" in out and "NOT consumed" not in out
    assert "decoders saved" in out


# (engine dir, input, recognize flags); -l labels and --feat_dim 20 on
# every flow but --raw_wav, whose wavs have no labels
FLOWS = {
    "greedy_timestamps_cmvn": ("port", "feats.ark",
                               ["-d", "greedy", "--timestamps", "--cmvn",
                                "cmvn.txt"]),
    "greedy_units": ("port", "feats.ark", ["-d", "greedy", "--units",
                                           "units"]),
    "beam": ("port", "feats.ark", ["-d", "beam", "-b", "4"]),
    "beam_ext_lm_context": ("port", "feats.ark",
                            ["-d", "beam", "-b", "4", "--timestamps",
                             "--lm", "lm.arpa", "--lm_weight", "0.3",
                             "--context_file", "ctx.txt",
                             "--context_bonus", "0.5"]),
    "topk_beam": ("topk", "feats.ark", ["-d", "beam", "-b", "4"]),
    "topk_greedy_timestamps": ("topk", "feats.ark",
                               ["-d", "greedy", "--timestamps"]),
    "topk_rescore_lm_context": ("topk", "feats.ark",
                                ["-d", "rescore", "-b", "4", "--lm",
                                 "lm.arpa", "--lm_weight", "0.1",
                                 "--context_file", "ctx.txt"]),
    "beam_engine": ("beam", "feats.ark", ["-d", "beam", "-b", "4"]),
    "beam_engine_rescore": ("beam", "feats.ark",
                            ["-d", "rescore", "-b", "4"]),
    "rescore": ("port", "feats.ark", ["-d", "rescore", "-b", "4"]),
    "rescore_lm_context": ("port", "feats.ark",
                           ["-d", "rescore", "-b", "4", "--lm", "lm.arpa",
                            "--context_file", "ctx.txt"]),
    "hier_rescore": ("port", "feats.ark",
                     ["-d", "rescore", "-b", "4", "--hier_rescore",
                      "--ctc_weight", "0.3"]),
    "attention": ("port", "feats.ark", ["-d", "attention", "-b", "3"]),
    "long_beam": ("port", "long.ark", ["-d", "beam", "-b", "4",
                                       "--long_overlap", "16"]),
    "long_hier_rescore": ("port", "long.ark",
                          ["-d", "rescore", "-b", "4", "--hier_rescore",
                           "--long_overlap", "16"]),
    "long_topk_greedy": ("topk", "long.ark", ["-d", "greedy",
                                              "--batch_size", "1"]),
    "raw_wav": ("port", "wav.scp", ["-d", "greedy", "--raw_wav"]),
}


def _argv(work, engine, inp, flags):
    argv = ["-p", str(work / engine), "-i", str(work / inp),
            "--feat_dim", "20", "--batch_size", "2"]
    if inp == "feats.ark":
        argv += ["-l", str(work / "labels.ark")]
    # file arguments live in the work dir
    return argv + [str(work / f) if (work / f).is_file() else f
                   for f in flags]


def _lines_and_stats(capsys):
    cap = capsys.readouterr()
    lines = [l for l in cap.out.splitlines() if l.strip()]
    stats = json.loads(cap.err.strip().splitlines()[-1])
    return lines, {k: stats.get(k) for k in ("utts", "frames", "cer")}


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_recognize_flow_equals_jax(work, capsys, flow):
    engine, inp, flags = FLOWS[flow]
    argv = _argv(work, engine, inp, flags)
    _jax_call(j_recognize.main, t_recognize.parse_args(argv))
    ref = _lines_and_stats(capsys)
    dirs = [engine] + (["root"] if engine == "port" else [])
    for d in dirs:
        got_stats = t_recognize.main(_argv(work, d, inp, flags)
                                     + ["--device", "cpu"])
        got = _lines_and_stats(capsys)
        assert got == ref, (flow, d)
        assert set(got_stats["split_s"]) == {
            "loader", "engine", "search", "aed", "memory_h2d"}
    n_utts = {"feats.ark": 3, "long.ark": 2, "wav.scp": 2}[inp]
    assert ref[1]["utts"] == n_utts and len(ref[0]) == n_utts
    if inp == "feats.ark":
        assert ref[1]["cer"] is not None


def test_recognize_refuses_what_jax_refuses(work, capsys):
    """Attention decoding past the largest bucket, --lm with greedy and
    hotwords on an on-device beam engine exit as the JAX recognizer
    does."""
    for engine, inp, flags in (
            ("port", "long.ark", ["-d", "attention"]),
            ("port", "feats.ark", ["-d", "greedy", "--lm", "lm.arpa"]),
            ("beam", "feats.ark", ["-d", "beam", "--context_file",
                                   "ctx.txt"])):
        argv = _argv(work, engine, inp, flags)
        with pytest.raises(SystemExit) as ref:
            _jax_call(j_recognize.main, t_recognize.parse_args(argv))
        with pytest.raises(SystemExit) as got:
            t_recognize.main(argv + ["--device", "cpu"])
        assert str(got.value).split()[:3] == str(ref.value).split()[:3]
    capsys.readouterr()


def test_recognize_defaults_to_the_card(work):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_recognize.main(_argv(work, "port", "feats.ark", ["-d", "greedy"]))
