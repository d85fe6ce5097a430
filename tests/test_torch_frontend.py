"""The PyTorch port's data pipeline against the JAX package's copy, on the
CPU: Kaldi IO (binary, compressed and text matrices, ark/scp, int-vector
arks, the writer), the native ark reader against the Python reader and
its hand-over on arks it does not parse, the features (deltas, CMVN,
splice, FeatureTransform), fbank (and the golden fixture), wav reading
and speed perturbation, augmentation, waveform distortion, the
DataLoader's batches and the CER. Both packages are numpy here, so every
result must be bit-equal on the same seeded inputs (the fbank fixture:
allclose(rtol 1e-4, atol 1e-3), its own test's standard).
"""

import json
import os
import random
import struct
import wave

import numpy as np
import pytest

from m3asr_tpu.frontend import augment as j_augment
from m3asr_tpu.frontend import fbank as j_fbank
from m3asr_tpu.frontend import features as j_features
from m3asr_tpu.frontend import wav_distortion as j_distortion
from m3asr_tpu.io import kaldi_io as j_kaldi_io
from m3asr_tpu.io.loader import DataLoader as JDataLoader
from m3asr_tpu.utils import text as j_text

from m3asr_tpu_torch.frontend import augment as t_augment
from m3asr_tpu_torch.frontend import fbank as t_fbank
from m3asr_tpu_torch.frontend import features as t_features
from m3asr_tpu_torch.frontend import wav_distortion as t_distortion
from m3asr_tpu_torch.io import kaldi_io as t_kaldi_io
from m3asr_tpu_torch.io import native_io as t_native_io
from m3asr_tpu_torch.io.loader import DataLoader
from m3asr_tpu_torch.utils import text as t_text

HERE = os.path.dirname(os.path.abspath(__file__))


def _compressed(rows, cols, rng):
    """A Kaldi CompressedMatrix (format 1) entry's payload after "\\0B"."""
    headers = np.sort(rng.integers(0, 65536, (cols, 4)), axis=1)
    data = rng.integers(0, 256, (cols, rows))
    return (b"CM " + struct.pack("<ff", -3.0, 7.5)
            + struct.pack("<ii", rows, cols)
            + headers.astype(np.uint16).tobytes()
            + data.astype(np.uint8).tobytes())


def _write_arks(tmp_path, seed=0):
    """A binary ark (+ scp), a mixed ark (binary, then compressed, then
    binary) and a text ark. Returns their paths and the binary mats."""
    rng = np.random.default_rng(seed)
    mats = {f"u{i}": rng.standard_normal((5 + 3 * i, 8)).astype(np.float32)
            for i in range(4)}
    with t_kaldi_io.ArkWriter(str(tmp_path / "b.ark"),
                              str(tmp_path / "b.scp")) as w:
        for k, m in mats.items():
            w.write(k, m)
    with open(tmp_path / "mixed.ark", "wb") as f:
        for i, key in enumerate(("m0", "m1", "m2")):
            f.write(key.encode() + b" \x00B")
            if i == 1:
                f.write(_compressed(6, 8, rng))
            else:
                m = rng.standard_normal((4, 8)).astype(np.float32)
                f.write(b"FM \x04" + struct.pack("<i", 4) + b"\x04"
                        + struct.pack("<i", 8) + m.tobytes())
    with open(tmp_path / "text.ark", "w") as f:
        f.write("t0  [\n  1.0 2.5\n  -3.0 4.0 ]\nt1 [ 0.5 6\n 7 8 ]\n")
    return mats


def _same(got, ref):
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["b.ark", "mixed.ark", "text.ark", "b.scp"])
def test_kaldi_readers_equal_jax(tmp_path, name):
    _write_arks(tmp_path)
    path = str(tmp_path / name)
    if name.endswith(".scp"):
        _same(list(t_kaldi_io.read_scp(path)),
              list(j_kaldi_io.read_scp(path)))
        return
    _same(list(t_kaldi_io.read_ark(path)), list(j_kaldi_io.read_ark(path)))
    _same(list(t_kaldi_io.read_ark_py(path)),
          list(j_kaldi_io.read_ark_py(path)))


def test_writer_bytes_equal_jax(tmp_path):
    mats = _write_arks(tmp_path)
    with j_kaldi_io.ArkWriter(str(tmp_path / "j.ark"),
                              str(tmp_path / "j.scp")) as w:
        for k, m in mats.items():
            w.write(k, m)
    assert (tmp_path / "j.ark").read_bytes() == \
        (tmp_path / "b.ark").read_bytes()
    assert (tmp_path / "j.scp").read_text().replace("j.ark", "b.ark") == \
        (tmp_path / "b.scp").read_text()


def test_native_reader_equals_python_and_hands_over(tmp_path):
    """The C++ reader (built by the port into its own build dir) equals
    the Python reader on a binary ark, raises UnsupportedArk on a
    compressed entry, and read_ark then carries on in Python without
    repeating what it already yielded."""
    mats = _write_arks(tmp_path)
    assert t_native_io.available(), t_native_io.load_error()
    got = list(t_native_io.read_ark(str(tmp_path / "b.ark")))
    _same(got, list(t_kaldi_io.read_ark_py(str(tmp_path / "b.ark"))))
    assert [k for k, _ in got] == list(mats)
    it = t_native_io.read_ark(str(tmp_path / "mixed.ark"))
    assert next(it)[0] == "m0"
    with pytest.raises(t_native_io.UnsupportedArk):
        next(it)
    mixed = list(t_kaldi_io.read_ark(str(tmp_path / "mixed.ark")))
    assert [k for k, _ in mixed] == ["m0", "m1", "m2"]
    _same(mixed, list(t_kaldi_io.read_ark_py(str(tmp_path / "mixed.ark"))))


def test_int_vector_ark_and_matrix_files_equal_jax(tmp_path):
    with open(tmp_path / "lab.ark", "wb") as f:
        for key, lab in (("a", [3, 1, 4]), ("b", [])):
            f.write(key.encode() + b" \x00B\x04" + struct.pack("<i", len(lab)))
            for x in lab:
                f.write(b"\x04" + struct.pack("<i", x))
    with open(tmp_path / "lab.txt", "w") as f:
        f.write("a 3 1 4\nb \nc 9\n")
    for name in ("lab.ark", "lab.txt"):
        _same(list(t_kaldi_io.read_int_vector_ark(str(tmp_path / name))),
              list(j_kaldi_io.read_int_vector_ark(str(tmp_path / name))))
    (tmp_path / "m.txt").write_text(" [\n 1 2 3\n 4 5 6 ]\n")
    np.testing.assert_array_equal(
        t_kaldi_io.read_kaldi_matrix(str(tmp_path / "m.txt")),
        j_kaldi_io.read_kaldi_matrix(str(tmp_path / "m.txt")))


def _cmvn_files(tmp_path, dim=6):
    rng = np.random.default_rng(1)
    data = rng.standard_normal((500, dim)) * 3 + 5
    s, sq = data.sum(0), (data ** 2).sum(0)
    (tmp_path / "cmvn.txt").write_text(
        "[\n " + " ".join(map(str, s)) + f" {len(data)}\n "
        + " ".join(map(str, sq)) + " 0 ]\n")
    stats = np.stack([np.append(s, len(data)), np.append(sq, 0.0)])
    with open(tmp_path / "cmvn.bin", "wb") as f:
        f.write(b"\x00BDM \x04" + struct.pack("<i", 2) + b"\x04"
                + struct.pack("<i", dim + 1) + stats.astype(np.float64)
                .tobytes())
    (tmp_path / "cmvn.json").write_text(json.dumps(
        {"means": list(data.mean(0)), "istds": list(1 / data.std(0))}))


@pytest.mark.parametrize("name", ["cmvn.txt", "cmvn.bin", "cmvn.json"])
def test_cmvn_equals_jax(tmp_path, name):
    _cmvn_files(tmp_path)
    mean, istd = t_features.read_kaldi_cmvn(str(tmp_path / name))
    jmean, jistd = j_features.read_kaldi_cmvn(str(tmp_path / name))
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(istd, jistd)
    x = np.random.default_rng(2).standard_normal((7, 6)).astype(np.float32)
    np.testing.assert_array_equal(t_features.apply_cmvn(x, mean, istd),
                                  j_features.apply_cmvn(x, jmean, jistd))


@pytest.mark.parametrize("order,window,lctx,rctx", [
    (0, 2, 0, 0), (2, 2, 0, 0), (1, 3, 2, 1), (2, 2, 1, 3)])
def test_feature_transform_equals_jax(tmp_path, order, window, lctx, rctx):
    feat = np.random.default_rng(3).standard_normal((23, 5)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        t_features.compute_deltas(feat, max(order, 1), window),
        j_features.compute_deltas(feat, max(order, 1), window))
    np.testing.assert_array_equal(t_features.splice(feat, lctx, rctx),
                                  j_features.splice(feat, lctx, rctx))
    _cmvn_files(tmp_path, dim=5 * (1 + order))
    kw = dict(order=order, window=window, lctx=lctx, rctx=rctx,
              cmvn_file=str(tmp_path / "cmvn.txt"))
    ours = t_features.FeatureTransform(5, **kw)
    theirs = j_features.FeatureTransform(5, **kw)
    assert ours.input_dim == theirs.input_dim
    np.testing.assert_array_equal(ours.transform(feat),
                                  theirs.transform(feat))


def _tone_wave(n=16000, seed=4):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    w = 8000 * np.sin(2 * np.pi * 440 * t) + 300 * rng.standard_normal(n)
    return np.clip(w, -32768, 32767).astype(np.int16)


def _write_wav(path, samples, rate=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(samples.tobytes())


@pytest.mark.parametrize("bins,dither", [(40, 0.0), (80, 0.0), (40, 1.0)])
def test_fbank_equals_jax(bins, dither):
    w = _tone_wave().astype(np.float32)
    got = t_fbank.fbank(w, num_mel_bins=bins, dither=dither,
                        rng=np.random.RandomState(5))
    ref = j_fbank.fbank(w, num_mel_bins=bins, dither=dither,
                        rng=np.random.RandomState(5))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(t_fbank.speed_perturb(w, 1.1),
                                  j_fbank.speed_perturb(w, 1.1))


def test_fbank_golden_fixture():
    fix = np.load(os.path.join(HERE, "fixtures", "fbank_golden.npz"))
    for name in ("noise", "tones", "quantized"):
        for bins in (40, 80):
            ours = t_fbank.fbank(fix[f"wave_{name}"], num_mel_bins=bins,
                                 sample_frequency=16000)
            ref = fix[f"feat_{name}_{bins}"]
            assert ours.shape == ref.shape
            np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-3)


def test_read_wav_equals_jax(tmp_path):
    _write_wav(tmp_path / "a.wav", _tone_wave(8000))
    got, sr = t_fbank.read_wav(str(tmp_path / "a.wav"))
    ref, jsr = j_fbank.read_wav(str(tmp_path / "a.wav"))
    assert sr == jsr == 16000
    np.testing.assert_array_equal(got, ref)


def test_augmentation_equals_jax():
    x = np.random.default_rng(6).standard_normal((200, 12)) \
        .astype(np.float32)
    conf = dict(warp_for_time=True, num_t_mask=2, num_f_mask=2, max_t=30,
                max_f=4, max_w=40)
    np.testing.assert_array_equal(
        t_augment.spec_augmentation(x, rng=random.Random(7), **conf),
        j_augment.spec_augmentation(x, rng=random.Random(7), **conf))
    np.testing.assert_array_equal(
        t_augment.spec_substitute(x, rng=random.Random(8)),
        j_augment.spec_substitute(x, rng=random.Random(8)))
    np.testing.assert_array_equal(
        t_augment.feature_dither(x, 0.5, np.random.RandomState(9)),
        j_augment.feature_dither(x, 0.5, np.random.RandomState(9)))
    kw = dict(spec_aug=True, spec_aug_conf={"max_t": 20},
              spec_sub=True)
    random.seed(10)
    got = t_augment.CollateFunc(**kw)(x, True)
    random.seed(10)
    ref = j_augment.CollateFunc(**kw)(x, True)
    np.testing.assert_array_equal(got, ref)
    assert t_augment.CollateFunc(**kw)(x, False) is x


@pytest.mark.parametrize("kind,conf", [
    ("gain_db", {"db": -6}), ("max_distortion", {"max_db": -3}),
    ("fence_distortion", {"mask_number": 3, "max_db": -5}),
    ("jag_distortion", {"mask_number": 0}),
    ("poly_distortion", {"a": 1, "m": 2, "n": 1}),
    ("quad_distortion", None), ("none_distortion", None)])
def test_wav_distortion_equals_jax(kind, conf):
    x = (_tone_wave(4000).astype(np.float64) / 32768.0)[None]
    random.seed(11)
    got = t_distortion.distort_wav_conf(x, kind, conf, rate=0.5,
                                        rng=np.random.RandomState(12))
    random.seed(11)
    ref = j_distortion.distort_wav_conf(x, kind, conf, rate=0.5,
                                        rng=np.random.RandomState(12))
    np.testing.assert_array_equal(got, ref)


def _batches(loader_cls, rspec, labels, **conf):
    out = []
    for b in loader_cls(rspec, labels, loader_conf=conf)(output_keys=True):
        out.append(b)
    return out


def _same_batches(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "keys":
                assert a[k] == b[k]
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("setting", ["ark", "scp", "cmvn_deltas",
                                     "buckets_max_len", "raw_wav"])
def test_data_loader_batches_equal_jax(tmp_path, setting):
    rng = np.random.default_rng(13)
    with t_kaldi_io.ArkWriter(str(tmp_path / "f.ark"),
                              str(tmp_path / "f.scp")) as w:
        for i, T in enumerate((30, 12, 45, 9, 21)):
            w.write(f"u{i}", rng.standard_normal((T, 5)).astype(np.float32))
    with open(tmp_path / "lab.txt", "w") as f:
        f.write("u0 1 2\nu1 3\nu2 4 5 6\nu4 7\n")
    rspec, labels = str(tmp_path / "f.ark"), str(tmp_path / "lab.txt")
    conf = {"feat_dim": 5, "batch_size": 2}
    if setting == "scp":
        rspec = str(tmp_path / "f.scp")
    elif setting == "cmvn_deltas":
        _cmvn_files(tmp_path, dim=15)
        conf.update(add_deltas=2, cmvn_file=str(tmp_path / "cmvn.txt"),
                    lctx=1, rctx=1)
    elif setting == "buckets_max_len":
        conf.update(bucket_lengths=(16, 32, 64), max_len=40, sampling=2)
    elif setting == "raw_wav":
        with open(tmp_path / "wav.scp", "w") as f:
            for i, n in enumerate((4000, 7000, 5200)):
                _write_wav(tmp_path / f"w{i}.wav", _tone_wave(n, seed=i))
                f.write(f"u{i} {tmp_path / f'w{i}.wav'}\n")
        rspec = str(tmp_path / "wav.scp")
        conf.update(raw_wav=True, feature_extraction_conf={
            "mel_bins": 5, "frame_length": 25, "frame_shift": 10})
    got = _batches(DataLoader, rspec, labels, **conf)
    ref = _batches(JDataLoader, rspec, labels, **conf)
    assert got
    _same_batches(got, ref)


def test_cer_equals_jax():
    rng = np.random.default_rng(14)
    refs = [list(rng.integers(0, 6, n)) for n in (0, 3, 8, 12)]
    hyps = [list(rng.integers(0, 6, n)) for n in (2, 3, 5, 14)]
    for r, h in zip(refs, hyps):
        assert t_text.edit_distance(r, h) == j_text.edit_distance(r, h)
    assert t_text.cer(refs, hyps) == j_text.cer(refs, hyps)
    assert t_text.edit_distance([1, 2, 3], [1, 3, 4])[0] == 2
    assert t_text.cer([[1, 2, 3]], [[1, 3, 4]]) == 2 / 3
