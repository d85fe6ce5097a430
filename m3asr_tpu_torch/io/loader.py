"""Training/eval data loader.

Rebuilds the reference loader family (loader/ctc_aed_loader*.py):
threaded prefetch over Kaldi ark/scp feature archives, per-utterance
FeatureTransform (deltas + CMVN + splice) and CollateFunc augmentation,
fixed-size padded batches with lengths, resume-skip support
(loader/ctc_aed_loader_domain_acc.py:165-185 — resume skips the first
`skip_num` utterances of the stream).

For serving, batches can additionally be length-bucketed so the
engine compiles few shapes (the loader_conf 'bucket' option — replaces
TRT optimization profiles end to end).

The port's numpy copy of ``m3asr_tpu/io/loader.py``.
"""

from __future__ import annotations

import queue
from threading import Thread
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from m3asr_tpu_torch.frontend.augment import CollateFunc
from m3asr_tpu_torch.frontend.features import FeatureTransform
from m3asr_tpu_torch.io import kaldi_io


def put_thread(q: queue.Queue, generator, *args):
    try:
        for item in generator(*args):
            q.put(item)
            if item is None:
                break
    except BaseException as e:  # surface in the consumer, don't hang it
        q.put(e)


class DataLoader:
    """Streams padded batches from Kaldi archives.

    Args:
        feat_rspec: path to feats ark or scp ('.scp' suffix switches).
        label_rspec: optional int-vector ark with targets.
        training: enables augmentation.
        loader_conf: dict with feat_dim, add_deltas, delta_window,
            cmvn_file, lctx, rctx, batch_size, queue_size.
        collate_func: CollateFunc instance or None.
    """

    def __init__(self, feat_rspec: str, label_rspec: Optional[str] = None,
                 training: bool = False,
                 loader_conf: Optional[dict] = None,
                 collate_func: Optional[CollateFunc] = None,
                 aed_label_rspec: Optional[str] = None,
                 domain_rspec: Optional[str] = None,
                 acc_rspec: Optional[str] = None,
                 trans_file: Optional[str] = None):
        conf = dict(loader_conf or {})
        self.feat_rspec = feat_rspec
        self.label_rspec = label_rspec
        # on-the-fly wav -> fbank mode (the reference's raw-wav loader
        # path, loader/augment.py:169-240: speed perturb -> wav
        # distortion -> kaldi fbank); enabled by raw_wav=True with
        # feat_rspec pointing at a wav scp ("key /path.wav" lines)
        self.raw_wav = bool(conf.get("raw_wav", False))
        self.feature_extraction_conf = dict(conf.get(
            "feature_extraction_conf",
            {"mel_bins": conf.get("feat_dim", 40), "frame_length": 25,
             "frame_shift": 10}))
        self.speed_perturb = bool(conf.get("speed_perturb", False))
        self.wav_distortion_conf = conf.get("wav_distortion_conf")
        self._wav_rng = np.random.RandomState(conf.get("seed", 0))
        # auxiliary label streams of the deployed recipe
        # (ctc_aed_loader_domain_acc emits (data, target, domain, acc,
        # aed_target, lens...))
        self.aed_label_rspec = aed_label_rspec
        self.domain_rspec = domain_rspec
        self.acc_rspec = acc_rspec
        # per-utterance transcript side stream of the lattice loaders
        # ("uttid w1 w2 ..." lines, strictly parallel to the feature
        # stream and key-asserted; ctc_aed_lattice_loader.py:146-149,
        # 189-201) — the sMBR lattice tools consume it
        self.trans_file = trans_file
        self.training = training
        self.batch_size = conf.get("batch_size", 1)
        self.queue_size = conf.get("queue_size", 8)
        # drop utterances longer than max_len frames (the reference
        # loaders size fixed ring buffers to max_len and skip overlong
        # utterances, ctc_aed_loader_domain_acc.py produce()); 0 = off
        self.max_len = int(conf.get("max_len", 0))
        # frame decimation AFTER the feature transform
        # (ctc_aed_lattice_loader.py: feat = feat[::sampling])
        self.sampling = int(conf.get("sampling", 1))
        # optional bucket ladder: pad each batch's time axis up to the
        # next bucket so the engine compiles few shapes
        self.bucket_lengths = tuple(conf.get("bucket_lengths", ()))
        # dp-sharded training needs every batch the same size
        self.drop_last = bool(conf.get("drop_last", False))
        self.transform = FeatureTransform(
            conf.get("feat_dim", 40),
            order=conf.get("add_deltas", 0),
            window=conf.get("delta_window", 2),
            cmvn_file=conf.get("cmvn_file"),
            lctx=conf.get("lctx", 0), rctx=conf.get("rctx", 0))
        self.collate = collate_func or CollateFunc()

    @property
    def input_dim(self) -> int:
        return self.transform.input_dim

    def _read_feats(self) -> Iterator[Tuple[str, np.ndarray]]:
        if self.raw_wav:
            return self._read_wavs()
        reader = (kaldi_io.read_scp if self.feat_rspec.endswith(".scp")
                  else kaldi_io.read_ark)
        return reader(self.feat_rspec)

    def _read_wavs(self) -> Iterator[Tuple[str, np.ndarray]]:
        """wav scp -> fbank, with training-time speed perturbation and
        waveform distortion (loader/augment.py:169-240)."""
        from m3asr_tpu_torch.frontend import fbank as F
        from m3asr_tpu_torch.frontend.wav_distortion import distort_wav_conf
        fe = self.feature_extraction_conf
        dither = fe.get("wav_dither", 0.0) if self.training else 0.0
        with open(self.feat_rspec) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                key, path = parts[0], parts[1]
                wave, sr = F.read_wav(path)
                if self.training and self.speed_perturb:
                    speed = self._wav_rng.choice([0.9, 1.0, 1.1])
                    wave = F.speed_perturb(wave, float(speed))
                if self.training and self.wav_distortion_conf:
                    c = self.wav_distortion_conf
                    rate = c.get("distortion_rate", 0.0)
                    if rate > 0 and self._wav_rng.rand() < rate:
                        wave = distort_wav_conf(
                            wave / 32768.0, c["distortion_type"],
                            c.get("distortion_conf"),
                            rng=self._wav_rng) * 32768.0
                feat = F.fbank(
                    wave, num_mel_bins=fe.get("mel_bins", 40),
                    frame_length=fe.get("frame_length", 25),
                    frame_shift=fe.get("frame_shift", 10),
                    dither=dither, sample_frequency=sr,
                    rng=self._wav_rng)
                yield key, feat

    def _utterances(self, skip_num: int = 0):
        labels: Dict[str, np.ndarray] = {}
        if self.label_rspec:
            labels = dict(kaldi_io.read_int_vector_ark(self.label_rspec))
        aux = {}
        for name, rspec in (("aed_target", self.aed_label_rspec),
                            ("domain", self.domain_rspec),
                            ("acc", self.acc_rspec)):
            if rspec:
                aux[name] = dict(kaldi_io.read_int_vector_ark(rspec))
        trans_fh = open(self.trans_file) if self.trans_file else None
        n = 0
        try:
            for key, feat in self._read_feats():
                trans = None
                if trans_fh is not None:
                    # the transcript stream is strictly parallel to the
                    # feature stream — advance it for every feat, even
                    # skipped ones, and key-assert
                    # (ctc_aed_lattice_loader.py:189-201)
                    trans = trans_fh.readline()
                    head = trans.split(maxsplit=1)[:1]
                    assert head and head[0] == key, \
                        f"trans_file out of sync at {key!r}: " + \
                        ("exhausted/blank line" if not head
                         else repr(head[0]))
                    trans = trans.rstrip("\n")
                if self.label_rspec and key not in labels:
                    continue
                # effective post-pipeline length without running the
                # transform (deltas/CMVN/splice are length-preserving):
                # cheap enough to evaluate for resume-skipped utterances
                eff_len = -(-feat.shape[0] // self.sampling)
                if self.max_len and eff_len > self.max_len:
                    continue  # overlong utterance (ring-buffer cap)
                # n counts only consumable utterances, so resume_skip
                # (the Trainer's consumed-row counter) aligns exactly
                n += 1
                if n <= skip_num:
                    continue  # resume skip (ctc_aed_loader:165-185)
                feat = self.transform.transform(feat)
                if self.sampling > 1:
                    feat = feat[::self.sampling]
                feat = self.collate(feat, self.training)
                extra = {name: d.get(key) for name, d in aux.items()}
                if trans is not None:
                    extra["trans"] = trans
                yield (key, np.asarray(feat, np.float32), labels.get(key),
                       extra)
        finally:
            if trans_fh is not None:
                trans_fh.close()

    def _batches(self, skip_num: int, output_keys: bool):
        batch: List = []
        for item in self._utterances(skip_num):
            batch.append(item)
            if len(batch) == self.batch_size:
                yield self._pad(batch, output_keys, self.bucket_lengths)
                batch = []
        if batch and not self.drop_last:
            yield self._pad(batch, output_keys, self.bucket_lengths)
        yield None

    @staticmethod
    def _pad_labels(labels):
        B = len(labels)
        U = max(len(l) for l in labels)
        tgt = np.zeros((B, U), np.int32)
        tlens = np.zeros((B,), np.int32)
        for i, l in enumerate(labels):
            tgt[i, : len(l)] = l
            tlens[i] = len(l)
        return tgt, tlens

    @staticmethod
    def _pad(batch, output_keys, bucket_lengths=()):
        keys = [k for k, _, _, _ in batch]
        feats = [f for _, f, _, _ in batch]
        labels = [l for _, _, l, _ in batch]
        extras = [e for _, _, _, e in batch]
        B = len(batch)
        T = max(f.shape[0] for f in feats)
        if bucket_lengths:
            T = next((b for b in sorted(bucket_lengths) if b >= T), T)
        D = feats[0].shape[1]
        data = np.zeros((B, T, D), np.float32)
        lens = np.zeros((B,), np.int32)
        for i, f in enumerate(feats):
            data[i, : f.shape[0]] = f
            lens[i] = f.shape[0]
        out = {"data": data, "lens": lens}
        if labels[0] is not None:
            out["target"], out["target_lens"] = DataLoader._pad_labels(labels)
        for name in extras[0]:
            vals = [e[name] for e in extras]
            if vals[0] is None:
                continue
            if name == "trans":  # raw transcript lines (lattice loaders)
                out[name] = vals
            elif name in ("domain", "acc"):  # scalar class ids
                out[name] = np.asarray([int(v[0]) for v in vals], np.int32)
            else:
                out[name], out[name + "_lens"] = DataLoader._pad_labels(vals)
        if output_keys:
            out["keys"] = keys
        return out

    def __call__(self, skip_num: int = 0, output_keys: bool = False):
        """Threaded-prefetch batch iterator (the reference's putThread
        queue pattern, loader/utils.py:31-37)."""
        q: queue.Queue = queue.Queue(self.queue_size)
        thread = Thread(target=put_thread,
                        args=(q, self._batches, skip_num, output_keys),
                        daemon=True)
        thread.start()
        while True:
            item = q.get()
            q.task_done()
            if item is None:
                break
            if isinstance(item, BaseException):
                thread.join()
                raise item
            yield item
        thread.join()
