"""Kaldi-compatible log-mel filterbank features from raw waveforms.

The reference extracts features on the fly with
torchaudio.compliance.kaldi.fbank (loader/augment.py:229-236, called
with num_mel_bins / frame_length / frame_shift / dither /
energy_floor=0.0 / sample_frequency, all other knobs at Kaldi
defaults). This is a dependency-free numpy implementation of exactly
that configuration space:

  snip-edges framing -> [dither] -> remove DC -> pre-emphasis 0.97
  -> povey window -> zero-pad to pow2 FFT -> power spectrum
  -> mel filterbank (Kaldi mel = 1127 ln(1 + f/700), low 20 Hz,
     high = Nyquist) -> log(max(x, eps))

Bit-compat note: matches torchaudio's kaldi.fbank to float32 tolerance
for dither=0 (dither draws RNG so only distributional equality holds);
the parity test (tests/test_fbank.py) asserts it when torchaudio is
importable and property-checks otherwise.

The port's numpy copy of ``m3asr_tpu/frontend/fbank.py``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np

EPSILON = 1.1920928955078125e-07  # float32 eps, torchaudio kaldi's floor


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=8)
def _povey_window(n: int) -> np.ndarray:
    # hann^0.85 (kaldi feature-window.cc); cached — the loader calls
    # fbank() once per utterance
    a = 2 * math.pi / (n - 1)
    return (0.5 - 0.5 * np.cos(a * np.arange(n))) ** 0.85


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, np.float64) / 700.0)


@functools.lru_cache(maxsize=8)
def mel_banks(num_bins: int, window_length_padded: int, sample_freq: float,
              low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi MelBanks (mel-computations.cc): triangular filters over the
    FFT bins, (num_bins, num_fft_bins) with num_fft_bins = padded/2."""
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    fft_bin_width = sample_freq / window_length_padded
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = mel_low + (bin_idx + 1) * mel_delta
    right_mel = mel_low + (bin_idx + 2) * mel_delta

    mel = mel_scale(fft_bin_width * np.arange(num_fft_bins))[None, :]
    up = (mel - left_mel) / (center_mel - left_mel)
    down = (right_mel - mel) / (right_mel - center_mel)
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def frame_signal(wave: np.ndarray, frame_size: int, frame_shift: int
                 ) -> np.ndarray:
    """snip_edges framing: m = 1 + (n - size) // shift frames."""
    n = wave.shape[0]
    if n < frame_size:
        return np.zeros((0, frame_size), np.float32)
    m = 1 + (n - frame_size) // frame_shift
    idx = (np.arange(m)[:, None] * frame_shift
           + np.arange(frame_size)[None, :])
    return wave[idx]


def fbank(wave: np.ndarray, num_mel_bins: int = 40,
          frame_length: float = 25.0, frame_shift: float = 10.0,
          dither: float = 0.0, energy_floor: float = 0.0,
          sample_frequency: float = 16000.0,
          preemphasis_coefficient: float = 0.97,
          remove_dc_offset: bool = True,
          rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Log-mel fbank of a 1-D waveform (Kaldi int16 scale, i.e. values
    in [-32768, 32767] like torchaudio.load_wav / kaldi). Returns
    (num_frames, num_mel_bins) float32.
    """
    wave = np.asarray(wave, np.float32).reshape(-1)
    frame_size = int(sample_frequency * frame_length / 1000)
    shift = int(sample_frequency * frame_shift / 1000)
    frames = frame_signal(wave, frame_size, shift).astype(np.float32)
    if frames.shape[0] == 0:
        return np.zeros((0, num_mel_bins), np.float32)

    if dither != 0.0:
        rng = rng or np.random.RandomState()
        frames = frames + dither * rng.randn(*frames.shape).astype(
            np.float32)
    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis_coefficient != 0.0:
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis_coefficient * prev
    frames = frames * _povey_window(frame_size)[None, :]

    padded = _next_pow2(frame_size)
    spec = np.fft.rfft(frames, n=padded, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, :padded // 2]

    banks = mel_banks(num_mel_bins, padded, sample_frequency)
    mel = power.astype(np.float32) @ banks.T
    return np.log(np.maximum(mel, EPSILON)).astype(np.float32)


def read_wav(path: str):
    """Minimal PCM16 WAV reader -> (waveform int16-scale float32 (n,),
    sample_rate). stdlib only (the reference leans on torchaudio/sox)."""
    import wave as _wave
    with _wave.open(path, "rb") as w:
        assert w.getsampwidth() == 2, "PCM16 only"
        n = w.getnframes()
        data = np.frombuffer(w.readframes(n), np.int16)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels())[:, 0]
        return data.astype(np.float32), w.getframerate()


def speed_perturb(wave: np.ndarray, speed: float) -> np.ndarray:
    """Speed perturbation by linear resampling — the functional
    equivalent of the reference's sox 'speed' effect
    (loader/augment.py:133-166); not bit-identical to sox's
    bandlimited resampler, but the standard 0.9/1.0/1.1 augmentation
    semantics (duration scales by 1/speed)."""
    if speed == 1.0:
        return wave
    n = wave.shape[0]
    m = int(round(n / speed))
    src = np.linspace(0.0, n - 1, m)
    return np.interp(src, np.arange(n), wave).astype(np.float32)
