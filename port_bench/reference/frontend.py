"""WAV reading, the bucket ladder and the log-mel features, as the recipe
defines them (librosa's conventions): 16-bit PCM over 2^15, a periodic Hann
window, centred frames with reflect padding, the Slaney mel filterbank from
5 Hz, and ``log(mel + 1e-4)``."""

from __future__ import annotations

import math
import wave

import numpy as np
import torch

LOG_EPS = 1e-4


def read_wav(path: str) -> np.ndarray:
    """A mono 16-bit WAV as float32 in [-1, 1)."""
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: not mono 16-bit PCM")
        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    return pcm.astype(np.float32) / np.float32(32768.0)


def bucket_ladder(max_length: int, min_length: int) -> list:
    """Lengths from ``min_length`` doubling up to ``max_length``, each
    rounded up to a multiple of 1024 samples."""
    ladder, length = [], min_length
    while length < max_length:
        ladder.append(int(length))
        length = int(length * 2)
    ladder.append(int(max_length))
    return sorted({(x + 1023) // 1024 * 1024 for x in ladder})


def bucket_length(n: int, ladder: list) -> int:
    """The shortest ladder length that holds ``n`` samples (the last
    otherwise)."""
    for length in ladder:
        if n <= length:
            return length
    return ladder[-1]


def parse_mel(descriptor: str) -> tuple:
    """``mel_<n_fft>_<hop>_<n_mels>`` -> (n_fft, hop, n_mels)."""
    name, *args = descriptor.split("_")
    if name != "mel":
        raise ValueError(f"the reference computes mel features only, got "
                         f"{descriptor!r}")
    return tuple(int(a) for a in args)


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (math.log(6.4) / 27)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= 15.0,
                    1000.0 * np.exp(math.log(6.4) / 27 * (m - 15.0)),
                    m * (200.0 / 3))


def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 5.0) -> np.ndarray:
    """Slaney-normalized triangular filters (n_mels, n_fft // 2 + 1)."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(sr / 2.0),
                                   n_mels + 2))
    lower = (freqs[None, :] - edges[:-2, None]) / np.diff(edges)[:-1, None]
    upper = (edges[2:, None] - freqs[None, :]) / np.diff(edges)[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    fb *= (2.0 / (edges[2:] - edges[:-2]))[:, None]
    return fb.astype(np.float32)


def log_mel(wave_batch: torch.Tensor, lengths: torch.Tensor, descriptor: str,
            sr: int = 44100) -> tuple:
    """(B, L) float32 waves and valid samples -> ((B, M, T) log-mel, (B,)
    valid frames ``length // hop + 1``, at most T)."""
    n_fft, hop, n_mels = parse_mel(descriptor)
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float32,
                               device=wave_batch.device)
    spec = torch.stft(wave_batch.float(), n_fft, hop_length=hop,
                      window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(
        wave_batch.device)
    mel = torch.einsum("mf,bft->bmt", fb, spec.abs())
    frames = torch.clamp(lengths.long() // hop + 1, max=spec.shape[-1])
    return torch.log(mel + LOG_EPS), frames
