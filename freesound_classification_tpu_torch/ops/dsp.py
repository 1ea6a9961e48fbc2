"""Audio DSP: feature descriptors, the Slaney mel filterbank, log-mel features,
and the first-order IIR of the overdrive effect.

Counterpart of ``freesound_classification_tpu/ops/dsp.py`` for the mel, stft
and raw descriptors. The JAX package computes the STFT as a block-DFT matmul
shaped for the TPU's matrix unit; here it is ``torch.stft`` with the same
conventions (periodic Hann window, ``center=True`` reflect padding, one-sided,
not normalized), which is the function ``dsp._logmel_xla`` computes. The
magnitude -> mel -> log tail is the hand-written kernel K1
(``ops/kernels.mel_project_log``); the log-STFT magnitude of the ``stft_*``
descriptors is plain PyTorch, as it is plain XLA in the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from freesound_classification_tpu_torch.ops import kernels


class FeatureDescriptor(NamedTuple):
    """Parsed feature descriptor string.

    kind: "mel" | "stft" | "raw"
    n_fft/hop_size: STFT params (0 for "raw")
    n_mel: mel band count (0 unless kind == "mel")
    """

    kind: str
    n_fft: int
    hop_size: int
    n_mel: int

    @property
    def n_features(self) -> int:
        if self.kind == "mel":
            return self.n_mel
        if self.kind == "stft":
            return self.n_fft // 2 + 1
        return 1

    @property
    def padding_value(self) -> float:
        """What a padded frame holds (JAX ``FeatureDescriptor``)."""
        return 0.0


def parse_features(descriptor: str) -> FeatureDescriptor:
    """Parse "mel_<nfft>_<hop>_<nmel>", "stft_<nfft>_<hop>" or "raw"."""
    name, *args = descriptor.split("_")
    if name == "mel":
        n_fft, hop, n_mel = (int(a) for a in args)
        return FeatureDescriptor("mel", n_fft, hop, n_mel)
    if name == "stft":
        n_fft, hop = (int(a) for a in args)
        return FeatureDescriptor("stft", n_fft, hop, 0)
    if name == "raw":
        return FeatureDescriptor("raw", 0, 0, 0)
    raise ValueError(f"unknown feature descriptor: {descriptor!r}")


def _hz_to_mel_slaney(freqs: np.ndarray) -> np.ndarray:
    """Slaney-style Hz->mel: linear below 1 kHz, log above."""
    freqs = np.asarray(freqs, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(
        freqs >= min_log_hz,
        min_log_mel + np.log(np.maximum(freqs, 1e-10) / min_log_hz) / logstep,
        freqs / f_sp,
    )


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)),
        mels * f_sp,
    )


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 5.0,
    fmax: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular Slaney-normalized mel filterbank, shape (n_mels, 1 + n_fft//2).

    The same numbers as the JAX package's ``dsp.mel_filterbank`` (librosa's
    ``filters.mel`` with htk=False, norm="slaney"), computed in numpy.
    """
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_edges = np.linspace(
        _hz_to_mel_slaney(np.array(fmin)),
        _hz_to_mel_slaney(np.array(fmax)),
        n_mels + 2,
    )
    mel_f = _mel_to_hz_slaney(mel_edges)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney normalization: each triangle integrates to ~constant energy
    weights *= (2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(dtype)


def num_stft_frames(length: int, n_fft: int, hop_size: int) -> int:
    """Frame count of a center-padded STFT over `length` samples."""
    return 1 + (length + 2 * (n_fft // 2) - n_fft) // hop_size


def feature_frames(length: int, descriptor: str) -> int:
    """Number of feature frames produced for a waveform of `length` samples."""
    feat = parse_features(descriptor)
    if feat.kind == "raw":
        return length
    return num_stft_frames(length, feat.n_fft, feat.hop_size)


def stft(x: torch.Tensor, n_fft: int, hop_size: int) -> torch.Tensor:
    """One-sided complex STFT of a (B, L) waveform batch -> (B, F, T)."""
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float32,
                               device=x.device)
    return torch.stft(
        x.float(), n_fft, hop_length=hop_size, window=window, center=True,
        pad_mode="reflect", normalized=False, onesided=True,
        return_complex=True,
    )


MelProject = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def log_mel_spectrogram(
    x: torch.Tensor,
    filterbank: torch.Tensor,
    n_fft: int,
    hop_size: int,
    mel_project: MelProject = kernels.mel_project_log,
) -> torch.Tensor:
    """Waveform (B, L) -> log-mel (B, n_mels, T).

    ``mel_project(spec, filterbank)`` is K1 by default; pass
    ``kernels.mel_project_log_reference`` to run the plain twin on the card.
    """
    return mel_project(stft(x, n_fft, hop_size), filterbank)


def log_stft_spectrogram(x: torch.Tensor, n_fft: int,
                         hop_size: int) -> torch.Tensor:
    """Waveform (B, L) -> log STFT magnitude (B, F, T), log(|S| + 1e-4)
    (JAX ``dsp.log_stft_spectrogram``)."""
    return torch.log(stft(x, n_fft, hop_size).abs() + kernels.LOG_EPS)


def featurize(
    x: torch.Tensor,
    descriptor: str,
    filterbank: torch.Tensor | None = None,
    mel_project: MelProject = kernels.mel_project_log,
) -> torch.Tensor:
    """Waveform (B, L) -> features (B, n_features, T) for a mel or stft
    descriptor, or (B, 1, L) for "raw" (JAX ``dsp.featurize``)."""
    feat = parse_features(descriptor)
    if feat.kind == "mel":
        if filterbank is None:
            filterbank = torch.from_numpy(
                mel_filterbank(44100, feat.n_fft, feat.n_mel)).to(x.device)
        return log_mel_spectrogram(x, filterbank, feat.n_fft, feat.hop_size,
                                   mel_project=mel_project)
    if feat.kind == "stft":
        return log_stft_spectrogram(x, feat.n_fft, feat.hop_size)
    return x[:, None, :]


@functools.lru_cache(maxsize=None)
def iir_matrices(a: float, chunk: int, nc: int, device: torch.device
                 ) -> tuple:
    """``iir_first_order``'s constants on ``device``, built once per key:
    the (chunk, chunk) Toeplitz T[n, k] = a^(n-k), the (nc, nc) block-carry
    Toeplitz in a^chunk, and the decay a^(n+1), each in float64 numpy, then
    float32. The keys are the (coefficient, chunk, number of blocks,
    device) the callers give (one ``nc`` per bucket length), so the cache is
    bounded by them and never evicts."""
    n = np.arange(chunk)
    delta = n[:, None] - n[None, :]
    tri = np.where(delta >= 0, a ** np.maximum(delta, 0), 0.0)
    i = np.arange(nc)
    di = i[:, None] - i[None, :]
    tri2 = np.where(di >= 0, (a ** chunk) ** np.maximum(di, 0), 0.0)
    decay = a ** (n + 1)
    return tuple(torch.from_numpy(m.astype(np.float32)).to(device)
                 for m in (tri, tri2, decay))


def iir_first_order(u: torch.Tensor, a: float,
                    chunk: int = 512) -> torch.Tensor:
    """y[n] = u[n] + a * y[n-1] along the last axis of (B, L), y[-1] = 0,
    for |a| <= 1 (JAX ``dsp.iir_first_order``).

    Solved in float32 blocks: inside each block of ``chunk`` samples
    y = T u with the lower-triangular Toeplitz T[n, k] = a^(n-k); the block
    ends then carry into the next blocks through a second such product over
    the block index, weighted by a^(k+1). The matrices stay on the device
    (``iir_matrices``), so a call after the first copies nothing from the
    host. The products must run in full
    float32: a TF32 product (about 3 decimal digits) puts ~5e-2 absolute
    error into the overdrive's DC-blocking filter, so a CUDA input raises
    unless PyTorch's float32 matmul precision is "highest" (its default).
    """
    if u.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "iir_first_order needs full float32 matmuls; "
            "torch.get_float32_matmul_precision() is "
            f"{torch.get_float32_matmul_precision()!r} (TF32)")
    b, length = u.shape
    nc = -(-length // chunk)
    tri, tri2, decay = iir_matrices(float(a), chunk, nc, u.device)
    uc = torch.nn.functional.pad(u.float(), (0, nc * chunk - length))
    uc = uc.view(b, nc, chunk)
    y_local = uc @ tri.T  # (B, NC, C)
    ends = y_local[:, :, -1] @ tri2.T  # (B, NC): each block's final y
    carry_in = torch.nn.functional.pad(ends[:, :-1], (1, 0))
    y = y_local + carry_in[:, :, None] * decay
    return y.reshape(b, nc * chunk)[:, :length]
