"""Phase-vocoder time stretch (JAX ``ops/pv.py``, the kernel route).

Per row, stretch by ``rate`` (rate > 1: shorter) with phase-coherent
resynthesis, in the row's own static buffer:

1. analysis: ``torch.stft`` (periodic Hann, center reflect padding, the
   conventions of the JAX package's block-DFT prologue) -> magnitudes,
   phases and the deviation-corrected phase advance per analysis hop;
2. resynthesis: K3 (``kernels.pv_resynth``): magnitude lerp, the tiled
   phase carry, bf16 inverse rDFT and overlap-add;
3. window-squared normalization, crop of the center padding, and the new
   valid length ``min(int(length / rate), L)``.

The port computes the kernel's function at every size; the JAX package
routes small inputs to its XLA formulation, which differs in the phase
carry (one unwrapped running sum) and synthesizes no frames past t_out.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from freesound_classification_tpu_torch.ops import kernels


def _princarg(x: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi] (round half to even, as jnp.round)."""
    return x - 2.0 * math.pi * torch.round(x / (2.0 * math.pi))


def analysis(wave: torch.Tensor, n_fft: int, hop: int):
    """(B, L) -> mag (B, t_in, F), dphi (B, t_in - 1, F), phase0 (B, F),
    all float32: the PV's analysis prologue."""
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float32,
                               device=wave.device)
    spec = torch.stft(wave.float(), n_fft, hop_length=hop, window=window,
                      center=True, pad_mode="reflect", normalized=False,
                      onesided=True, return_complex=True).transpose(1, 2)
    re, im = spec.real, spec.imag
    mag = torch.sqrt(re * re + im * im).contiguous()
    phase = torch.atan2(im, re)
    n_bins = n_fft // 2 + 1
    expected = (2.0 * math.pi * torch.arange(
        n_bins, dtype=torch.float32, device=wave.device) / n_fft) * hop
    dphi = _princarg(phase[:, 1:] - phase[:, :-1] - expected) + expected
    return mag, dphi.contiguous(), phase[:, 0].contiguous()


@functools.lru_cache(maxsize=8)
def _window_sum(n_fft: int, hop: int, t_out: int) -> np.ndarray:
    """Overlap-added squared Hann window of t_out frames (numpy f32)."""
    rows = t_out + n_fft // hop - 1
    wsum = np.zeros(rows * hop, np.float32)
    w = np.asarray(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft)
                                      / n_fft), np.float32)
    for k in range(t_out):
        wsum[k * hop: k * hop + n_fft] += w * w
    return np.maximum(wsum, 1e-8)


@functools.lru_cache(maxsize=8)
def _bases(n_fft: int, device: torch.device):
    return tuple(torch.from_numpy(b).to(device=device, dtype=torch.bfloat16)
                 for b in kernels.synthesis_basis(n_fft))


def phase_vocoder_stretch(wave: torch.Tensor, lengths: torch.Tensor,
                          rate: torch.Tensor, n_fft: int = 2048,
                          hop: int = 512):
    """Stretch each (B, L) row by ``rate`` (B,) in (0, 1.3]; returns
    (stretched (B, L) float32, new valid lengths)."""
    b, length = wave.shape
    t_out = (length + n_fft // 2) // hop + 2
    mag, dphi, phase0 = analysis(wave, n_fft, hop)
    icos, isin = _bases(n_fft, wave.device)
    rows = kernels.pv_resynth(mag, dphi, phase0, rate.float().contiguous(),
                              icos, isin, hop, t_out)
    out = rows.reshape(b, -1)
    out = out / torch.from_numpy(_window_sum(n_fft, hop, t_out)).to(
        out.device)
    # the analysis center-padded by n_fft // 2: drop it, crop to the buffer
    start = n_fft // 2
    out = out[:, start: start + min(length, out.shape[1] - start)]
    if out.shape[1] < length:
        out = torch.nn.functional.pad(out, (0, length - out.shape[1]))
    new_len = torch.clamp((lengths.float() / rate).to(torch.int32),
                          max=length)
    new_len = torch.clamp(new_len, min=1)
    valid = (torch.arange(length, device=wave.device)[None]
             < new_len[:, None])
    return torch.where(valid, out, 0.0), new_len.to(lengths.dtype)


def pitch_shift(wave: torch.Tensor, lengths: torch.Tensor,
                cents: torch.Tensor, n_fft: int = 2048, hop: int = 512):
    """Duration-preserving pitch shift of each (B, L) row by ``cents`` (B,)
    in [-300, 300] (JAX ``pv.pitch_shift``): a PV stretch by rate 1/f (K3)
    scales the duration by f, and a resample by f (K2) scales the pitch by
    f and the duration back, f = 2^(cents/1200). The stretch runs in a
    buffer of ~1.2 L, so the resample sees the whole stretched clip."""
    from freesound_classification_tpu_torch.ops.augment import resample_rate

    length = wave.shape[1]
    padded = ((int(length * 1.2) + hop - 1) // hop) * hop
    wave = torch.nn.functional.pad(wave, (0, padded - length))
    factor = torch.exp2(cents.float() / 1200.0)
    stretched, new_len = phase_vocoder_stretch(wave, lengths, 1.0 / factor,
                                               n_fft, hop)
    out, new_len = resample_rate(stretched, new_len, factor)
    return (out[:, :length],
            torch.clamp(new_len, max=length).to(lengths.dtype))
