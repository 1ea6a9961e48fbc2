"""The fast featurization of the bench shape: one bf16 cat-DFT product per
block offset, then the split mel kernel K9 (``kernels.mel_log_split``).

Counterpart of ``fast_featurize`` in ``scripts/probe_dft_context.py``. The
signal is reflect-padded by n_fft / 2 in float32 and cut into hop-sized
blocks cast to bf16; frame t's spectrum is the sum over the m = n_fft / hop
block offsets o of ``blocks[t + o] @ basis[o]``, where ``basis[o]`` holds
rows [o hop, (o + 1) hop) of the Hann-windowed DFT matrix as [cos | sin]
(``cat_basis``). Each product gives bf16 (float32 sums rounded once) and
the m products are added in bf16, as the probe's ``einsum(...,
preferred_element_type=bfloat16)`` does. These are plain large matrix
products, left to ``torch.matmul`` as the JAX package leaves them to XLA.
K9 then takes |S| at the probe kernel's bf16 rounding points, the mel
projection and the log, and writes (B, M, T).

The probe padded each half of the spectrum to 1152 lanes for the TPU's
tiling; the padded bins have re = im = 0 and zero filterbank rows, so they
add nothing, and here the halves lie side by side (``im_offset`` = F).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from freesound_classification_tpu_torch.ops import dsp, kernels
from freesound_classification_tpu_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=8)
def dft_basis(n_fft: int, hop: int) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed rDFT basis split into hop-sized row blocks (numpy float32):
    (cos_basis, sin_basis), each (m, hop, n_fft // 2 + 1) with m = n_fft //
    hop (the JAX package's ``dsp._dft_basis``, copied)."""
    if n_fft % hop:
        raise ValueError(f"hop {hop} does not divide n_fft {n_fft}")
    m = n_fft // hop
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    angle = -2.0 * np.pi * n * k / n_fft
    cos_b = (np.cos(angle) * w[:, None]).astype(np.float32)
    sin_b = (np.sin(angle) * w[:, None]).astype(np.float32)
    return (cos_b.reshape(m, hop, n_bins), sin_b.reshape(m, hop, n_bins))


def cat_basis(n_fft: int, hop: int, im_offset: int | None = None
              ) -> np.ndarray:
    """(m, hop, 2 im_offset) float32: cos at columns [0, F), sin at
    [im_offset, im_offset + F), zero elsewhere; ``im_offset`` defaults to F
    (the probe's ``_cat_basis`` is ``im_offset`` = 1152)."""
    cos_b, sin_b = dft_basis(n_fft, hop)
    m, _, n_bins = cos_b.shape
    im_offset = n_bins if im_offset is None else im_offset
    if im_offset < n_bins:
        raise ValueError(f"im_offset {im_offset} < {n_bins} bins")
    cat = np.zeros((m, hop, 2 * im_offset), np.float32)
    cat[:, :, :n_bins] = cos_b
    cat[:, :, im_offset:im_offset + n_bins] = sin_b
    return cat


def cat_dft_spectrum(wave: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(B, L) waveforms -> bf16 [re | im] spectra (B, T, 2 im_offset) by the
    bf16 ``cat_basis`` (m, hop, 2 im_offset) on the waveforms' device; T =
    1 + L // hop, the center-padded STFT's frame count."""
    m, hop, _ = basis.shape
    n_fft = m * hop
    b, length = wave.shape
    pad = n_fft // 2
    xp = F.pad(wave.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    n_frames = dsp.num_stft_frames(length, n_fft, hop)
    total = xp.shape[-1]
    # whole blocks, and at least the n_frames + m - 1 the views reach
    n_blocks = max(-(-total // hop), n_frames + m - 1)
    xp = F.pad(xp, (0, n_blocks * hop - total))
    blocks = xp.view(b, n_blocks, hop).to(torch.bfloat16)
    spec = None
    for o in range(m):
        d = blocks[:, o:o + n_frames] @ basis[o]
        spec = d if spec is None else spec + d
    return spec


def fast_featurize(wave: torch.Tensor, fb_t: torch.Tensor,
                   basis: torch.Tensor) -> torch.Tensor:
    """(B, L) waveforms -> (B, M, T) float32 log-mel: ``cat_dft_spectrum``,
    then K9 with the (F, M) filterbank ``fb_t`` (cast to bf16)."""
    return kernels.mel_log_split(
        cat_dft_spectrum(wave, basis), fb_t.to(torch.bfloat16),
        n_freq=fb_t.shape[0], im_offset=basis.shape[-1] // 2)


class FastFrontend:
    """The 2d frontend by the fast featurization (the probe's
    ``fast_inputs``): (wave (B, L), sample lengths (B,)) -> (log-mel (B, M,
    T, 1), frame lengths (B,) = min(lengths // hop + 1, T)). ``descriptor``
    is a mel descriptor whose hop divides its n_fft. ``device`` is the card
    unless the caller passes "cpu"; without a card it raises."""

    def __init__(self, descriptor: str, sr: int = 44100,
                 device: torch.device | str = "cuda"):
        feat = dsp.parse_features(descriptor)
        if feat.kind != "mel":
            raise ValueError(f"FastFrontend needs a mel descriptor, got "
                             f"{descriptor!r}")
        device = resolve_device(device)
        self.hop = feat.hop_size
        self.basis = torch.from_numpy(cat_basis(feat.n_fft, self.hop)).to(
            device=device, dtype=torch.bfloat16)
        self.fb_t = torch.from_numpy(np.ascontiguousarray(dsp.mel_filterbank(
            sr, feat.n_fft, feat.n_mel, fmin=5.0).T)).to(
            device=device, dtype=torch.bfloat16)

    def __call__(self, wave: torch.Tensor, sample_lengths: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        spec = fast_featurize(wave, self.fb_t, self.basis)
        frame_lengths = torch.clamp(sample_lengths // self.hop + 1,
                                    max=spec.shape[-1])
        return spec[..., None], frame_lengths
