"""Sox-faithful freeverb (JAX ``ops/freeverb.py``, its ``reverb_batch`` on
the ``use_mxu_fft=False`` route, with ``torch.fft``).

sox's ``reverb`` is freeverb: 8 parallel feedback combs with a one-pole
lowpass in the loop, 4 series allpasses, a pre-delay, a 0.015 wet gain, and
dry + wet out. The topology is linear and time-invariant for fixed
parameters, so its transfer function is evaluated in closed form on the
rFFT grid of a power-of-two length covering the clip plus the decay margin,
and applied by FFT convolution:

    H_comb(z)    = z^-N (1 - d z^-1) / (1 - d z^-1 - f (1-d) z^-N)
    H_allpass(z) = (1.5 z^-N - 1) / (1 - 0.5 z^-N)
    H_wet(z)     = gain z^-D [sum_i H_comb,Ni] [prod_j H_ap,Mj]

with sox's mappings: comb lengths round(scale * r * COMB_LENGTHS),
scale = room/100 * 0.9 + 0.1, r = sr/44100; feedback
1 - exp((reverberance - b)/(a b)); damping hf/100 * 0.3 + 0.2.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

COMB_LENGTHS = np.array([1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617])
ALLPASS_LENGTHS = np.array([225, 341, 441, 556])

# feedback-curve constants (sox reverb_create)
_A = -1.0 / math.log(1.0 - 0.3)
_B = 100.0 / (math.log(1.0 - 0.98) * _A + 1.0)


def feedback_of(reverberance: torch.Tensor) -> torch.Tensor:
    """Comb feedback from reverberance %: 0.30 at 0 .. 0.98 at 100."""
    return 1.0 - torch.exp((reverberance - _B) / (_A * _B))


def comb_sizes(room_scale: torch.Tensor, sr: int) -> torch.Tensor:
    """(B,) room_scale % -> (B, 8) int64 comb delay lengths in samples."""
    scale = room_scale / 100.0 * 0.9 + 0.1
    lengths = torch.from_numpy(
        (sr / 44100.0 * COMB_LENGTHS).astype(np.float32)).to(
        room_scale.device)
    return torch.floor(scale[:, None] * lengths + 0.5).long()


def allpass_sizes(sr: int) -> np.ndarray:
    return np.floor(sr / 44100.0 * ALLPASS_LENGTHS + 0.5).astype(np.int64)


@functools.lru_cache(maxsize=4)
def _static_response(fft_len: int, sr: int, pre_delay_ms: float,
                     wet_gain_db: float) -> np.ndarray:
    """Allpass cascade x pre-delay x wet gain on the rFFT grid (numpy f64,
    returned complex64; the same for every row)."""
    k = np.arange(fft_len // 2 + 1)
    w = 2.0 * np.pi * k / fft_len
    h = np.full(k.shape, 10.0 ** (wet_gain_db / 20.0) * 0.015, complex)
    for m in allpass_sizes(sr):
        zm = np.exp(-1j * w * m)
        h *= (1.5 * zm - 1.0) / (1.0 - 0.5 * zm)
    d = int(pre_delay_ms / 1000.0 * sr + 0.5)
    h *= np.exp(-1j * w * d)
    return h.astype(np.complex64)


def wet_response(reverberance: torch.Tensor, room_scale: torch.Tensor,
                 fft_len: int, sr: int, hf_damping: float = 50.0,
                 pre_delay_ms: float = 20.0,
                 wet_gain_db: float = 0.0) -> torch.Tensor:
    """(B,) params -> (B, fft_len // 2 + 1) complex64 wet transfer function.
    ``fft_len`` is a power of two: each comb's z^-N phase is taken at the
    exact integer angle (k N) mod fft_len, with no drift at high bins."""
    if fft_len & (fft_len - 1):
        raise ValueError(f"fft_len must be a power of two, got {fft_len}")
    device = reverberance.device
    damp = hf_damping / 100.0 * 0.3 + 0.2
    static = torch.from_numpy(
        _static_response(fft_len, sr, pre_delay_ms, wet_gain_db)).to(device)
    fb = feedback_of(reverberance.float())  # (B,)
    sizes = comb_sizes(room_scale.float(), sr)  # (B, 8)
    k = torch.arange(fft_len // 2 + 1, device=device)
    w = 2.0 * math.pi * k.float() / fft_len
    z1 = torch.polar(torch.ones_like(w), -w)
    denom_lp = 1.0 - damp * z1  # (F,)
    c = (fb * (1.0 - damp))[:, None]  # (B, 1)
    h = torch.zeros(fb.shape[0], k.shape[0], dtype=torch.complex64,
                    device=device)
    for i in range(COMB_LENGTHS.size):
        kn = (k[None, :] * sizes[:, i:i + 1]) & (fft_len - 1)  # (B, F)
        ang = 2.0 * math.pi * kn.float() / fft_len
        zn = torch.polar(torch.ones_like(ang), -ang)
        h = h + zn * denom_lp / (denom_lp - c * zn)
    return h * static


def decay_samples(reverberance: torch.Tensor, room_scale: torch.Tensor,
                  sr: int, db: float = 60.0) -> torch.Tensor:
    """Per-row tail length: samples for the slowest comb to decay by
    ``db``."""
    fb = feedback_of(reverberance.float())
    n_max = comb_sizes(room_scale.float(), sr)[:, -1].float()
    per_sample = torch.log(fb) / n_max
    level = float(np.log(np.float32(10.0 ** (-db / 20.0))))  # float32 log
    return (level / per_sample).to(torch.int32)


def reverb_batch(wave: torch.Tensor, lengths: torch.Tensor,
                 reverberance: torch.Tensor, room_scale: torch.Tensor,
                 sr: int, ir_seconds: float = 1.5):
    """Sox reverb of a (B, L) batch -> (dry + wet (B, L), new lengths).

    Circular FFT convolution against the transfer function sampled on a
    power-of-two grid of at least L + ir_seconds * sr samples; the tail past
    L is dropped, the valid length grows by the decay time.
    """
    b, length = wave.shape
    ir_len = int(ir_seconds * sr)
    fft_len = 1 << (length + ir_len - 1).bit_length()
    h = wet_response(reverberance, room_scale, fft_len, sr) + 1.0
    xf = torch.fft.rfft(wave.float(), fft_len, dim=-1)
    out = torch.fft.irfft(xf * h, fft_len, dim=-1)[:, :length]
    tail = decay_samples(reverberance, room_scale, sr)
    new_len = torch.clamp(lengths + tail, max=length)
    return out, torch.clamp(new_len, min=1).to(lengths.dtype)


def freeverb_ir(reverberance: torch.Tensor, room_scale: torch.Tensor,
                sr: int, ir_len: int, hf_damping: float = 50.0,
                pre_delay_ms: float = 20.0,
                wet_gain_db: float = 0.0) -> torch.Tensor:
    """(B,) params -> (B, ir_len) wet impulse responses (JAX
    ``freeverb.freeverb_ir``): the inverse rFFT of ``wet_response`` on a
    power-of-two grid of at least 2 ir_len - 1 and 2.4 s, about twice the
    slowest -120 dB decay of the parameters' range (reverberance and room
    in [0, 50)), so the grid's time aliasing stays below -120 dB."""
    grid = 1 << max(2 * ir_len - 1, int(2.4 * sr)).bit_length()
    h = wet_response(reverberance, room_scale, grid, sr,
                     hf_damping=hf_damping, pre_delay_ms=pre_delay_ms,
                     wet_gain_db=wet_gain_db)
    return torch.fft.irfft(h, grid, dim=-1)[..., :ir_len]
