"""Wrappers of the port's hand-written CUDA kernels, beside their plain twins.

Each replaces a TPU kernel of
``freesound_classification_tpu/ops/pallas_kernels.py``:

- K1, ``mel_project_log`` (``csrc/mel_log.cu``, replaces ``_mel_log_kernel``):
  the log-mel tail of the frontend,
  ``out[b, m, t] = log(sum_f fb[m, f] * |S[b, f, t]| + 1e-4)``.
- K2, ``resample_linear`` (``csrc/resample.cu``, replaces
  ``_resample_kernel``): per-row linear-interpolation resample, the
  augmentation chain's playback-rate change.
- K3, ``pv_resynth`` (``csrc/pv_resynth.cu``, replaces
  ``_pv_resynth_kernel``): phase-vocoder resynthesis with overlap-add, the
  output half of the chain's PV stretch.

A wrapper runs its plain twin only for tensors on the CPU. A CUDA tensor
launches the kernel, or the wrapper raises; nothing falls back. Each launch
adds one to the wrapper's ``launches`` count, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

LOG_EPS = 1e-4
_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y/z, one block row per clip


def mel_project_log_reference(spec: torch.Tensor,
                              fb: torch.Tensor) -> torch.Tensor:
    """Plain twin of K1: complex spectrum (B, F, T) x filterbank (M, F) ->
    log-mel (B, M, T)."""
    return torch.log(
        torch.abs(spec).transpose(-1, -2) @ fb.T + LOG_EPS
    ).transpose(-1, -2)


def mel_project_log(spec: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """K1: complex64 spectrum (B, F, T), any strides, x contiguous float32
    filterbank (M, F) -> contiguous float32 log-mel (B, M, T).

    CPU tensors take ``mel_project_log_reference``; CUDA tensors launch
    ``mel_log_kernel`` on the current stream.
    """
    if spec.device.type == "cpu" and fb.device.type == "cpu":
        return mel_project_log_reference(spec, fb)
    if spec.device.type != "cuda" or fb.device != spec.device:
        raise ValueError(
            "mel_project_log: spec and fb must both be on the CPU or both on "
            f"one CUDA device, got {spec.device} and {fb.device}")
    if spec.dtype != torch.complex64 or spec.dim() != 3:
        raise ValueError("mel_project_log: spec must be complex64 (B, F, T), "
                         f"got {spec.dtype} {tuple(spec.shape)}")
    if fb.dtype != torch.float32 or fb.dim() != 2:
        raise ValueError("mel_project_log: fb must be float32 (M, F), got "
                         f"{fb.dtype} {tuple(fb.shape)}")
    n_batch, n_freq, n_frames = spec.shape
    n_mel = fb.shape[0]
    if fb.shape[1] != n_freq:
        raise ValueError(f"mel_project_log: fb has {fb.shape[1]} frequency "
                         f"bins, spec has {n_freq}")
    if not fb.is_contiguous():
        raise ValueError("mel_project_log: fb must be contiguous")
    if not 0 < n_batch <= _MAX_GRID_YZ or min(n_freq, n_frames, n_mel) <= 0:
        raise ValueError(f"mel_project_log: unsupported shape B={n_batch} "
                         f"F={n_freq} T={n_frames} M={n_mel}")

    from freesound_classification_tpu_torch.ops import build

    lib = build.load_library()
    out = torch.empty((n_batch, n_mel, n_frames), dtype=torch.float32,
                      device=spec.device)
    # read in place through the strides: torch.stft's (B, F, T) output lies
    # frame-major in memory, which the kernel's loads are laid out for
    with torch.cuda.device(spec.device):
        err = lib.mel_log_launch(
            spec.data_ptr(), *spec.stride(), fb.data_ptr(), out.data_ptr(),
            n_batch, n_freq, n_frames, n_mel,
            torch.cuda.current_stream(spec.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mel_log_kernel launch failed: cudaError {err}")
    mel_project_log.launches += 1
    return out


mel_project_log.launches = 0


def _check_cuda_inputs(name: str, *tensors: torch.Tensor) -> None:
    device = tensors[0].device
    for t in tensors:
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name}: every input must be on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous float32, got "
                             f"{t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# K2: linear-interpolation resample
# ---------------------------------------------------------------------------

RESAMPLE_MAX_FACTOR = 1.8  # the TPU kernel's domain; the chain's <= 1.31
_MAX_EXACT_INDEX = 1 << 24  # sample indices stay exact in float32


def _range(x: torch.Tensor) -> tuple:
    """(min, max) of ``x`` on the host, with one device sync."""
    return tuple(torch.stack(torch.aminmax(x)).tolist())


def _check_resample_factor(factor: torch.Tensor) -> None:
    low, top = _range(factor)
    if not (0.0 < low and top <= RESAMPLE_MAX_FACTOR):
        raise ValueError(
            f"resample_linear: factors must lie in (0, "
            f"{RESAMPLE_MAX_FACTOR}], got [{low}, {top}]")


def resample_linear_reference(wave: torch.Tensor,
                              factor: torch.Tensor) -> torch.Tensor:
    """Plain twin of K2: (B, L) x (B,) -> (B, L),
    ``out[b, i] = (1 - frac) w[b, i0] + frac w[b, i0 + 1]`` at
    ``pos = i * factor[b]`` (float32), with samples past L read as 0."""
    b, length = wave.shape
    pos = (torch.arange(length, dtype=torch.float32, device=wave.device)[None]
           * factor[:, None])
    fl = torch.floor(pos)
    frac = pos - fl
    i0 = fl.long()
    padded = torch.cat([wave, wave.new_zeros(b, 1)], dim=1)
    taps = [torch.gather(padded, 1, torch.clamp(i, max=length))
            for i in (i0, i0 + 1)]
    return (1.0 - frac) * taps[0] + frac * taps[1]


def resample_linear(wave: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """K2: float32 (B, L) waves x (B,) factors in (0, 1.8] -> (B, L).

    CPU tensors take ``resample_linear_reference``; CUDA tensors launch
    ``resample_kernel``. Masking to the new valid lengths is the caller's
    (``ops/augment.resample_rate``).
    """
    if wave.device.type == "cpu" and factor.device.type == "cpu":
        _check_resample_factor(factor)
        return resample_linear_reference(wave, factor)
    _check_cuda_inputs("resample_linear", wave, factor)
    n_batch, length = wave.shape
    if factor.shape != (n_batch,):
        raise ValueError(f"resample_linear: factor {tuple(factor.shape)} for "
                         f"{n_batch} rows")
    if not (0 < n_batch <= _MAX_GRID_YZ and 0 < length < _MAX_EXACT_INDEX):
        raise ValueError(f"resample_linear: unsupported shape {n_batch} x "
                         f"{length}")
    _check_resample_factor(factor)

    from freesound_classification_tpu_torch.ops import build

    lib = build.load_library()
    out = torch.empty_like(wave)
    with torch.cuda.device(wave.device):
        err = lib.resample_launch(
            wave.data_ptr(), factor.data_ptr(), out.data_ptr(), n_batch,
            length, torch.cuda.current_stream(wave.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"resample_kernel launch failed: cudaError {err}")
    resample_linear.launches += 1
    return out


resample_linear.launches = 0


# ---------------------------------------------------------------------------
# K3: phase-vocoder resynthesis
# ---------------------------------------------------------------------------

PV_MAX_RATE = 1.3  # the TPU kernel's domain; the chain's rates <= 1.19
PV_TILE = 128  # frames per phase-carry tile: the TPU kernel's _PV_TM
_TWO_PI = 6.2831854820251465  # float32(2 pi)
_INV_TWO_PI = 0.15915493667125702  # float32(1 / float32(2 pi))


def _wrap_phase(x: torch.Tensor) -> torch.Tensor:
    """To (-pi, pi]: x - 2 pi floor(x / 2 pi + 1/2), as XLA evaluates the
    TPU kernel's expression: the quotient as a product with the float32
    reciprocal, the difference rounded once (a fused multiply-add; exact in
    float64 here, since 2 pi * turns needs < 53 bits)."""
    turns = torch.floor(x * _INV_TWO_PI + 0.5)
    return (x.double() - _TWO_PI * turns.double()).float()


def synthesis_basis(n_fft: int):
    """Windowed inverse-rDFT basis (numpy float32): (icos, isin), each
    (n_fft // 2 + 1, n_fft), with ``re @ icos + im @ isin`` =
    ``irfft(re + i im) * hann``."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[:, None]
    n = np.arange(n_fft)[None, :]
    coef = np.full((n_bins, 1), 2.0)
    coef[0, 0] = coef[-1, 0] = 1.0
    ang = 2.0 * np.pi * k * n / n_fft
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    icos = (coef * np.cos(ang) / n_fft) * w[None, :]
    isin = (-coef * np.sin(ang) / n_fft) * w[None, :]
    return icos.astype(np.float32), isin.astype(np.float32)


def _check_pv_rate(rate: torch.Tensor) -> None:
    low, top = _range(rate)
    if not (0.0 < low and top <= PV_MAX_RATE):
        raise ValueError(f"pv_resynth: rates must lie in (0, {PV_MAX_RATE}], "
                         f"got [{low}, {top}]")


def pv_resynth_reference(mag, dphi, phase0, rate, icos, isin, hop: int,
                         t_out: int) -> torch.Tensor:
    """Plain twin of K3: mag (B, t_in, F), dphi (B, t_in - 1, F), phase0
    (B, F), rate (B,), bf16 icos/isin (F, n_fft) -> overlap-added rows
    (B, t_out + r - 1, hop) float32, r = n_fft // hop. Frames past t_out
    are synthesized from the clamped positions, as the TPU kernel's last
    tile does."""
    b, t_in, f = mag.shape
    r = icos.shape[1] // hop
    rows = t_out + r - 1
    n_tiles = -(-rows // PV_TILE)
    device = mag.device
    pos = (torch.arange(rows, dtype=torch.float32, device=device)[None]
           * rate[:, None])
    pm = torch.clamp(pos, 0.0, float(t_in - 1))
    fl = torch.floor(pm)
    frac = (pm - fl)[..., None]
    i0 = fl.long()
    i1 = torch.clamp(i0 + 1, max=t_in - 1)

    def pick(x, idx):
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, f))

    mags = (1.0 - frac) * pick(mag, i0) + frac * pick(mag, i1)
    idx_d = torch.floor(torch.clamp(pos, 0.0, float(t_in - 2))).long()
    d = pick(dphi, idx_d)
    d = torch.cat([d, d.new_zeros(b, n_tiles * PV_TILE - rows, f)], dim=1)
    d = d.view(b, n_tiles, PV_TILE, f)
    # exclusive running sums inside each tile, left to right in float32,
    # then each tile's carry: the kernel's order of additions
    excl = torch.empty_like(d)
    run = d.new_zeros(b, n_tiles, f)
    for j in range(PV_TILE):
        excl[:, :, j] = run
        run = run + d[:, :, j]
    carry = phase0
    phis = torch.empty_like(d)
    for t in range(n_tiles):
        phis[:, t] = _wrap_phase(carry[:, None, :] + excl[:, t])
        carry = _wrap_phase(carry + run[:, t])
    phis = phis.view(b, n_tiles * PV_TILE, f)[:, :rows]
    re = (mags * torch.cos(phis)).to(torch.bfloat16)
    im = (mags * torch.sin(phis)).to(torch.bfloat16)
    syn = (re.float() @ icos.float() + im.float() @ isin.float()
           ).to(torch.bfloat16).float()
    out = torch.zeros(b, rows, hop, dtype=torch.float32, device=device)
    for o in range(r):
        out[:, o:] += syn[:, : rows - o, o * hop:(o + 1) * hop]
    return out


def pv_resynth(mag, dphi, phase0, rate, icos, isin, hop: int,
               t_out: int) -> torch.Tensor:
    """K3: the phase-vocoder resynthesis of ``pv_resynth_reference``.

    CPU tensors take the plain twin; CUDA tensors launch the four kernels of
    ``csrc/pv_resynth.cu`` (tile sums, phase, bf16 synthesis product,
    overlap-add) and count one launch. Rates must lie in (0, 1.3].
    """
    if mag.device.type == "cpu":
        _check_pv_rate(rate)
        return pv_resynth_reference(mag, dphi, phase0, rate, icos, isin,
                                    hop, t_out)
    _check_cuda_inputs("pv_resynth", mag, dphi, phase0, rate)
    b, t_in, f = mag.shape
    n_fft = icos.shape[1]
    r = n_fft // hop
    if (dphi.shape != (b, t_in - 1, f) or phase0.shape != (b, f)
            or rate.shape != (b,) or icos.shape != (f, n_fft)
            or isin.shape != icos.shape or t_in < 2 or r < 1
            or not 0 < b <= _MAX_GRID_YZ):
        raise ValueError(
            f"pv_resynth: inconsistent shapes mag {tuple(mag.shape)}, dphi "
            f"{tuple(dphi.shape)}, phase0 {tuple(phase0.shape)}, rate "
            f"{tuple(rate.shape)}, basis {tuple(icos.shape)}, hop {hop}")
    _check_pv_rate(rate)
    rows = t_out + r - 1
    n_tiles = -(-rows // PV_TILE)
    bins_pad = -(-f // 16) * 16
    n_pad = -(-n_fft // 128) * 128
    device = mag.device
    basis = torch.zeros(2 * bins_pad, n_pad, dtype=torch.bfloat16,
                        device=device)
    basis[:f, :n_fft] = icos.to(device=device, dtype=torch.bfloat16)
    basis[bins_pad: bins_pad + f, :n_fft] = isin.to(device=device,
                                                    dtype=torch.bfloat16)
    tile_sum = torch.empty(b, n_tiles, f, dtype=torch.float32, device=device)
    a = torch.empty(b * rows, 2 * bins_pad, dtype=torch.bfloat16,
                    device=device)
    syn = torch.empty(b * rows, n_pad, dtype=torch.bfloat16, device=device)
    out = torch.empty(b, rows, hop, dtype=torch.float32, device=device)

    from freesound_classification_tpu_torch.ops import build

    lib = build.load_library()
    with torch.cuda.device(device):
        err = lib.pv_resynth_launch(
            mag.data_ptr(), dphi.data_ptr(), phase0.data_ptr(),
            rate.data_ptr(), basis.data_ptr(), tile_sum.data_ptr(),
            a.data_ptr(), syn.data_ptr(), out.data_ptr(), b, t_in, f,
            bins_pad, n_pad, hop, r, rows,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pv_resynth kernels launch failed: cudaError {err}")
    pv_resynth.launches += 1
    return out


pv_resynth.launches = 0
