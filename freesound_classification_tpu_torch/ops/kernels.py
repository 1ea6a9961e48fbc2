"""Wrappers of the port's hand-written CUDA kernels, beside their plain twins.

Each replaces a TPU kernel of
``freesound_classification_tpu/ops/pallas_kernels.py``:

- K1, ``mel_project_log`` (``csrc/mel_log.cu``, replaces ``_mel_log_kernel``):
  the log-mel tail of the frontend,
  ``out[b, m, t] = log(sum_f fb[m, f] * |S[b, f, t]| + 1e-4)``.
- K2, ``resample_linear`` (``csrc/resample.cu``, replaces
  ``_resample_kernel``): per-row linear-interpolation resample, the
  augmentation chain's playback-rate change, masked to the chain's valid
  lengths in its store.
- K3, ``pv_resynth`` (``csrc/pv_resynth.cu``, replaces
  ``_pv_resynth_kernel``): phase-vocoder resynthesis with overlap-add, the
  output half of the chain's PV stretch.
- K4/K5, ``resnet_block_2d_fused`` (replaces ``_fused_kernel`` and
  ``_fused_t_kernel`` of ``ops/pallas_resnet.py``), and K6,
  ``resnet_block_1d_fused`` (replaces ``_fused_1d_kernel`` of
  ``ops/pallas_resnet1d.py``), both on the convolution core of
  ``csrc/conv_blocks.cu``: the eval-mode resnet block with BatchNorm
  folded, the ``fused_infer`` option of the models.
- K7, ``basic_block_fused`` (``csrc/conv_blocks.cu``, on the same
  convolution core; replaces
  ``_basic_t_kernel`` of ``ops/pallas_backbone.py``): the eval-mode
  stride-1 identity BasicBlock of the backbone, BatchNorm folded
  (``fused_infer``).
- K8, ``conv_head_fused`` (``csrc/conv_head.cu``, replaces ``_head_kernel``
  of ``ops/pallas_head.py``): the 2d CNN's eval-mode block0 head, bn_in ->
  conv3x3 -> 2x2 max-pool -> bn_out -> PReLU in one pass (``fused_head``).
- K9, ``mel_log_split`` (``csrc/mel_log_split.cu``, replaces
  ``_mel_log_split_kernel`` of ``scripts/probe_dft_context.py``): the log-mel
  tail of the fast featurization (``ops/fast_featurize.py``), K1's function
  on a bf16 [re | im] spectrum at the TPU kernel's bf16 rounding points.

A wrapper runs its plain twin only for tensors on the CPU. A CUDA tensor
launches the kernel, or the wrapper raises; nothing falls back. Each launch
adds one to the wrapper's ``launches`` count, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

LOG_EPS = 1e-4
_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y/z, one block row per clip


def mel_project_log_reference(spec: torch.Tensor,
                              fb: torch.Tensor) -> torch.Tensor:
    """Plain twin of K1: complex spectrum (B, F, T) x filterbank (M, F) ->
    log-mel (B, M, T)."""
    return torch.log(
        torch.abs(spec).transpose(-1, -2) @ fb.T + LOG_EPS
    ).transpose(-1, -2)


def mel_band_ranges(fb: torch.Tensor) -> tuple:
    """Each band's range of bins in a (M, F) filterbank, as K1 loops over
    them: int32 (M,) ``lo`` (the first non-zero bin) and ``hi`` (one past
    the last), on ``fb``'s device with no host sync. A band with no
    non-zero entry gets lo = F, hi = 0: an empty range."""
    n_freq = fb.shape[1]
    nonzero = fb != 0
    bins = torch.arange(n_freq, dtype=torch.int32, device=fb.device)
    lo = torch.where(nonzero, bins, n_freq).amin(dim=1)
    hi = torch.where(nonzero, bins + 1, 0).amax(dim=1)
    return lo.to(torch.int32).contiguous(), hi.to(torch.int32).contiguous()


_K1_FRAMES = 8  # frames per block of mel_log_kernel: 8 x F floats staged


def mel_project_log(spec: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """K1: complex64 spectrum (B, F, T), any strides, x contiguous float32
    filterbank (M, F) -> contiguous float32 log-mel (B, M, T).

    CPU tensors take ``mel_project_log_reference``; CUDA tensors launch
    ``mel_log_kernel`` on the current stream, which sums each band over its
    ``mel_band_ranges`` only.
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
    if (not 0 < n_batch <= _MAX_GRID_YZ or min(n_freq, n_frames, n_mel) <= 0
            or _K1_FRAMES * n_freq * 4 > _MAX_SHARED_BYTES):
        raise ValueError(f"mel_project_log: unsupported shape B={n_batch} "
                         f"F={n_freq} T={n_frames} M={n_mel}")

    from freesound_classification_tpu_torch.ops import build

    lib = build.load_library()
    out = torch.empty((n_batch, n_mel, n_frames), dtype=torch.float32,
                      device=spec.device)
    lo, hi = mel_band_ranges(fb)
    # read in place through the strides: torch.stft's (B, F, T) output lies
    # frame-major in memory, which the kernel's loads are laid out for
    with torch.cuda.device(spec.device):
        err = lib.mel_log_launch(
            spec.data_ptr(), *spec.stride(), fb.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), out.data_ptr(), n_batch, n_freq, n_frames, n_mel,
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


def _check_cpu_domain(name: str, what: str, x: torch.Tensor,
                      top: float) -> None:
    """The CPU twins' check of the domain (0, top] that the CUDA kernels
    check on the card."""
    low, high = float(x.min()), float(x.max())
    if not (0.0 < low and high <= top):
        raise ValueError(f"{name}: {what} must lie in (0, {top}], got "
                         f"[{low}, {high}]")


def resample_linear_reference(wave: torch.Tensor, factor: torch.Tensor,
                              lengths: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Plain twin of K2: (B, L) x (B,) -> (B, L),
    ``out[b, i] = (1 - frac) w[b, i0] + frac w[b, i0 + 1]`` at
    ``pos = i * factor[b]`` (float32), with samples past L read as 0, and
    with ``lengths`` (B,) ``out[b, i] = 0`` where ``pos >= lengths[b]``."""
    b, length = wave.shape
    pos = (torch.arange(length, dtype=torch.float32, device=wave.device)[None]
           * factor[:, None])
    fl = torch.floor(pos)
    frac = pos - fl
    i0 = fl.long()
    padded = torch.cat([wave, wave.new_zeros(b, 1)], dim=1)
    taps = [torch.gather(padded, 1, torch.clamp(i, max=length))
            for i in (i0, i0 + 1)]
    out = (1.0 - frac) * taps[0] + frac * taps[1]
    if lengths is None:
        return out
    return torch.where(pos < lengths.float()[:, None], out, 0.0)


def resample_linear(wave: torch.Tensor, factor: torch.Tensor,
                    lengths: torch.Tensor | None = None) -> torch.Tensor:
    """K2: float32 (B, L) waves x (B,) factors in (0, 1.8] -> (B, L),
    zero where ``i * factor[b] >= lengths[b]`` if integer ``lengths`` (B,)
    are given (the effects chain's valid lengths).

    CPU tensors take ``resample_linear_reference`` after a host check of
    the factors; CUDA tensors launch ``resample_kernel``, which checks the
    factors on the card (one out of the domain ends the run with a
    device-side error), so the call makes no host sync.
    """
    if wave.device.type == "cpu" and factor.device.type == "cpu":
        _check_cpu_domain("resample_linear", "factors", factor,
                          RESAMPLE_MAX_FACTOR)
        return resample_linear_reference(wave, factor, lengths)
    _check_cuda_inputs("resample_linear", wave, factor)
    n_batch, length = wave.shape
    if factor.shape != (n_batch,):
        raise ValueError(f"resample_linear: factor {tuple(factor.shape)} for "
                         f"{n_batch} rows")
    if not (0 < n_batch <= _MAX_GRID_YZ and 0 < length < _MAX_EXACT_INDEX):
        raise ValueError(f"resample_linear: unsupported shape {n_batch} x "
                         f"{length}")
    if lengths is not None:
        if (lengths.device != wave.device or lengths.shape != (n_batch,)
                or lengths.is_floating_point() or lengths.is_complex()):
            raise ValueError(
                f"resample_linear: lengths must be integers (B,) = "
                f"({n_batch},) on {wave.device}, got {lengths.dtype} "
                f"{tuple(lengths.shape)} on {lengths.device}")
        lengths = lengths.to(torch.int32).contiguous()

    from freesound_classification_tpu_torch.ops import build

    lib = build.load_library()
    out = torch.empty_like(wave)
    with torch.cuda.device(wave.device):
        err = lib.resample_launch(
            wave.data_ptr(), factor.data_ptr(),
            None if lengths is None else lengths.data_ptr(), out.data_ptr(),
            n_batch, length, RESAMPLE_MAX_FACTOR,
            torch.cuda.current_stream(wave.device).cuda_stream)
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
# pv_resynth_kernel's shape: 64 frames a block (half a phase tile), the
# overlap-add offsets it takes (n_fft // hop; the chain's hop is n_fft // 4),
# columns per offset (hop, zero padded), basis rows per streamed stage,
# and the widest bins_pad whose A, basis ring and staging tile fit 227 KB
_PV_ROWS = 64
_PV_OFFSETS = 4
_PV_COLS = 256
_PV_STAGE_K = 32
_PV_MAX_BINS_PAD = 528
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


def pv_basis_tiles(icos: torch.Tensor, isin: torch.Tensor,
                   hop: int) -> torch.Tensor:
    """The padded [icos; isin] basis as ``pv_resynth_kernel`` streams it:
    bf16 (offsets, stages, 4, 32, 8, 8) = (o, q, k // 8 % 4, c // 8, c % 8,
    k % 8), one contiguous 16 KB stage per (o, q), holding rows k in
    [32 q, 32 q + 32) and columns o * hop + c, c < 256, of

        [icos; 0; isin; 0]   (2 bins_pad, n_fft), bins_pad = F rounded up to 16

    with zeros at c >= hop: wgmma's K-major core matrices (8 columns x 8
    rows of k, 128 bytes each), 4 along k outside 32 along the columns."""
    f, n_fft = icos.shape
    bins_pad = -(-f // 16) * 16
    full = icos.new_zeros((2 * bins_pad, _PV_OFFSETS, _PV_COLS),
                          dtype=torch.bfloat16)
    for o in range(_PV_OFFSETS):
        cols = slice(o * hop, (o + 1) * hop)
        full[:f, o, :hop] = icos[:, cols]
        full[bins_pad: bins_pad + f, o, :hop] = isin[:, cols]
    stages = 2 * bins_pad // _PV_STAGE_K
    return full.view(stages, _PV_STAGE_K // 8, 8, _PV_OFFSETS,
                     _PV_COLS // 8, 8).permute(3, 0, 1, 4, 5, 2).contiguous()


def _cached_pv_basis_tiles(icos, isin, hop: int,
                           device: torch.device) -> torch.Tensor:
    """``pv_basis_tiles`` on ``device``, built once per (device, n_fft) for
    the same unmodified icos and isin (``ops/pv.py`` passes its cached
    bases on every call)."""
    return _pv_basis_tiles_on(icos, isin, hop, device, icos._version,
                              isin._version)


@functools.lru_cache(maxsize=4)
def _pv_basis_tiles_on(icos, isin, hop, device, *versions):
    # a tensor hashes by identity: the key is these tensors at these versions
    return pv_basis_tiles(icos, isin, hop).to(device)


def pv_resynth(mag, dphi, phase0, rate, icos, isin, hop: int,
               t_out: int) -> torch.Tensor:
    """K3: the phase-vocoder resynthesis of ``pv_resynth_reference``.

    CPU tensors take the plain twin; CUDA tensors launch the three kernels
    of ``csrc/pv_resynth.cu`` (tile sums; A, the bf16 synthesis product on
    wgmma and the overlap-add in one pass; the rows spanning two blocks)
    and count one launch. Rates must lie in (0, 1.3]; the kernel takes
    n_fft // hop == 4, hop <= 256 and F <= 528 (the chain's n_fft <= 1024,
    hop n_fft // 4).
    """
    if mag.device.type == "cpu":
        _check_cpu_domain("pv_resynth", "rates", rate, PV_MAX_RATE)
        return pv_resynth_reference(mag, dphi, phase0, rate, icos, isin,
                                    hop, t_out)
    _check_cuda_inputs("pv_resynth", mag, dphi, phase0, rate)
    b, t_in, f = mag.shape
    n_fft = icos.shape[1]
    r = n_fft // hop
    bins_pad = -(-f // 16) * 16
    if (dphi.shape != (b, t_in - 1, f) or phase0.shape != (b, f)
            or rate.shape != (b,) or icos.shape != (f, n_fft)
            or isin.shape != icos.shape or t_in < 2
            or not 0 < b <= _MAX_GRID_YZ):
        raise ValueError(
            f"pv_resynth: inconsistent shapes mag {tuple(mag.shape)}, dphi "
            f"{tuple(dphi.shape)}, phase0 {tuple(phase0.shape)}, rate "
            f"{tuple(rate.shape)}, basis {tuple(icos.shape)}, hop {hop}")
    if r != _PV_OFFSETS or hop > _PV_COLS or bins_pad > _PV_MAX_BINS_PAD:
        raise ValueError(
            f"pv_resynth: the kernel takes n_fft // hop == {_PV_OFFSETS}, "
            f"hop <= {_PV_COLS} and F <= {_PV_MAX_BINS_PAD}, got n_fft "
            f"{n_fft}, hop {hop}, F {f}")
    rows = t_out + r - 1
    device = mag.device
    tiles = _cached_pv_basis_tiles(icos, isin, hop, device)
    sums = torch.empty(b, -(-rows // PV_TILE), PV_TILE // 16, f,
                       dtype=torch.float32, device=device)
    spill = torch.empty(b, -(-rows // _PV_ROWS), r * (r - 1) // 2, hop,
                        dtype=torch.bfloat16, device=device)
    out = torch.empty(b, rows, hop, dtype=torch.float32, device=device)

    from freesound_classification_tpu_torch.ops import build

    lib = build.load_library()
    with torch.cuda.device(device):
        err = lib.pv_resynth_launch(
            mag.data_ptr(), dphi.data_ptr(), phase0.data_ptr(),
            rate.data_ptr(), tiles.data_ptr(), sums.data_ptr(),
            spill.data_ptr(), out.data_ptr(), b, t_in, f, bins_pad, hop,
            rows, PV_MAX_RATE, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pv_resynth kernels launch failed: cudaError {err}")
    pv_resynth.launches += 1
    return out


pv_resynth.launches = 0


# ---------------------------------------------------------------------------
# K4/K5 and K6: the eval-mode resnet block with BatchNorm folded
# ---------------------------------------------------------------------------

_MAX_SHARED_BYTES = 232448  # dynamic shared memory a Hopper block may use


class FusedBlockWeights(NamedTuple):
    """A folded resnet block as the kernels read it: w1, w3 (cp, cp) and w2
    (taps, cp, cp) bf16 with input channels on rows (the JAX package's
    (C, K) layout), bias and slope (3, cp) float32 (b1, b2, b3 and the three
    PReLU slopes); zero past ``channels``, cp = channels rounded up to 16."""

    w1: torch.Tensor
    w2: torch.Tensor
    w3: torch.Tensor
    bias: torch.Tensor
    slope: torch.Tensor
    channels: int


def pack_resnet_block(fp: dict) -> FusedBlockWeights:
    """A folded block (``ops/resnet_infer.fold_block_params{,_1d}``: float32
    w1 (C, C), w2 (taps, C, C), w3 (C, C), b1-b3, a1-a3) -> its kernel
    weights: the float32 fold rounded once to bf16, and zero padding."""
    c = fp["w1"].shape[0]
    cp = -(-c // 16) * 16

    def mat(m):
        return F.pad(m, (0, cp - c, 0, cp - c)).to(torch.bfloat16) \
            .contiguous()

    def vec(*vs):
        return F.pad(torch.stack(vs).float(), (0, cp - c)).contiguous()

    return FusedBlockWeights(mat(fp["w1"]), mat(fp["w2"]), mat(fp["w3"]),
                             vec(fp["b1"], fp["b2"], fp["b3"]),
                             vec(fp["a1"], fp["a2"], fp["a3"]), c)


def conv1x1(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A (C, K) matrix (the JAX package's layout) as a 1x1 convolution over
    dim 1 of a (B, C, T) or (B, C, H, W) map."""
    spatial = h.dim() - 2
    w = w.T.reshape(w.shape[1], w.shape[0], *([1] * spatial))
    return (F.conv1d if spatial == 1 else F.conv2d)(h, w)


def _fused_block_reference(x: torch.Tensor, wts: FusedBlockWeights,
                           conv2) -> torch.Tensor:
    """The kernel's function in float32 at its bf16 rounding points: x, the
    weights, h1, h2 and y are bf16 values, every sum is float32."""
    c = wts.channels
    shape = (1, c) + (1,) * (x.dim() - 2)

    def vec(v):
        return v[:c].view(shape)

    def mat(w):
        return w[..., :c, :c].float()

    def bf16(h):
        return h.to(torch.bfloat16).float()

    xb = bf16(x)
    h1 = bf16(F.prelu(conv1x1(xb, mat(wts.w1)) + vec(wts.bias[0]),
                      wts.slope[0, :c]))
    h2 = bf16(F.prelu(conv2(h1, mat(wts.w2)) + vec(wts.bias[1]),
                      wts.slope[1, :c]))
    y = F.prelu(conv1x1(h2, mat(wts.w3)) + vec(wts.bias[2]) + xb,
                wts.slope[2, :c])
    return y.to(torch.bfloat16).to(x.dtype)


def resnet_block_1d_fused_reference(x: torch.Tensor,
                                    wts: FusedBlockWeights) -> torch.Tensor:
    """Plain twin of K6: (B, C, T) -> (B, C, T) in x's dtype. conv2's three
    taps read h1 at t - 1, t, t + 1, and h1 = 0 outside [0, T)."""
    return _fused_block_reference(
        x, wts, lambda h, w2: F.conv1d(h, w2.permute(2, 1, 0), padding=1))


def resnet_block_2d_fused_reference(x: torch.Tensor,
                                    wts: FusedBlockWeights) -> torch.Tensor:
    """Plain twin of K4/K5: (B, C, H, W) -> (B, C, H, W) in x's dtype and
    memory format. conv2's tap 3 dh + dw reads h1 at (h + dh - 1,
    w + dw - 1), and h1 = 0 outside the map."""
    def conv2(h, w2):
        k = w2.shape[-1]
        return F.conv2d(h, w2.reshape(3, 3, k, k).permute(3, 2, 0, 1),
                        padding=1)

    return _fused_block_reference(x, wts, conv2)


def _check_weights(name: str, x: torch.Tensor, wts, want: dict,
                   aligned: bool = False) -> None:
    """Each ``want[key] = (shape, dtype)``: the weight tensor ``key`` of
    ``wts`` is contiguous, of that shape and dtype, on x's device, and
    16-byte aligned where ``aligned`` (the cp.async loads of
    ``conv_blocks.cu``)."""
    for key, (shape, dtype) in want.items():
        t = getattr(wts, key)
        if (t.shape != shape or t.dtype != dtype or t.device != x.device
                or not t.is_contiguous()
                or (aligned and t.data_ptr() % 16)):
            raise ValueError(f"{name}: {key} must be contiguous "
                             f"{'aligned ' * aligned}{dtype} {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def _check_block_input(name: str, x: torch.Tensor, channels: int,
                       spatial: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be on the CPU or a CUDA device, "
                         f"got {x.device}")
    if (x.dim() != 2 + spatial or x.shape[1] != channels
            or min(x.shape) <= 0):
        raise ValueError(f"{name}: x {tuple(x.shape)} for a {channels}-"
                         f"channel {spatial}d block")


def _round16(n: int) -> int:
    return -(-n // 16) * 16


# ---------------------------------------------------------------------------
# The blocks' convolution core (csrc/conv_blocks.cu): K4/K5, K6 and K7
# ---------------------------------------------------------------------------

H100_SMS = 132


class ConvPlan(NamedTuple):
    """One launch of the core: tiles of ``bm`` positions x ``bn`` channels
    on a ``grid_m`` x ``grid_n`` grid, ``smem`` bytes of shared memory."""

    bm: int
    bn: int
    grid_m: int
    grid_n: int
    smem: int


def _chunking(bm: int, bn: int) -> tuple:
    """(channels a K chunk, stages of the ring) of a bm x bn tile (``Tile``
    in ``csrc/conv_blocks.cu``): 32 x 3 at 64 columns, where two blocks an
    SM must fit, but 64 x 3 for the 32-row tile (one 16-byte A segment a
    thread); 64 x 2 at 128 columns (half the barriers)."""
    if bn == 64:
        return (32 if bm >= 64 else 64), 3
    return 64, 2


def _ring_bytes(bm: int, bn: int) -> int:
    """The ring: per stage an A chunk (bm rows of bk + 8 channels) and a B
    chunk (bk rows of bn + 8 columns), bf16."""
    bk, stages = _chunking(bm, bn)
    return stages * (bm * (bk + 8) + bk * (bn + 8)) * 2


def _tile(cp: int) -> tuple:
    """(positions, columns) of a tile: 256 x 64 for cp <= 64 (one column
    tile; the tall tile halves the weight traffic), else 128 x 128."""
    return (256, 64) if cp <= 64 else (128, 128)


@functools.lru_cache(maxsize=256)
def conv_plan(m_total: int, n_write: int, cp: int) -> ConvPlan:
    """A convolution launch (``conv_kernel``: K7's two, K4/K5's h1) over
    ``m_total`` positions writing ``n_write`` columns of weights cp
    wide."""
    bm, bn = _tile(cp)
    return ConvPlan(bm, bn, -(-m_total // bm), -(-n_write // bn),
                    _ring_bytes(bm, bn))


@functools.lru_cache(maxsize=256)
def tail_plan(m_total: int, cp: int) -> ConvPlan:
    """K4/K5's tail (``resnet_tail_kernel``): ``_tile``'s positions, or 64
    where those would give fewer than two tiles an SM (the deepest blocks'
    small maps); the ring, then h2 (bm rows of the channels rounded to the
    chunk, + 8) in shared memory."""
    bm, bn = _tile(cp)
    if -(-m_total // bm) < 2 * H100_SMS:
        bm = 64
    bk = _chunking(bm, bn)[0]
    kpad = -(-cp // bk) * bk
    return ConvPlan(bm, bn, -(-m_total // bm), 1,
                    _ring_bytes(bm, bn) + bm * (kpad + 8) * 2)


# K6's small-map tiles, largest first: the three-launch plan takes the first
# that puts a wave of blocks on the card
_SMALL_MAP_TILES = ((64, 128), (64, 64), (32, 64))


@functools.lru_cache(maxsize=256)
def small_map_plan(m_total: int, n_write: int) -> ConvPlan:
    """One launch of K6's three-launch plan (``conv_kernel`` over
    ``m_total`` positions writing ``n_write`` columns), tiled over positions
    and columns: the largest of ``_SMALL_MAP_TILES`` whose grid fills the
    132 SMs, else the smallest (the largest grid the map allows). 128-column
    tiles only where there are more than 64 columns."""
    plans = [ConvPlan(bm, bn, -(-m_total // bm), -(-n_write // bn),
                      _ring_bytes(bm, bn))
             for bm, bn in _SMALL_MAP_TILES if bn == 64 or n_write > 64]
    return next((p for p in plans if p.grid_m * p.grid_n >= H100_SMS),
                plans[-1])


@functools.lru_cache(maxsize=256)
def resnet_block_1d_plan(m_total: int, channels: int, cp: int) -> tuple:
    """K6's launches on the core: K4/K5's two (``conv_plan`` for h1, then
    ``tail_plan``, h2 in shared memory) where the tail's grid fills the
    card; else three (h1, h2 through device memory, y), each tiled over
    positions and columns (``small_map_plan``), so that the weights are
    split across blocks rather than streamed whole by each of a few."""
    tail = tail_plan(m_total, cp)
    if tail.grid_m >= H100_SMS:
        return conv_plan(m_total, cp, cp), tail
    return (small_map_plan(m_total, cp), small_map_plan(m_total, cp),
            small_map_plan(m_total, channels))


def _channel_rows(x: torch.Tensor, cp: int) -> tuple:
    """x (B, C, H, W) as the core's map of channel rows: (tensor, its
    element strides (sb, sh, sw), the channels it reads). In place where
    the channels are contiguous and C, every stride and the base give
    16-byte aligned rows (the model's channels_last maps at C % 8 == 0);
    else a zero-padded (B, H, W, cp) copy."""
    xb = x.to(torch.bfloat16)
    c = xb.shape[1]
    sb, sc, sh, sw = xb.stride()
    if (sc == 1 and c % 8 == 0 and sb % 8 == 0 and sh % 8 == 0
            and sw % 8 == 0 and xb.data_ptr() % 16 == 0):
        return xb, (sb, sh, sw), c
    rows = F.pad(xb.permute(0, 2, 3, 1), (0, cp - c)).contiguous()
    return rows, rows.stride()[:3], cp


def _block_buffers(name: str, x: torch.Tensor, cp: int) -> tuple:
    """The rows of x, the h1 scratch (B, H, W, cp) and the channels_last
    output of a 2d block launch, and the number of positions."""
    n_batch, c, height, width = x.shape
    m_total = n_batch * height * width
    if m_total >= 2**31:
        raise ValueError(f"{name}: {tuple(x.shape)} exceeds the grid")
    rows = _channel_rows(x, cp)
    h1 = torch.empty((n_batch, height, width, cp), dtype=torch.bfloat16,
                     device=x.device)
    out = torch.empty(tuple(x.shape), dtype=torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last)
    return rows, h1, out, m_total


def resnet_block_2d_fused(x: torch.Tensor,
                          wts: FusedBlockWeights) -> torch.Tensor:
    """K4/K5: the folded ResnetBlock2d on an NCHW map (read in place when
    channels_last with C % 8 == 0, the model's; other layouts through a
    padded copy), any float dtype (rounded to bf16 on the way in) -> bf16
    values in x's dtype, channels_last. CPU tensors take
    ``resnet_block_2d_fused_reference``; CUDA tensors launch the h1
    convolution and the tail of ``csrc/conv_blocks.cu``."""
    if x.device.type == "cpu":
        return resnet_block_2d_fused_reference(x, wts)
    name = "resnet_block_2d_fused"
    _check_block_input(name, x, wts.channels, 2)
    cp = wts.w1.shape[0]
    _check_weights(name, x, wts, {
        "w1": ((cp, cp), torch.bfloat16), "w3": ((cp, cp), torch.bfloat16),
        "w2": ((9, cp, cp), torch.bfloat16),
        "bias": ((3, cp), torch.float32), "slope": ((3, cp), torch.float32)},
        aligned=True)
    if cp % 16 or not 0 < wts.channels <= cp:
        raise ValueError(f"{name}: {wts.channels} channels padded to {cp}")
    (rows, (sb, sh, sw), readable), h1, out, m_total = _block_buffers(
        name, x, cp)
    n_batch, c, height, width = x.shape
    first, tail = conv_plan(m_total, cp, cp), tail_plan(m_total, cp)

    from freesound_classification_tpu_torch.ops import build

    lib = build.load_library()
    osb, _, osh, osw = out.stride()
    with torch.cuda.device(x.device):
        err = lib.resnet_block_2d_launch(
            rows.data_ptr(), sb, sh, sw, readable, wts.w1.data_ptr(),
            wts.w2.data_ptr(), wts.w3.data_ptr(), wts.bias.data_ptr(),
            wts.slope.data_ptr(), h1.data_ptr(), out.data_ptr(), osb, osh,
            osw, int(c % 2 == 0), n_batch, c, cp, height, width, first.bm,
            first.bn, first.smem, tail.bm, tail.bn, tail.smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"resnet_block_2d kernels launch failed: cudaError "
                           f"{err}")
    resnet_block_2d_fused.launches += 1
    return out.to(x.dtype)


resnet_block_2d_fused.launches = 0


def resnet_block_1d_fused(x: torch.Tensor,
                          wts: FusedBlockWeights) -> torch.Tensor:
    """K6: the folded ResnetBlock1d on a (B, C, T) map (read in place when
    its channels are contiguous with C % 8 == 0, the fused hierarchical
    path's layout; others through a padded copy), any float dtype (rounded
    to bf16 on the way in) -> bf16 values in x's dtype, channels contiguous.
    CPU tensors take ``resnet_block_1d_fused_reference``; CUDA tensors
    launch ``csrc/conv_blocks.cu`` with H = 1 and W = T, as
    ``resnet_block_1d_plan`` plans it."""
    if x.device.type == "cpu":
        return resnet_block_1d_fused_reference(x, wts)
    name = "resnet_block_1d_fused"
    _check_block_input(name, x, wts.channels, 1)
    cp = wts.w1.shape[0]
    _check_weights(name, x, wts, {
        "w1": ((cp, cp), torch.bfloat16), "w3": ((cp, cp), torch.bfloat16),
        "w2": ((3, cp, cp), torch.bfloat16),
        "bias": ((3, cp), torch.float32), "slope": ((3, cp), torch.float32)},
        aligned=True)
    if cp % 16 or not 0 < wts.channels <= cp:
        raise ValueError(f"{name}: {wts.channels} channels padded to {cp}")
    n_batch, c, length = x.shape
    m_total = n_batch * length
    if m_total >= 2**31:
        raise ValueError(f"{name}: {tuple(x.shape)} exceeds the grid")
    rows, (sb, _, st), readable = _channel_rows(x.unsqueeze(2), cp)
    plan = resnet_block_1d_plan(m_total, c, cp)
    # h1, and h2 where three launches pass it through device memory
    scratch = torch.empty((len(plan) - 1, m_total, cp), dtype=torch.bfloat16,
                          device=x.device)
    out = torch.empty((n_batch, length, c), dtype=torch.bfloat16,
                      device=x.device).transpose(1, 2)
    tiles = [v for p in plan for v in (p.bm, p.bn, p.smem)]
    tiles += [0] * (9 - len(tiles))

    from freesound_classification_tpu_torch.ops import build

    lib = build.load_library()
    with torch.cuda.device(x.device):
        err = lib.resnet_block_1d_launch(
            rows.data_ptr(), sb, st, readable, wts.w1.data_ptr(),
            wts.w2.data_ptr(), wts.w3.data_ptr(), wts.bias.data_ptr(),
            wts.slope.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + (len(plan) - 2) * m_total * cp * 2,
            out.data_ptr(), out.stride(0), c,
            int(c % 2 == 0), n_batch, c, cp, length, len(plan), *tiles,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"resnet_block_1d kernels launch failed: cudaError "
                           f"{err}")
    resnet_block_1d_fused.launches += 1
    return out if x.dtype == torch.bfloat16 else out.to(x.dtype)


resnet_block_1d_fused.launches = 0


# ---------------------------------------------------------------------------
# K7: the eval-mode backbone BasicBlock with BatchNorm folded
# ---------------------------------------------------------------------------


class BasicBlockWeights(NamedTuple):
    """A folded stride-1 identity BasicBlock as K7 reads it: w1, w2 bf16
    (9, cp, cp) matrices (tap 3 dh + dw, input channels on rows), bias
    (2, cp) float32 (b1, b2); zero past ``channels``, cp = channels rounded
    up to 16."""

    w1: torch.Tensor
    w2: torch.Tensor
    bias: torch.Tensor
    channels: int


def pack_basic_block(fp: dict) -> BasicBlockWeights:
    """A folded block (``ops/backbone_infer.fold_basic_params``: float32
    w1, w2 (3, 3, C, C), b1, b2) -> its kernel weights: the float32 fold
    rounded once to bf16, and zero padding."""
    c = fp["w1"].shape[2]
    cp = _round16(c)

    def mat(w):
        return F.pad(w.reshape(9, c, c), (0, cp - c, 0, cp - c)) \
            .to(torch.bfloat16).contiguous()

    bias = F.pad(torch.stack([fp["b1"], fp["b2"]]).float(), (0, cp - c))
    return BasicBlockWeights(mat(fp["w1"]), mat(fp["w2"]), bias.contiguous(),
                             c)


def _conv3x3(h: torch.Tensor, w: torch.Tensor, c: int) -> torch.Tensor:
    """An NCHW map times (9, cp, cp) tap-major weights, SAME padding."""
    k = w[:, :c, :c].float().reshape(3, 3, c, c).permute(3, 2, 0, 1)
    return F.conv2d(h, k, padding=1)


def basic_block_fused_reference(x: torch.Tensor,
                                wts: BasicBlockWeights) -> torch.Tensor:
    """Plain twin of K7: (B, C, H, W) -> the same shape in x's dtype and
    memory format, ``relu(conv3x3(h1) + b2 + x)`` with ``h1 =
    relu(conv3x3(x) + b1)``, h1 = 0 outside the map. The kernel's rounding
    points: x, the weights and h1 are bf16 values, the sums and biases
    float32, and y is rounded to bf16."""
    c = wts.channels
    xb = x.to(torch.bfloat16).float()
    b1, b2 = (wts.bias[i, :c].view(1, c, 1, 1) for i in (0, 1))
    h1 = F.relu(_conv3x3(xb, wts.w1, c) + b1).to(torch.bfloat16).float()
    y = F.relu(_conv3x3(h1, wts.w2, c) + b2 + xb)
    return y.to(torch.bfloat16).to(x.dtype)


def basic_block_fused(x: torch.Tensor,
                      wts: BasicBlockWeights) -> torch.Tensor:
    """K7: the folded stride-1 identity BasicBlock on an NCHW map (read in
    place when channels_last with C % 8 == 0, the model's; other layouts
    through a padded copy), any float dtype (rounded to bf16 on the way
    in) -> bf16 values in x's dtype, channels_last. CPU tensors take
    ``basic_block_fused_reference``; CUDA tensors launch the two
    convolutions of ``csrc/conv_blocks.cu`` (h1 through device memory)."""
    if x.device.type == "cpu":
        return basic_block_fused_reference(x, wts)
    name = "basic_block_fused"
    _check_block_input(name, x, wts.channels, 2)
    cp = wts.bias.shape[1]
    _check_weights(name, x, wts, {
        "w1": ((9, cp, cp), torch.bfloat16),
        "w2": ((9, cp, cp), torch.bfloat16),
        "bias": ((2, cp), torch.float32)}, aligned=True)
    if cp % 16 or not 0 < wts.channels <= cp:
        raise ValueError(f"{name}: {wts.channels} channels padded to {cp}")
    (rows, (sb, sh, sw), readable), h1, out, m_total = _block_buffers(
        name, x, cp)
    n_batch, c, height, width = x.shape
    plan = conv_plan(m_total, cp, cp)

    from freesound_classification_tpu_torch.ops import build

    lib = build.load_library()
    osb, _, osh, osw = out.stride()
    with torch.cuda.device(x.device):
        err = lib.basic_block_launch(
            rows.data_ptr(), sb, sh, sw, readable, wts.w1.data_ptr(),
            wts.w2.data_ptr(), wts.bias.data_ptr(), h1.data_ptr(),
            out.data_ptr(), osb, osh, osw, int(c % 2 == 0), n_batch, c, cp,
            height, width, plan.bm, plan.bn, plan.smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"basic_block kernels launch failed: cudaError "
                           f"{err}")
    basic_block_fused.launches += 1
    return out.to(x.dtype)


basic_block_fused.launches = 0


# ---------------------------------------------------------------------------
# K8: the eval-mode ConvBlock2d head (bn_in -> conv3x3 -> 2x2 max -> bn_out
# -> PReLU)
# ---------------------------------------------------------------------------

HEAD_MAX_IN = 4  # input channels the kernel takes (block0 has 2)
HEAD_TILE = (8, 32)  # pooled rows and columns a tile of the kernel
_HEAD_PATCH_ROW = 81  # the staged input's row in pixels (17 mod 32)


class HeadWeights(NamedTuple):
    """A folded head as K8 reads it: s_in, t_in (C_in,) float32 (bn_in, an
    affine on the input); w the packed (K, depth) bf16 operand of the
    conv's matrix product (``pack_conv_head``); scale, shift and alpha
    (depth,) float32 (bn_out with the conv bias folded in, applied after
    the pool, and the PReLU slopes)."""

    s_in: torch.Tensor
    t_in: torch.Tensor
    w: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor
    alpha: torch.Tensor


def _head_pairs(c_in: int) -> int:
    """CP: C_in rounded up to even, so that each pair of K rows is one
    tap's two channels."""
    return c_in + c_in % 2


def head_k_rows(c_in: int) -> int:
    """K of the head's matrix product: 9 taps x CP, zero-padded to a
    multiple of 16 (the k of mma.sync m16n8k16; the kernel runs the last
    2 or 4 real k as one m16n8k8): 32 for C_in <= 2, else 48."""
    return -(-9 * _head_pairs(c_in) // 16) * 16


def pack_conv_head(fp: dict) -> HeadWeights:
    """A folded head (``ops/head_infer.fold_head_params``, float32) -> its
    kernel weights: the conv kernel (3, 3, C_in, depth), rounded once to
    bf16, as the (K, depth) operand: row tap CP + ci (tap 3 dh + dw), zero
    for the padding channel ci >= C_in and past 9 CP."""
    c_in, depth = fp["kern"].shape[2:]
    cp = _head_pairs(c_in)
    w = F.pad(fp["kern"].reshape(9, c_in, depth).float(),
              (0, 0, 0, cp - c_in)).reshape(9 * cp, depth)
    w = F.pad(w, (0, 0, 0, head_k_rows(c_in) - 9 * cp))
    return HeadWeights(
        fp["s_in"].float().contiguous(), fp["t_in"].float().contiguous(),
        w.to(torch.bfloat16).contiguous(), fp["scale"].float().contiguous(),
        fp["bias"].float().contiguous(), fp["alpha"].float().contiguous())


def head_conv_weight(wts: HeadWeights) -> torch.Tensor:
    """The conv weight (depth, C_in, 3, 3), float32, of the packed
    operand."""
    c_in, depth = wts.s_in.shape[0], wts.w.shape[1]
    cp = _head_pairs(c_in)
    return wts.w[:9 * cp].float().reshape(3, 3, cp, depth)[:, :, :c_in] \
        .permute(3, 2, 0, 1)


class HeadPlan(NamedTuple):
    """K8's launch: ``tiles_h`` x ``tiles_w`` tiles of ``tile_h`` x
    ``tile_w`` pooled outputs a clip, ``n_tiles`` in all (blocks walk them
    in turn), ``smem`` bytes of shared memory a block."""

    tile_h: int
    tile_w: int
    tiles_h: int
    tiles_w: int
    n_tiles: int
    smem: int


@functools.lru_cache(maxsize=256)
def head_plan(n_batch: int, c_in: int, h_out: int, w_out: int,
              depth: int) -> HeadPlan:
    """K8's tiles and shared memory (``smem_bytes`` in
    ``csrc/conv_head.cu``): the staging tile of pooled outputs (bf16, in
    TMA's boxes of 16 channels) and the staged input (2 tile_h + 2 rows of
    ``_HEAD_PATCH_ROW`` pixels of CP bf16)."""
    th, tw = HEAD_TILE
    tiles_h, tiles_w = -(-h_out // th), -(-w_out // tw)
    smem = (th * tw * depth * 2
            + (2 * th + 2) * _HEAD_PATCH_ROW * _head_pairs(c_in) * 2)
    return HeadPlan(th, tw, tiles_h, tiles_w, n_batch * tiles_h * tiles_w,
                    smem)


def conv_head_fused_reference(x: torch.Tensor,
                              wts: HeadWeights) -> torch.Tensor:
    """Plain twin of K8: (B, C_in, H, W), any float dtype -> (B, depth,
    H // 2, W // 2) bf16. bn_in(x) in float32 rounded to bf16 (the SAME
    zeros are zeros of bn_in(x)), the bf16 conv with float32 sums, the 2x2
    max of the float32 conv outputs, ``* scale + shift``, PReLU, bf16."""

    def per_channel(v):
        return v.view(1, -1, 1, 1)

    xa = (x.float() * per_channel(wts.s_in) + per_channel(wts.t_in)) \
        .to(torch.bfloat16).float()
    y = F.max_pool2d(F.conv2d(xa, head_conv_weight(wts), padding=1), 2)
    y = y * per_channel(wts.scale) + per_channel(wts.shift)
    return torch.where(y >= 0, y, per_channel(wts.alpha) * y) \
        .to(torch.bfloat16)


def conv_head_fused(x: torch.Tensor, wts: HeadWeights) -> torch.Tensor:
    """K8: the folded head on an NCHW map (any strides; float32 or bf16)
    -> (B, depth, H // 2, W // 2) bf16 in channels_last memory. CPU tensors
    take ``conv_head_fused_reference``; CUDA tensors launch
    ``conv_head_kernel`` (``csrc/conv_head.cu``, tiles of ``head_plan``).
    1 <= C_in <= 4, H and W >= 2, depth a multiple of 16 in [16, 128]."""
    if x.device.type == "cpu":
        return conv_head_fused_reference(x, wts)
    name = "conv_head_fused"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be on the CPU or a CUDA device, "
                         f"got {x.device}")
    c_in, (k_rows, depth) = wts.s_in.shape[0], wts.w.shape
    if (x.dim() != 4 or x.shape[1] != c_in or not 1 <= c_in <= HEAD_MAX_IN
            or min(x.shape[2:]) < 2 or x.shape[0] <= 0
            or depth % 16 or not 16 <= depth <= 128
            or k_rows != head_k_rows(c_in)):
        raise ValueError(f"{name}: unsupported x {tuple(x.shape)} for "
                         f"{c_in} -> {depth} channels, K {k_rows}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    for key in HeadWeights._fields:
        t = getattr(wts, key)
        dtype = torch.bfloat16 if key == "w" else torch.float32
        if t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous {dtype} on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    n_batch, _, height, width = x.shape
    h_out, w_out = height // 2, width // 2
    out = torch.empty((n_batch, depth, h_out, w_out), dtype=torch.bfloat16,
                      device=x.device, memory_format=torch.channels_last)
    plan = head_plan(n_batch, c_in, h_out, w_out, depth)
    if plan.n_tiles >= 2**31:
        raise ValueError(f"{name}: {plan.n_tiles} tiles exceed the grid")

    from freesound_classification_tpu_torch.ops import build

    lib = build.load_library()
    osb, _, osh, osw = out.stride()
    with torch.cuda.device(x.device):
        err = lib.conv_head_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), wts.s_in.data_ptr(),
            wts.t_in.data_ptr(), wts.w.data_ptr(), wts.scale.data_ptr(),
            wts.shift.data_ptr(), wts.alpha.data_ptr(), out.data_ptr(),
            n_batch, c_in, height, width, depth, *x.stride(), osb, osh, osw,
            plan.smem, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_head_kernel launch failed: cudaError {err}")
    conv_head_fused.launches += 1
    return out


conv_head_fused.launches = 0


# ---------------------------------------------------------------------------
# K9: the split mel kernel of the fast featurization
# ---------------------------------------------------------------------------


def split_magnitude(spec: torch.Tensor, n_freq: int,
                    im_offset: int) -> torch.Tensor:
    """|S| of a bf16 [re | im] spectrum (..., W) -> bf16 (..., n_freq),
    rounded to bf16 after each of its four operations (re^2, im^2, the sum,
    the sqrt), as the TPU kernel's bf16 arithmetic rounds."""
    re = spec[..., :n_freq]
    im = spec[..., im_offset:im_offset + n_freq]
    return torch.sqrt(re * re + im * im)


def mel_log_split_reference(spec: torch.Tensor, fb_t: torch.Tensor,
                            n_freq: int, im_offset: int) -> torch.Tensor:
    """Plain twin of K9: bf16 spectrum (B, T, W), re at [0, n_freq) and im
    at [im_offset, im_offset + n_freq) of each row, x bf16 filterbank (F, M)
    -> float32 log-mel (B, M, T); the products of bf16 values are exact in
    float32 and summed in float32."""
    mag = split_magnitude(spec, n_freq, im_offset)
    mel = mag.float() @ fb_t.float()
    return torch.log(mel + LOG_EPS).transpose(-1, -2)


def _check_split_layout(spec: torch.Tensor, fb_t: torch.Tensor, n_freq: int,
                        im_offset: int) -> None:
    if spec.dtype != torch.bfloat16 or fb_t.dtype != torch.bfloat16:
        raise ValueError(f"mel_log_split: spec and fb_t must be bfloat16, got "
                         f"{spec.dtype} and {fb_t.dtype}")
    if spec.dim() != 3 or fb_t.dim() != 2 or fb_t.shape[0] != n_freq:
        raise ValueError(f"mel_log_split: spec {tuple(spec.shape)} must be "
                         f"(B, T, W) and fb_t {tuple(fb_t.shape)} (F={n_freq}"
                         ", M)")
    if not 0 < n_freq <= im_offset or im_offset + n_freq > spec.shape[-1]:
        raise ValueError(f"mel_log_split: re [0, {n_freq}) and im "
                         f"[{im_offset}, {im_offset + n_freq}) do not fit a "
                         f"row of {spec.shape[-1]}")


def mel_band_pack(fb_t: torch.Tensor) -> tuple:
    """K9's filterbank: each band's range of bins in a (F, M) filterbank,
    int32 (M,) ``lo`` and ``hi`` (``mel_band_ranges`` of its transpose),
    and float32 (M, F) ``packed``, band m's weights over [lo[m], hi[m])
    from the start of row m and zeros after, so that a band's weights lie
    side by side; on ``fb_t``'s device with no host sync."""
    n_freq = fb_t.shape[0]
    lo, hi = mel_band_ranges(fb_t.T)
    j = torch.arange(n_freq, device=fb_t.device)
    idx = torch.clamp(lo.long()[:, None] + j, max=n_freq - 1)
    picked = torch.gather(fb_t.T.float(), 1, idx)
    packed = torch.where(j < (hi - lo)[:, None], picked, 0.0)
    return lo, hi, packed.contiguous()


@functools.lru_cache(maxsize=4)
def _band_pack_of(fb_t, version):
    # a tensor hashes by identity: the key is this tensor at this version
    return mel_band_pack(fb_t)


class SplitPlan(NamedTuple):
    blocks: int  # one a tile of _K9_FRAMES rows: a run of _K9_FRAMES x W
    smem: int  # bytes: the 16-byte chunks that enclose the run when it
    #            starts up to 14 bytes into its first chunk


_K9_FRAMES = 4  # kFrames of mel_log_split_kernel


def split_plan(n_rows: int, width: int) -> SplitPlan:
    """What ``mel_log_split`` hands ``mel_log_split_kernel`` for ``n_rows``
    = B T rows of ``width`` bf16 values."""
    smem = -(-(_K9_FRAMES * width * 2 + 14) // 16) * 16
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(f"mel_log_split: rows of {width} values do not fit "
                         f"a block's shared memory ({smem} bytes)")
    return SplitPlan(-(-n_rows // _K9_FRAMES), smem)


def mel_log_split(spec: torch.Tensor, fb_t: torch.Tensor, n_freq: int,
                  im_offset: int) -> torch.Tensor:
    """K9: contiguous bf16 [re | im] spectrum (B, T, W) x bf16 filterbank
    (F, M) -> contiguous float32 log-mel (B, M, T).

    CPU tensors take ``mel_log_split_reference``; CUDA tensors launch
    ``mel_log_split_kernel`` (``csrc/mel_log_split.cu``), which reads the
    frames back to back and sums each band over its range of bins only
    (``mel_band_pack``, cached per filterbank).
    """
    _check_split_layout(spec, fb_t, n_freq, im_offset)
    if spec.device.type == "cpu" and fb_t.device.type == "cpu":
        return mel_log_split_reference(spec, fb_t, n_freq, im_offset)
    if spec.device.type != "cuda" or fb_t.device != spec.device:
        raise ValueError(
            "mel_log_split: spec and fb_t must both be on the CPU or both on "
            f"one CUDA device, got {spec.device} and {fb_t.device}")
    n_batch, n_frames, width = spec.shape
    n_mel = fb_t.shape[1]
    if not spec.is_contiguous():
        raise ValueError(f"mel_log_split: the kernel reads frames back to "
                         f"back, so spec must be a contiguous (B, T, W); got "
                         f"strides {spec.stride()} for {tuple(spec.shape)}")
    if not 0 < n_batch * n_frames < 2 ** 31 or n_mel <= 0:
        raise ValueError(f"mel_log_split: unsupported shape B={n_batch} "
                         f"T={n_frames} M={n_mel}")
    plan = split_plan(n_batch * n_frames, width)
    lo, hi, packed = _band_pack_of(fb_t, fb_t._version)

    from freesound_classification_tpu_torch.ops import build

    lib = build.load_library()
    out = torch.empty((n_batch, n_mel, n_frames), dtype=torch.float32,
                      device=spec.device)
    with torch.cuda.device(spec.device):
        err = lib.mel_log_split_launch(
            spec.data_ptr(), width, im_offset, packed.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
            n_batch * n_frames, n_freq, n_frames, n_mel, plan.blocks,
            plan.smem, torch.cuda.current_stream(spec.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mel_log_split_kernel launch failed: cudaError "
                           f"{err}")
    mel_log_split.launches += 1
    return out


mel_log_split.launches = 0
