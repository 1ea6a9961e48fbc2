"""Wrappers of the port's hand-written CUDA kernels, beside their plain twins.

K1, ``mel_project_log``: the log-mel tail of the frontend,
``out[b, m, t] = log(sum_f fb[m, f] * |S[b, f, t]| + 1e-4)``.
It replaces the TPU kernel ``_mel_log_kernel`` of
``freesound_classification_tpu/ops/pallas_kernels.py`` (reached there through
``_mel_project_log_2d`` and ``mel_project_log_ri``). The CUDA source is
``csrc/mel_log.cu``.

A wrapper runs its plain twin only for tensors on the CPU. A CUDA tensor
launches the kernel, or the wrapper raises; nothing falls back. Each launch
adds one to the wrapper's ``launches`` count, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import torch

LOG_EPS = 1e-4
_MAX_GRID_Z = 65535  # CUDA's limit on gridDim.z, one block row per clip


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
    if not 0 < n_batch <= _MAX_GRID_Z or min(n_freq, n_frames, n_mel) <= 0:
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
