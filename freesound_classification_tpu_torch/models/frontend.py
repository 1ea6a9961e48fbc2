"""Waveform -> model-input featurization (JAX ``models/frontend.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from freesound_classification_tpu_torch.ops import dsp, kernels
from freesound_classification_tpu_torch.utils.device import resolve_device


class Frontend:
    """Maps (wave (B, L), sample_lengths (B,)) to model inputs and valid
    frame counts (B,) int64.

    model_family:
      "2d" -> spectrogram image (B, F, T, 1)  [TwoDimensionalCNN]
      "1d" -> per-frame features (B, T, F)    [HierarchicalCNN]

    Features are the descriptor's: log-mel (``mel_*``), log-STFT magnitude
    (``stft_*``) or the raw samples (``raw``, F = 1, a frame per sample).
    ``mel_project`` is K1 (``kernels.mel_project_log``) unless a caller
    substitutes its plain twin to compare the two on the card. ``device``
    is the card unless the caller passes "cpu"; without a card it raises.
    """

    def __init__(
        self,
        descriptor: str,
        model_family: str = "2d",
        sr: int = 44100,
        device: torch.device | str = "cuda",
        mel_project: dsp.MelProject = kernels.mel_project_log,
    ):
        if model_family not in ("1d", "2d"):
            raise ValueError(f"unknown model family {model_family!r}")
        self.feat = dsp.parse_features(descriptor)
        self.descriptor = descriptor
        self.model_family = model_family
        self.sr = sr
        self.device = resolve_device(device)
        self.mel_project = mel_project
        self.filterbank = None
        if self.feat.kind == "mel":
            self.filterbank = torch.from_numpy(dsp.mel_filterbank(
                sr=sr, n_fft=self.feat.n_fft, n_mels=self.feat.n_mel,
                fmin=5.0)).to(self.device)

    @property
    def n_features(self) -> int:
        return self.feat.n_features

    def frame_count(self, length: int) -> int:
        return dsp.feature_frames(length, self.descriptor)

    def frame_lengths(self, sample_lengths: torch.Tensor) -> torch.Tensor:
        """Valid feature frames per clip given its valid samples."""
        if self.feat.kind == "raw":
            return sample_lengths
        return sample_lengths // self.feat.hop_size + 1

    def __call__(self, wave: torch.Tensor, sample_lengths: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        spec = dsp.featurize(wave, self.descriptor, self.filterbank,
                             mel_project=self.mel_project)  # (B, F, T)
        frame_lengths = torch.clamp(self.frame_lengths(sample_lengths),
                                    max=spec.shape[-1])
        if self.model_family == "2d":
            return spec[..., None], frame_lengths
        return spec.transpose(-1, -2), frame_lengths


MODEL_FAMILY = {
    "2d_cnn": "2d",
    "backbone_cnn": "2d",
    "hierarchical_cnn": "1d",
    "apc": "1d",
    "cpc": "1d",
}
