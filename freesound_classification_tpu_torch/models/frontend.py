"""Waveform -> model-input featurization (JAX ``models/frontend.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from freesound_classification_tpu_torch.ops import dsp, kernels


class Frontend:
    """Maps (wave (B, L), sample_lengths (B,)) to the 2d model's inputs:
    the log-mel image (B, F, T, 1) and valid frame counts (B,) int64.

    ``mel_project`` is K1 (``kernels.mel_project_log``) unless a caller
    substitutes its plain twin to compare the two on the card.
    """

    def __init__(
        self,
        descriptor: str,
        model_family: str = "2d",
        sr: int = 44100,
        device: torch.device | str = "cpu",
        mel_project: dsp.MelProject = kernels.mel_project_log,
    ):
        self.feat = dsp.parse_features(descriptor)
        if self.feat.kind != "mel" or model_family != "2d":
            raise NotImplementedError(
                f"Frontend({descriptor!r}, {model_family!r}): the port has "
                "the mel features of the '2d' family only (ROADMAP M4)")
        self.descriptor = descriptor
        self.model_family = model_family
        self.sr = sr
        self.device = torch.device(device)
        self.mel_project = mel_project
        self.filterbank = torch.from_numpy(dsp.mel_filterbank(
            sr=sr, n_fft=self.feat.n_fft, n_mels=self.feat.n_mel, fmin=5.0,
        )).to(self.device)

    def frame_count(self, length: int) -> int:
        return dsp.feature_frames(length, self.descriptor)

    def frame_lengths(self, sample_lengths: torch.Tensor) -> torch.Tensor:
        """Valid feature frames per clip given its valid samples."""
        return sample_lengths // self.feat.hop_size + 1

    def __call__(self, wave: torch.Tensor, sample_lengths: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        spec = dsp.log_mel_spectrogram(
            wave, self.filterbank, self.feat.n_fft, self.feat.hop_size,
            mel_project=self.mel_project)  # (B, F, T)
        frame_lengths = torch.clamp(self.frame_lengths(sample_lengths),
                                    max=spec.shape[-1])
        return spec[..., None], frame_lengths
