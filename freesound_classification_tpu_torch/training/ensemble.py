"""Fold-ensemble inference: the 5-fold prediction path
(JAX ``training/ensemble.py:EnsemblePredictor``).

The JAX package stacks the fold weights and vmaps one program over them. Here
each batch is featurized once, the K fold models run in a loop over the shared
features, and their sigmoids are averaged.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from freesound_classification_tpu_torch.models.frontend import Frontend


class EnsemblePredictor:
    """K fold models behind one frontend, on ``device``."""

    def __init__(self, models: Sequence[nn.Module], frontend: Frontend,
                 device: torch.device | str):
        if not models:
            raise ValueError("EnsemblePredictor needs at least one model")
        self.device = torch.device(device)
        self.models = [m.to(self.device).eval() for m in models]
        self.frontend = frontend

    @torch.inference_mode()
    def predict_batch(self, wave, lengths) -> torch.Tensor:
        """(B, L) waveforms + (B,) valid lengths -> (B, C) fold-averaged
        probabilities, float32 on ``device``."""
        wave = torch.as_tensor(wave, device=self.device)
        lengths = torch.as_tensor(lengths, device=self.device)
        inputs, frame_lengths = self.frontend(wave, lengths)
        probs = [torch.sigmoid(m(inputs, frame_lengths)) for m in self.models]
        return torch.stack(probs).mean(dim=0)

    def predict_loader(self, loader, n_tta: int = 1) -> np.ndarray:
        """Fold-averaged probabilities over a bucketed loader, with rows put
        back in dataset order by ``batch["index"]``."""
        if n_tta > 1:
            raise NotImplementedError(
                "n_tta > 1: test-time augmentation needs the augmentation "
                "ops, which the port does not have yet (ROADMAP M1.6)")
        probs_chunks, idx_chunks = [], []
        for batch in loader:
            probs = self.predict_batch(batch["signal"], batch["lengths"])
            probs_chunks.append(probs.cpu().numpy())
            idx_chunks.append(batch["index"])
        probs = np.concatenate(probs_chunks)
        out = np.zeros_like(probs)
        out[np.concatenate(idx_chunks)] = probs
        return out
