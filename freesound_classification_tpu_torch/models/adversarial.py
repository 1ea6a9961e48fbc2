"""The adversarial test's train-vs-test domain discriminator (JAX
``models/adversarial.py``).

Per-frame features (B, T, F) -> BatchNorm -> 1x1 conv -> resnet block ->
max-pool -> BatchNorm -> unpadded width-3 conv -> resnet block -> max-pool
-> BatchNorm -> unpadded width-3 conv -> resnet block -> BatchNorm -> a 1x1
conv to one logit a frame -> sigmoid; a clip's domain score is the max over
its valid frames. The frame counts follow each pool and unpadded conv as
JAX's do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from freesound_classification_tpu_torch.models.blocks import (
    BatchNorm,
    Conv1d,
    ResnetBlock1d,
    masked_max_pool_time,
)


class DomainDiscriminator(nn.Module):
    """``forward(feats (B, T, F), frame_lengths (B,))`` -> {"domain_prob":
    (B,), "frame_probs": (B, T')}, float32. Module names are flax's."""

    def __init__(self, input_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.bn0 = BatchNorm(input_dim)
        self.conv0 = Conv1d(input_dim, 32, 1)
        self.res0 = ResnetBlock1d(32)
        self.bn1 = BatchNorm(32)
        self.conv1 = Conv1d(32, 32, 3)
        self.res1 = ResnetBlock1d(32)
        self.bn2 = BatchNorm(32)
        self.conv2 = Conv1d(32, 64, 3)
        self.res2 = ResnetBlock1d(64)
        self.bn_head = BatchNorm(64)
        self.head = Conv1d(64, 1, 1)

    def forward(self, feats: torch.Tensor,
                frame_lengths: torch.Tensor) -> dict:
        h = feats.to(self.dtype).transpose(1, 2)  # (B, F, T)
        h = self.res0(self.conv0(self.bn0(h)))
        h = F.max_pool1d(h, 2)
        lengths = torch.clamp(frame_lengths // 2, min=1)
        h = self.res1(self.conv1(self.bn1(h)))
        h = F.max_pool1d(h, 2)
        lengths = torch.clamp((lengths - 2) // 2, min=1)
        h = self.res2(self.conv2(self.bn2(h)))
        lengths = torch.clamp(lengths - 2, min=1)
        frame_probs = torch.sigmoid(self.head(self.bn_head(h)))  # (B, 1, T')
        lengths = torch.clamp(lengths, max=frame_probs.shape[2])
        pooled = masked_max_pool_time(frame_probs, lengths)[:, 0]
        return {"domain_prob": pooled.float(),
                "frame_probs": frame_probs[:, 0].float()}
