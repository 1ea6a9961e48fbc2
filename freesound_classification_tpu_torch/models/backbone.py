"""The resnet18/34 backbone classifier (JAX ``models/backbone.py``).

The log-(mel-)spectrogram (B, H, W, 1) is repeated to 3 channels, batch-
normed (``input_norm``), run through a resnet trunk (conv7x7/2 -> BN -> relu
-> max-pool 3/2 -> stages of BasicBlocks 64/128/256/512), max-pooled over
its valid frames and fed to the shared MLP head. Inside, maps are NCHW.
Module names follow the JAX package's (``trunk.stage{s}_block{b}.conv1``,
...), so ``interop`` maps the weights by name.

``fused_infer`` runs eval-mode blocks through ``ops/backbone_infer.py``:
K7 for the stride-1 identity blocks, the folded twin for the others.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from freesound_classification_tpu_torch.models.blocks import (
    BatchNorm,
    Conv2d,
    MLPHead,
    at_least_float32,
    masked_max_pool_2d,
)
from freesound_classification_tpu_torch.ops import backbone_infer

RESNET_STAGES = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
}
TRUNK_WIDTH = 512  # the last stage's channels, the head's width
TRUNK_STRIDES = 5  # conv1, the max-pool and the first blocks of stages 1-3


class BasicBlock(nn.Module):
    """conv3x3 (stride) -> BN -> relu -> conv3x3 -> BN -> + shortcut ->
    relu, all convolutions bias-free. The shortcut is a 1x1 conv (stride)
    and BN where the width or the stride changes, else the identity."""

    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 fused_infer: bool = False):
        super().__init__()
        self.strides = strides
        self.fused_infer = fused_infer
        self.conv1 = Conv2d(in_channels, features, 3, stride=strides,
                            padding=1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.downsample = self.downsample_bn = None
        if in_channels != features or strides != 1:
            # flax's SAME for a 1x1 window is no padding at any stride
            self.downsample = Conv2d(in_channels, features, 1,
                                     stride=strides, bias=False)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_infer and not self.training:
            return backbone_infer.basic_block_infer(x, self, self.strides)
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        res = (x if self.downsample is None
               else self.downsample_bn(self.downsample(x)))
        return F.relu(h + res)


class ResNetTrunk(nn.Module):
    """conv7x7/2 (pad 3) -> BN -> relu -> max-pool 3/2 (pad 1) -> the
    stages; each stage after the first opens with a stride-2 block."""

    def __init__(self, stages: Sequence[int], fused_infer: bool = False):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.block_names = []
        c_in = 64
        for stage, n_blocks in enumerate(stages):
            features = 64 * 2**stage
            for b in range(n_blocks):
                name = f"stage{stage}_block{b}"
                self.add_module(name, BasicBlock(
                    c_in, features, 2 if stage > 0 and b == 0 else 1,
                    fused_infer))
                self.block_names.append(name)
                c_in = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        # max_pool2d pads with -inf, as flax's max_pool
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for name in self.block_names:
            h = getattr(self, name)(h)
        return h


def trunk_frames(frame_lengths: torch.Tensor) -> torch.Tensor:
    """Valid frames after the trunk's five stride-2 stages: ``(l + 1) // 2``
    five times, at least 1 (65 frames -> 3, not 65 // 32 = 2)."""
    lengths = frame_lengths
    for _ in range(TRUNK_STRIDES):
        lengths = (lengths + 1) // 2
    return torch.clamp(lengths, min=1)


class CNNBackbone(nn.Module):
    """Spectrogram (B, H, W, 1) + valid frame counts -> (B, n_classes)
    float32 logits (JAX ``CNNBackbone``). ``dtype`` is the compute dtype;
    parameters stay float32."""

    def __init__(self, arch: str = "resnet18", n_classes: int = 80,
                 dtype: torch.dtype = torch.float32,
                 output_dropout: float = 0.0, fused_infer: bool = False):
        super().__init__()
        if arch not in RESNET_STAGES:
            raise ValueError(f"unknown backbone {arch!r}, expected one of "
                             f"{sorted(RESNET_STAGES)}")
        self.arch = arch
        self.dtype = dtype
        self.input_norm = BatchNorm(3)
        self.trunk = ResNetTrunk(RESNET_STAGES[arch], fused_infer)
        self.head = MLPHead(TRUNK_WIDTH, n_classes, dropout=output_dropout)

    def forward(self, spec: torch.Tensor,
                frame_lengths: torch.Tensor) -> torch.Tensor:
        x = spec.to(self.dtype).repeat(1, 1, 1, 3)
        h = self.input_norm(x.permute(0, 3, 1, 2))  # channels_last memory
        h = self.trunk(h)
        feats = masked_max_pool_2d(h, trunk_frames(frame_lengths))
        return at_least_float32(self.head(feats))
