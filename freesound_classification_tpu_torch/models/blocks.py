"""Building blocks of the 2d CNN, eval mode, NCHW.

Counterparts of ``freesound_classification_tpu/models/blocks.py``. The JAX
package is channels-last; inside the port's model tensors are NCHW (an NHWC
input permuted to NCHW is already in PyTorch's channels_last memory format,
which cuDNN keeps through the convolutions). Parameters stay float32 and are
cast to the activations' dtype at use, as flax does for a ``dtype=bfloat16``
module. BatchNorm is the eval-mode affine with running statistics; training
arrives with ROADMAP slice 2.

``phase_conv_pool_2d`` of the JAX package is an XLA rewrite of conv3x3 +
max-pool that gives the same result, so the port runs ``conv2d`` +
``max_pool2d``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e30
BN_EPS = 1e-5


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(C,) -> broadcastable over dim 1 of ``x``, in ``x``'s dtype."""
    return v.to(x.dtype).view(1, -1, *([1] * (x.dim() - 2)))


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over dim 1 with eps 1e-5: the flax
    ``nn.BatchNorm(use_running_average=True)`` the JAX blocks run at
    inference. The affine is folded in float32, then applied in the input's
    dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        shift = self.bias - self.running_mean * scale
        return x * _per_channel(scale, x) + _per_channel(shift, x)


class PReLU(nn.Module):
    """Per-channel PReLU over dim 1, init 0.25."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 parameters run in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype))


class Linear(nn.Linear):
    """``nn.Linear`` whose float32 parameters run in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class ResnetBlock2d(nn.Module):
    """1x1 -> 3x3 (pad 1) -> 1x1 conv residual block, BN+PReLU after each
    (JAX ``blocks.ResnetBlock2d``)."""

    def __init__(self, depth: int):
        super().__init__()
        self.conv1 = Conv2d(depth, depth, 1)
        self.bn1 = BatchNorm(depth)
        self.prelu1 = PReLU(depth)
        self.conv2 = Conv2d(depth, depth, 3, padding=1)
        self.bn2 = BatchNorm(depth)
        self.prelu2 = PReLU(depth)
        self.conv3 = Conv2d(depth, depth, 1)
        self.bn3 = BatchNorm(depth)
        self.prelu3 = PReLU(depth)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.prelu1(self.bn1(self.conv1(x)))
        h = self.prelu2(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return self.prelu3(h + x)


class ConvBlock2d(nn.Module):
    """BN -> conv3x3 -> max-pool 2x2 -> BN -> PReLU -> ResnetBlock2d
    (JAX ``blocks.ConvBlock2d``). Halves H and W; an axis of size 1 pools
    with window 1, where ``max_pool2d`` with window 2 would raise."""

    def __init__(self, in_channels: int, depth: int):
        super().__init__()
        self.bn_in = BatchNorm(in_channels)
        self.conv = Conv2d(in_channels, depth, 3, padding=1)
        self.bn_out = BatchNorm(depth)
        self.prelu = PReLU(depth)
        self.resnet = ResnetBlock2d(depth)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        window = (2 if x.shape[2] >= 2 else 1, 2 if x.shape[3] >= 2 else 1)
        h = self.conv(self.bn_in(x))
        if window != (1, 1):
            h = F.max_pool2d(h, window)
        h = self.prelu(self.bn_out(h))
        return self.resnet(h)


def time_mask(lengths: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B,) valid frame counts -> (B, n_frames) bool mask."""
    t = torch.arange(n_frames, device=lengths.device)
    return t[None, :] < lengths[:, None]


def mask_time_2d(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero the padded time frames (dim 3) of an NCHW feature map, so bucket
    padding stays the same constant however deep the receptive field."""
    return h * time_mask(lengths, h.shape[3])[:, None, None, :].to(h.dtype)


def masked_max_pool_2d(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Global max over (H, W) of an NCHW map with W (time) masked -> (B, C)."""
    mask = time_mask(lengths, h.shape[3])[:, None, None, :]
    return torch.where(mask, h, NEG_INF).amax(dim=(2, 3))


class MLPHead(nn.Module):
    """BN -> Linear -> BN -> PReLU -> Linear(n_classes) (JAX
    ``blocks.MLPHead``; its dropout is the identity in eval mode)."""

    def __init__(self, width: int, n_classes: int):
        super().__init__()
        self.bn1 = BatchNorm(width)
        self.fc1 = Linear(width, width)
        self.bn2 = BatchNorm(width)
        self.prelu = PReLU(width)
        self.fc2 = Linear(width, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.prelu(self.bn2(self.fc1(self.bn1(x))))
        return self.fc2(h)


def block_depths(num_conv_blocks: int, conv_base_depth: int,
                 growth_rate: float) -> Sequence[int]:
    """Per-stage channel widths: int(growth_rate**k * conv_base_depth)."""
    return [int(growth_rate**k * conv_base_depth)
            for k in range(num_conv_blocks)]
