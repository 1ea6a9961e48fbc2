"""Building blocks of the 2d and the 1d CNN, NCHW and (B, C, T), in eval and
train mode.

Counterparts of ``freesound_classification_tpu/models/blocks.py``. The JAX
package is channels-last; inside the port's models tensors are NCHW (an NHWC
input permuted to NCHW is already in PyTorch's channels_last memory format,
which cuDNN keeps through the convolutions) and (B, C, T) for ``nn.Conv1d``.
``fused_infer=True`` runs eval-mode resnet blocks through the folded, fused
kernels (``ops/resnet_infer.py``: K6 in 1d, K4/K5 in 2d), and
``fused_head=True`` the 2d block0 head through K8 (``ops/head_infer.py``);
training, init and the checkpoint layout are the same either way. Parameters stay float32 and are
cast to the activations' dtype at use, as flax does for a ``dtype=bfloat16``
module. BatchNorm follows flax's: batch statistics in float32 when training,
and running statistics updated with the biased batch variance.

``phase_conv_pool_2d``/``_1d`` of the JAX package are XLA rewrites of conv3 +
max-pool that give the same result, so the port runs the convolution and
the max-pool.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from freesound_classification_tpu_torch.ops import head_infer, resnet_infer

NEG_INF = -1e30
BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(C,) -> broadcastable over dim 1 of ``x``, in ``x``'s dtype."""
    return v.to(x.dtype).view(1, -1, *([1] * (x.dim() - 2)))


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with eps 1e-5: flax's ``nn.BatchNorm(momentum=
    0.9)`` as the JAX blocks use it.

    Eval: the affine of the running statistics, folded in float32 and
    applied in the input's dtype. Train: the batch mean and variance over
    every dim but 1, in float32 for any input dtype, with flax's fast
    variance ``max(E[x^2] - E[x]^2, 0)``; the output is computed in float32
    and cast back. The running statistics move by 0.1 towards the batch's,
    with the *biased* variance as flax does; ``F.batch_norm`` would use the
    unbiased one (n/(n-1) times larger, 20/19 for the head's 20 rows).
    """

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            scale = self.weight * torch.rsqrt(self.running_var + BN_EPS)
            shift = self.bias - self.running_mean * scale
            return x * _per_channel(scale, x) + _per_channel(shift, x)
        xf = x.float()
        dims = [d for d in range(x.dim()) if d != 1]
        mean = xf.mean(dim=dims)
        var = torch.clamp(
            (xf * xf).mean(dim=dims) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(
                mean.detach(), alpha=1.0 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(
                var.detach(), alpha=1.0 - BN_MOMENTUM)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - _per_channel(mean, xf)) * _per_channel(mul, xf)
        return (y + _per_channel(self.bias, xf)).to(x.dtype)


class PReLU(nn.Module):
    """Per-channel PReLU over dim 1, init 0.25."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` whose float32 parameters run in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 parameters run in the input's dtype; with
    ``bias=False`` (the backbone's convolutions) there is no bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """``nn.Linear`` whose float32 parameters run in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class _ResnetBlock(nn.Module):
    """1x1 -> 3 (pad 1) -> 1x1 conv residual block, BN+PReLU after each."""

    conv = Conv2d

    def __init__(self, depth: int, fused_infer: bool = False):
        super().__init__()
        self.fused_infer = fused_infer
        self.conv1 = self.conv(depth, depth, 1)
        self.bn1 = BatchNorm(depth)
        self.prelu1 = PReLU(depth)
        self.conv2 = self.conv(depth, depth, 3, padding=1)
        self.bn2 = BatchNorm(depth)
        self.prelu2 = PReLU(depth)
        self.conv3 = self.conv(depth, depth, 1)
        self.bn3 = BatchNorm(depth)
        self.prelu3 = PReLU(depth)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.prelu1(self.bn1(self.conv1(x)))
        h = self.prelu2(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return self.prelu3(h + x)


class ResnetBlock1d(_ResnetBlock):
    """The block over (B, C, T) (JAX ``blocks.ResnetBlock1d``). With
    ``fused_infer``, eval-mode forwards run K6."""

    conv = Conv1d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_infer and not self.training:
            return resnet_infer.resnet_block_1d_infer(x, self)
        return super().forward(x)


class ResnetBlock2d(_ResnetBlock):
    """The block over NCHW (JAX ``blocks.ResnetBlock2d``). With
    ``fused_infer``, eval-mode forwards run K4/K5, as the JAX block routes
    to its transposed-layout kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_infer and not self.training:
            return resnet_infer.resnet_block_2d_infer(x, self, use_kernel=True)
        return super().forward(x)


class ConvBlock1d(nn.Module):
    """BN -> conv3 (pad 1) -> max-pool 2 -> BN -> PReLU -> ResnetBlock1d
    (JAX ``blocks.ConvBlock1d``). Halves T; a time axis of size 1 pools with
    window 1, where ``max_pool1d`` with window 2 would raise. With
    ``fused_infer``, eval-mode forwards keep the map's channels contiguous
    for K6."""

    def __init__(self, in_channels: int, depth: int,
                 fused_infer: bool = False):
        super().__init__()
        self.bn_in = BatchNorm(in_channels)
        self.conv = Conv1d(in_channels, depth, 3, padding=1)
        self.bn_out = BatchNorm(depth)
        self.prelu = PReLU(depth)
        self.resnet = ResnetBlock1d(depth, fused_infer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.resnet.fused_infer and not self.training:
            h = self._head_channels_contiguous(self.bn_in(x))
        else:
            h = self.conv(self.bn_in(x))
            if x.shape[2] >= 2:
                h = F.max_pool1d(h, 2)
        h = self.prelu(self.bn_out(h))
        return self.resnet(h)

    def _head_channels_contiguous(self, x: torch.Tensor) -> torch.Tensor:
        """conv and pool over (B, C, 1, T) in channels_last memory: the map
        K6 is handed keeps its channels contiguous (the JAX package's
        (B, T, C)), which K6 reads in place, where ``conv1d`` would make its
        input contiguous and return a time-major map that K6 copies."""
        x4 = x.unsqueeze(2).contiguous(memory_format=torch.channels_last)
        h = F.conv2d(x4, self.conv.weight.to(x.dtype).unsqueeze(2),
                     self.conv.bias.to(x.dtype), padding=(0, 1))
        if x.shape[2] >= 2:
            h = F.max_pool2d(h, (1, 2))
        return h.squeeze(2)


class ConvBlock2d(nn.Module):
    """BN -> conv3x3 -> max-pool 2x2 -> BN -> PReLU -> ResnetBlock2d
    (JAX ``blocks.ConvBlock2d``). Halves H and W; an axis of size 1 pools
    with window 1, where ``max_pool2d`` with window 2 would raise.

    With ``fused_head``, an eval-mode forward over a map of at least 2 x 2
    that ``head_infer.head_supported`` accepts (block0's 2-channel input)
    runs the head, BN -> conv -> pool -> BN -> PReLU, through K8, whose
    output is bf16 values in x's dtype (the model's); then the resnet
    block."""

    def __init__(self, in_channels: int, depth: int,
                 fused_infer: bool = False, fused_head: bool = False):
        super().__init__()
        self.fused_head = fused_head
        self.bn_in = BatchNorm(in_channels)
        self.conv = Conv2d(in_channels, depth, 3, padding=1)
        self.bn_out = BatchNorm(depth)
        self.prelu = PReLU(depth)
        self.resnet = ResnetBlock2d(depth, fused_infer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.fused_head and not self.training
                and head_infer.head_supported(x.shape,
                                              self.conv.out_channels)):
            return self.resnet(
                head_infer.conv_block_2d_head_infer(x, self))
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


def mask_time(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero the padded time frames (dim 2) of a (B, C, T) map, so bucket
    padding stays the zero of the convolutions' own padding however deep
    the receptive field."""
    return h * time_mask(lengths, h.shape[2])[:, None, :].to(h.dtype)


def masked_max_pool_time(h: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Global max over the valid frames of a (B, C, T) map -> (B, C)."""
    mask = time_mask(lengths, h.shape[2])[:, None, :]
    return torch.where(mask, h, NEG_INF).amax(dim=2)


def mask_time_2d(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero the padded time frames (dim 3) of an NCHW feature map, so bucket
    padding stays the same constant however deep the receptive field."""
    return h * time_mask(lengths, h.shape[3])[:, None, None, :].to(h.dtype)


def masked_max_pool_2d(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Global max over (H, W) of an NCHW map with W (time) masked -> (B, C)."""
    mask = time_mask(lengths, h.shape[3])[:, None, None, :]
    return torch.where(mask, h, NEG_INF).amax(dim=(2, 3))


class MLPHead(nn.Module):
    """BN -> Linear -> BN -> PReLU -> Dropout -> Linear(n_classes) (JAX
    ``blocks.MLPHead``). Dropout zeroes with probability ``dropout`` and
    scales the kept values by 1/(1 - dropout) in train mode, as flax's."""

    def __init__(self, width: int, n_classes: int, dropout: float = 0.0):
        super().__init__()
        self.bn1 = BatchNorm(width)
        self.fc1 = Linear(width, width)
        self.bn2 = BatchNorm(width)
        self.prelu = PReLU(width)
        self.dropout = dropout
        self.fc2 = Linear(width, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.prelu(self.bn2(self.fc1(self.bn1(x))))
        h = F.dropout(h, self.dropout, training=self.training)
        return self.fc2(h)


def block_depths(num_conv_blocks: int, conv_base_depth: int,
                 growth_rate: float) -> Sequence[int]:
    """Per-stage channel widths: int(growth_rate**k * conv_base_depth)."""
    return [int(growth_rate**k * conv_base_depth)
            for k in range(num_conv_blocks)]


def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize ``model`` in place as flax initializes the JAX model:
    conv and dense kernels LeCun-normal (normal truncated at 2 std, scaled
    to variance 1/fan_in), biases 0, BatchNorm scale 1 / bias 0 / mean 0 /
    var 1, PReLU 0.25. The draws come from ``generator``."""
    # std of a unit normal truncated to [-2, 2], which flax divides out
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                w = module.weight
                fan_in = w[0].numel()
                std = fan_in ** -0.5 / trunc_std
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
            elif isinstance(module, PReLU):
                module.weight.fill_(0.25)
