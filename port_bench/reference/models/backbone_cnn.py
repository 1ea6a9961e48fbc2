"""The backbone classifier (``model_kind`` ``backbone_cnn``) with a ResNet
trunk of BasicBlocks (He et al. 2015, Table 1; ``stages`` and ``widths``
from the configuration, (3, 4, 6, 3) at 64/128/256/512 for ResNet-34): the
spectrogram repeated to 3 channels and batch-normed, conv7x7/2 -> BN ->
ReLU -> max-pool 3/2, the stages, the valid frames after five halvings
max-pooled, and the MLP head."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.model import bn_spec, conv_spec


def blocks(cfg: dict) -> list:
    """(name, in channels, out channels, stride) of every BasicBlock."""
    out, c_in = [], cfg["widths"][0]
    for stage, (n, c) in enumerate(zip(cfg["stages"], cfg["widths"])):
        for b in range(n):
            out.append((f"trunk.stage{stage}_block{b}", c_in, c,
                        2 if stage > 0 and b == 0 else 1))
            c_in = c
    return out


def head_width(cfg: dict) -> int:
    return cfg["widths"][-1]


def param_spec(cfg: dict) -> list:
    """(name, shape, kind) of the trunk's parameters and statistics."""
    stem = cfg["widths"][0]
    spec = bn_spec("input_norm", 3) + conv_spec("trunk.conv1", stem, 3, 7,
                                                False)
    spec += bn_spec("trunk.bn1", stem)
    for name, c_in, c, stride in blocks(cfg):
        spec += conv_spec(f"{name}.conv1", c, c_in, 3, False)
        spec += bn_spec(f"{name}.bn1", c)
        spec += conv_spec(f"{name}.conv2", c, c, 3, False)
        spec += bn_spec(f"{name}.bn2", c)
        if c_in != c or stride != 1:
            spec += conv_spec(f"{name}.downsample", c, c_in, 1, False)
            spec += bn_spec(f"{name}.downsample_bn", c)
    return spec


def forward(net, spec: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """(B, M, T) log-mel and (B,) valid frames -> (B, C) logits."""
    x = net.bn("input_norm", net.q(spec[:, None].expand(-1, 3, -1, -1)))
    h = F.relu(net.bn("trunk.bn1", net.conv("trunk.conv1", x, stride=2,
                                            padding=3)))
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    for name, c_in, c, stride in blocks(net.cfg):
        r = F.relu(net.bn(f"{name}.bn1", net.conv(
            f"{name}.conv1", h, stride=stride, padding=1)))
        r = net.bn(f"{name}.bn2", net.conv(f"{name}.conv2", r, padding=1))
        if c_in != c or stride != 1:
            h = net.bn(f"{name}.downsample_bn", net.conv(
                f"{name}.downsample", h, stride=stride))
        h = F.relu(net.q(r + h))
    lengths = frames
    for _ in range(1 + len(net.cfg["stages"])):  # conv1, the max-pool and
        # every stage after the first halve time
        lengths = (lengths + 1) // 2
    lengths = torch.clamp(lengths, min=1)
    valid = (torch.arange(h.shape[3], device=h.device)[None]
             < lengths[:, None])[:, None, None, :]
    return net.head(torch.where(valid, h, -torch.inf).amax(dim=(2, 3)))
