"""The recipe's 2d CNN (``model_kind`` ``2d_cnn``): the log-mel image plus a
linspace(-1, 1) frequency channel; blocks BN -> conv3x3 -> 2x2 max-pool ->
BN -> PReLU -> a 1x1/3x3/1x1 residual block with BN and PReLU after each
conv; padded frames zeroed after every block; each block from
``start_deep_supervision_on`` on max-pooled over its valid frames, and the
MLP head."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.model import bn_spec, conv_spec


def depths(cfg: dict) -> list:
    return [int(cfg["growth_rate"] ** k * cfg["conv_base_depth"])
            for k in range(cfg["num_conv_blocks"])]


def head_width(cfg: dict) -> int:
    return sum(depths(cfg)[cfg["start_deep_supervision_on"]:])


def param_spec(cfg: dict) -> list:
    """(name, shape, kind) of the trunk's parameters and statistics."""
    spec, c_in = [], 2
    for k, d in enumerate(depths(cfg)):
        p = f"blocks.{k}"
        spec += bn_spec(f"{p}.bn_in", c_in) + conv_spec(f"{p}.conv", d, c_in,
                                                        3)
        spec += bn_spec(f"{p}.bn_out", d) + [(f"{p}.prelu.weight", (d,),
                                              "prelu")]
        for j, size in ((1, 1), (2, 3), (3, 1)):
            spec += conv_spec(f"{p}.resnet.conv{j}", d, d, size)
            spec += bn_spec(f"{p}.resnet.bn{j}", d)
            spec += [(f"{p}.resnet.prelu{j}.weight", (d,), "prelu")]
        c_in = d
    return spec


def forward(net, spec: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """(B, M, T) log-mel and (B,) valid frames -> (B, C) logits."""
    cfg = net.cfg
    b, m, t = spec.shape
    freq = torch.linspace(-1.0, 1.0, m, device=spec.device)
    h = net.q(torch.stack([spec, freq[None, :, None].expand(b, m, t)], dim=1))
    lengths, feats = frames, []
    for k in range(cfg["num_conv_blocks"]):
        p = f"blocks.{k}"
        window = (2 if h.shape[2] >= 2 else 1, 2 if h.shape[3] >= 2 else 1)
        h = net.conv(f"{p}.conv", net.bn(f"{p}.bn_in", h), padding=1)
        if window != (1, 1):
            h = F.max_pool2d(h, window)
        x = net.prelu(f"{p}.prelu", net.bn(f"{p}.bn_out", h))
        r = net.prelu(f"{p}.resnet.prelu1", net.bn(
            f"{p}.resnet.bn1", net.conv(f"{p}.resnet.conv1", x)))
        r = net.prelu(f"{p}.resnet.prelu2", net.bn(
            f"{p}.resnet.bn2", net.conv(f"{p}.resnet.conv2", r, padding=1)))
        r = net.bn(f"{p}.resnet.bn3", net.conv(f"{p}.resnet.conv3", r))
        h = net.prelu(f"{p}.resnet.prelu3", net.q(r + x))
        lengths = torch.clamp(lengths // 2, min=1)
        valid = (torch.arange(h.shape[3], device=h.device)[None]
                 < lengths[:, None])[:, None, None, :]
        h = h * valid
        if k >= cfg["start_deep_supervision_on"]:
            feats.append(torch.where(valid, h, -torch.inf).amax(dim=(2, 3)))
    return net.head(torch.cat(feats, dim=1))
