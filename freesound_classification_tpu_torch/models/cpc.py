"""CPC, contrastive predictive coding (JAX ``models/cpc.py``).

Input BatchNorm over the per-frame features (B, T, F) -> causal stride-2
convolutions with PReLU (each left-padded by k - 1 with nothing trimmed,
JAX's reading of the reference, PARITY #12; lengths ``max((l + 1) // 2,
1)``) -> the output BatchNorm, giving z (B, S, D) -> a forward GRU context c
(B, S, C) -> per-step couplings a_k(c), scored against z by the (S, S)
matrix z a_k^T with a binary cross-entropy whose target is the identity
shifted by k (context step t must pick encoder step t + k), averaged over
the pairs of valid steps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from freesound_classification_tpu_torch.models.blocks import (
    BatchNorm,
    Conv1d,
    GRUCell,
    Linear,
    PReLU,
    gru_sequence,
    time_mask,
)


class CausalConv1d(nn.Module):
    """Left-padded strided convolution over (B, C, T): the output at t sees
    inputs up to t only. ``conv`` holds the weights (flax ``enc{k}/conv``)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: int = 3, stride: int = 2):
        super().__init__()
        self.pad = kernel_size - 1
        self.conv = Conv1d(in_channels, features, kernel_size, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (self.pad, 0)))


class CPCModel(nn.Module):
    """``forward(feats (B, T, F), frame_lengths (B,))`` -> {"loss_parts":
    per prediction step its (masked sum, valid pairs), float32, which
    ``blocks.loss_terms`` divides into JAX's ``loss_terms``, "z": (B, S, D)
    float32, "output": the context (B, S, C) float32}. Module names follow
    flax's (``input_bn``, ``enc{k}``, ``prelu{k}``, ``output_bn``,
    ``GRUCell_0``, ``coupling_{s}``)."""

    def __init__(self, input_dim: int, n_encoder_layers: int = 5,
                 conv_base_depth: int = 32, growth_rate: float = 2.0,
                 context_size: int = 256, prediction_steps: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_encoder_layers = n_encoder_layers
        self.prediction_steps = prediction_steps
        self.input_bn = BatchNorm(input_dim)
        c_in = input_dim
        for k in range(n_encoder_layers):
            depth = int(growth_rate**k * conv_base_depth)
            setattr(self, f"enc{k}", CausalConv1d(c_in, depth))
            setattr(self, f"prelu{k}", PReLU(depth))
            c_in = depth
        self.output_bn = BatchNorm(c_in)
        self.GRUCell_0 = GRUCell(c_in, context_size)
        for step in range(1, prediction_steps + 1):
            setattr(self, f"coupling_{step}", Linear(context_size, c_in))

    def forward(self, feats: torch.Tensor,
                frame_lengths: torch.Tensor) -> dict:
        h = self.input_bn(feats.to(self.dtype).transpose(1, 2))  # (B, F, T)
        lengths = frame_lengths
        for k in range(self.n_encoder_layers):
            h = getattr(self, f"prelu{k}")(getattr(self, f"enc{k}")(h))
            lengths = torch.clamp((lengths + 1) // 2, min=1)
        z = self.output_bn(h).transpose(1, 2)  # (B, S, D)
        s = z.shape[1]
        lengths = torch.clamp(lengths, max=s)
        c = gru_sequence(z, self.GRUCell_0)  # (B, S, C)
        valid = time_mask(lengths, s).to(torch.float32)
        pair_mask = valid[:, :, None] * valid[:, None, :]
        pairs = pair_mask.sum()
        loss_parts = []
        for step in range(1, self.prediction_steps + 1):
            a = getattr(self, f"coupling_{step}")(c)  # (B, S, D)
            # score of encoder step s against context step t
            logits = torch.matmul(z, a.transpose(1, 2)).float()
            labels = torch.diag(logits.new_ones(max(s - step, 0)), -step) \
                if s > step else logits.new_zeros(s, s)
            per_elem = (labels * F.softplus(-logits)
                        + (1.0 - labels) * F.softplus(logits))
            loss_parts.append(((per_elem * pair_mask).sum(), pairs))
        return {"loss_parts": loss_parts, "z": z.float(),
                "output": c.float()}
