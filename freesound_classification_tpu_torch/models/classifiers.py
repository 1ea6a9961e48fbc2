"""The classifier families (JAX ``models/classifiers.py``):

- ``TwoDimensionalCNN``: the 2d CNN over log-mel images with the frequency
  encoding channel;
- ``HierarchicalCNN``: the 1d conv tower over per-frame features (log-mel,
  log-STFT or raw samples) with deep supervision;
- ``CNNBackbone`` (``models/backbone.py``): the resnet18/34 trunk over the
  3-channel spectrogram.

Public layouts are the JAX package's: the 2d model takes (B, H=n_features,
W=n_frames, 1), the 1d model (B, T, F), each with per-clip valid frame
counts, and all return (B, n_classes) float32 logits. Inside, tensors are
NCHW and (B, C, T). The two CNNs aggregate each deep-supervised block by a
masked max over time (``aggregation_type="max"``) or by the final states of
a length-aware bidirectional GRU (``"rnn"``, ``blocks.MaskedBiGRU``, named
``rnn{k}`` after block k as in JAX; the 2d model first takes the mean over
frequency). ``fused_infer`` runs the eval-mode resnet blocks through
the fused kernels (K4/K5 in 2d, K6 in 1d, K7 in the backbone) and
``fused_head`` the 2d CNN's block0 head through K8; training and the
weights are the same either way.
"""

from __future__ import annotations

import torch
from torch import nn

from freesound_classification_tpu_torch.models.backbone import CNNBackbone
from freesound_classification_tpu_torch.models.blocks import (
    ConvBlock1d,
    ConvBlock2d,
    MLPHead,
    MaskedBiGRU,
    at_least_float32,
    block_depths,
    mask_time,
    mask_time_2d,
    masked_max_pool_2d,
    masked_max_pool_time,
)


RNN_SIZE = 128  # the GRUs' hidden width (JAX ``classifiers.RNN_SIZE``)


def _check_aggregation(aggregation_type: str) -> None:
    if aggregation_type not in ("max", "rnn"):
        raise ValueError(
            f"unknown aggregation_type {aggregation_type!r}")


def _aggregators(model: nn.Module, aggregation_type: str, depths,
                 start: int) -> int:
    """Give ``model`` an ``rnn{k}`` GRU for every supervised block k where
    the aggregation is "rnn"; returns the head's input width."""
    _check_aggregation(aggregation_type)
    model.aggregation_type = aggregation_type
    if aggregation_type == "max":
        return sum(depths[start:])
    for k in range(start, len(depths)):
        setattr(model, f"rnn{k}", MaskedBiGRU(depths[k], RNN_SIZE))
    return 2 * RNN_SIZE * (len(depths) - start)


def add_frequency_encoding(x: torch.Tensor) -> torch.Tensor:
    """Append a linspace(-1, 1, H) channel broadcast over time.
    x: (B, H, W, C) -> (B, H, W, C + 1)."""
    b, h, w, _ = x.shape
    vertical = torch.linspace(-1.0, 1.0, h, device=x.device).to(x.dtype)
    return torch.cat(
        [x, vertical[None, :, None, None].expand(b, h, w, 1)], dim=-1)


class TwoDimensionalCNN(nn.Module):
    """2d CNN over log-mel images with deep supervision.

    ``dtype`` is the compute dtype (float32, or bfloat16 for ``--bf16``);
    parameters stay float32 and logits come out float32. ``train()`` mode
    takes BatchNorm statistics from the batch and applies the head's
    dropout; ``eval()`` uses the running statistics.
    """

    def __init__(
        self,
        num_conv_blocks: int = 5,
        start_deep_supervision_on: int = 2,
        conv_base_depth: int = 64,
        growth_rate: float = 2.0,
        aggregation_type: str = "max",
        n_classes: int = 80,
        dtype: torch.dtype = torch.float32,
        output_dropout: float = 0.0,
        fused_infer: bool = False,
        fused_head: bool = False,
    ):
        super().__init__()
        self.start_deep_supervision_on = start_deep_supervision_on
        self.dtype = dtype
        depths = block_depths(num_conv_blocks, conv_base_depth, growth_rate)
        # the input carries the spectrogram plus the frequency encoding
        self.blocks = nn.ModuleList(
            ConvBlock2d(c_in, d, fused_infer, fused_head)
            for c_in, d in zip([2, *depths], depths))
        # deep supervision: the aggregated features of every block from
        # start_deep_supervision_on on feed the head
        self.head = MLPHead(
            _aggregators(self, aggregation_type, depths,
                         start_deep_supervision_on),
            n_classes, dropout=output_dropout)

    def forward(self, spec: torch.Tensor,
                frame_lengths: torch.Tensor) -> torch.Tensor:
        x = add_frequency_encoding(spec.to(self.dtype))
        h = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (channels_last in memory)
        lengths = frame_lengths
        features = []
        for k, block in enumerate(self.blocks):
            h = block(h)
            lengths = torch.clamp(lengths // 2, min=1)
            h = mask_time_2d(h, lengths)
            if k < self.start_deep_supervision_on:
                continue
            if self.aggregation_type == "max":
                features.append(masked_max_pool_2d(h, lengths))
            else:
                # mean over frequency -> (B, W, C), then the GRUs
                features.append(getattr(self, f"rnn{k}")(
                    h.mean(dim=2).transpose(1, 2), lengths))
        return at_least_float32(self.head(torch.cat(features, dim=-1)))


class HierarchicalCNN(nn.Module):
    """1d conv tower over per-frame features with deep supervision (JAX
    ``HierarchicalCNN``). ``input_dim`` is F, the
    features per frame (n_mels, n_fft // 2 + 1, or 1 for raw samples);
    ``dtype``, parameters and modes as ``TwoDimensionalCNN``'s."""

    def __init__(
        self,
        input_dim: int,
        num_conv_blocks: int = 5,
        start_deep_supervision_on: int = 2,
        conv_base_depth: int = 64,
        growth_rate: float = 2.0,
        aggregation_type: str = "max",
        n_classes: int = 80,
        dtype: torch.dtype = torch.float32,
        output_dropout: float = 0.0,
        fused_infer: bool = False,
    ):
        super().__init__()
        self.start_deep_supervision_on = start_deep_supervision_on
        self.dtype = dtype
        depths = block_depths(num_conv_blocks, conv_base_depth, growth_rate)
        self.blocks = nn.ModuleList(
            ConvBlock1d(c_in, d, fused_infer)
            for c_in, d in zip([input_dim, *depths], depths))
        self.head = MLPHead(
            _aggregators(self, aggregation_type, depths,
                         start_deep_supervision_on),
            n_classes, dropout=output_dropout)

    def forward(self, feats: torch.Tensor,
                frame_lengths: torch.Tensor) -> torch.Tensor:
        h = feats.to(self.dtype).transpose(1, 2)  # (B, T, F) -> (B, F, T)
        lengths = frame_lengths
        features = []
        for k, block in enumerate(self.blocks):
            h = block(h)
            lengths = torch.clamp(lengths // 2, min=1)
            h = mask_time(h, lengths)
            if k < self.start_deep_supervision_on:
                continue
            if self.aggregation_type == "max":
                features.append(masked_max_pool_time(h, lengths))
            else:
                features.append(getattr(self, f"rnn{k}")(
                    h.transpose(1, 2), lengths))
        return at_least_float32(self.head(torch.cat(features, dim=-1)))


def build_classifier(model_kind: str, network, n_classes: int,
                     dtype: torch.dtype = torch.float32,
                     fused_infer: bool = False,
                     input_dim: int | None = None,
                     fused_head: bool = False) -> nn.Module:
    """The classifier of ``model_kind`` from an experiment's
    ``config.network`` (``utils.config.Config`` or any object with those
    attributes), as the JAX ``build_classifier``. ``input_dim`` (features
    per frame) is needed by the 1d family only; the backbone reads
    ``network.backbone`` (default "resnet18") and ``output_dropout``.
    ``fused_infer`` routes eval-mode resnet blocks through the fused
    kernels, ``fused_head`` the 2d CNN's block0 head through K8 (both
    default off, as in the JAX package)."""
    if model_kind == "backbone_cnn":
        return CNNBackbone(
            arch=str(getattr(network, "backbone", "resnet18")),
            n_classes=n_classes, dtype=dtype,
            output_dropout=float(getattr(network, "output_dropout", 0.0)),
            fused_infer=fused_infer)
    common = dict(
        num_conv_blocks=int(network.num_conv_blocks),
        start_deep_supervision_on=int(network.start_deep_supervision_on),
        conv_base_depth=int(network.conv_base_depth),
        growth_rate=float(network.growth_rate),
        aggregation_type=network.aggregation_type,
        n_classes=n_classes,
        dtype=dtype,
        output_dropout=float(getattr(network, "output_dropout", 0.0)),
        fused_infer=fused_infer,
    )
    if model_kind == "2d_cnn":
        return TwoDimensionalCNN(fused_head=fused_head, **common)
    if model_kind == "hierarchical_cnn":
        if input_dim is None:
            raise ValueError("hierarchical_cnn needs input_dim, the "
                             "features per frame")
        return HierarchicalCNN(int(input_dim), **common)
    raise ValueError(f"unknown model kind {model_kind!r}")
