"""The 2d CNN's eval-mode block0 head in one pass (JAX
``ops/pallas_head.py``): bn_in -> conv3x3 (SAME) -> 2x2 max-pool -> bn_out
-> PReLU, so the full-resolution conv map is never written.

``fold_head_params`` keeps bn_in as an affine on the input: folding it into
the conv weights would change the SAME padding, which pads bn_in's output
with zeros. The conv bias and bn_out become one affine after the pool (a
per-channel constant commutes with the max). ``conv_block_2d_head_infer``
runs K8 (``kernels.conv_head_fused``), whose output is bf16 values, cast to
the block's dtype: a float32 model with ``fused_head`` gets a bf16-rounded
head, as the JAX package's does.
"""

from __future__ import annotations

import torch
from torch import nn

from freesound_classification_tpu_torch.ops import kernels, resnet_infer


def fold_head_params(block: nn.Module, eps: float = 1e-5) -> dict:
    """A ``ConvBlock2d``'s head folded: s_in, t_in (C_in,), kern (3, 3,
    C_in, depth), scale, bias, alpha (depth,), float32 (JAX
    ``pallas_head.fold_head_params``)."""
    with torch.no_grad():
        bn_in, bn_out = block.bn_in, block.bn_out
        s_in = bn_in.weight / torch.sqrt(bn_in.running_var + eps)
        s_out = bn_out.weight / torch.sqrt(bn_out.running_var + eps)
        return {
            "s_in": s_in, "t_in": bn_in.bias - bn_in.running_mean * s_in,
            "kern": block.conv.weight.detach().permute(2, 3, 1, 0),
            "scale": s_out,
            "bias": (block.conv.bias - bn_out.running_mean) * s_out
            + bn_out.bias,
            "alpha": block.prelu.weight.detach(),
        }


def head_supported(shape, depth: int) -> bool:
    """Whether K8 takes an NCHW input of ``shape`` into ``depth`` channels
    (JAX ``pallas_head.head_supported`` less its VMEM clause)."""
    if len(shape) != 4:
        return False
    _, c, h, w = shape
    return (1 <= c <= kernels.HEAD_MAX_IN and h >= 2 and w >= 2
            and depth % 16 == 0 and 16 <= depth <= 128)


def conv_block_2d_head_infer(x: torch.Tensor,
                             block: nn.Module) -> torch.Tensor:
    """The head of ``block`` on NCHW x -> (B, depth, H // 2, W // 2) in x's
    dtype, through K8 (JAX ``pallas_head.conv_block_2d_head_infer``)."""
    wts = resnet_infer.fused_weights(block, fold_head_params,
                                     kernels.pack_conv_head)
    return kernels.conv_head_fused(x, wts).to(x.dtype)
