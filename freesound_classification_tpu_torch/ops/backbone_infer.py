"""The backbone's eval-mode BasicBlock with BatchNorm folded into its
convolutions (JAX ``ops/pallas_backbone.py``).

At eval time both BatchNorms of a block are per-channel affines, so
conv3x3 -> BN -> relu -> conv3x3 -> BN -> +shortcut -> relu collapses to two
bias-free convolutions with folded weights (``fold_basic_params``: ``s =
scale / sqrt(var + eps)``, ``w' = w s``, ``b' = beta - mean s``, in float32,
as the JAX package folds), and the projection shortcut likewise.

``basic_block_infer`` routes as the JAX function does, less the TPU's VMEM
fit check (a budget of the TPU compiler; K7's tiles fit a Hopper block's
shared memory at every map size): a stride-1 block whose input width is its
width and that has no projection runs K7 (``kernels.basic_block_fused``),
which rounds x, the weights, h1 and y to bf16; every other block runs the
folded twin (``basic_block_infer_folded``) in x's dtype. Maps are NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from freesound_classification_tpu_torch.ops import kernels, resnet_infer


def _fold(conv: nn.Module, bn: nn.Module, eps: float):
    """A bias-free conv weight (K, C, kh, kw) -> the JAX layout (kh, kw,
    C, K), folded with its BatchNorm."""
    s = bn.weight / torch.sqrt(bn.running_var + eps)
    return conv.weight.permute(2, 3, 1, 0) * s, bn.bias - bn.running_mean * s


def fold_basic_params(block: nn.Module, eps: float = 1e-5) -> dict:
    """One ``BasicBlock`` folded: w1 (3, 3, C, K), w2 (3, 3, K, K), b1, b2
    (K,), and for a projection shortcut wd (C, K) and bd (K,), float32
    (JAX ``pallas_backbone.fold_basic_params``)."""
    with torch.no_grad():
        w1, b1 = _fold(block.conv1, block.bn1, eps)
        w2, b2 = _fold(block.conv2, block.bn2, eps)
        fp = {"w1": w1, "b1": b1, "w2": w2, "b2": b2}
        if block.downsample is not None:
            wd, bd = _fold(block.downsample, block.downsample_bn, eps)
            fp["wd"], fp["bd"] = wd[0, 0], bd
    return fp


def basic_block_infer_folded(x: torch.Tensor, fp: dict,
                             strides: int = 1) -> torch.Tensor:
    """The folded twin on NCHW, everything in x's dtype (JAX
    ``basic_block_infer_xla``)."""
    dt = x.dtype

    def bias(v):
        return v.to(dt).view(1, -1, 1, 1)

    def conv3x3(h, w, stride):
        return F.conv2d(h, w.permute(3, 2, 0, 1).to(dt), stride=stride,
                        padding=1)

    h = F.relu(conv3x3(x, fp["w1"], strides) + bias(fp["b1"]))
    h = conv3x3(h, fp["w2"], 1) + bias(fp["b2"])
    if "wd" in fp:
        res = kernels.conv1x1(x[:, :, ::strides, ::strides],
                              fp["wd"].to(dt)) + bias(fp["bd"])
    else:
        res = x
    return F.relu(h + res)


def basic_block_infer(x: torch.Tensor, block: nn.Module,
                      strides: int = 1) -> torch.Tensor:
    """Eval-mode fused ``BasicBlock`` forward on NCHW (JAX
    ``basic_block_infer``): K7 for a stride-1 block with x's width equal to
    its own and no projection, else the folded twin."""
    if (strides != 1 or block.downsample is not None
            or x.shape[1] != block.conv1.weight.shape[0]):
        return basic_block_infer_folded(x, fold_basic_params(block), strides)
    return kernels.basic_block_fused(x, resnet_infer.fused_weights(
        block, fold_basic_params, kernels.pack_basic_block))
