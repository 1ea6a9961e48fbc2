"""Eval-mode resnet blocks with BatchNorm folded into their convolutions
(JAX ``ops/pallas_resnet1d.py`` and ``ops/pallas_resnet.py``).

At eval time each BatchNorm is a per-channel affine, so the block
conv1x1 -> BN -> PReLU -> conv3 (or 3x3) -> BN -> PReLU -> conv1x1 -> BN ->
+x -> PReLU collapses to three convolutions with folded weights
(``fold_block_params_1d`` / ``fold_block_params``: ``s = scale / sqrt(var +
eps)``, ``w' = w s``, ``b' = (b - mean) s + beta``, in float32, as the JAX
package folds).

``resnet_block_1d_infer`` and ``resnet_block_2d_infer`` route as the JAX
functions do, less the TPU's VMEM fit check (a budget of the TPU compiler;
the kernels' tiles fit a Hopper block's shared memory at every map size):
the fused kernel (K6, or K4/K5 in 2d, ``ops/kernels.py``), which rounds x,
the weights, h1, h2 and y to bf16; or, for a block whose input width is not
its depth or on request, the folded twin (``resnet_block_*_infer_folded``),
which computes in x's dtype. Maps are the port's: (B, C, T) and NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from freesound_classification_tpu_torch.ops import kernels


def _fold(conv: nn.Module, bn: nn.Module, eps: float):
    """conv weight (K, C, *k) -> the JAX layout (*k, C, K), folded."""
    w = conv.weight
    kern = w.permute(*range(2, w.dim()), 1, 0)
    s = bn.weight / torch.sqrt(bn.running_var + eps)
    return kern * s, (conv.bias - bn.running_mean) * s + bn.bias


def _fold_block(block: nn.Module, eps: float) -> dict:
    with torch.no_grad():
        w1, b1 = _fold(block.conv1, block.bn1, eps)
        w2, b2 = _fold(block.conv2, block.bn2, eps)
        w3, b3 = _fold(block.conv3, block.bn3, eps)
        taps = w2.shape[:-2].numel()
        return {"w1": w1.reshape(w1.shape[-2:]),
                "w2": w2.reshape(taps, *w2.shape[-2:]),
                "w3": w3.reshape(w3.shape[-2:]),
                "b1": b1, "b2": b2, "b3": b3,
                "a1": block.prelu1.weight.detach(),
                "a2": block.prelu2.weight.detach(),
                "a3": block.prelu3.weight.detach()}


def fold_block_params_1d(block: nn.Module, eps: float = 1e-5) -> dict:
    """One ``ResnetBlock1d`` folded: w1 (C, K), w2 (3, C, K) tap-major
    (t-1, t, t+1), w3 (K, K), b1-b3 and a1-a3 (K,), float32 (JAX
    ``pallas_resnet1d.fold_block_params_1d``)."""
    return _fold_block(block, eps)


def fold_block_params(block: nn.Module, eps: float = 1e-5) -> dict:
    """One ``ResnetBlock2d`` folded: as ``fold_block_params_1d`` with w2
    (9, C, K), tap 3 dh + dw (JAX ``pallas_resnet.fold_block_params``)."""
    return _fold_block(block, eps)


def fused_weights(block: nn.Module, fold,
                  pack=kernels.pack_resnet_block):
    """``pack(fold(block))``, ``block``'s kernel weights, kept on the block
    until one of its tensors is replaced or changed in place (a new storage
    or a new version counter): an eager forward would otherwise fold and
    pack again on every call, some 35 small launches per block."""
    tensors = [*block.parameters(), *block.buffers()]
    key = tuple((t.data_ptr(), t._version) for t in tensors)
    cached = getattr(block, "_fused_weights_cache", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, pack(fold(block)))
        block._fused_weights_cache = cached
    return cached[1]


def _folded(x: torch.Tensor, fp: dict, conv2) -> torch.Tensor:
    dt = x.dtype
    view = (1, -1) + (1,) * (x.dim() - 2)
    b1, b2, b3 = (fp[k].to(dt).view(view) for k in ("b1", "b2", "b3"))
    a1, a2, a3 = (fp[k].to(dt) for k in ("a1", "a2", "a3"))
    h = F.prelu(kernels.conv1x1(x, fp["w1"].to(dt)) + b1, a1)
    h = F.prelu(conv2(h, fp["w2"].to(dt)) + b2, a2)
    h = kernels.conv1x1(h, fp["w3"].to(dt)) + b3
    return F.prelu(h + x, a3)


def resnet_block_1d_infer_folded(x: torch.Tensor, fp: dict) -> torch.Tensor:
    """Folded twin on (B, C, T), everything in x's dtype (JAX
    ``resnet_block_1d_infer_xla``)."""
    return _folded(x, fp, lambda h, w2: F.conv1d(
        h, w2.permute(2, 1, 0), padding=1))


def resnet_block_2d_infer_folded(x: torch.Tensor, fp: dict) -> torch.Tensor:
    """Folded twin on NCHW, everything in x's dtype (JAX
    ``resnet_block_2d_infer_xla``)."""
    def conv2(h, w2):
        c, k = w2.shape[1:]
        return F.conv2d(h, w2.reshape(3, 3, c, k).permute(3, 2, 0, 1),
                        padding=1)

    return _folded(x, fp, conv2)


def resnet_block_1d_infer(x: torch.Tensor, block: nn.Module,
                          use_kernel: bool = True) -> torch.Tensor:
    """Eval-mode fused ``ResnetBlock1d`` forward, (B, C, T) -> the same
    shape (JAX ``resnet_block_1d_infer``; ``use_kernel`` is its
    ``use_pallas_kernel``). K6 when x's width is the block's depth, else
    the folded twin."""
    if x.shape[1] != block.conv1.weight.shape[0] or not use_kernel:
        return resnet_block_1d_infer_folded(x, fold_block_params_1d(block))
    return kernels.resnet_block_1d_fused(
        x, fused_weights(block, fold_block_params_1d))


def resnet_block_2d_infer(x: torch.Tensor, block: nn.Module,
                          use_kernel: bool | str = False) -> torch.Tensor:
    """Eval-mode fused ``ResnetBlock2d`` forward on NCHW (JAX
    ``resnet_block_2d_infer``; ``use_kernel`` is its ``use_pallas_kernel``).
    True and "v1" (the TPU's two layouts) both run K4/K5; False, or an x
    whose width is not the block's depth, the folded twin."""
    if x.shape[1] != block.conv1.weight.shape[0] or not use_kernel:
        return resnet_block_2d_infer_folded(x, fold_block_params(block))
    return kernels.resnet_block_2d_fused(
        x, fused_weights(block, fold_block_params))
