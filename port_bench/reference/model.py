"""The classifiers as plain functions of a parameter dict, float32.

Each ``model_kind`` of a configuration has its file,
``reference/models/<model_kind>.py``, with ``param_spec(cfg)`` (the
trunk's parameters), ``head_width(cfg)`` and ``forward(net, spec, frames)``
(the logits, built from ``Net``'s layers). What the kinds share is here:
the MLP head BN -> Linear -> BN -> PReLU -> dropout -> Linear, BatchNorm,
the convolutions, the loss and ``Quant``.

BatchNorm takes the batch's statistics in train mode (biased variance, eps
1e-5) and its running ones in eval mode. Parameter names are those of the
port's checkpoints, so one weight draw (``port_bench.weights``) serves both.
``Quant`` rounds every value that the port's bf16 model keeps in bf16 (the
input, each convolution's and matrix product's operands and result, each
BatchNorm's, activation's and residual sum's output) and the gradients
that flow back through them to a narrower type: the control.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from port_bench import spec as spec_lib

BN_EPS = 1e-5


@functools.lru_cache(maxsize=None)
def _kind(name: str):
    return spec_lib.load_module("reference/models", name)


def kind(cfg: dict):
    """The module of ``cfg``'s ``model_kind``."""
    return _kind(cfg["model_kind"])


def head_width(cfg: dict) -> int:
    return kind(cfg).head_width(cfg)


def bn_spec(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), "bn_w"), (f"{name}.bias", (c,), "bn_b"),
            (f"{name}.running_mean", (c,), "bn_mean"),
            (f"{name}.running_var", (c,), "bn_var")]


def conv_spec(name: str, c_out: int, c_in: int, k: int, bias: bool = True
              ) -> list:
    out = [(f"{name}.weight", (c_out, c_in, k, k), "w")]
    return out + ([(f"{name}.bias", (c_out,), "bias")] if bias else [])


def _head(width: int, n_classes: int) -> list:
    return (bn_spec("head.bn1", width)
            + [("head.fc1.weight", (width, width), "w"),
               ("head.fc1.bias", (width,), "bias")]
            + bn_spec("head.bn2", width)
            + [("head.prelu.weight", (width,), "prelu"),
               ("head.fc2.weight", (n_classes, width), "w"),
               ("head.fc2.bias", (n_classes,), "bias")])


def param_spec(cfg: dict) -> list:
    """(name, shape, kind) of every parameter and BatchNorm statistic."""
    return kind(cfg).param_spec(cfg) + _head(head_width(cfg),
                                             cfg["n_classes"])


class _RoundTrip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x through ``dtype`` and back, scaled per tensor into its range
    (int8: symmetric, 127 steps to the largest magnitude)."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    if dtype == torch.int8:
        step = amax / 127.0
        return (torch.round(x.float() / step) * step).to(x.dtype)
    scale = torch.finfo(dtype).max / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class Quant:
    """Values through ``fwd`` (and their gradients through ``bwd``); None
    leaves them in float32."""

    def __init__(self, fwd: Optional[torch.dtype] = None,
                 bwd: Optional[torch.dtype] = None):
        self.fwd, self.bwd = fwd, bwd or fwd

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.fwd is None:
            return x
        return _RoundTrip.apply(x, self.fwd, self.bwd)


FP32 = Quant()
FP8 = Quant(torch.float8_e4m3fn, torch.float8_e5m2)
INT8 = Quant(torch.int8)


class Net:
    """The forward of ``cfg``'s model over a parameter dict ``p``. In
    ``train`` mode BatchNorm takes batch statistics and the head's dropout
    multiplies by ``dropout_mask`` ((B, width) of 0 and 1 / (1 - p));
    ``calibrate`` (eval) sets every BatchNorm's running statistics to those
    of the batch on the way."""

    def __init__(self, cfg: dict, p: dict, train: bool, q: Quant = FP32,
                 dropout_mask: Optional[torch.Tensor] = None,
                 calibrate: bool = False):
        self.cfg, self.p, self.train, self.q = cfg, p, train, q
        self.mask, self.calibrate = dropout_mask, calibrate

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        p = self.p
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.train or self.calibrate:
            dims = [d for d in range(x.dim()) if d != 1]
            mean = x.mean(dim=dims)
            var = x.var(dim=dims, unbiased=False)
            if self.calibrate:
                p[f"{name}.running_mean"] = mean.detach().clone()
                p[f"{name}.running_var"] = var.detach().clone()
        else:
            mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        scale = p[f"{name}.weight"] * torch.rsqrt(var + BN_EPS)
        return self.q((x - mean.view(shape)) * scale.view(shape)
                      + p[f"{name}.bias"].view(shape))

    def conv(self, name: str, x: torch.Tensor, **kw) -> torch.Tensor:
        return self.q(F.conv2d(self.q(x), self.q(self.p[f"{name}.weight"]),
                               self.p.get(f"{name}.bias"), **kw))

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.q(F.linear(self.q(x), self.q(self.p[f"{name}.weight"]),
                               self.p[f"{name}.bias"]))

    def prelu(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.q(F.prelu(x, self.p[f"{name}.weight"]))

    def head(self, feats: torch.Tensor) -> torch.Tensor:
        h = self.prelu("head.prelu", self.bn(
            "head.bn2", self.linear("head.fc1", self.bn("head.bn1", feats))))
        if self.train and self.mask is not None:
            h = h * self.mask
        return self.linear("head.fc2", h)

    def __call__(self, spec: torch.Tensor, frames: torch.Tensor
                 ) -> torch.Tensor:
        """(B, M, T) log-mel and (B,) valid frames -> (B, C) logits."""
        return kind(self.cfg).forward(self, spec, frames)


def lsep(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row LSEP, log(1 + sum over (positive i, negative j) of
    exp(s_j - s_i))."""
    pairs = (labels[:, :, None] > labels[:, None, :]).float()
    diff = logits[:, None, :] - logits[:, :, None]
    return torch.log1p((torch.exp(diff) * pairs).sum(dim=(1, 2)))


LOSSES: dict = {"lsep_naive": lsep}


def loss_fn(name: str) -> Callable:
    if name not in LOSSES:
        raise ValueError(f"the reference has no loss {name!r}")
    return LOSSES[name]
