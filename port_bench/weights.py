"""Weights from a seed, made on the device in one draw, handed alike to the
port and to the reference.

One ``torch.randn`` of every model's leaves at once on a generator of the
device, then one elementwise rule a leaf: convolution and dense kernels
N(0, 1 / fan_in), biases 0.05 N, BatchNorm scale 1 + 0.1 N and shift 0.1 N,
PReLU slopes 0.25 + 0.05 N, running mean 0 and variance 1.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.model import param_spec

DRAWN = {"w", "bias", "bn_w", "bn_b", "prelu"}


def _leaf(kind: str, z: torch.Tensor, shape: tuple) -> torch.Tensor:
    if kind == "w":
        return z.view(shape) * (math.prod(shape[1:]) ** -0.5)
    if kind == "bias" or kind == "bn_b":
        return z * (0.05 if kind == "bias" else 0.1)
    if kind == "bn_w":
        return 1.0 + 0.1 * z
    if kind == "prelu":
        return 0.25 + 0.05 * z
    raise ValueError(kind)


def make(cfg: dict, seed: int, device, n_models: int = 1) -> list:
    """``n_models`` float32 state dicts of ``cfg``'s model."""
    spec = param_spec(cfg)
    sizes = [math.prod(shape) for _, shape, kind in spec if kind in DRAWN]
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(n_models, sum(sizes), generator=gen, device=device)
    models = []
    for m in range(n_models):
        parts = iter(torch.split(z[m], sizes))
        state = {}
        for name, shape, kind in spec:
            if kind in DRAWN:
                state[name] = _leaf(kind, next(parts), shape).contiguous()
            else:
                fill = 0.0 if kind == "bn_mean" else 1.0
                state[name] = torch.full(shape, fill, device=device)
        models.append(state)
    return models
