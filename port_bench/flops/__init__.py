"""The models' floating-point operations, counted from the configuration and
the batch shape: every convolution and matrix product, 2 operations a
multiply-add, the backward twice the forward (the input's and the weight's
gradient of every layer). BatchNorm, activations, pooling and the loss are
left out, as they are bound by memory.

Each ``model_kind`` has its file, ``flops/<model_kind>.py``, whose
``trunk(cfg, batch, h, w)`` counts one forward of the trunk over a
(batch, h mel bands, w frames) input; the MLP head is counted here."""

from __future__ import annotations

import functools

from port_bench import spec as spec_lib
from port_bench.reference.frontend import parse_mel
from port_bench.reference.model import head_width


def conv(b: int, h: int, w: int, c_out: int, c_in: int, k: int) -> int:
    """One k x k convolution's operations at an (h, w) output."""
    return 2 * b * h * w * c_out * c_in * k * k


def out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


@functools.lru_cache(maxsize=None)
def _kind(name: str):
    return spec_lib.load_module("flops", name)


def forward(cfg: dict, batch: int, samples: int) -> int:
    """One forward of ``batch`` clips padded to ``samples`` samples."""
    _, hop, n_mels = parse_mel(cfg["features"])
    total = _kind(cfg["model_kind"]).trunk(cfg, batch, n_mels,
                                           samples // hop + 1)
    width = head_width(cfg)
    return total + 2 * batch * width * (width + cfg["n_classes"])


def train_step(cfg: dict, batch: int, samples: int) -> int:
    """Forward and backward of one train step."""
    return 3 * forward(cfg, batch, samples)
