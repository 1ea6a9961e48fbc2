"""A fresh model for training (JAX ``training/state.py``).

The JAX package bundles params, batch statistics, optimizer state, step and
PRNG key into one train state. In the port the ``Engine`` holds the model
(parameters and BatchNorm buffers), the optimizer, the step count and a
``torch.Generator``; this module makes the model, initialized from a seed
as flax initializes the JAX model.
"""

from __future__ import annotations

import torch
from torch import nn

from freesound_classification_tpu_torch.models.blocks import init_like_flax
from freesound_classification_tpu_torch.models.classifiers import (
    build_classifier,
)


def create_model(network, n_classes: int, dtype: torch.dtype, seed: int,
                 device: torch.device, model_kind: str = "2d_cnn",
                 input_dim: int | None = None) -> nn.Module:
    """The ``model_kind`` classifier of ``network`` (an experiment's
    ``config.network``; ``input_dim`` features per frame for the 1d
    family) on ``device``, with flax's initializers drawn from ``seed``."""
    model = build_classifier(model_kind, network, n_classes, dtype=dtype,
                             input_dim=input_dim)
    init_like_flax(model, torch.Generator().manual_seed(seed))
    return model.to(device)
