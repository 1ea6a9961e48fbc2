"""A fresh model for training (JAX ``training/state.py``).

The JAX package bundles params, batch statistics, optimizer state, step and
PRNG key into one train state. In the port the ``Engine`` holds the model
(parameters and BatchNorm buffers), the optimizer, the step count and a
``torch.Generator``; this module makes the model, initialized from a seed
as flax initializes the JAX model.
"""

from __future__ import annotations

import torch

from freesound_classification_tpu_torch.models.blocks import init_like_flax
from freesound_classification_tpu_torch.models.classifiers import (
    TwoDimensionalCNN,
    build_classifier,
)


def create_model(network, n_classes: int, dtype: torch.dtype, seed: int,
                 device: torch.device) -> TwoDimensionalCNN:
    """The 2d CNN of ``network`` (an experiment's ``config.network``) on
    ``device``, with flax's initializers drawn from ``seed``."""
    model = build_classifier(network, n_classes, dtype=dtype)
    init_like_flax(model, torch.Generator().manual_seed(seed))
    return model.to(device)
