"""Fold checkpoints as ``.npz`` files (JAX ``training/checkpoints.py``).

The JAX package keeps orbax train states; the port saves a model's weights
and BatchNorm statistics in the JAX package's variable layout
(``interop.to_jax_variables``) as the flat ``.npz`` that the predict CLI and
``scripts/export_fold_weights.py`` already share, for either classifier
family. Each file is written durably (``interop.save_fold_npz``: fsynced,
then renamed into place), so a reader never sees half a file and a kill
leaves a complete one. ``load_model`` serves reloading a fold's best model
and the finetune CLI's warm start from another experiment.
Optimizer state is not saved: resuming waits (ROADMAP).
"""

from __future__ import annotations

import os

from torch import nn

from freesound_classification_tpu_torch import interop


def save_model(path: str, model: nn.Module) -> None:
    """Write ``model``'s variables to ``path`` durably."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    params, stats = interop.to_jax_variables(model.state_dict())
    interop.save_fold_npz(path, params, stats)


def load_model(path: str, model: nn.Module) -> None:
    """Load a ``save_model`` file into ``model`` in place."""
    sd = interop.from_jax_variables(*interop.load_fold_npz(path))
    model.load_state_dict(sd)
