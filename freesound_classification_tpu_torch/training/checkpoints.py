"""Fold checkpoints as ``.npz`` files (JAX ``training/checkpoints.py``).

The JAX package keeps orbax train states; the port saves a model's weights
and BatchNorm statistics in the JAX package's variable layout
(``interop.to_jax_variables``) as the flat ``.npz`` that the predict CLI and
``scripts/export_fold_weights.py`` already share, for either classifier
family. Each file is written durably (``interop.save_fold_npz``: fsynced,
then renamed into place), so a reader never sees half a file and a kill
leaves a complete one. ``load_model`` serves reloading a fold's best model
and the finetune CLI's warm start from another experiment.
``prune_epoch_checkpoints`` keeps the newest periodic
``model_on_epoch_N.npz`` files of a fold. Optimizer state is not saved:
resuming waits (ROADMAP M2.2).
"""

from __future__ import annotations

import os
import re

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


_EPOCH_FILE = re.compile(r"^model_on_epoch_(\d+)\.npz$")


def prune_epoch_checkpoints(fold_dir: str, keep: int) -> None:
    """Keep only the newest ``keep`` periodic ``model_on_epoch_N.npz``
    files in ``fold_dir``; best and final models are never touched, and
    ``keep <= 0`` keeps all (the reference's behaviour)."""
    if keep <= 0:
        return
    found = sorted((int(m.group(1)), name) for name in os.listdir(fold_dir)
                   if (m := _EPOCH_FILE.match(name)))
    for _, name in found[:-keep]:
        os.remove(os.path.join(fold_dir, name))
