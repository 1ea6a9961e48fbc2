"""Fold checkpoints (JAX ``training/checkpoints.py``).

The JAX package keeps orbax train states. The port saves a model's weights
and BatchNorm statistics in the JAX package's variable layout
(``interop.to_jax_variables``) as the flat ``.npz`` that the predict CLI and
``scripts/export_fold_weights.py`` already share, for either classifier
family: ``best_model.npz``, ``final_model.npz`` and ``model_on_epoch_N.npz``.
``load_model`` serves reloading a fold's best model and the finetune CLI's
warm start from another experiment. ``prune_epoch_checkpoints`` keeps the
newest periodic ``model_on_epoch_N.npz`` files of a fold.

A fold's resume point is one file, ``last_model.pt`` (the port's own
format, not read by the JAX package): the engine's whole train state and
its progress metadata in one ``torch.save`` dict, so both become visible in
one rename. JAX's bundle (``save_resume_bundle``) swaps a directory for the
same guarantee because orbax writes directories.

Every file is written durably (``interop.write_durably``: fsynced, renamed
into place, the directory fsynced), so a reader never sees half a file and
a kill leaves the previous file or the new one.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
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


def save_bundle(path: str, bundle: dict) -> None:
    """Write a resume bundle (tensors, numbers, strings, lists and dicts of
    them) to ``path`` durably, in one atomic step."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    interop.write_durably(path, lambda f: torch.save(bundle, f))


def load_bundle(path: str) -> Optional[dict]:
    """The bundle at ``path`` with its tensors on the CPU, or None where
    there is none. Only the types ``save_bundle`` writes are unpickled."""
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


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
