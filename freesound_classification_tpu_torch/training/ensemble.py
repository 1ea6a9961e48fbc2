"""Fold-ensemble inference: the 5-fold prediction path
(JAX ``training/ensemble.py:EnsemblePredictor``).

The JAX package stacks the fold weights and vmaps one program over them. Here
each batch is featurized once, the K fold models run in a loop over the shared
features, and their sigmoids are averaged; test-time augmentation averages
such passes. On a data-parallel mesh (``parallel/mesh.py``) each rank predicts
its slice of every batch's rows and the ranks gather them.

Spans (``utils/profiling.span``): a batch's host-to-device copy (``h2d``),
its featurization (``predict.frontend``), each fold's forward and sigmoid
(``predict.fold``, ``fold=k``) and the wait for its probabilities on the
host (``predict.readback``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.parallel import mesh as mesh_lib
from freesound_classification_tpu_torch.utils.profiling import span


class EnsemblePredictor:
    """K fold models behind one frontend, on ``device``."""

    def __init__(self, models: Sequence[nn.Module], frontend: Frontend,
                 device: torch.device | str):
        if not models:
            raise ValueError("EnsemblePredictor needs at least one model")
        self.device = torch.device(device)
        self.models = [m.to(self.device).eval() for m in models]
        self.frontend = frontend

    @torch.inference_mode()
    def predict_batch(self, wave, lengths) -> torch.Tensor:
        """(B, L) waveforms + (B,) valid lengths -> (B, C) fold-averaged
        probabilities, float32 on ``device``."""
        wave = torch.as_tensor(wave, device=self.device)
        lengths = torch.as_tensor(lengths, device=self.device)
        with span("predict.frontend"):
            inputs, frame_lengths = self.frontend(wave, lengths)
        probs = []
        for k, m in enumerate(self.models):
            with span("predict.fold", fold=k):
                probs.append(torch.sigmoid(m(inputs, frame_lengths)))
        return torch.stack(probs).mean(dim=0)

    def _predict_rows(self, wave: torch.Tensor, lengths: torch.Tensor,
                      mesh: mesh_lib.Mesh) -> torch.Tensor:
        """``predict_batch`` of a global batch on a mesh: this rank's rows
        (``parallel.mesh.shard_batch``'s: at least one, a repeat of the
        last row where the batch has too few), gathered from every rank in
        rank order, the repeats dropped. Every rank joins one gather a
        batch."""
        n = wave.shape[0]
        rows = torch.as_tensor(mesh_lib.shard_batch(
            {"row": np.arange(n)}, mesh.rank, mesh.world_size)["row"],
            device=self.device)
        with torch.inference_mode():
            probs = self.predict_batch(wave[rows], lengths[rows])
            return mesh_lib.all_gather_rows(probs, mesh.group)[:n]

    def predict_loader(self, loader, tta_fn: Optional[Callable] = None,
                       generator: Optional[torch.Generator] = None,
                       n_tta: int = 1,
                       mesh: Optional[mesh_lib.Mesh] = None) -> np.ndarray:
        """Fold-averaged probabilities over a bucketed loader, with rows put
        back in dataset order by ``batch["index"]`` on every pass, averaged
        over ``n_tta`` passes (JAX ``EnsemblePredictor.predict_loader``).

        Pass 0 is clean; on each later pass ``tta_fn(wave, lengths,
        generator) -> (wave, lengths)`` perturbs each batch once, on the
        device, and the perturbed batch feeds every fold (crop TTA happens
        in the loader itself when it was built with train=True). As in JAX,
        the draws are per pass, not per fold: n_tta draws rather than
        n_folds * n_tta, a divergence from the reference's sequential
        folds.

        On a ``mesh`` with a process group every rank walks the same global
        batches (a loader built without the mesh, so crop TTA draws the
        same crops on every rank), perturbs each one whole with its
        ``generator`` (seeded alike on every rank, so the draws are one
        process's), predicts its slice of the rows and gathers the others'
        (``_predict_rows``): every rank returns one process's
        probabilities."""
        if tta_fn is not None and n_tta > 1 and generator is None:
            raise ValueError(
                "predict_loader: tta_fn with n_tta > 1 needs a "
                "torch.Generator for the perturbation passes")
        if mesh is not None and not mesh.distributed:
            mesh = None
        total = None
        for t in range(max(n_tta, 1)):
            probs_chunks, idx_chunks = [], []
            for batch in loader:
                if mesh is not None and "n_global" in batch:
                    raise ValueError(
                        "predict_loader on a mesh takes the global batches: "
                        "build the loader without the mesh")
                with span("h2d"):
                    wave = torch.as_tensor(batch["signal"],
                                           device=self.device)
                    lengths = torch.as_tensor(batch["lengths"],
                                              device=self.device)
                if tta_fn is not None and t > 0:
                    with torch.inference_mode():
                        wave, lengths = tta_fn(wave, lengths, generator)
                probs = (self.predict_batch(wave, lengths) if mesh is None
                         else self._predict_rows(wave, lengths, mesh))
                with span("predict.readback"):
                    probs_chunks.append(probs.cpu().numpy())
                idx_chunks.append(batch["index"])
            probs = np.concatenate(probs_chunks)
            out = np.zeros_like(probs)
            out[np.concatenate(idx_chunks)] = probs
            total = out if total is None else total + out
        return total / max(n_tta, 1)
