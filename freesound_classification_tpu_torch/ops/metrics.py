"""lwlrap, label-weighted label-ranking average precision (JAX
``ops/metrics.py``).

- ``lwlrap``: numpy, over a whole set, with sklearn's >= tie handling;
  samples with no positive label are skipped.
- ``lwlrap_torch``: the in-step version over one (B, C) batch, on the
  batch's device; ``row_mask`` drops padded rows.

With per-sample weight = number of labels, the weighted mean of per-sample
LRAP is the sum over (sample, true label) of precision at its rank divided by
the total label count; both versions use that form.
"""

from __future__ import annotations

import numpy as np
import torch


def _sample_terms_np(truth_row: np.ndarray, scores_row: np.ndarray) -> float:
    """Sum over true labels of (#true with score >= s) / (#all with
    score >= s)."""
    true_idx = np.flatnonzero(truth_row)
    if true_idx.size == 0:
        return 0.0
    s_true = scores_row[true_idx]
    ranks = (scores_row[None, :] >= s_true[:, None]).sum(axis=1)
    hits = (s_true[None, :] >= s_true[:, None]).sum(axis=1)
    return float(np.sum(hits / ranks))


def lwlrap(truth: np.ndarray, scores: np.ndarray) -> float:
    """Label-weighted LRAP over a set (numpy)."""
    pos = np.asarray(truth) > 0
    scores = np.asarray(scores)
    n_labels = pos.sum(axis=1)
    keep = n_labels > 0
    if not np.any(keep):
        return 0.0
    total = sum(_sample_terms_np(t, s) for t, s in zip(pos[keep],
                                                      scores[keep]))
    return total / float(n_labels[keep].sum())


def lwlrap_torch(truth: torch.Tensor, scores: torch.Tensor,
                 row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """lwlrap of a (B, C) batch as a 0-d tensor, C^2 pairwise per row."""
    pos = (truth > 0).to(scores.dtype)
    if row_mask is not None:
        pos = pos * row_mask.to(scores.dtype)[:, None]
    # ge[b, i, j] = scores[b, j] >= scores[b, i]
    ge = (scores[:, None, :] >= scores[:, :, None]).to(scores.dtype)
    ranks = ge.sum(dim=2)
    hits = (ge * pos[:, None, :]).sum(dim=2)
    per_label = torch.where(ranks > 0, hits / ranks, 0.0) * pos
    weight = pos.sum()
    return torch.where(weight > 0, per_label.sum() / weight, 0.0)
