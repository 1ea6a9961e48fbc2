"""lwlrap, label-weighted label-ranking average precision (JAX
``ops/metrics.py``).

- ``lwlrap``: numpy, over a whole set, with sklearn's >= tie handling;
  samples with no positive label are skipped.
- ``lwlrap_torch``: the in-step version over one (B, C) batch, on the
  batch's device; ``row_mask`` drops padded rows.
- ``per_class_lwlrap``: each class's lwlrap and weight (its share of the
  labels); their weighted sum is ``lwlrap``.

With per-sample weight = number of labels, the weighted mean of per-sample
LRAP is the sum over (sample, true label) of precision at its rank divided by
the total label count; both versions use that form.
"""

from __future__ import annotations

import numpy as np
import torch


def _precisions_np(truth_row: np.ndarray, scores_row: np.ndarray) -> tuple:
    """(indices of the true labels, each one's precision at its rank:
    (#true with score >= s) / (#all with score >= s))."""
    true_idx = np.flatnonzero(truth_row)
    s_true = scores_row[true_idx]
    ranks = (scores_row[None, :] >= s_true[:, None]).sum(axis=1)
    hits = (s_true[None, :] >= s_true[:, None]).sum(axis=1)
    return true_idx, hits / ranks


def _sample_terms_np(truth_row: np.ndarray, scores_row: np.ndarray) -> float:
    """Sum over true labels of their precision at rank."""
    true_idx, precision = _precisions_np(truth_row, scores_row)
    if true_idx.size == 0:
        return 0.0
    return float(np.sum(precision))


def lwlrap(truth: np.ndarray, scores: np.ndarray) -> float:
    """Label-weighted LRAP over a set (numpy)."""
    pos = np.asarray(truth) > 0
    scores = np.asarray(scores)
    n_labels = pos.sum(axis=1)
    keep = n_labels > 0
    if not np.any(keep):
        return 0.0
    # a plain running sum, as the JAX package's: Python's sum() of floats
    # is compensated (3.12), and the blend's COBYLA follows the last bit
    total = 0.0
    for t, s in zip(pos[keep], scores[keep]):
        total += _sample_terms_np(t, s)
    return total / float(n_labels[keep].sum())


def per_class_lwlrap(truth: np.ndarray, scores: np.ndarray):
    """(per-class lwlrap, per-class weight), numpy."""
    truth = np.asarray(truth) > 0
    scores = np.asarray(scores)
    n_samples, _ = truth.shape
    precisions = np.zeros_like(scores, dtype=np.float64)
    for i in range(n_samples):
        true_idx, precision = _precisions_np(truth[i], scores[i])
        precisions[i, true_idx] = precision
    labels_per_class = truth.sum(axis=0)
    per_class = np.where(labels_per_class > 0,
                         precisions.sum(axis=0)
                         / np.maximum(labels_per_class, 1), 0.0)
    weight = labels_per_class / max(labels_per_class.sum(), 1)
    return per_class, weight


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
