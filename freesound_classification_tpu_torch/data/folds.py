"""K-fold splits (JAX ``data/folds.py``, the port's own numpy copy).

- ``train_validation_data``: shuffled KFold, the same splits as
  ``sklearn.model_selection.KFold(n_folds, shuffle=True, random_state=seed)``
  without sklearn.
- ``train_validation_data_stratified``: multilabel iterative stratification
  (Sechidis et al. 2011) with the control flow and RNG call order of the
  iterstrat package, as the JAX package has it.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np

Split = Tuple[np.ndarray, np.ndarray]


def train_validation_data(ids: Sequence, labels, n_folds: int,
                          seed: int) -> Iterator[Split]:
    """Plain shuffled KFold over ``ids`` (the noisy set's split), as
    sklearn's: permute the indices with ``RandomState(seed)``, cut them into
    ``n_folds`` runs (the first ``len(ids) % n_folds`` one longer), yield
    sorted (train, valid)."""
    del labels
    n_samples = len(ids)
    indices = np.arange(n_samples)
    np.random.RandomState(seed).shuffle(indices)
    sizes = np.full(n_folds, n_samples // n_folds, dtype=int)
    sizes[: n_samples % n_folds] += 1
    start = 0
    for size in sizes:
        valid = np.zeros(n_samples, dtype=bool)
        valid[indices[start: start + size]] = True
        start += size
        yield np.flatnonzero(~valid), np.flatnonzero(valid)


def iterative_stratification(labels: np.ndarray, r: np.ndarray,
                             random_state: np.random.RandomState
                             ) -> np.ndarray:
    """Fold index of each sample, by iterative stratification: the label
    with the fewest remaining examples goes first (random tie break); each
    of its samples goes to the fold desiring that label most, ties broken by
    overall desire and then randomly; all-zero rows fill the fold with the
    largest overall desire."""
    labels = np.asarray(labels, dtype=bool)
    n_samples = labels.shape[0]
    test_folds = np.zeros(n_samples, dtype=int)
    c_folds = r * n_samples
    c_folds_labels = np.outer(r, labels.sum(axis=0))

    not_processed = np.ones(n_samples, dtype=bool)
    while np.any(not_processed):
        num_labels = labels[not_processed].sum(axis=0)
        if num_labels.sum() == 0:
            for sample_idx in np.where(not_processed)[0]:
                fold_idx = np.argmax(c_folds)
                test_folds[sample_idx] = fold_idx
                c_folds[fold_idx] -= 1
            break
        label_idx = np.where(
            num_labels == num_labels[np.nonzero(num_labels)[0]].min())[0]
        if label_idx.shape[0] > 1:
            label_idx = label_idx[random_state.choice(label_idx.shape[0])]
        sample_idxs = np.where(
            np.logical_and(labels[:, label_idx].flatten(), not_processed))[0]
        for sample_idx in sample_idxs:
            label_folds = c_folds_labels[:, label_idx]
            fold_idx = np.where(label_folds == label_folds.max())[0]
            if fold_idx.shape[0] > 1:
                temp_fold_idx = np.where(
                    c_folds[fold_idx] == c_folds[fold_idx].max())[0]
                fold_idx = fold_idx[temp_fold_idx]
                if temp_fold_idx.shape[0] > 1:
                    fold_idx = fold_idx[
                        random_state.choice(temp_fold_idx.shape[0])]
            fold_idx = int(np.atleast_1d(fold_idx)[0])
            test_folds[sample_idx] = fold_idx
            not_processed[sample_idx] = False
            c_folds_labels[fold_idx, labels[sample_idx]] -= 1
            c_folds[fold_idx] -= 1
    return test_folds


def multilabel_stratified_splits(y: np.ndarray, n_folds: int,
                                 seed: int) -> Iterator[Split]:
    """iterstrat's ``MultilabelStratifiedKFold(shuffle=True)``: shuffle the
    rows once, stratify the shuffled labels, undo the shuffle."""
    y = np.asarray(y, dtype=bool)
    rng = np.random.RandomState(seed)
    order = np.arange(y.shape[0])
    rng.shuffle(order)
    r = np.asarray([1 / n_folds] * n_folds)
    fold_of = iterative_stratification(y[order], r, rng)[np.argsort(order)]
    indices = np.arange(len(fold_of))
    for fold in range(n_folds):
        yield indices[fold_of != fold], indices[fold_of == fold]


def binarize_label_strings(label_strings, classmap: dict) -> np.ndarray:
    """Comma-separated class-name strings -> (N, C) binary float32; empty
    names (``"a,,b"``, a trailing comma) are skipped."""
    out = np.zeros((len(label_strings), len(classmap)), dtype=np.float32)
    for k, item in enumerate(label_strings):
        for label in str(item).split(","):
            if label:
                out[k, classmap[label]] = 1.0
    return out


def train_validation_data_stratified(ids: Sequence, labels: Sequence[str],
                                     classmap: dict, n_folds: int,
                                     seed: int) -> Iterator[Split]:
    """Stratified (train, valid) index splits over the curated set."""
    del ids
    binary = binarize_label_strings(list(labels), classmap)
    return multilabel_stratified_splits(binary, n_folds, seed)
