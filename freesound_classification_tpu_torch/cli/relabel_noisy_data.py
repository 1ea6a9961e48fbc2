"""Pseudolabel the noisy subset from model predictions (JAX
``cli/relabel_noisy_data.py``). Five strategies, chosen by a
``<mode>_<param>`` descriptor:

- ``fullmatch_<cps>``             keep rows whose thresholded predictions
                                  match the given labels exactly
- ``relabelall_<cps>``            replace every row's labels by its
                                  thresholded predictions, drop empty rows
- ``relabelall-replacenan_<cps>`` the same
- ``relabelall-merge_<cps>``      the union of old and new labels
- ``scoring_<topk>``              keep the top-k rows by per-sample
                                  label-ranking agreement

    python -m freesound_classification_tpu_torch.cli.relabel_noisy_data \\
        --noisy_df train_noisy.csv \\
        --noisy_predictions_df noisy_probabilities.csv \\
        --output_df train_noisy_relabeled.csv --mode scoring_1000

The ``*_<cps>`` threshold makes the mean number of predicted classes per
sample nearest ``cps``. Both CSVs are sorted by ``fname`` first, and the
output is the JAX CLI's byte for byte: the same rows in the same order,
cells as pandas writes them back.
"""

from __future__ import annotations

import argparse

import numpy as np

from freesound_classification_tpu_torch.data.folds import (
    binarize_label_strings,
)
from freesound_classification_tpu_torch.data.tables import (
    as_written,
    cell_text,
    read_predictions,
    read_table,
    write_table,
)

N_THRESHOLDS = 10000


def find_threshold(probs: np.ndarray,
                   expected_classes_per_sample: float) -> float:
    """The first of ``linspace(0, 1, 10000)`` whose mean count of
    ``probs > t`` per row is nearest the target. The JAX CLI compares every
    threshold with every probability at once ((10000, N, C) booleans: 15.9
    GB at 19,815 x 80); here each count above a threshold is an exact
    integer from the sorted probabilities, divided by N as numpy's mean of
    integer counts is, so the threshold is the same."""
    thresholds = np.linspace(0, 1, N_THRESHOLDS)
    flat = np.sort(np.asarray(probs, dtype=np.float64).ravel())
    above = flat.size - np.searchsorted(flat, thresholds, side="right")
    classes_per_sample = above / float(probs.shape[0])
    k = np.argmin(np.abs(classes_per_sample - expected_classes_per_sample))
    return float(thresholds[k])


def score_samples(y_true: np.ndarray, y_score: np.ndarray) -> np.ndarray:
    """Per-sample label-ranking average precision: how well the model's
    ranking agrees with the given noisy labels (1 where a row has no label
    or every label)."""
    from scipy.stats import rankdata

    n_samples, n_labels = y_true.shape
    neg = -y_score
    scores = np.ones(n_samples)
    for i in range(n_samples):
        relevant = np.flatnonzero(y_true[i] > 0)
        if relevant.size == 0 or relevant.size == n_labels:
            continue
        rank = rankdata(neg[i], "max")[relevant]
        L = rankdata(neg[i][relevant], "max")
        scores[i] = (L / rank).mean()
    return scores


def binary_to_labels(binary: np.ndarray, class_cols) -> list:
    return [",".join(class_cols[k] for k in np.flatnonzero(row))
            for row in binary]


def merge_labels(first, second) -> list:
    merged = []
    for f, s in zip(first, second):
        m = set(cell_text(f).split(",")) | set(s.split(","))
        m.discard("")
        merged.append(",".join(sorted(m)))
    return merged


def relabel(header, rows, pred_fnames, class_cols, probs,
            mode_descriptor: str) -> list:
    """The output rows (cells as pandas writes them) of the noisy CSV's
    ``header`` and ``rows`` under ``mode_descriptor``, given the
    predictions' fnames, class columns and (N, C) probabilities."""
    fname_k = header.index("fname")
    rows = sorted(rows, key=lambda row: row[fname_k])
    order = sorted(range(len(pred_fnames)), key=lambda i: pred_fnames[i])
    probs = probs[order]
    label_k = header.index("labels")
    labels = [row[label_k] for row in rows]
    written = [[as_written(cell) for cell in row] for row in rows]

    mode, *params = mode_descriptor.split("_")
    noisy_labels = binarize_label_strings(
        [cell_text(cell) for cell in labels],
        {c: i for i, c in enumerate(class_cols)})

    def with_labels(new_labels):
        return [row[:label_k] + [new] + row[label_k + 1:]
                for row, new in zip(written, new_labels)]

    if mode == "fullmatch":
        binary = probs > find_threshold(probs, float(params[0]))
        match = (binary == (noisy_labels > 0)).all(-1)
        return [row for row, keep in zip(written, match) if keep]

    if mode in ("relabelall", "relabelall-replacenan"):
        binary = probs > find_threshold(probs, float(params[0]))
        return [row for row in with_labels(binary_to_labels(binary,
                                                            class_cols))
                if row[label_k] != ""]

    if mode == "relabelall-merge":
        binary = probs > find_threshold(probs, float(params[0]))
        return with_labels(merge_labels(
            labels, binary_to_labels(binary, class_cols)))

    if mode == "scoring":
        topk = int(params[0])
        scores = score_samples(noisy_labels, probs)
        return [written[i] for i in np.argsort(-scores)[:topk]]

    raise ValueError(f"unknown relabel mode {mode_descriptor!r}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--noisy_df", required=True, type=str)
    parser.add_argument("--noisy_predictions_df", required=True, type=str)
    parser.add_argument("--output_df", required=True, type=str)
    parser.add_argument("--mode", required=True, type=str)
    args = parser.parse_args(argv)

    header, rows = read_table(args.noisy_df)
    out = relabel(header, rows, *read_predictions(args.noisy_predictions_df),
                  args.mode)
    print("Relabeled df shape:", (len(out), len(header)))
    write_table(args.output_df, header, out)


if __name__ == "__main__":
    main()
