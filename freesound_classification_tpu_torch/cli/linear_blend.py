"""Linear-blend ensembling (JAX ``cli/linear_blend.py``): COBYLA search of
one weight an experiment maximizing the lwlrap of the weighted sum of their
out-of-fold predictions, then the same weights on each experiment's
fold-mean test predictions.

    python -m freesound_classification_tpu_torch.cli.linear_blend \\
        --experiments experiments/<a> experiments/<b> \\
        --train_df train_curated.csv --output_df blend_submission.csv \\
        [--rankdata]

The JAX CLI's two repairs of the reference stay: the test loop uses its own
loop variable (the reference's read a stale ``experiment``), and each
experiment contributes its fold-mean prediction (the reference summed its
folds unnormalized).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from freesound_classification_tpu_torch.cli.common import write_predictions
from freesound_classification_tpu_torch.data.dataset import (
    read_csv_columns,
)
from freesound_classification_tpu_torch.data.folds import (
    binarize_label_strings,
)
from freesound_classification_tpu_torch.data.tables import (
    cell_text,
    read_prediction_files,
)
from freesound_classification_tpu_torch.ops.metrics import lwlrap


def to_ranks(values: np.ndarray) -> np.ndarray:
    from scipy.stats import rankdata

    return np.array([rankdata(r) for r in values])


def _sorted_predictions(files) -> tuple:
    """(fnames, sorted class columns, values) of the CSVs concatenated,
    rows sorted by fname."""
    fnames, classes, values = read_prediction_files(files)
    rows = sorted(range(len(fnames)), key=lambda i: fnames[i])
    return [fnames[i] for i in rows], classes, values[rows]


def load_oof_predictions(experiment_dir: str) -> tuple:
    """An experiment's ``val_preds*`` files, concatenated, rows by fname."""
    return _sorted_predictions(sorted(glob.glob(
        os.path.join(experiment_dir, "predictions", "val_preds*"))))


def load_test_predictions(experiment_dir: str) -> list:
    """Each ``test_preds*`` file of an experiment, rows by fname."""
    return [_sorted_predictions([path]) for path in sorted(glob.glob(
        os.path.join(experiment_dir, "predictions", "test_preds*")))]


def optimize_blend(prediction_values, actual_labels):
    """COBYLA weight search: alphas in [0, 1] summing to [0.01, 0.99],
    maximizing lwlrap of the weighted OOF sum. Returns (alphas, lwlrap)."""
    import scipy.optimize

    n = len(prediction_values)

    def constraints():
        yield scipy.optimize.LinearConstraint(A=np.ones(n), lb=0.01, ub=0.99)
        for k in range(n):
            A = np.zeros(n)
            A[k] = 1
            yield scipy.optimize.LinearConstraint(A=A, lb=0, ub=1)

    def target(alphas):
        blended = np.sum(
            [a * p for a, p in zip(alphas, prediction_values)], axis=0)
        return -lwlrap(actual_labels, blended)

    result = scipy.optimize.minimize(
        target, np.ones(n) / n, constraints=list(constraints()),
        method="COBYLA")
    return result.x, -target(result.x)


def actual_labels(train_df: str, class_cols) -> np.ndarray:
    """(N, C) binary labels of the train CSV, rows in sorted fname order."""
    fnames, labels = read_csv_columns(train_df, ["fname", "labels"])
    order = sorted(range(len(fnames)), key=lambda k: fnames[k])
    return binarize_label_strings([cell_text(labels[k]) for k in order],
                                  {c: i for i, c in enumerate(class_cols)})


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--experiments", type=str, required=True, nargs="+",
                        help="experiment directories to blend")
    parser.add_argument("--train_df", type=str, required=True)
    parser.add_argument("--rankdata", action="store_true", default=False)
    parser.add_argument("--output_df", type=str, required=True)
    args = parser.parse_args(argv)

    predictions = [load_oof_predictions(e) for e in args.experiments]
    class_cols = predictions[0][1]
    prediction_values = [values for _, _, values in predictions]
    if args.rankdata:
        prediction_values = [to_ranks(p) for p in prediction_values]

    alphas, best = optimize_blend(prediction_values,
                                  actual_labels(args.train_df, class_cols))
    print()
    for experiment, alpha in zip(args.experiments, alphas):
        print(f"{experiment}: {alpha}")
    print(f"\nFinal lwlrap: {best}")

    test_blend = None
    fnames = None
    for alpha, exp in zip(alphas, args.experiments):
        folds = load_test_predictions(exp)
        fold_mean = np.mean([to_ranks(v) if args.rankdata else v
                             for _, _, v in folds], axis=0)
        fnames = folds[0][0]
        test_blend = (alpha * fold_mean if test_blend is None
                      else test_blend + alpha * fold_mean)

    write_predictions(args.output_df, fnames, class_cols, test_blend)
    print(f"wrote {args.output_df}")


if __name__ == "__main__":
    main()
