"""Parity report of a finished experiment against the reference's lwlrap
(``scripts/compare_to_baseline.py``).

    python -m freesound_classification_tpu_torch.cli.compare_to_baseline \\
        --experiment experiments/<name> --train_df train_curated.csv \\
        --classmap classmap.json [--reference_lwlrap 0.86] \\
        [--reference_oof_dir <reference experiment>/predictions]

Reads ``results.json`` and ``predictions/val_preds_fold_*.csv``, recomputes
the global out-of-fold lwlrap from the raw OOF rows, and prints it with the
per-fold metrics; with ``--reference_lwlrap`` the delta against it (PASS
within BASELINE.md's 0.005, else FAIL and exit 1); with
``--reference_oof_dir`` the reference's recomputed lwlrap and the classes
that lost most.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

from freesound_classification_tpu_torch.data.dataset import (
    class_names_from_classmap,
    load_classmap,
    read_csv_columns,
)
from freesound_classification_tpu_torch.data.folds import (
    binarize_label_strings,
)
from freesound_classification_tpu_torch.data.tables import (
    cell_text,
    read_prediction_files,
)
from freesound_classification_tpu_torch.ops.metrics import (
    lwlrap,
    per_class_lwlrap,
)

TOLERANCE = 0.005  # BASELINE.md: match the reference's lwlrap within 0.005


def load_oof(pred_dir: str, class_names: list) -> tuple:
    """(fnames, (N, C) scores in ``class_names`` order) of every
    ``val_preds_fold_*.csv`` under ``pred_dir``, concatenated."""
    paths = sorted(glob.glob(os.path.join(pred_dir, "val_preds_fold_*.csv")))
    if not paths:
        raise FileNotFoundError(f"no val_preds_fold_*.csv under {pred_dir}")
    fnames, _, values = read_prediction_files(paths, class_names)
    return fnames, values


def oof_lwlrap(oof: tuple, train_labels: dict, class_map: dict):
    """(lwlrap, per-class lwlrap, class weights) of the OOF rows whose fname
    the train CSV has (an inner join in OOF order)."""
    fnames, scores = oof
    rows = [i for i, f in enumerate(fnames) if f in train_labels]
    truth = binarize_label_strings(
        [train_labels[fnames[i]] for i in rows], class_map)
    scores = scores[rows]
    per_class, weights = per_class_lwlrap(truth, scores)
    return lwlrap(truth, scores), per_class, weights


def train_labels_by_fname(train_df: str) -> dict:
    fnames, labels = read_csv_columns(train_df, ["fname", "labels"])
    if len(set(fnames)) != len(fnames):
        raise ValueError(f"{train_df}: fnames are not unique")
    return {f: cell_text(cell) for f, cell in zip(fnames, labels)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--experiment", required=True)
    p.add_argument("--train_df", required=True)
    p.add_argument("--classmap", required=True)
    p.add_argument("--reference_lwlrap", type=float, default=None)
    p.add_argument("--reference_oof_dir", type=str, default=None)
    p.add_argument("--top_diffs", type=int, default=15,
                   help="per-class rows to print in the diff table")
    args = p.parse_args(argv)

    class_map = load_classmap(args.classmap)
    class_names = class_names_from_classmap(class_map)
    train_labels = train_labels_by_fname(args.train_df)

    with open(os.path.join(args.experiment, "results.json")) as f:
        results = json.load(f)
    fold_metrics = {k: v["metric"] for k, v in results.items()
                    if k.startswith("fold") and isinstance(v, dict)
                    and "metric" in v}

    oof = load_oof(os.path.join(args.experiment, "predictions"), class_names)
    ours, per_class, weights = oof_lwlrap(oof, train_labels, class_map)

    print(f"experiment: {args.experiment}")
    for k in sorted(fold_metrics):
        print(f"  {k}: lwlrap {fold_metrics[k]:.5f}")
    print(f"global OOF lwlrap (recomputed from {len(oof[0])} OOF rows): "
          f"{ours:.5f}")
    if "metric" in results:
        drift = abs(results["metric"] - ours)
        print(f"results.json metric: {results['metric']:.5f} "
              f"(recompute drift {drift:.2e})")

    status = 0
    if args.reference_lwlrap is not None:
        delta = ours - args.reference_lwlrap
        verdict = "PASS" if delta >= -TOLERANCE else "FAIL"
        print(f"lwlrap delta vs reference: {delta:+.5f} "
              f"(reference {args.reference_lwlrap:.5f}, tolerance "
              f"-{TOLERANCE}) -> {verdict}")
        if verdict == "FAIL":
            status = 1

    if args.reference_oof_dir:
        ref_l, ref_pc, _ = oof_lwlrap(
            load_oof(args.reference_oof_dir, class_names), train_labels,
            class_map)
        delta = ours - ref_l
        verdict = "PASS" if delta >= -TOLERANCE else "FAIL"
        print(f"reference OOF lwlrap (recomputed): {ref_l:.5f}; "
              f"delta {delta:+.5f} -> {verdict}")
        if verdict == "FAIL":
            status = 1
        diffs = per_class - ref_pc
        order = np.argsort(diffs)
        print("largest per-class regressions (ours - reference), "
              "weight = label prevalence:")
        for i in order[: args.top_diffs]:
            print(f"  {class_names[i]:>40s}  d={diffs[i]:+.4f}  "
                  f"ours={per_class[i]:.4f} ref={ref_pc[i]:.4f} "
                  f"w={weights[i]:.4f}")

    return status


if __name__ == "__main__":
    sys.exit(main())
