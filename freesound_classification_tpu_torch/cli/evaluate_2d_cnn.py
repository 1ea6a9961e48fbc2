"""Per-fold and overall out-of-fold lwlrap of a trained experiment, with
optional test-time augmentation (JAX ``cli/evaluate_2d_cnn.py``).

    python -m freesound_classification_tpu_torch.cli.evaluate_2d_cnn \\
        --experiment experiments/<name> --train_df train.csv \\
        --train_data_dir train --classmap classmap.json [--device cpu]

Splits ``--train_df`` into the experiment's folds (its ``_n_folds`` and
``_kfold_seed``, stratified as the train CLI splits them), predicts each
fold's validation clips with that fold's ``best_model.npz`` (float32),
averaging ``--n_tta`` passes as the predict CLI does, and prints each
fold's lwlrap, their mean and the lwlrap of all folds' predictions
together; ``--per_class`` adds the per-class lwlrap and weight, sorted by
lwlrap. On CUDA the log-mel frontend runs K1, once a batch and pass.

On several ranks: ``torchrun --nproc_per_node N -m
freesound_classification_tpu_torch.cli.evaluate_2d_cnn ... --mesh_devices
N``, as the predict CLI: each rank predicts its slice of every batch's rows
and gathers the rest, rank 0 prints, and ``main()`` returns the same
metrics on every rank.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from freesound_classification_tpu_torch.cli import common
from freesound_classification_tpu_torch.cli.predict_2d_cnn import (
    build_predictor,
)
from freesound_classification_tpu_torch.data.dataset import (
    ClipDataset,
    class_names_from_classmap,
    load_classmap,
    read_csv_columns,
)
from freesound_classification_tpu_torch.data.folds import (
    binarize_label_strings,
    train_validation_data_stratified,
)
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.data.tables import cell_text
from freesound_classification_tpu_torch.ops.metrics import (
    lwlrap,
    per_class_lwlrap,
)
from freesound_classification_tpu_torch.utils.experiment import Experiment


def main(argv=None) -> dict:
    """Run the CLI; returns {"folds": [lwlrap of each fold], "overall":
    the lwlrap of all out-of-fold predictions}."""
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--experiment", required=True, type=str)
    parser.add_argument("--train_df", required=True, type=str)
    parser.add_argument("--train_data_dir", required=True, type=str)
    parser.add_argument("--classmap", required=True, type=str)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--model_kind", type=str, default="2d_cnn",
                        choices=("2d_cnn", "hierarchical_cnn", "backbone_cnn"))
    common.add_tta_arguments(parser)
    parser.add_argument("--per_class", action="store_true", default=False,
                        help="print the per-class lwlrap decomposition")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    common.add_mesh_argument(parser)
    args = parser.parse_args(argv)
    common.reject_degenerate_tta(parser, args)
    with common.data_parallel(args) as mesh:
        return _evaluate(args, mesh)


def _evaluate(args, mesh) -> dict:
    device = mesh.device
    experiment = Experiment(resume_from=args.experiment)
    class_map = load_classmap(args.classmap)
    n_folds = int(experiment.config.data._n_folds)
    kfold_seed = int(experiment.config.data._kfold_seed)
    fnames, label_cells = read_csv_columns(args.train_df,
                                           ["fname", "labels"])
    splits = list(train_validation_data_stratified(
        fnames, label_cells, class_map, n_folds, kfold_seed))
    tta_fn = common.make_tta_fn(args.tta_noise_snr_db, args.tta_shift_max_s,
                                shuffle_p=args.tta_shuffle_p)
    crops = args.n_tta > 1 and args.tta_max_audio_length is not None

    ladder = common.default_ladder(None)
    fold_metrics, all_probs, all_labels = [], [], []
    for fold in range(n_folds):
        _, valid_idx = splits[fold]
        ds = ClipDataset(
            [os.path.join(args.train_data_dir, fnames[i]) for i in valid_idx],
            raw_labels=[label_cells[i] for i in valid_idx],
            classmap=class_map, sr=common.SR,
            max_audio_length=args.tta_max_audio_length if crops else None,
            seed=kfold_seed + fold)
        # train mode draws a fresh crop every TTA pass; every rank reads
        # the global batches, and the ensemble splits their rows
        loader = make_loader(ds, ladder, batch_size=args.batch_size,
                             train=crops, shuffle=False, drop_last=False,
                             num_workers=args.num_workers)
        predictor = build_predictor(args.experiment, device, folds=[fold],
                                    model_kind=args.model_kind)
        preds = predictor.predict_loader(
            loader, tta_fn=tta_fn,
            generator=torch.Generator(device=device).manual_seed(1000 * fold),
            n_tta=args.n_tta, mesh=mesh)
        labels = binarize_label_strings(
            [cell_text(label_cells[i]) for i in valid_idx], class_map)
        m = lwlrap(labels, preds)
        print(f"fold {fold}: lwlrap {m:.4f}")
        fold_metrics.append(m)
        all_probs.append(preds)
        all_labels.append(labels)

    labels, probs = np.concatenate(all_labels), np.concatenate(all_probs)
    overall = lwlrap(labels, probs)
    print(f"\nmean fold lwlrap: {np.mean(fold_metrics):.4f}")
    print(f"overall OOF lwlrap: {overall:.4f}")

    if args.per_class:
        per_class, weight = per_class_lwlrap(labels, probs)
        names = class_names_from_classmap(class_map)
        width = max(len("classname"), *(len(n) for n in names))
        print(f"{'classname':<{width}}  {'lwlrap':>8}  {'weight':>8}")
        for k in np.argsort(per_class, kind="stable"):
            print(f"{names[k]:<{width}}  {per_class[k]:8.6f}  "
                  f"{weight[k]:8.6f}")
    return {"folds": fold_metrics, "overall": overall}


if __name__ == "__main__":
    common.log_launches_at_exit()
    main()
