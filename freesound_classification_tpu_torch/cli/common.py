"""Shared CLI plumbing of the port (JAX ``cli/common.py``): the device, the
bucket ladder, the train CLIs' flag surface and their per-fold loop,
keyed by the model kind (``2d_cnn``, ``hierarchical_cnn`` or
``backbone_cnn``).

The train loop reads the manifests with the ``csv`` module and draws the
JAX CLI's rows with numpy: ``--max_samples`` as pandas' ``df.sample(n,
random_state=kfold_seed)`` (``RandomState(seed).permutation(len)[:n]``, on
the train and the test CSV) and ``--holdout_size`` as sklearn's
``train_test_split`` (the holdout is the first ``ceil(h * n)`` rows of
``RandomState(seed).permutation(n)``, the train set the rest in that
order). It splits the curated folds with the port's stratification and the
noisy set (``--noisy_train_df``) with plain KFold, adds to each fold's train
set the noisy split's validation part (every noisy row with
``--share_noisy``), trains each requested fold with the ``Engine``, and
writes ``checkpoints/fold_k/{best,final,model_on_epoch_N}_model.npz``,
``predictions/val_preds_fold_k.csv`` and, with ``--sample_submission``,
``predictions/test_preds_fold_k.csv``. ``finalize_results`` then registers
the global out-of-fold lwlrap as ``metric`` once every fold has its result,
and writes the mean-of-folds ``submission.csv`` once every fold's test
predictions exist. ``refuse_unported`` raises on the flags of parts not
ported yet. ``log_launches_at_exit`` lets a run of several CLI processes
(the recipe kit) count each one's kernel launches.
"""

from __future__ import annotations

import argparse
import atexit
import csv
import json
import math
import os
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from freesound_classification_tpu_torch.data import bucketing
from freesound_classification_tpu_torch.data.dataset import (
    ClipDataset,
    class_names_from_classmap,
    load_classmap,
    read_csv_columns,
)
from freesound_classification_tpu_torch.data.folds import (
    binarize_label_strings,
    train_validation_data,
    train_validation_data_stratified,
)
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.data.tables import (
    cell_text,
    read_prediction_files,
)
from freesound_classification_tpu_torch.models.frontend import (
    MODEL_FAMILY,
    Frontend,
)
from freesound_classification_tpu_torch.ops import kernels
from freesound_classification_tpu_torch.ops.augment import (
    AugmentConfig,
    make_augmenter,
)
from freesound_classification_tpu_torch.ops.dsp import parse_features
from freesound_classification_tpu_torch.ops.metrics import lwlrap
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.training.state import create_model
from freesound_classification_tpu_torch.utils.device import resolve_device
from freesound_classification_tpu_torch.utils.experiment import Experiment

SR = 44100
LAUNCH_LOG_ENV = "FSC_LAUNCH_LOG"


def log_launches_at_exit() -> None:
    """Where ``$FSC_LAUNCH_LOG`` names a file, set every kernel wrapper's
    count to 0 and, at this process's exit, append to that file one JSON
    line: the program's ``argv`` and each wrapper's ``launches`` in it. The
    CLIs that run kernels call this when run as programs."""
    path = os.environ.get(LAUNCH_LOG_ENV)
    if not path:
        return
    for name in kernels.launch_counts():
        getattr(kernels, name).launches = 0

    def write() -> None:
        line = json.dumps({"argv": sys.argv,
                           "launches": kernels.launch_counts()})
        with open(path, "a") as f:
            f.write(line + "\n")

    atexit.register(write)


def default_ladder(max_audio_length: Optional[float], sr: int = SR):
    """Bucket ladder covering up to max_audio_length (or ~30 s full clips)."""
    max_len = int((max_audio_length or 30) * sr)
    return bucketing.make_bucket_ladder(max_len, min_length=sr // 2)


def add_train_arguments(parser: argparse.ArgumentParser) -> None:
    """The JAX train CLI's flag surface (the reference's train_2d_cnn
    flags plus --loss, --bf16, --max_batch_elems, --experiments_dir,
    --mixup_exact_add and --profile). Flags of parts not ported yet are
    accepted and refused at run time with the ROADMAP item named.
    ``--sample_submission`` and ``--test_data_dir``, which the JAX CLI
    requires, are optional: without them no test predictions are written."""
    add = parser.add_argument
    add("--train_df", required=True, type=str, help="path to train CSV")
    add("--train_data_dir", required=True, type=str)
    add("--noisy_train_df", type=str, help="path to noisy train CSV")
    add("--noisy_train_data_dir", type=str)
    add("--share_noisy", action="store_true", default=False,
        help="every noisy row in every fold's train set")
    add("--resume", action="store_true", default=False,
        help="not ported yet (ROADMAP M2.2)")
    add("--test_data_dir", type=str, help="path to test data")
    add("--sample_submission", type=str,
        help="path to the sample submission CSV (the test set)")
    add("--classmap", required=True, type=str)
    add("--log_interval", default=10, type=int)
    add("--batch_size", type=int, default=64)
    add("--max_audio_length", type=int, default=10,
        help="max audio length in seconds; longer clips are cropped")
    add("--lr", default=0.01, type=float)
    add("--max_samples", type=int, help="maximum number of samples to use")
    add("--holdout_size", type=float, default=0.0)
    add("--epochs", default=100, type=int)
    add("--scheduler", type=str, default="steplr_1_0.5")
    add("--accumulation_steps", type=int, default=1)
    add("--save_every", type=int, default=1)
    add("--keep_checkpoints", type=int, default=0,
        help="retention for periodic model_on_epoch_N checkpoints: keep "
             "only the newest K (0 = keep all, reference behavior)")
    add("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    add("--aggregation_type", type=str, required=True, choices=("max", "rnn"))
    add("--num_conv_blocks", type=int, default=5)
    add("--start_deep_supervision_on", type=int, default=2)
    add("--conv_base_depth", type=int, default=64)
    add("--growth_rate", type=float, default=2)
    add("--weight_decay", type=float, default=1e-5)
    add("--output_dropout", type=float, default=0.0)
    add("--p_mixup", type=float, default=0.0)
    add("--p_aug", type=float, default=0.0)
    add("--switch_off_augmentations_on", type=int, default=20)
    add("--features", type=str, required=True, help="feature descriptor")
    add("--optimizer", type=str, required=True, choices=("adam", "momentum"))
    add("--folds", type=int, required=True, nargs="+")
    add("--n_folds", type=int, default=4)
    add("--kfold_seed", type=int, default=42)
    add("--num_workers", type=int, default=4)
    add("--label", type=str, default="2d_cnn")
    add("--loss", type=str, default="lsep_naive",
        choices=("lsep", "lsep_naive", "bce", "focal"))
    add("--bf16", action="store_true", default=False,
        help="bfloat16 model compute (params stay float32)")
    add("--max_batch_elems", type=int, default=None,
        help="pack batches by total samples instead of a fixed batch size")
    add("--experiments_dir", type=str, default="experiments")
    add("--mixup_exact_add", action="store_true", default=False,
        help="additive MixUp instead of the reference's replace quirk")
    add("--profile", action="store_true", default=False,
        help="trace epoch 1 with torch.profiler into "
             "<experiment>/summaries/profile")
    add("--fold_parallel", action="store_true", default=False,
        help="not ported yet (ROADMAP M5.2)")
    add("--mesh_devices", type=int, default=None,
        help="not ported yet (ROADMAP M5.1)")


def refuse_unported(args) -> None:
    """Raise on a flag whose part of the train CLI is not ported yet."""
    waits = [
        (args.resume, "--resume", "M2.2"),
        (args.accumulation_steps > 1, "--accumulation_steps > 1", "M2.2"),
        (args.fold_parallel, "--fold_parallel", "M5.2"),
        (args.mesh_devices is not None, "--mesh_devices", "M5.1"),
    ]
    for given, flag, item in waits:
        if given:
            raise NotImplementedError(
                f"{flag}: not ported yet (ROADMAP {item})")


def experiment_config(args, n_classes: int, input_dim: int,
                      extra_network: Optional[dict] = None) -> dict:
    """The nested experiment config of the JAX CLI; ``extra_network`` adds
    to its network section (the backbone CLI's ``backbone``)."""
    network = {
        "num_conv_blocks": args.num_conv_blocks,
        "start_deep_supervision_on": args.start_deep_supervision_on,
        "conv_base_depth": args.conv_base_depth,
        "growth_rate": args.growth_rate,
        "output_dropout": args.output_dropout,
        "aggregation_type": args.aggregation_type,
    }
    network.update(extra_network or {})
    return {
        "network": network,
        "data": {
            "features": args.features,
            "_n_folds": args.n_folds,
            "_kfold_seed": args.kfold_seed,
            "_input_dim": input_dim,
            "_n_classes": n_classes,
            "_holdout_size": args.holdout_size,
            "p_mixup": args.p_mixup,
            "p_aug": args.p_aug,
            "max_audio_length": args.max_audio_length,
            "noisy": args.noisy_train_df is not None,
            "_train_df": args.train_df,
            "_train_data_dir": args.train_data_dir,
            "_noisy_train_df": args.noisy_train_df,
            "_noisy_train_data_dir": args.noisy_train_data_dir,
            "_share_noisy": args.share_noisy,
        },
        "train": {
            "accumulation_steps": args.accumulation_steps,
            "batch_size": args.batch_size,
            "learning_rate": args.lr,
            "scheduler": args.scheduler,
            "optimizer": args.optimizer,
            "epochs": args.epochs,
            "_save_every": args.save_every,
            "_keep_checkpoints": args.keep_checkpoints,
            "weight_decay": args.weight_decay,
            "switch_off_augmentations_on": args.switch_off_augmentations_on,
            "_loss": args.loss,
        },
        "label": args.label,
    }


def build_engine(args, experiment: Experiment, n_classes: int,
                 device: torch.device, seed: int = 42,
                 model_kind: str = "2d_cnn") -> Engine:
    """A fresh ``model_kind`` model, the frontend of its family (K1 for
    mel features), the augmenter (K2, K3) and the engine for one fold;
    ``args.warm_start_path``, where the finetune CLI sets it, seeds every
    fold's model. With ``args.profile`` the engine traces epoch 1 into
    ``<experiment>/summaries/profile``."""
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = create_model(experiment.config.network, n_classes, dtype, seed,
                         device, model_kind=model_kind,
                         input_dim=parse_features(args.features).n_features)
    frontend = Frontend(args.features, MODEL_FAMILY[model_kind], sr=SR,
                        device=device)
    augment = make_augmenter(AugmentConfig(
        p_mixup=args.p_mixup, p_aug=args.p_aug,
        # chunk shuffle only for non-rnn models, as the reference
        p_shuffle=0.5 if args.aggregation_type != "rnn" else 0.0,
        mixup_quirk_replace=not args.mixup_exact_add, sr=SR))
    profile_dir = None
    if args.profile:
        profile_dir = os.path.join(
            experiment.register_directory("summaries"), "profile")
    return Engine(model, frontend, experiment.config.train, loss=args.loss,
                  augment=augment,
                  checkpoint_dir=experiment.register_directory("checkpoints"),
                  seed=seed, device=device,
                  warm_start_path=getattr(args, "warm_start_path", None),
                  profile_dir=profile_dir)


def write_predictions(path: str, fnames, class_names, probs) -> None:
    """CSV of ``fname`` plus the sorted class columns."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["fname", *class_names])
        for name, row in zip(fnames, probs):
            writer.writerow([name, *(f"{v:.9g}" for v in row)])


class Manifest(NamedTuple):
    """Rows of a CSV: fnames and their label cells (None for a test set)."""
    fnames: list
    labels: Optional[list]

    def take(self, rows) -> "Manifest":
        return Manifest([self.fnames[i] for i in rows],
                        None if self.labels is None
                        else [self.labels[i] for i in rows])


def sample_rows(n_rows: int, n: int, seed: int) -> np.ndarray:
    """pandas' ``df.sample(n, random_state=seed)``: the first ``n`` of
    ``RandomState(seed).permutation(n_rows)``."""
    if n > n_rows:
        raise ValueError(f"cannot take a sample of {n} from {n_rows} rows")
    return np.random.RandomState(seed).permutation(n_rows)[:n]


def holdout_rows(n_rows: int, holdout_size: float, seed: int) -> tuple:
    """sklearn's ``train_test_split(arange(n_rows), test_size=holdout_size,
    random_state=seed)``: (kept rows, holdout rows), each in the order of
    ``RandomState(seed).permutation(n_rows)``."""
    if not 0.0 < holdout_size < 1.0:
        raise ValueError(f"--holdout_size {holdout_size}: give a fraction "
                         "in (0, 1)")
    n_test = math.ceil(holdout_size * n_rows)
    if not 0 < n_test < n_rows:
        raise ValueError(f"--holdout_size {holdout_size} of {n_rows} rows "
                         "leaves no train or no holdout row")
    perm = np.random.RandomState(seed).permutation(n_rows)
    return perm[n_test:], perm[:n_test]


class TrainingSets(NamedTuple):
    """What the JAX CLI reads before its fold loop: the curated train set
    (after ``--max_samples`` and the holdout), the test set, the holdout,
    the noisy set, and the curated and noisy fold splits."""
    train: Manifest
    test: Optional[Manifest]
    holdout: Optional[Manifest]
    noisy: Optional[Manifest]
    splits: list
    noisy_splits: Optional[list]


def training_sets(args, class_map: dict) -> TrainingSets:
    """The JAX CLI's row selection (``cli/common.py:286-318``); a test set
    without its data directory raises before any work."""
    if args.sample_submission is not None and args.test_data_dir is None:
        raise ValueError("--sample_submission needs --test_data_dir")
    train = Manifest(*read_csv_columns(args.train_df, ["fname", "labels"]))
    test = (Manifest(read_csv_columns(args.sample_submission, ["fname"])[0],
                     None) if args.sample_submission else None)
    noisy = (Manifest(*read_csv_columns(args.noisy_train_df,
                                        ["fname", "labels"]))
             if args.noisy_train_df else None)
    if args.max_samples:
        train = train.take(sample_rows(len(train.fnames), args.max_samples,
                                       args.kfold_seed))
        if test is not None:
            test = test.take(sample_rows(
                len(test.fnames), min(args.max_samples, len(test.fnames)),
                args.kfold_seed))
    holdout = None
    if args.holdout_size:
        keep, held = holdout_rows(len(train.fnames), args.holdout_size,
                                  args.kfold_seed)
        holdout, train = train.take(held), train.take(keep)
    splits = list(train_validation_data_stratified(
        train.fnames, train.labels, class_map, args.n_folds,
        args.kfold_seed))
    noisy_splits = (list(train_validation_data(
        noisy.fnames, noisy.labels, args.n_folds, args.kfold_seed))
        if noisy is not None else None)
    return TrainingSets(train, test, holdout, noisy, splits, noisy_splits)


def fold_train_manifest(args, sets: TrainingSets, fold: int) -> tuple:
    """(files, label cells) of fold ``fold``'s train set: its curated train
    rows, then the noisy split's validation rows of the fold (every noisy
    row with ``--share_noisy``), as the JAX CLI builds them
    (``cli/common.py:324-345``)."""
    train_idx, _ = sets.splits[fold]
    part = sets.train.take(train_idx)
    files = [os.path.join(args.train_data_dir, f) for f in part.fnames]
    labels = list(part.labels)
    if sets.noisy is not None:
        sel = (range(len(sets.noisy.fnames)) if args.share_noisy
               else sets.noisy_splits[fold][1])
        noisy = sets.noisy.take(sel)
        files += [os.path.join(args.noisy_train_data_dir, f)
                  for f in noisy.fnames]
        labels += noisy.labels
    return files, labels


def run_training(args, model_kind: str = "2d_cnn",
                 extra_network: Optional[dict] = None) -> Experiment:
    """Train a ``model_kind`` model on each of ``args.folds``: fit and
    validate, save the final model, reload the best, write its out-of-fold
    predictions (and test predictions, and register the holdout's lwlrap);
    then ``finalize_results``. ``extra_network`` goes into the config's
    network section."""
    refuse_unported(args)
    device = resolve_device(args.device)
    class_map = load_classmap(args.classmap)
    n_classes = len(class_map)
    config = experiment_config(args, n_classes,
                               parse_features(args.features).n_features,
                               extra_network)
    with Experiment(config, experiments_dir=args.experiments_dir) \
            as experiment:
        print(experiment.config)
        sets = training_sets(args, class_map)
        ladder = default_ladder(args.max_audio_length)
        full_ladder = default_ladder(None)
        class_names = class_names_from_classmap(class_map)
        predictions = experiment.register_directory("predictions")
        batching = dict(
            batch_size=None if args.max_batch_elems else args.batch_size,
            max_batch_elems=args.max_batch_elems,
            num_workers=args.num_workers)

        def dataset(manifest, data_dir):
            return ClipDataset(
                [os.path.join(data_dir, f) for f in manifest.fnames],
                raw_labels=manifest.labels, classmap=class_map, sr=SR)

        for fold in args.folds:
            print(f"\n   -----  Fold {fold}\n")
            files, labels = fold_train_manifest(args, sets, fold)
            train_ds = ClipDataset(
                files, raw_labels=labels, classmap=class_map,
                max_audio_length=args.max_audio_length, sr=SR,
                seed=args.kfold_seed + fold)
            valid = sets.train.take(sets.splits[fold][1])
            train_loader = make_loader(train_ds, ladder, train=True,
                                       seed=args.kfold_seed, **batching)
            valid_loader = make_loader(dataset(valid, args.train_data_dir),
                                       full_ladder, **batching)
            # the head's dropout draws from PyTorch's default generator
            torch.manual_seed(args.kfold_seed + fold)
            engine = build_engine(args, experiment, n_classes, device,
                                  model_kind=model_kind)
            scores = engine.fit_validate(train_loader, valid_loader,
                                         epochs=args.epochs, fold=fold,
                                         log_interval=args.log_interval)
            experiment.register_result(f"fold{fold}.metric", max(scores))
            for key in ("loss", "clips_per_sec", "steps", "seconds"):
                experiment.register_result(
                    f"fold{fold}.train_{key}",
                    [float(e[key]) for e in engine.epoch_stats])
            engine.save_model(fold, "final_model")
            engine.load_model(fold, "best_model")
            write_predictions(
                os.path.join(predictions, f"val_preds_fold_{fold}.csv"),
                valid.fnames, class_names, engine.predict(valid_loader))
            if sets.test is not None:
                test_loader = make_loader(
                    dataset(sets.test, args.test_data_dir), full_ladder,
                    **batching)
                write_predictions(
                    os.path.join(predictions, f"test_preds_fold_{fold}.csv"),
                    sets.test.fnames, class_names,
                    engine.predict(test_loader))
            if sets.holdout is not None:
                holdout_metric = engine.evaluate(make_loader(
                    dataset(sets.holdout, args.train_data_dir), full_ladder,
                    batch_size=args.batch_size,
                    num_workers=args.num_workers))
                experiment.register_result(f"fold{fold}.holdout_metric",
                                           holdout_metric)
                print(f"\nHoldout metric: {holdout_metric:.4f}")
        finalize_results(experiment, sets.train, class_map, args.n_folds)
        return experiment


def finalize_results(experiment: Experiment, train: Manifest,
                     class_map: dict, n_folds: int) -> None:
    """The global OOF metric and the mean-of-folds submission (JAX
    ``finalize_results``): once every fold of ``n_folds`` has its result,
    register the lwlrap of all folds' OOF predictions against ``train``'s
    labels, both sorted by fname, as ``metric``; once every fold's
    ``test_preds_fold_k.csv`` exists, write their mean as
    ``submission.csv``."""
    class_names = class_names_from_classmap(class_map)
    pred_dir = os.path.join(experiment.experiment_dir, "predictions")
    if all(f"fold{k}" in experiment.results for k in range(n_folds)):
        fnames, _, values = read_prediction_files(
            [os.path.join(pred_dir, f"val_preds_fold_{k}.csv")
             for k in range(n_folds)], class_names)
        if set(fnames) != set(train.fnames):
            raise ValueError("the folds' OOF rows are not the train set")
        labels = binarize_label_strings(
            [cell_text(v) for v in train.labels], class_map)
        pred_order = sorted(range(len(fnames)), key=lambda i: fnames[i])
        label_order = sorted(range(len(train.fnames)),
                             key=lambda i: train.fnames[i])
        metric = lwlrap(labels[label_order], values[pred_order])
        experiment.register_result("metric", metric)
        print(f"\nGlobal OOF lwlrap: {metric:.4f}")

    test_files = [os.path.join(pred_dir, f"test_preds_fold_{k}.csv")
                  for k in range(n_folds)]
    if all(os.path.isfile(f) for f in test_files):
        folds = [read_prediction_files([f], class_names)
                 for f in test_files]
        write_predictions(os.path.join(pred_dir, "submission.csv"),
                          folds[0][0], class_names,
                          np.mean([v for _, _, v in folds], axis=0))
