"""Shared CLI plumbing of the port (JAX ``cli/common.py``): the device, the
bucket ladder, the train CLIs' flag surface and their per-fold loop,
keyed by the model kind (``2d_cnn``, ``hierarchical_cnn`` or
``backbone_cnn``).

The train loop reads the manifests with the ``csv`` module, splits folds
with the port's own numpy stratification, trains each requested fold with
the ``Engine``, and writes ``checkpoints/fold_k/{best,final}_model.npz`` and
``predictions/val_preds_fold_k.csv``. Test predictions, ``submission.csv``,
the holdout split and the noisy set wait (ROADMAP M2.3), and periodic
checkpoints (M2.2): ``refuse_unported`` raises on their flags, and warns on
the flags that are accepted and have no effect yet.
"""

from __future__ import annotations

import argparse
import csv
import os
import warnings
from typing import Optional

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
    train_validation_data_stratified,
)
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.models.frontend import (
    MODEL_FAMILY,
    Frontend,
)
from freesound_classification_tpu_torch.ops.augment import (
    AugmentConfig,
    make_augmenter,
)
from freesound_classification_tpu_torch.ops.dsp import parse_features
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.training.state import create_model
from freesound_classification_tpu_torch.utils.device import resolve_device
from freesound_classification_tpu_torch.utils.experiment import Experiment

SR = 44100


def default_ladder(max_audio_length: Optional[float], sr: int = SR):
    """Bucket ladder covering up to max_audio_length (or ~30 s full clips)."""
    max_len = int((max_audio_length or 30) * sr)
    return bucketing.make_bucket_ladder(max_len, min_length=sr // 2)


def add_train_arguments(parser: argparse.ArgumentParser) -> None:
    """The JAX train CLI's flag surface (the reference's train_2d_cnn
    flags plus --loss, --bf16, --max_batch_elems, --experiments_dir and
    --mixup_exact_add). Flags of parts not ported yet are accepted and
    refused at run time with the ROADMAP item named."""
    add = parser.add_argument
    add("--train_df", required=True, type=str, help="path to train CSV")
    add("--train_data_dir", required=True, type=str)
    add("--noisy_train_df", type=str, help="not ported yet (ROADMAP M2.3)")
    add("--noisy_train_data_dir", type=str)
    add("--share_noisy", action="store_true", default=False)
    add("--resume", action="store_true", default=False,
        help="not ported yet (ROADMAP M2.2)")
    add("--test_data_dir", type=str,
        help="accepted with a warning; test predictions wait (ROADMAP "
             "M2.3)")
    add("--sample_submission", type=str,
        help="not ported yet (ROADMAP M2.3)")
    add("--classmap", required=True, type=str)
    add("--log_interval", default=10, type=int)
    add("--batch_size", type=int, default=64)
    add("--max_audio_length", type=int, default=10,
        help="max audio length in seconds; longer clips are cropped")
    add("--lr", default=0.01, type=float)
    add("--max_samples", type=int, help="not ported yet (ROADMAP M2.3)")
    add("--holdout_size", type=float, default=0.0,
        help="not ported yet (ROADMAP M2.3)")
    add("--epochs", default=100, type=int)
    add("--scheduler", type=str, default="steplr_1_0.5")
    add("--accumulation_steps", type=int, default=1)
    add("--save_every", type=int, default=1,
        help="accepted; away from 1 it warns: periodic checkpoints wait "
             "(ROADMAP M2.2)")
    add("--keep_checkpoints", type=int, default=0,
        help="accepted; away from 0 it warns (ROADMAP M2.2)")
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
        help="not ported yet (ROADMAP M5.3)")
    add("--fold_parallel", action="store_true", default=False,
        help="not ported yet (ROADMAP M5.2)")
    add("--mesh_devices", type=int, default=None,
        help="not ported yet (ROADMAP M5.1)")


def refuse_unported(args) -> None:
    """Raise on a flag whose part of the train driver is not ported yet;
    warn on one that is accepted and has no effect yet (``--test_data_dir``
    alone, which the JAX CLI needs only with ``--sample_submission``, and
    ``--save_every`` or ``--keep_checkpoints`` away from their defaults)."""
    waits = [
        (args.sample_submission is not None, "--sample_submission",
         "M2.3: test predictions and submission.csv"),
        (args.noisy_train_df is not None, "--noisy_train_df", "M2.3"),
        (bool(args.holdout_size), "--holdout_size", "M2.3"),
        (args.max_samples is not None, "--max_samples", "M2.3"),
        (args.resume, "--resume", "M2.2"),
        (args.accumulation_steps > 1, "--accumulation_steps > 1", "M2.2"),
        (args.profile, "--profile", "M5.3"),
        (args.fold_parallel, "--fold_parallel", "M5.2"),
        (args.mesh_devices is not None, "--mesh_devices", "M5.1"),
    ]
    for given, flag, item in waits:
        if given:
            raise NotImplementedError(
                f"{flag}: not ported yet (ROADMAP {item})")
    ignored = [
        (args.test_data_dir is not None, "--test_data_dir",
         "no test predictions are written (ROADMAP M2.3)"),
        (args.save_every != 1, "--save_every",
         "no periodic checkpoints are written (ROADMAP M2.2)"),
        (args.keep_checkpoints != 0, "--keep_checkpoints",
         "no periodic checkpoints are written (ROADMAP M2.2)"),
    ]
    for given, flag, effect in ignored:
        if given:
            warnings.warn(f"{flag} is accepted and has no effect yet: "
                          f"{effect}", UserWarning, stacklevel=2)


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
    fold's model."""
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
    return Engine(model, frontend, experiment.config.train, loss=args.loss,
                  augment=augment,
                  checkpoint_dir=experiment.register_directory("checkpoints"),
                  seed=seed, device=device,
                  warm_start_path=getattr(args, "warm_start_path", None))


def write_predictions(path: str, fnames, class_names, probs) -> None:
    """CSV of ``fname`` plus the sorted class columns."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["fname", *class_names])
        for name, row in zip(fnames, probs):
            writer.writerow([name, *(f"{v:.9g}" for v in row)])


def run_training(args, model_kind: str = "2d_cnn",
                 extra_network: Optional[dict] = None) -> Experiment:
    """Train a ``model_kind`` model on each of ``args.folds``: fit and
    validate, save the final model, reload the best and write its
    out-of-fold predictions. ``extra_network`` goes into the config's
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
        fnames, labels = read_csv_columns(args.train_df, ["fname", "labels"])
        splits = list(train_validation_data_stratified(
            fnames, labels, class_map, args.n_folds, args.kfold_seed))
        ladder = default_ladder(args.max_audio_length)
        full_ladder = default_ladder(None)
        class_names = class_names_from_classmap(class_map)
        predictions = experiment.register_directory("predictions")
        files = np.asarray([os.path.join(args.train_data_dir, f)
                            for f in fnames])
        labels = np.asarray(labels)
        batching = dict(
            batch_size=None if args.max_batch_elems else args.batch_size,
            max_batch_elems=args.max_batch_elems,
            num_workers=args.num_workers)
        for fold in args.folds:
            print(f"\n   -----  Fold {fold}\n")
            train_idx, valid_idx = splits[fold]
            train_ds = ClipDataset(
                files[train_idx], raw_labels=labels[train_idx],
                classmap=class_map, max_audio_length=args.max_audio_length,
                sr=SR, seed=args.kfold_seed + fold)
            valid_ds = ClipDataset(files[valid_idx],
                                   raw_labels=labels[valid_idx],
                                   classmap=class_map, sr=SR)
            train_loader = make_loader(train_ds, ladder, train=True,
                                       seed=args.kfold_seed, **batching)
            valid_loader = make_loader(valid_ds, full_ladder, **batching)
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
                [fnames[i] for i in valid_idx], class_names,
                engine.predict(valid_loader))
        return experiment
