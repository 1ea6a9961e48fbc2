"""The self-supervised pretraining CLIs' shared driver (JAX
``cli/ssl_common.py``): ``train_apc`` and ``train_cpc``.

The JAX CLIs' flags (``--device`` defaults to ``cuda``; ``--mesh_devices``
N under ``torchrun --nproc_per_node N`` trains each fold data-parallel over
N ranks, ``common.data_parallel``). Rows are read with the ``csv`` module;
``--max_samples`` draws them as pandas' ``df.sample(n, random_state=
kfold_seed)`` does (``common.sample_rows``), and the folds are plain KFold
(``data/folds.train_validation_data``). Per fold: the 1d frontend (K1 for
mel features), the augmenter at ``--p_aug`` (the effects chain: K2, K3),
the model's own losses through the ``Engine``'s self-supervised mode
(validation score ``-loss``, which picks ``best_model.npz``), summaries
through tensorboardX where it imports, ``fold{k}.metric`` (the best score)
and each epoch's train loss, clips/s, steps and seconds in
``results.json``, ``final_model.npz``, and the representation probe
(``utils/projection.py``: 5-NN accuracy, and the TSNE image where sklearn
and matplotlib import), which never stops training.
"""

from __future__ import annotations

import argparse
import os

import torch

from freesound_classification_tpu_torch.cli import common
from freesound_classification_tpu_torch.data.dataset import (
    ClipDataset,
    load_classmap,
    read_csv_columns,
)
from freesound_classification_tpu_torch.data.folds import (
    train_validation_data,
)
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.models.apc import APCModel
from freesound_classification_tpu_torch.models.blocks import init_like_flax
from freesound_classification_tpu_torch.models.cpc import CPCModel
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops.augment import (
    AugmentConfig,
    make_augmenter,
)
from freesound_classification_tpu_torch.ops.dsp import parse_features
from freesound_classification_tpu_torch.training import checkpoints as ckpt_lib
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.utils.experiment import Experiment
from freesound_classification_tpu_torch.utils.projection import (
    projection_summary,
)


def add_ssl_arguments(parser: argparse.ArgumentParser) -> None:
    """The JAX SSL CLIs' flag surface."""
    add = parser.add_argument
    add("--train_df", required=True, type=str)
    add("--train_data_dir", required=True, type=str)
    add("--classmap", required=True, type=str)
    add("--resume", action="store_true", default=False)
    add("--log_interval", default=10, type=int)
    add("--batch_size", type=int, default=32)
    add("--max_audio_length", type=int, default=10)
    add("--lr", default=0.001, type=float)
    add("--max_samples", type=int)
    add("--epochs", default=100, type=int)
    add("--scheduler", type=str, default="steplr_1_0.5")
    add("--accumulation_steps", type=int, default=1)
    add("--save_every", type=int, default=1)
    add("--keep_checkpoints", type=int, default=0,
        help="keep only the newest K periodic checkpoints (0 = all)")
    add("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    add("--weight_decay", type=float, default=1e-5)
    add("--p_aug", type=float, default=0.0)
    add("--switch_off_augmentations_on", type=int, default=10**9)
    add("--features", type=str, required=True)
    add("--optimizer", type=str, required=True, choices=("adam", "momentum"))
    add("--folds", type=int, required=True, nargs="+")
    add("--n_folds", type=int, default=4)
    add("--kfold_seed", type=int, default=42)
    add("--num_workers", type=int, default=4)
    add("--label", type=str, default="ssl")
    add("--proj_interval", type=int, default=10,
        help="epochs between KNN/TSNE projection summaries")
    add("--rnn_size", type=int, default=256)
    add("--rnn_layers", type=int, default=3)
    add("--prediction_steps", type=int, default=3)
    add("--context_size", type=int, default=256)
    add("--n_encoder_layers", type=int, default=5)
    add("--conv_base_depth", type=int, default=32)
    add("--growth_rate", type=float, default=2.0)
    add("--experiments_dir", type=str, default="experiments")
    add("--mesh_devices", type=int, default=None,
        help="data-parallel ranks, one process and one card each: launch "
             "with torchrun --nproc_per_node N ... --mesh_devices N "
             "(default: torchrun's world size, 1 without it)")


def build_ssl_model(kind: str, args, input_dim: int,
                    seed: int = 42) -> torch.nn.Module:
    """The ``kind`` ("apc" or "cpc") model of the flags over ``input_dim``
    features a frame, initialized as flax's from ``seed``."""
    if kind == "apc":
        model = APCModel(input_dim, rnn_size=args.rnn_size,
                         rnn_layers=args.rnn_layers,
                         prediction_steps=args.prediction_steps)
    elif kind == "cpc":
        model = CPCModel(input_dim, n_encoder_layers=args.n_encoder_layers,
                         conv_base_depth=args.conv_base_depth,
                         growth_rate=args.growth_rate,
                         context_size=args.context_size,
                         prediction_steps=args.prediction_steps)
    else:
        raise ValueError(f"unknown self-supervised model {kind!r}")
    init_like_flax(model, torch.Generator().manual_seed(seed))
    return model


def ssl_config(args, kind: str, n_classes: int, input_dim: int) -> dict:
    """The JAX SSL CLI's experiment config."""
    network = {"prediction_steps": args.prediction_steps}
    if kind == "apc":
        network.update(rnn_size=args.rnn_size, rnn_layers=args.rnn_layers)
    else:
        network.update(context_size=args.context_size,
                       n_encoder_layers=args.n_encoder_layers,
                       conv_base_depth=args.conv_base_depth,
                       growth_rate=args.growth_rate)
    return {
        "network": network,
        "data": {
            "features": args.features,
            "_n_folds": args.n_folds,
            "_kfold_seed": args.kfold_seed,
            "_input_dim": input_dim,
            "_n_classes": n_classes,
            "p_aug": args.p_aug,
            "max_audio_length": args.max_audio_length,
            "_train_df": args.train_df,
            "_train_data_dir": args.train_data_dir,
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
            "_proj_interval": args.proj_interval,
        },
        "label": args.label,
    }


def run_ssl_training(args, kind: str) -> Experiment:
    """Pretrain a ``kind`` model on each of ``args.folds`` (data-parallel
    under ``torchrun``: rank 0 writes, and runs the representation probe);
    returns the experiment once every checkpoint is written."""
    with common.data_parallel(args) as mesh:
        experiment = _run_ssl_training(args, kind, mesh)
    ckpt_lib.wait_for_saves()
    return experiment


def _run_ssl_training(args, kind: str, mesh) -> Experiment:
    device = mesh.device
    dp = mesh if mesh.distributed else None
    class_map = load_classmap(args.classmap)
    input_dim = parse_features(args.features).n_features
    config = ssl_config(args, kind, len(class_map), input_dim)
    with Experiment(config, implicit_resuming=args.resume,
                    experiments_dir=args.experiments_dir,
                    mesh=dp) as experiment:
        print("\n     ////// CONFIG //////")
        print(experiment.config)
        fnames, labels = read_csv_columns(args.train_df, ["fname", "labels"])
        if args.max_samples:
            rows = common.sample_rows(len(fnames), args.max_samples,
                                      args.kfold_seed)
            fnames = [fnames[i] for i in rows]
            labels = [labels[i] for i in rows]
        splits = list(train_validation_data(fnames, labels, args.n_folds,
                                            args.kfold_seed))
        ladder = common.default_ladder(args.max_audio_length)
        checkpoints = experiment.register_directory("checkpoints")
        summaries = experiment.register_directory("summaries")

        def dataset(rows, seed=42):
            return ClipDataset(
                [os.path.join(args.train_data_dir, fnames[i]) for i in rows],
                raw_labels=[labels[i] for i in rows], classmap=class_map,
                max_audio_length=args.max_audio_length, sr=common.SR,
                seed=seed)

        def writer_factory(fold: int, split: str):
            if not mesh.is_writer:
                return None
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return None
            return SummaryWriter(
                log_dir=os.path.join(summaries, f"fold_{fold}", split))

        for fold in args.folds:
            print(f"\n\n   -----  Fold {fold}\n")
            train_idx, valid_idx = splits[fold]
            engine = Engine(
                build_ssl_model(kind, args, input_dim),
                Frontend(args.features, "1d", sr=common.SR, device=device),
                experiment.config.train,
                augment=make_augmenter(AugmentConfig(p_aug=args.p_aug,
                                                     sr=common.SR)),
                checkpoint_dir=checkpoints, device=device,
                summary_writer_factory=writer_factory, self_supervised=True,
                mesh=dp)
            train_loader = make_loader(
                dataset(train_idx, args.kfold_seed + fold), ladder,
                batch_size=args.batch_size, train=True, seed=args.kfold_seed,
                size_multiple=mesh.world_size, num_workers=args.num_workers,
                mesh=dp)
            valid_loader = make_loader(
                dataset(valid_idx), ladder, batch_size=args.batch_size,
                num_workers=args.num_workers, mesh=dp)
            scores = engine.fit_validate(
                train_loader, valid_loader, epochs=args.epochs, fold=fold,
                log_interval=args.log_interval, resume=args.resume)
            experiment.register_result(f"fold{fold}.metric", max(scores))
            for key in ("loss", "clips_per_sec", "steps", "seconds"):
                experiment.register_result(
                    f"fold{fold}.train_{key}",
                    [float(e[key]) for e in engine.epoch_stats])
            engine.save_model(fold, "final_model")
            if not mesh.is_writer:
                continue
            # the probe runs on rank 0 alone, over every validation clip
            probe_loader = valid_loader if dp is None else make_loader(
                dataset(valid_idx), ladder, batch_size=args.batch_size,
                num_workers=args.num_workers)
            try:
                score = projection_summary(engine, probe_loader, summaries,
                                           fold)
            except Exception as err:  # a diagnostic never stops training
                print(f"projection summary skipped: {err}")
            else:
                experiment.register_result(f"fold{fold}.knn_accuracy",
                                           score)
        return experiment


def main_apc(argv=None) -> Experiment:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_ssl_arguments(parser)
    return run_ssl_training(parser.parse_args(argv), "apc")


def main_cpc(argv=None) -> Experiment:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_ssl_arguments(parser)
    return run_ssl_training(parser.parse_args(argv), "cpc")
