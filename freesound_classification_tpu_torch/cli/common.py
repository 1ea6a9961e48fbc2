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
``--share_noisy``), trains each requested fold with the ``Engine`` (with
``--fold_parallel``, all of them together with the ``MultiFoldEngine``
of ``training/multifold.py``, one stacked model on the card), and
writes ``checkpoints/fold_k/{best,final,model_on_epoch_N}_model.npz``,
``predictions/val_preds_fold_k.csv`` and, with ``--sample_submission``,
``predictions/test_preds_fold_k.csv``. ``finalize_results`` then registers
the global out-of-fold lwlrap as ``metric`` once every fold has its result,
and writes the mean-of-folds ``submission.csv`` once every fold's test
predictions exist. ``--resume`` enters an existing experiment and continues
each fold from its ``last_model.pt`` bundle (the stacked run from
``checkpoints/multifold_resume.pt``), at any number of ranks and under any
fold layout; each fold's summaries go to
``summaries/fold_k/{train,valid}`` through tensorboardX where it imports.

Data parallel (``data_parallel``, JAX's ``--mesh_devices``): under
``torchrun --nproc_per_node N ... --mesh_devices N`` each rank is one
process with one card, the train loaders' batch sizes are trimmed to a
multiple of N, and the ``Engine`` steps on each rank's slice of the global
batch (``parallel/mesh.py``); rank 0 alone prints the per-fold lines and
writes the experiment's files. The predict and evaluate CLIs take the
same flag: each rank predicts its slice of every batch's rows
(``EnsemblePredictor.predict_loader(mesh=...)``), and rank 0 prints and
writes. Without ``torchrun`` the run is today's single process, and
``--mesh_devices`` above 1 raises.
With ``--fold_parallel`` and two or more folds under ``torchrun`` the
folds train over the ranks in JAX's fold layout (``training/multifold.
fold_layout``), for any number of ranks: each rank trains its fold
group's folds as one stacked model, on a group of d > 1 ranks data
parallel over the group (its rows of every fold, and the template engine
validating and predicting on the group: the valid, test and holdout
loaders go over the group's ranks). The group's place 0 writes those
folds' files and sends their results to rank 0, which registers them and
runs ``finalize_results`` once every owner has written (the gather waits
for it). The ranks share the experiment directory.
``log_launches_at_exit`` lets a run of several CLI processes (the recipe
kit, the ranks of a job) count each one's kernel launches.

The inference CLIs' test-time augmentation: ``reject_degenerate_tta``
refuses ``--n_tta > 1`` with every stochastic knob off, and
``make_tta_fn`` builds the on-device perturbation of the later passes
(chunk shuffle, then ``augment.tta_perturb``'s shift and noise).
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
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
    apply_shuffle_chunks,
    apply_tta_perturb,
    draw_shuffle_chunks,
    draw_tta_perturb,
    make_augmenter,
)
from freesound_classification_tpu_torch.ops.dsp import parse_features
from freesound_classification_tpu_torch.ops.metrics import lwlrap
from freesound_classification_tpu_torch.parallel import mesh as mesh_lib
from freesound_classification_tpu_torch.training import checkpoints, multifold
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.training.multifold import (
    MultiFoldEngine,
)
from freesound_classification_tpu_torch.training.state import create_model
from freesound_classification_tpu_torch.utils.device import resolve_device
from freesound_classification_tpu_torch.utils.experiment import Experiment

SR = 44100
LAUNCH_LOG_ENV = "FSC_LAUNCH_LOG"


def log_launches_at_exit() -> None:
    """Where ``$FSC_LAUNCH_LOG`` names a file, set every kernel wrapper's
    count to 0 and, at this process's exit, append to that file one JSON
    line: the program's ``argv``, its ``rank`` (``torchrun``'s ``RANK``, 0
    without it) and each wrapper's ``launches`` in it. The CLIs that run
    kernels call this when run as programs."""
    path = os.environ.get(LAUNCH_LOG_ENV)
    if not path:
        return
    for name in kernels.launch_counts():
        getattr(kernels, name).launches = 0

    def write() -> None:
        line = json.dumps({"argv": sys.argv,
                           "rank": int(os.environ.get("RANK", 0)),
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
    --mixup_exact_add, --profile and --fold_parallel). ``--mesh_devices``
    is the number of ranks ``torchrun`` started (``data_parallel``).
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
        help="enter an existing experiment and continue each fold from "
             "its last_model.pt bundle")
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
        help="train every fold of --folds together as one stacked model "
             "on the card (training/multifold.py); under torchrun, over "
             "the ranks in JAX's fold layout (fold groups, or fold-local)")
    add_mesh_argument(parser)


def add_mesh_argument(parser: argparse.ArgumentParser) -> None:
    """``--mesh_devices``, the ranks ``torchrun`` started
    (``data_parallel``)."""
    parser.add_argument(
        "--mesh_devices", type=int, default=None,
        help="data-parallel ranks, one process and one card each: launch "
             "with torchrun --nproc_per_node N ... --mesh_devices N "
             "(default: torchrun's world size, 1 without it)")


@contextlib.contextmanager
def data_parallel(args):
    """The run's ``parallel.mesh.Mesh`` from ``--mesh_devices``,
    ``--device`` and ``torchrun``'s environment; ranks above 0 print
    nothing inside, and the process group is destroyed on the way out."""
    mesh = mesh_lib.make_mesh(args.mesh_devices, args.device)
    try:
        with mesh.quiet():
            yield mesh
    finally:
        mesh.close()


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
                 model_kind: str = "2d_cnn",
                 mesh: Optional[mesh_lib.Mesh] = None) -> Engine:
    """A fresh ``model_kind`` model, the frontend of its family (K1 for
    mel features), the augmenter (K2, K3) and the engine for one fold;
    ``args.warm_start_path``, where the finetune CLI sets it, seeds every
    fold's model. With ``args.profile`` the engine traces epoch 1 into
    ``<experiment>/summaries/profile``. Each fit's summaries go to
    ``<experiment>/summaries/fold_k/{train,valid}`` where tensorboardX
    imports, and nowhere where it does not (JAX ``build_engine``). On a
    ``mesh`` the engine is a rank of the data-parallel job, and only rank
    0 traces and writes summaries."""
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
    summaries = experiment.register_directory("summaries")
    writes = mesh is None or mesh.is_writer
    profile_dir = (os.path.join(summaries, "profile")
                   if args.profile and writes else None)

    def writer_factory(fold: int, split: str):
        if not writes:
            return None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
        return SummaryWriter(
            log_dir=os.path.join(summaries, f"fold_{fold}", split))

    return Engine(model, frontend, experiment.config.train, loss=args.loss,
                  augment=augment,
                  checkpoint_dir=experiment.register_directory("checkpoints"),
                  seed=seed, device=device,
                  warm_start_path=getattr(args, "warm_start_path", None),
                  profile_dir=profile_dir,
                  summary_writer_factory=writer_factory, mesh=mesh)


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
    """Train a ``model_kind`` model on each of ``args.folds`` (with
    ``--resume``, from each fold's bundle where it has one): fit and
    validate, save the final model, reload the best, write its out-of-fold
    predictions (and test predictions, and register the holdout's lwlrap);
    then ``finalize_results``. With ``--fold_parallel`` and more than one
    fold the folds train together (``MultiFoldEngine``). Under ``torchrun``
    each fold trains data-parallel over the ranks (``data_parallel``).
    ``extra_network`` goes into the config's network section. Returns
    once every checkpoint is written."""
    with data_parallel(args) as mesh:
        experiment = _run_training(args, mesh, model_kind, extra_network)
    checkpoints.wait_for_saves()
    return experiment


def _run_training(args, mesh: mesh_lib.Mesh, model_kind: str,
                  extra_network: Optional[dict]) -> Experiment:
    device = mesh.device
    dp = mesh if mesh.distributed else None
    class_map = load_classmap(args.classmap)
    n_classes = len(class_map)
    config = experiment_config(args, n_classes,
                               parse_features(args.features).n_features,
                               extra_network)
    with Experiment(config, implicit_resuming=args.resume,
                    experiments_dir=args.experiments_dir,
                    mesh=dp) as experiment:
        print(experiment.config)
        sets = training_sets(args, class_map)
        ladder = default_ladder(args.max_audio_length)
        full_ladder = default_ladder(None)
        class_names = class_names_from_classmap(class_map)
        predictions = experiment.register_directory("predictions")
        fold_parallel = args.fold_parallel and len(args.folds) > 1
        folds = list(args.folds)
        # under torchrun the folds' groups go over the ranks, even on one
        # rank, so that its run goes through the collectives
        fold_mesh = (multifold.make_fold_mesh(mesh, folds)
                     if fold_parallel and mesh.distributed else None)
        # a fold group of d > 1 ranks: its template engine is on the group
        group = fold_mesh.data_group if fold_mesh is not None else None
        # the fold-parallel ranks take whole folds' train batches: their
        # train loaders are the folds' own, unsharded (JAX's
        # ``fold_loaders(f, 1)``); the other loaders go over the group
        train_mesh = None if fold_parallel else dp
        loader_mesh = group if fold_parallel else dp
        batching = dict(
            batch_size=None if args.max_batch_elems else args.batch_size,
            max_batch_elems=args.max_batch_elems,
            num_workers=args.num_workers)

        def dataset(manifest, data_dir):
            return ClipDataset(
                [os.path.join(data_dir, f) for f in manifest.fnames],
                raw_labels=manifest.labels, classmap=class_map, sr=SR)

        def fold_loaders(fold: int) -> tuple:
            """(train loader, valid loader, valid manifest) of ``fold``."""
            files, labels = fold_train_manifest(args, sets, fold)
            train_ds = ClipDataset(
                files, raw_labels=labels, classmap=class_map,
                max_audio_length=args.max_audio_length, sr=SR,
                seed=args.kfold_seed + fold)
            valid = sets.train.take(sets.splits[fold][1])
            return (make_loader(
                        train_ds, ladder, train=True, seed=args.kfold_seed,
                        size_multiple=1 if fold_parallel else mesh.world_size,
                        mesh=train_mesh, **batching),
                    make_loader(dataset(valid, args.train_data_dir),
                                full_ladder, mesh=loader_mesh, **batching),
                    valid)

        def train_stats(epoch_stats: list) -> dict:
            return {f"train_{key}": [float(e[key]) for e in epoch_stats]
                    for key in ("loss", "clips_per_sec", "steps", "seconds")}

        def register(fold: int, results: dict) -> None:
            for key, value in results.items():
                experiment.register_result(f"fold{fold}.{key}", value)

        def emit_fold_artifacts(engine: Engine, fold: int, valid_loader,
                                valid: Manifest, writes: bool) -> dict:
            """From ``fold``'s best model: its out-of-fold and test
            predictions and its holdout lwlrap (on a data-parallel mesh
            every rank predicts; the rank that ``writes`` writes).
            Returns ``{"holdout_metric": ...}`` with a holdout."""
            engine.load_model(fold, "best_model")

            def write(name, fnames, probs):
                if writes:
                    write_predictions(os.path.join(predictions, name),
                                      fnames, class_names, probs)

            write(f"val_preds_fold_{fold}.csv", valid.fnames,
                  engine.predict(valid_loader))
            if sets.test is not None:
                test_loader = make_loader(
                    dataset(sets.test, args.test_data_dir), full_ladder,
                    mesh=loader_mesh, **batching)
                write(f"test_preds_fold_{fold}.csv", sets.test.fnames,
                      engine.predict(test_loader))
            if sets.holdout is None:
                return {}
            holdout_metric = engine.evaluate(make_loader(
                dataset(sets.holdout, args.train_data_dir), full_ladder,
                batch_size=args.batch_size,
                num_workers=args.num_workers, mesh=loader_mesh))
            print(f"\nHoldout metric: {holdout_metric:.4f}")
            return {"holdout_metric": holdout_metric}

        if fold_parallel:
            own = fold_mesh.own_folds if fold_mesh is not None else folds
            layout = (", layout " + multifold.layout_record(
                fold_mesh.layout, folds) if fold_mesh is not None else "")
            print(f"\n   -----  Folds {folds} (parallel{layout})\n")
            loaders = [fold_loaders(fold) for fold in own]
            # the head's dropout draws from PyTorch's default generator;
            # every rank's template is the one process's, and at place j
            # of a fold group dropout starts from the place's seed
            seed = args.kfold_seed + folds[0]
            torch.manual_seed(seed)
            template = build_engine(args, experiment, n_classes, device,
                                    model_kind=model_kind, mesh=group)
            if group is not None:
                torch.manual_seed(group.rank_seed(seed))
            stack = MultiFoldEngine(template, own, fold_mesh=fold_mesh)
            best = stack.fit([t for t, _, _ in loaders],
                             [v for _, v, _ in loaders], epochs=args.epochs,
                             log_interval=args.log_interval,
                             resume=args.resume)
            stack.save_fold_models("final_model")
            # each fold's files are its group's place 0's; their results
            # reach rank 0 by a gather that returns once every owner has
            # written
            writes = group is None or group.is_writer
            results = []
            for k, fold in enumerate(own):
                stats = train_stats([
                    dict(e, loss=e["loss"][k],
                         clips_per_sec=e["clips"][k] / e["seconds"])
                    for e in stack.epoch_stats])
                results.append((fold, {"metric": float(best[k]), **stats,
                                       **emit_fold_artifacts(
                                           template, fold, *loaders[k][1:],
                                           writes=writes)}))
            for rank_results in mesh.all_gather_object(
                    results if writes else []):
                for fold, fold_results in rank_results:
                    register(fold, fold_results)
        else:
            for fold in args.folds:
                print(f"\n   -----  Fold {fold}\n")
                train_loader, valid_loader, valid = fold_loaders(fold)
                # the head's dropout draws from PyTorch's default
                # generator, each rank's from its own seed
                torch.manual_seed(mesh.rank_seed(args.kfold_seed + fold))
                engine = build_engine(args, experiment, n_classes, device,
                                      model_kind=model_kind, mesh=dp)
                scores = engine.fit_validate(
                    train_loader, valid_loader, epochs=args.epochs,
                    fold=fold, log_interval=args.log_interval,
                    resume=args.resume)
                experiment.register_result(f"fold{fold}.metric",
                                           max(scores))
                register(fold, train_stats(engine.epoch_stats))
                engine.save_model(fold, "final_model")
                register(fold, emit_fold_artifacts(
                    engine, fold, valid_loader, valid, mesh.is_writer))
        if mesh.is_writer:
            finalize_results(experiment, sets.train, class_map,
                             args.n_folds)
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


def reject_degenerate_tta(parser: argparse.ArgumentParser, args) -> None:
    """Error out when ``--n_tta > 1`` with every stochastic knob of
    ``add_tta_arguments`` off (JAX ``reject_degenerate_tta``): inference is
    deterministic, so such passes would all be the same."""
    stochastic = (args.tta_max_audio_length is not None
                  or args.tta_noise_snr_db > 0.0
                  or args.tta_shift_max_s > 0.0
                  or args.tta_shuffle_p > 0.0)
    if args.n_tta > 1 and not stochastic:
        parser.error(
            "--n_tta > 1 requires a stochastic TTA mode "
            "(--tta_max_audio_length, --tta_noise_snr_db, "
            "--tta_shift_max_s or --tta_shuffle_p): inference is "
            "deterministic, so TTA without one would average identical "
            "passes")


def add_tta_arguments(parser: argparse.ArgumentParser) -> None:
    """The inference CLIs' TTA flags, with JAX's defaults and help."""
    add = parser.add_argument
    add("--n_tta", type=int, default=1)
    add("--tta_max_audio_length", type=int, default=None,
        help="with --n_tta > 1, random-crop clips to this many seconds per "
             "TTA pass (the reference's only TTA mode)")
    add("--tta_noise_snr_db", type=float, default=0.0,
        help="with --n_tta > 1, add white noise this many dB below each "
             "clip's RMS on passes > 0 (on-device TTA; 0 = off)")
    add("--tta_shift_max_s", type=float, default=0.0,
        help="with --n_tta > 1, random right time-shift up to this many "
             "seconds on passes > 0 (on-device TTA; 0 = off)")
    add("--tta_shuffle_p", type=float, default=0.0,
        help="with --n_tta > 1, shuffle 0.5 s chunks with this probability "
             "on passes > 0 (the reference's intended ShuffleAudio TTA; "
             "0 = off)")


def make_tta_fn(noise_snr_db: float, shift_max_s: float,
                shuffle_p: float = 0.0):
    """The on-device TTA perturbation of the CLI knobs, ``fn(wave,
    lengths, generator) -> (wave, lengths)``: chunk shuffle at
    ``shuffle_p``, then ``tta_perturb``'s shift and noise (JAX
    ``make_tta_fn``). None when every knob is off."""
    if noise_snr_db <= 0.0 and shift_max_s <= 0.0 and shuffle_p <= 0.0:
        return None

    def fn(wave, lengths, gen):
        b, l = wave.shape
        if shuffle_p > 0.0:
            wave = apply_shuffle_chunks(
                wave, lengths, draw_shuffle_chunks(gen, b, l, shuffle_p,
                                                   sr=SR), sr=SR)
        draws = draw_tta_perturb(gen, b, l, noise_snr_db, shift_max_s, SR)
        return apply_tta_perturb(wave, lengths, draws, noise_snr_db)

    return fn
