"""Predict with a trained experiment's per-fold best models
(JAX ``cli/predict_2d_cnn.py``).

    python -m freesound_classification_tpu_torch.cli.predict_2d_cnn \\
        --experiment experiments/<name> --test_df sample_submission.csv \\
        --test_data_dir test --classmap classmap.json --output_df preds.csv

Reads the experiment's ``config.json`` and each fold's
``checkpoints/fold_k/best_model.npz`` (written by the port's train CLIs, or
from a JAX checkpoint by ``scripts/export_fold_weights.py``), runs the fold
ensemble over the test CSV, and writes ``fname`` plus the sorted class
columns. ``--model_kind`` picks the family: ``2d_cnn`` (the default),
``hierarchical_cnn`` or ``backbone_cnn``. On CUDA a log-mel frontend always
runs the hand-written kernel K1. ``build_predictor(..., fused_infer=True)``
runs the eval resnet blocks through the fused kernels (K4/K5 in 2d, K6 in
1d, K7 in the backbone) and ``fused_head=True`` the 2d block0 head through
K8; they are library options with no flag, off by default, as in the JAX
package.
"""

from __future__ import annotations

import argparse
import os

import torch

from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import common
from freesound_classification_tpu_torch.data.dataset import (
    ClipDataset,
    class_names_from_classmap,
    load_classmap,
    read_manifest,
)
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.models.classifiers import (
    build_classifier,
)
from freesound_classification_tpu_torch.models.frontend import (
    MODEL_FAMILY,
    Frontend,
)
from freesound_classification_tpu_torch.ops import dsp, kernels
from freesound_classification_tpu_torch.training.ensemble import (
    EnsemblePredictor,
)
from freesound_classification_tpu_torch.utils.experiment import Experiment


def add_predict_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--experiment", required=True, type=str,
                        help="path to the experiment directory")
    parser.add_argument("--test_df", required=True, type=str)
    parser.add_argument("--test_data_dir", required=True, type=str)
    parser.add_argument("--classmap", required=True, type=str)
    parser.add_argument("--output_df", required=True, type=str)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--max_batch_elems", type=int, default=None,
                        help="pack batches by total padded samples instead "
                             "of a fixed batch size")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--model_kind", type=str, default="2d_cnn",
                        choices=("2d_cnn", "hierarchical_cnn", "backbone_cnn"))
    parser.add_argument("--bf16", action="store_true", default=False,
                        help="bfloat16 model compute (params stay float32)")
    parser.add_argument("--folds", type=int, nargs="+", default=None,
                        help="folds to ensemble (default: all n_folds)")


def fold_weight_paths(experiment: Experiment, folds=None) -> list:
    if folds is None:
        folds = range(int(experiment.config.data._n_folds))
    return [os.path.join(experiment.experiment_dir, "checkpoints",
                         f"fold_{k}", "best_model.npz") for k in folds]


def build_predictor(
    experiment_dir: str,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
    mel_project: dsp.MelProject = kernels.mel_project_log,
    folds=None,
    model_kind: str = "2d_cnn",
    fused_infer: bool = False,
    fused_head: bool = False,
) -> EnsemblePredictor:
    """The fold ensemble of the ``model_kind`` experiment at
    ``experiment_dir`` on ``device``; ``fused_infer`` routes the eval-mode
    resnet blocks through the fused kernels, ``fused_head`` the 2d block0
    head through K8. A fold of another family than ``model_kind`` raises.

    The models are built on the ``meta`` device and take the fold arrays as
    their tensors (``assign=True``), so no default init runs only to be
    overwritten.
    """
    experiment = Experiment(resume_from=experiment_dir)
    cfg = experiment.config
    n_classes = int(cfg.data._n_classes)
    models = []
    for path in fold_weight_paths(experiment, folds):
        params, stats = interop.load_fold_npz(path)
        if interop.model_kind_of(params) != model_kind:
            raise ValueError(
                f"{path} holds a {interop.model_kind_of(params)} model, not "
                f"the {model_kind} that --model_kind asks for")
        with torch.device("meta"):
            model = build_classifier(
                model_kind, cfg.network, n_classes, dtype=dtype,
                fused_infer=fused_infer, fused_head=fused_head,
                input_dim=dsp.parse_features(cfg.data.features).n_features)
        model.load_state_dict(interop.from_jax_variables(params, stats),
                              assign=True)
        models.append(model)
    frontend = Frontend(cfg.data.features, MODEL_FAMILY[model_kind],
                        sr=common.SR, device=device, mel_project=mel_project)
    return EnsemblePredictor(models, frontend, device)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_predict_arguments(parser)
    args = parser.parse_args(argv)
    device = common.resolve_device(args.device)

    class_names = class_names_from_classmap(load_classmap(args.classmap))
    fnames, files = read_manifest(args.test_df, args.test_data_dir)
    loader = make_loader(
        ClipDataset(files, sr=common.SR), common.default_ladder(None),
        batch_size=(None if args.max_batch_elems else args.batch_size),
        max_batch_elems=args.max_batch_elems,
        num_workers=args.num_workers,
    )
    predictor = build_predictor(
        args.experiment, device,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        folds=args.folds, model_kind=args.model_kind)
    probs = predictor.predict_loader(loader)
    common.write_predictions(args.output_df, fnames, class_names, probs)
    print(f"wrote {args.output_df}")


if __name__ == "__main__":
    common.log_launches_at_exit()
    main()
