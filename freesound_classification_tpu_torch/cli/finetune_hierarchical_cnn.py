"""Finetune a pretrained hierarchical CNN
(JAX ``cli/finetune_hierarchical_cnn.py``).

    python -m freesound_classification_tpu_torch.cli.finetune_hierarchical_cnn \\
        --pretrained_model experiments/<pretrained> --pretrained_fold 0 \\
        --train_df train.csv --train_data_dir train --classmap classmap.json \\
        --features mel_2048_1024_128 --aggregation_type max --optimizer adam \\
        --folds 0 --n_folds 5 [--device cuda] ...

The architecture (blocks, supervision start, base depth, growth) and the
features come from the pretrained experiment's ``config.json``, whatever
the flags say; every fold then warm-starts from the pretrained fold's
``checkpoints/fold_<pretrained_fold>/best_model.npz`` (weights and
BatchNorm statistics; the optimizer and step start fresh) and trains as
``train_hierarchical_cnn`` does; with ``--fold_parallel`` every fold of the
stacked model starts from those weights.
"""

from __future__ import annotations

import argparse
import os

from freesound_classification_tpu_torch.cli import common
from freesound_classification_tpu_torch.utils.experiment import Experiment


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    common.add_train_arguments(parser)
    parser.add_argument("--pretrained_model", required=True, type=str,
                        help="path to the pretrained experiment directory")
    parser.add_argument("--pretrained_fold", required=True, type=int)
    args = parser.parse_args(argv)

    pcfg = Experiment(resume_from=args.pretrained_model).config
    args.num_conv_blocks = int(pcfg.network.num_conv_blocks)
    args.start_deep_supervision_on = int(
        pcfg.network.start_deep_supervision_on)
    args.conv_base_depth = int(pcfg.network.conv_base_depth)
    args.growth_rate = float(pcfg.network.growth_rate)
    args.features = str(pcfg.data.features)
    args.warm_start_path = os.path.join(
        args.pretrained_model, "checkpoints",
        f"fold_{args.pretrained_fold}", "best_model.npz")
    if not os.path.isfile(args.warm_start_path):
        raise FileNotFoundError(
            f"no pretrained weights at {args.warm_start_path}")
    return common.run_training(args, "hierarchical_cnn")


if __name__ == "__main__":
    common.log_launches_at_exit()
    main()
