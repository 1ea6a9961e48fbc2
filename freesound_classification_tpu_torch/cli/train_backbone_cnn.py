"""Train the resnet18/34 backbone classifier (JAX
``cli/train_backbone_cnn.py``).

    python -m freesound_classification_tpu_torch.cli.train_backbone_cnn \\
        --backbone resnet34 --train_df train.csv --train_data_dir train \\
        --classmap classmap.json --features mel_2048_1024_128 \\
        --aggregation_type max --optimizer adam --folds 0 --n_folds 5 \\
        [--device cuda] [--bf16] [--p_aug 0.75] [--output_dropout 0.5] ...

The same flags and per-fold loop as ``train_2d_cnn``, plus ``--backbone``
(written to the experiment's ``config.json`` as ``network.backbone``), with
the model ``CNNBackbone`` over the spectrogram image. The tower flags
(``--num_conv_blocks`` and the like) are recorded but shape nothing.
Writes ``checkpoints/fold_k/{best,final}_model.npz``, which the predict CLI
reads with ``--model_kind backbone_cnn``.
"""

from __future__ import annotations

import argparse

from freesound_classification_tpu_torch.cli import common
from freesound_classification_tpu_torch.models.backbone import RESNET_STAGES


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    common.add_train_arguments(parser)
    parser.add_argument("--backbone", type=str, default="resnet18",
                        choices=sorted(RESNET_STAGES))
    args = parser.parse_args(argv)
    return common.run_training(args, "backbone_cnn",
                               extra_network={"backbone": args.backbone})


if __name__ == "__main__":
    common.log_launches_at_exit()
    main()
