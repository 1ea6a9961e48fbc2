"""Train the 2d mel-spectrogram CNN (JAX ``cli/train_2d_cnn.py``).

    python -m freesound_classification_tpu_torch.cli.train_2d_cnn \\
        --train_df train.csv --train_data_dir train --classmap classmap.json \\
        --features mel_2048_1024_128 --aggregation_type max --optimizer adam \\
        --folds 0 --n_folds 5 [--device cuda] [--bf16] [--p_aug 0.75] ...

Per fold: train with on-device augmentation (K2, K3 in the effects chain)
and the log-mel frontend (K1), validate each epoch, and write
``checkpoints/fold_k/{best,final}_model.npz`` (which the port's predict CLI
reads) and ``predictions/val_preds_fold_k.csv`` under
``<experiments_dir>/<config name>/``. With ``--fold_parallel`` the folds
train together as one stacked model (``training/multifold.py``) and write
the same files.
"""

from __future__ import annotations

import argparse

from freesound_classification_tpu_torch.cli import common


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    common.add_train_arguments(parser)
    args = parser.parse_args(argv)
    return common.run_training(args)


if __name__ == "__main__":
    common.log_launches_at_exit()
    main()
