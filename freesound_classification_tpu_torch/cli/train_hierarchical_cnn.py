"""Train the 1d hierarchical CNN (JAX ``cli/train_hierarchical_cnn.py``).

    python -m freesound_classification_tpu_torch.cli.train_hierarchical_cnn \\
        --train_df train.csv --train_data_dir train --classmap classmap.json \\
        --features mel_2048_1024_128 --aggregation_type max --optimizer adam \\
        --num_conv_blocks 6 --conv_base_depth 64 --growth_rate 1.5 \\
        --folds 0 --n_folds 5 [--device cuda] [--bf16] [--p_aug 0.75] ...

The same flags and per-fold loop as ``train_2d_cnn``, with the model
``HierarchicalCNN`` over per-frame features in the "1d" layout (B, T, F):
``mel_*`` (K1), ``stft_*`` or ``raw``. Writes
``checkpoints/fold_k/{best,final}_model.npz``, which the predict CLI reads
with ``--model_kind hierarchical_cnn`` and the finetune CLI warm-starts
from.
"""

from __future__ import annotations

import argparse

from freesound_classification_tpu_torch.cli import common


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    common.add_train_arguments(parser)
    args = parser.parse_args(argv)
    return common.run_training(args, "hierarchical_cnn")


if __name__ == "__main__":
    main()
