"""Export a JAX-trained experiment's fold checkpoints for the PyTorch port.

    python scripts/export_fold_weights.py --experiment experiments/<name>

For every ``checkpoints/fold_k/best_model`` orbax directory of the
experiment, restores the model variables with the JAX package and writes
``checkpoints/fold_k/best_model.npz`` beside it: a
flat ``.npz`` of ``params`` and ``batch_stats`` that the port's predict CLI
reads (``freesound_classification_tpu_torch.interop.load_fold_npz``). Runs
wherever the JAX package runs; the port itself needs no JAX.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from freesound_classification_tpu.training import checkpoints as ckpt_lib  # noqa: E402
from freesound_classification_tpu_torch.interop import save_fold_npz  # noqa: E402


def export_experiment(experiment_dir: str) -> list:
    """Write ``best_model.npz`` beside every fold's best checkpoint; returns
    the written paths in fold order."""
    fold_dirs = sorted(
        glob.glob(os.path.join(experiment_dir, "checkpoints", "fold_*")),
        key=lambda d: int(d.rsplit("_", 1)[1]))
    written = []
    for fold_dir in fold_dirs:
        ckpt = os.path.join(fold_dir, "best_model")
        if not (os.path.exists(ckpt) or os.path.exists(ckpt + ".old")):
            continue
        # plain nested dicts: no model has to be rebuilt to restore them
        raw = ckpt_lib.restore_raw(ckpt)
        save_fold_npz(ckpt + ".npz", raw["params"], raw["batch_stats"])
        written.append(ckpt + ".npz")
    if not written:
        raise FileNotFoundError(
            f"no checkpoints/fold_*/best_model under {experiment_dir}")
    return written


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--experiment", required=True,
                        help="path to the experiment directory")
    args = parser.parse_args(argv)
    for path in export_experiment(args.experiment):
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
