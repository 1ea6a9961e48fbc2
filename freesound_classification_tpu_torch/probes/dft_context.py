"""5-fold inference at the bench shape (B = 64 clips x 10 s) through two
featurizations: the counterpart of ``scripts/probe_dft_context.py``.

    python -m freesound_classification_tpu_torch.probes.dft_context

- **V1**, the bench's program: the log-mel ``Frontend`` (``torch.stft``,
  then K1) and the 5-fold bf16 ``EnsemblePredictor``.
- **V3**, the same folds behind ``FastFrontend``: one bf16 cat-DFT product
  per block offset, then the split mel kernel K9.

The folds are the bench's (``bench.random_fold_variables``: one random
draw, per-fold perturbations). The probe prints ms per call of each
(CUDA events over 20 calls after 3 warm-up calls, in turns V1, V3, V3, V1)
and V3 against V1: the largest |difference| of the probabilities and their
correlation.

The probe's V2 and V4 ("split dispatch": the featurization as a jit
program of its own, ahead of the model's) have no counterpart here: eager
PyTorch always dispatches the frontend and the model apart, so V1 and V3
are split already. No CUDA-graph variant is made; the JAX package has
none.
"""

from __future__ import annotations

import numpy as np
import torch

from freesound_classification_tpu_torch import bench
from freesound_classification_tpu_torch.cli import common
from freesound_classification_tpu_torch.ops.fast_featurize import FastFrontend
from freesound_classification_tpu_torch.training.ensemble import (
    EnsemblePredictor,
)


def predictors(models: list, device) -> dict:
    """{"V1": the bench's predictor, "V3": the same models behind
    ``FastFrontend``}."""
    v1 = bench.inference_predictor(models, device)
    v3 = EnsemblePredictor(v1.models, FastFrontend(
        bench.FEATURES, sr=bench.SR, device=device), device)
    return {"V1": v1, "V3": v3}


def compare(p1: torch.Tensor, p3: torch.Tensor) -> tuple:
    """(max |p3 - p1|, correlation of the two) over every probability."""
    a, b = p1.float().cpu().numpy().ravel(), p3.float().cpu().numpy().ravel()
    return float(np.abs(a - b).max()), float(np.corrcoef(a, b)[0, 1])


def ms_per_call(preds: dict, wave: torch.Tensor,
                lengths: torch.Tensor) -> dict:
    """Mean ms per ``predict_batch`` of each predictor by CUDA events, runs
    in turns (V1, V3, V3, V1), each after 3 warm-up calls."""
    times = {name: [] for name in preds}
    for name in ("V1", "V3", "V3", "V1"):
        for _ in range(3):
            preds[name].predict_batch(wave, lengths)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            preds[name].predict_batch(wave, lengths)
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / 20)
    return times


def main() -> None:
    batch, seconds = 64, 10
    device = common.resolve_device("cuda")
    print(bench.device_line(device), flush=True)
    models = bench.fold_models(bench.random_fold_variables())
    preds = predictors(models, device)
    length = int(bench.SR * seconds)
    rng = np.random.RandomState(0)
    wave = torch.from_numpy(rng.randn(batch, length).astype(np.float32)
                            * 0.1).to(device)
    lengths = torch.full((batch,), length, dtype=torch.int32, device=device)
    print(f"5-fold ensemble inference, B={batch} x {seconds:g} s:",
          flush=True)
    for name, runs in ms_per_call(preds, wave, lengths).items():
        label = {"V1": "V1 log-mel frontend (K1)",
                 "V3": "V3 bf16 cat-DFT + split mel kernel (K9)"}[name]
        print(f"  {label:44s} {np.mean(runs):8.3f} ms (runs "
              f"{', '.join(f'{r:.3f}' for r in runs)})", flush=True)
    diff, corr = compare(preds["V1"].predict_batch(wave, lengths),
                         preds["V3"].predict_batch(wave, lengths))
    print(f"V3 vs V1: max |prob diff| {diff:.3e}, corr {corr:.6f}",
          flush=True)


if __name__ == "__main__":
    main()
