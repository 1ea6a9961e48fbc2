"""The port's benchmark, the counterpart of the repository's ``bench.py``:
5-fold mel-CNN inference in clips/s, and the train step with and without
augmentation.

    python -m freesound_classification_tpu_torch.bench

Workloads, as ``bench.py``'s:

- **Inference.** 1120 synthetic clips with the FSDKaggle2019 test-length mix
  (lognormal, 1-15 s at 44.1 kHz: ``bench.py``'s numpy draws, so the same
  lengths), bucketed on the ladder from 1 s, batched within a bucket to at
  most 128 x 10 s of samples in equal chunks whose filler rows repeat the
  bucket's first clips (executed, not counted). The reference-scale 2d CNN
  (6 blocks, base depth 64, growth 1.5, max aggregation, deep supervision
  from block 2, 80 classes) in bf16, 5 folds (one random draw and per-fold
  perturbations, ``random_fold_variables``), through ``EnsemblePredictor``
  with the log-mel frontend (``torch.stft``, then K1). A warm-up over every
  batch, then one timed pass: wall clock ending in
  ``torch.cuda.synchronize()``. ``bench.py`` runs its model with
  ``fused_infer=False`` as this one does, and its block0 ``phase_pool`` is a
  TPU lowering of the same function.
- **Train step.** B = 64 clips x 10 s, ``mel_2048_1024_128``, the same model
  in bf16, LSEP, Adam at lr 1e-3 without weight decay, driven through
  ``Engine.train_step``; with no augmentation, and with the augmenter
  ``p_mixup=0.5, p_aug=0.75, p_shuffle=0.5`` mixing the batch with itself
  (``bench.py`` passes no partner). ms per step by CUDA events over 20 steps
  after one warm-up step.

Output: the card's ``nvidia-smi`` name and power limit, a ``# pad_fraction``
line, a ``# kernel launches`` line (K1, K2, K3 per workload), and last one
JSON line with ``bench.py``'s keys: ``metric``, ``value``, ``unit``,
``vs_baseline`` (against the reference's 1120 clips per minute), ``mfu``,
``train_step_ms_noaug``, ``train_step_ms_aug``, ``train_mfu_noaug``,
``train_mfu_aug`` and ``train_mfu`` (the no-augmentation one).

MFU counts FLOPs with ``torch.utils.flop_counter.FlopCounterMode``, which
sees convolutions and matrix products only (``bench.py``'s XLA
``cost_analysis`` counted every operation): one forward per batch shape x 5
folds, and one train step's forward and backward, against 989e12 FLOP/s
(dense bf16). Left out: ``hbm_gbps``, ``hbm_gbps_xla_ub`` and
``train_hbm_gbps_*``, which read XLA's post-fusion HLO traffic
(``utils/hlo_traffic.py``); PyTorch has no counterpart of it.

``run`` takes the sizes as arguments, so the CPU tests can run it small
(``device="cpu"``: host clock, the kernels' plain twins); the module's entry
point runs the sizes above on the card, and raises without one.
"""

from __future__ import annotations

import json
import subprocess
import time
import types

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import common
from freesound_classification_tpu_torch.data.bucketing import (
    bucket_of,
    make_bucket_ladder,
)
from freesound_classification_tpu_torch.models.classifiers import (
    TwoDimensionalCNN,
)
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops import kernels
from freesound_classification_tpu_torch.ops.augment import (
    AugmentConfig,
    make_augmenter,
)
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.training.ensemble import (
    EnsemblePredictor,
)
from freesound_classification_tpu_torch.training.state import create_model

SR = 44100
N_CLASSES = 80
N_FOLDS = 5
N_CLIPS = 1120  # stage-1 test scale
BASELINE_CLIPS_PER_SEC = 1120.0 / 60.0  # the reference: ~1 min for the job
FEATURES = "mel_2048_1024_128"
NETWORK = {"num_conv_blocks": 6, "start_deep_supervision_on": 2,
           "conv_base_depth": 64, "growth_rate": 1.5,
           "aggregation_type": "max"}
MAX_BATCH_ELEMS = 128 * SR * 10
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
COUNTED = {"K1": kernels.mel_project_log, "K2": kernels.resample_linear,
           "K3": kernels.pv_resynth}


def synthetic_clip_lengths(n: int, seed: int = 0) -> np.ndarray:
    """FSDKaggle2019-ish test length distribution: 1-15 s, median ~5 s
    (``bench.py``'s draws)."""
    rng = np.random.RandomState(seed)
    secs = np.clip(rng.lognormal(mean=1.45, sigma=0.6, size=n), 1.0, 15.0)
    return (secs * SR).astype(np.int64)


def _perturbed(tree: dict, rng: np.random.RandomState) -> dict:
    # sorted keys: the leaf order of jax.tree.map over the same dicts
    return {k: _perturbed(v, rng) if isinstance(v, dict)
            else v + (0.01 * rng.randn(*v.shape)).astype(v.dtype)
            for k, v in sorted(tree.items())}


def _positive(tree: dict) -> dict:
    return {k: _positive(v) if isinstance(v, dict) else np.abs(v) + 0.05
            for k, v in tree.items()}


def random_fold_variables(n_folds: int = N_FOLDS, network: dict = NETWORK,
                          seed: int = 0) -> list:
    """``n_folds`` (params, batch_stats) of the 2d CNN in the JAX package's
    layout, as ``scripts/probe_dft_context.py`` makes its folds: one random
    draw (``interop.random_jax_variables``), then fold i adds 0.01 N(0, 1)
    from ``RandomState(100 + i)`` to every leaf (batch_stats first, as
    jax.tree.map visits {"batch_stats", "params"}), and every batch
    statistic becomes |v| + 0.05."""
    shape = {k: network[k] for k in ("num_conv_blocks",
                                     "start_deep_supervision_on",
                                     "conv_base_depth", "growth_rate")}
    params, stats = interop.random_jax_variables(**shape,
                                                 n_classes=N_CLASSES,
                                                 seed=seed)
    folds = []
    for i in range(n_folds):
        rng = np.random.RandomState(100 + i)
        fold_stats = _perturbed(stats, rng)
        folds.append((_perturbed(params, rng), _positive(fold_stats)))
    return folds


def fold_models(variables: list, network: dict = NETWORK,
                dtype: torch.dtype = torch.bfloat16) -> list:
    """The port's ``TwoDimensionalCNN`` of each fold's variables (on the
    CPU, eval mode)."""
    models = []
    for params, stats in variables:
        model = TwoDimensionalCNN(**network, n_classes=N_CLASSES, dtype=dtype)
        model.load_state_dict(interop.from_jax_variables(params, stats))
        models.append(model.eval())
    return models


def inference_plan(lengths: np.ndarray,
                   max_batch_elems: int = MAX_BATCH_ELEMS) -> list:
    """``bench.py``'s batches: [(bucket length, clip ids)], per bucket of
    the ladder from 1 s, in equal chunks of at most ``max_batch_elems``
    samples (8 to 512 clips), the last chunk filled up with the bucket's
    first clips."""
    ladder = make_bucket_ladder(int(lengths.max()), min_length=SR)
    buckets = bucket_of(lengths, ladder)
    plan = []
    for b, bucket_length in enumerate(ladder):
        ids = np.flatnonzero(buckets == b)
        if ids.size == 0:
            continue
        bs_cap = max(min(int(max_batch_elems // bucket_length), 512), 8)
        nb = -(-len(ids) // bs_cap)
        bs = -(-len(ids) // nb)
        padded = np.concatenate([ids, ids[: nb * bs - len(ids)]])
        plan += [(bucket_length, padded[k: k + bs])
                 for k in range(0, len(padded), bs)]
    return plan


def inference_batches(lengths: np.ndarray, plan: list, device) -> list:
    """Each planned batch as (wave (B, L) float32, lengths (B,) int32) on
    ``device``: N(0, 0.1^2) samples from one ``RandomState(1)`` in plan
    order, zero past each clip's length (``bench.py``'s waves)."""
    rng = np.random.RandomState(1)
    batches = []
    for bucket_length, chunk in plan:
        wave = rng.randn(len(chunk), bucket_length).astype(np.float32) * 0.1
        for row, i in enumerate(chunk):
            wave[row, lengths[i]:] = 0.0
        batches.append((torch.from_numpy(wave).to(device),
                        torch.from_numpy(lengths[chunk].astype(np.int32))
                        .to(device)))
    return batches


def inference_predictor(models: list, device) -> EnsemblePredictor:
    """The bench's inference program: the log-mel frontend (K1) and the
    fold models on ``device``."""
    return EnsemblePredictor(models, Frontend(FEATURES, "2d", sr=SR,
                                              device=device), device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def _since(before: dict) -> dict:
    return {name: n - before[name] for name, n in _launches().items()}


def bench_inference(device: torch.device, n_clips: int = N_CLIPS,
                    network: dict = NETWORK, n_folds: int = N_FOLDS,
                    max_batch_elems: int = MAX_BATCH_ELEMS) -> tuple:
    """The 5-fold inference workload; returns (clips/s, FLOPs of the timed
    pass, pad_fraction, filler rows, rows, kernel launches)."""
    models = fold_models(random_fold_variables(n_folds, network), network)
    predictor = inference_predictor(models, device)
    lengths = synthetic_clip_lengths(n_clips)
    plan = inference_plan(lengths, max_batch_elems)
    batches = inference_batches(lengths, plan, device)
    n_rows = sum(len(chunk) for _, chunk in plan)
    before = _launches()
    for wave, ln in batches:  # warm-up: every batch shape
        predictor.predict_batch(wave, ln)
    _sync(device)
    flops_by_shape: dict = {}
    for wave, ln in batches:
        if wave.shape not in flops_by_shape:
            with FlopCounterMode(display=False) as counter:
                predictor.predict_batch(wave, ln)
            flops_by_shape[wave.shape] = counter.get_total_flops()
    total_flops = float(sum(flops_by_shape[w.shape] for w, _ in batches))
    _sync(device)
    t0 = time.perf_counter()
    for wave, ln in batches:
        predictor.predict_batch(wave, ln)
    _sync(device)
    dt = time.perf_counter() - t0
    return (n_clips / dt, total_flops / dt, (n_rows - n_clips) / n_rows,
            n_rows - n_clips, n_rows, _since(before))


def train_batch(device: torch.device, batch: int = 64,
                seconds: float = 10) -> tuple:
    """The train-step workload's batch, (wave, lengths, labels) on
    ``device``: ``bench.py``'s draws from ``RandomState(0)``."""
    b, length = batch, int(SR * seconds)
    rng = np.random.RandomState(0)
    wave = torch.from_numpy(rng.randn(b, length).astype(np.float32)
                            * 0.1).to(device)
    lengths = torch.full((b,), length, dtype=torch.int32, device=device)
    labels = torch.from_numpy((rng.rand(b, N_CLASSES) < 0.05).astype(
        np.float32)).to(device)
    return wave, lengths, labels


def train_engine(device: torch.device, network: dict, augment: bool,
                 n: int) -> Engine:
    """The train-step workload's engine: the bf16 model from seed 0, Adam,
    and with ``augment`` the chain of ``bench.py`` (p_mixup 0.5, p_aug 0.75,
    p_shuffle 0.5), ready for ``n`` steps."""
    train_config = types.SimpleNamespace(
        optimizer="adam", learning_rate=1e-3, scheduler="steplr_1_1.0",
        weight_decay=0.0)
    augmenter = make_augmenter(AugmentConfig(
        p_mixup=0.5, p_aug=0.75, p_shuffle=0.5)) if augment else None
    model = create_model(types.SimpleNamespace(**network), N_CLASSES,
                         torch.bfloat16, seed=0, device=device)
    engine = Engine(model, Frontend(FEATURES, "2d", sr=SR, device=device),
                    train_config, loss="lsep", augment=augmenter, seed=0,
                    device=device)
    engine.make_optimizer(max_steps=n + 2, steps_per_epoch=n + 2)
    return engine


def bench_train_steps(device: torch.device, network: dict = NETWORK,
                      batch: int = 64, seconds: float = 10,
                      n: int = 20) -> tuple:
    """The train-step workload without and with augmentation; returns
    (bench.py's train keys, kernel launches per variant)."""
    wave, lengths, labels = train_batch(device, batch, seconds)
    out, launches = {}, {}
    for key in ("noaug", "aug"):
        engine = train_engine(device, network, key == "aug", n)
        before = _launches()
        with FlopCounterMode(display=False) as counter:
            engine.train_step(wave, lengths, labels)
        flops = counter.get_total_flops()
        engine.train_step(wave, lengths, labels)  # warm-up
        _sync(device)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                engine.train_step(wave, lengths, labels)
            end.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(end) / n
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                engine.train_step(wave, lengths, labels)
            ms = (time.perf_counter() - t0) / n * 1e3
        launches[f"train_{key}"] = _since(before)
        out[f"train_step_ms_{key}"] = ms
        out[f"train_mfu_{key}"] = flops / (ms * 1e-3) / PEAK_BF16
    out["train_mfu"] = out["train_mfu_noaug"]
    return out, launches


def device_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run(device: str = "cuda", n_clips: int = N_CLIPS,
        network: dict = NETWORK, n_folds: int = N_FOLDS,
        max_batch_elems: int = MAX_BATCH_ELEMS, train_batch: int = 64,
        train_seconds: float = 10, train_steps: int = 20) -> dict:
    """Both workloads on ``device``; prints the lines described above and
    returns the JSON record."""
    device = common.resolve_device(device)
    print(device_line(device), flush=True)
    clips_per_sec, flop_rate, pad_fraction, filler, n_rows, infer_launches = \
        bench_inference(device, n_clips, network, n_folds, max_batch_elems)
    print(f"# pad_fraction={pad_fraction:.4f} ({filler} filler rows of "
          f"{n_rows}; reported clips/s undercounts by this fraction)",
          flush=True)
    record = {
        "metric": "5fold_melcnn_inference_clips_per_sec_per_chip",
        "value": clips_per_sec,
        "unit": "clips/s",
        "vs_baseline": clips_per_sec / BASELINE_CLIPS_PER_SEC,
        "mfu": flop_rate / PEAK_BF16,
    }
    train, train_launches = bench_train_steps(
        device, network, train_batch, train_seconds, train_steps)
    record.update(train)
    print("# kernel launches " + json.dumps(
        {"inference": infer_launches, **train_launches}), flush=True)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    run()
