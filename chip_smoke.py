"""Run the PyTorch port's main paths once on one CUDA card, and check them.

    python3 chip_smoke.py

The paths, each driven through the CLI a user would call:

- predict: 5-fold inference of the reference-scale 2d mel CNN (6 blocks,
  base depth 64, growth 1.5, max aggregation, deep supervision from block 2,
  80 classes) through the port's predict CLI, in bf16, on ~200 synthetic
  clips with the bench's length distribution (1-15 s at 44.1 kHz). The fold
  weights are random, made from a seed in the JAX package's layout, and
  reach the port through ``interop`` as a JAX-trained fold would.
- train: the published recipe (scripts/reproduce_reference.sh: 5 blocks,
  base depth 100, growth 1.5, deep supervision from block 1, dropout 0.5,
  mel_2048_1024_128, 15 s crops, Adam 1cycle, MixUp 0.5, effects chain
  0.75, batch 20, bf16) through the port's train CLI, one fold, two short
  epochs on synthetic labelled clips; its best_model.npz then predicts
  through the predict CLI.
- the hierarchical 1d CNN (train, finetune, predict) at the predict path's
  width, and the resnet34 backbone (train with the recipe's optimizer and
  augmentation flags; 5-fold predict with random folds), each with the
  same inputs.
- the fused options of the 5-fold ensembles: ``fused_infer`` (K4/K5, K6,
  K7) and the 2d CNN's ``fused_head`` (K8), against the unfused CLIs.
- the probe (``probes/dft_context.py``): the bench's 5-fold bf16 ensemble
  at B = 64 x 10 s behind the log-mel frontend (V1, K1) and behind the fast
  featurization (V3: bf16 cat-DFT products, then K9).
- the bench (``python -m freesound_classification_tpu_torch.bench``): 5-fold
  inference over 1120 bucketed clips, and the B = 64 x 10 s train step
  with and without augmentation.
- the published recipe end to end: the port's kit
  (``freesound_classification_tpu_torch/recipes/reproduce_reference.sh``:
  class map, curated 5-fold round with test predictions and submission,
  noisy-set scoring and relabelling, the noisy round, the blend) on an
  FSDKaggle2019-layout mini dataset, and the train CLI's ``--profile``.
- the profiling probes (``probes/train_step_split.py``,
  ``probes/model_ablation.py``).
- the rest of the engine: the 2d train CLI with ``--accumulation_steps 2``
  killed after its first epoch and resumed with ``--resume``; test-time
  augmentation through the predict CLI; ``evaluate_2d_cnn`` on the recipe
  kit's curated experiment.
- fold-parallel training (``--fold_parallel``, ``training/multifold.py``):
  the recipe's 2d train CLI over the five folds as one stacked model; the
  stacked step against the five single-fold steps in turns
  (``probes/fold_parallel.py``); its float32 truth; its resume.
- fold-parallel training over ranks (``FoldMesh``): 4 folds on two gloo
  ranks sharing the card, against one process; the fold-parallel train
  CLI on one NCCL rank under ``torchrun``.
- inference on a mesh: the predict CLI under ``torchrun`` on one NCCL
  rank, and the fold ensemble's ``predict_loader(mesh=...)`` on two gloo
  ranks sharing the card.
- the reference's host transform API (``data/transforms.py``): its train
  stack with the effects chain on the card (K3, K2), with and without
  spawn DataLoader workers.
- the ``rnn`` aggregation: the recipe's train CLI with
  ``--aggregation_type rnn``, sequential and ``--fold_parallel``, and the
  predict CLI on the stacked run; the self-supervised CLIs ``train_apc``
  and ``train_cpc`` at their default widths; ``adversarial_test``.

Phases, each of which raises on failure (none catches its own):
  1. device: a CUDA card is required; prints nvidia-smi's name and power
     limit; the children's bytecode cache (``bytecode_cache``)
  2. build: compiles the port's CUDA sources, prints the seconds, while
     the host writes the paths' WAVs and random-weight experiments
  3. K1: the mel kernel against its plain twin at B=128 x 10 s,
     mel_2048_1024_128, float32, on the mel filterbank and on a dense one;
     the bands one bin up and the frames shifted by one fail by far; the
     bytes it moves beside the function's, and its launches by
     torch.profiler
  4. K2: the resample kernel against its plain twin at the effects chain's
     shape for the bench's train batch (48 of 64 rows x 10 s), unmasked and
     masked to valid lengths as the chain calls it; a wrong factor, a
     shifted wave and lengths a tenth of a clip short failing by far; timed
     beside grid_sample and the same mask (a yardstick the port never
     calls)
  5. K3: the phase-vocoder resynthesis against its plain twin at the same
     shape (n_fft 1024, hop 256), on a real analysis; shifted frames fail;
     the bytes it moves beside the function's, and its three launches by
     torch.profiler
  K6 (the hierarchical path's six block shapes, on the maps' channels-
     contiguous layout, with the layout the path hands it and the cost of
     a time-major one), K4/K5 (the 2d path's six block shapes), K7 (the
     backbone's four stage shapes) and K8
     (the 2d block0 head): each against its plain version at the paths'
     shapes, and three wrong inputs failing by far (shifted frames, another
     fold's weights, and padding the wrong tensor: x instead of h1, or x
     before bn_in); each timed in turns with its plain version and its
     bf16 folded twin on cuDNN (a yardstick the port never calls)
  K9: the split mel kernel against its plain twin at the probe's shape
     (64 x 431 frames of a bf16 [re | im] spectrum, F 1025, M 128), on the
     mel filterbank and on a dense one, and three wrong inputs failing by
     far (im_offset one bin off, frames shifted by one, the magnitude as one
     float32 chain)
  no sync: K2's and K3's wrappers once each under
     torch.cuda.set_sync_debug_mode("error"); then a factor and a rate out
     of their domains, each in a child process, which must fail naming the
     kernel
  step split: one augmented bench train step (B = 64 x 10 s) by
     torch.profiler: device busy time and idle share, K1's and K3's share,
     the ten longest kernels; then the probe's stages of that step, and of
     the bench's 5-fold inference of one 128 x 10 s batch, each timed alone
     (ms by events, busy ms and launches by torch.profiler); a stage that
     launched nothing fails
  ablation: the model-ablation probe's variants, ms by events
  6. predict path: the predict CLI with launch counts reset just before
     it; the CSV's schema and values; K1 launched; the predictions vary
     across clips by more than the bf16 tolerance, and the same ensemble
     through K1's plain twin agrees with them; on every batch of the run,
     K1's log-mel and the float32 ensemble's probabilities agree with the
     twin's; clips/s
  mesh predict (M5.4): the predict path's CLI as a child, then under
     ``torchrun --standalone --nproc_per_node 1 ... --mesh_devices 1``
     (NCCL): each CSV within the bf16 tolerance of the predict path's, K1
     launched as often as there, rank 0 alone reporting; each child's
     predict-loop clips/s; then ``predict_loader(mesh=...)`` on two ranks
     sharing the card over gloo: both ranks' rows the same, within the
     bf16 tolerance of the CSV, K1 once a batch on each rank; clips/s
  compat (M4.5): the reference's train stack (``data/transforms.py`` over
     ``data/sound_dataset.py``: LoadAudio, SampleLongAudio, MapLabels,
     ShuffleAudio, MixUp, AudioAugmentation(p=1) on the card,
     AudioFeatures, DropFields) over 11 clips of 2000 samples to 17 s,
     read through a DataLoader twice with no worker (a buffer's first
     chain call, then its later ones) and once with 2 spawn workers:
     each chain call launched K2 and K3 once and nothing else, and each
     launch agreed with its plain twin on the same arguments (K2 1e-6, K3
     2^-7 of the largest output), one at n_fft 512; samples/s; then the
     one-clip chain at 3000 samples, 5 s and 15 s: ms by events, device
     launches
  7. train path: the train CLI with the counts reset just before it; K1, K2
     and K3 launched; losses finite; parameters moved; best_model.npz
     predicts finite probabilities through the predict CLI; steps/s
  TTA: the predict CLI on the train path's fold over its labelled clips,
     bf16: --n_tta 1 bit for bit the clean pass; --n_tta 3 with the shift,
     noise and shuffle knobs, and with 5 s crops: K1 once a batch and pass,
     probabilities in [0, 1] whose mean difference from the clean ones is
     more than 0 and less than TTA_MEAN_DIFF; clips/s of each
  resume: the train CLI at the recipe's width (MixUp off), fold 0 of 125
     clips, 2 epochs of 5 steps, accumulation 2: straight; as a child
     SIGKILLed once its epoch-0 bundle (a partial mean in it) is on disk,
     then resumed with --resume (K1, K2 and K3 launched, epoch 1 only,
     the same global_step and epoch-0 score, final weights within
     RESUME_WEIGHT_TOL and 10x nearer than a run on other folds); a
     temporary named for the killed child's pid, planted beside its
     bundle, is gone after the resumed run, and no checkpoint directory of
     the three runs (on the writer and synchronous) holds a ``*.tmp-*``
     file
  fold parallel: the train CLI at the recipe's width with
     ``--fold_parallel`` over folds 0-4 of the 150 labelled clips, 2
     epochs: every fold's best and final models and OOF CSV, five fold
     metrics and the global one, each fold moved from the init and apart
     from the others, fold 0 predicts; K1 once per stacked step and K2
     and K3 per fold within the stacked epochs; stacked steps/s and
     fold-steps/s; peak memory. Then the stacked step over 5 x 20 x 15 s
     against 5 single-fold steps, 3 warm-ups and 10 calls each in turns
     (ms by events, busy ms and launches by torch.profiler, peak memory);
     the first float32 step's per-fold losses (1e-4) and gradients (1e-2
     of each fold's largest) against the single-fold steps', from
     ``phase_f32_step``'s weights on 5 of its batches, each beside the
     single step's own spread on reversed rows (run beside the resume's
     killed child); and the resume phase's runs over two of the folds
     stacked (every fold's final weights within RESUME_WEIGHT_TOL of the
     straight run's)
  data parallel (M5.1): the train path's CLI under ``torchrun
     --standalone --nproc_per_node 1 ... --mesh_devices 1`` (NCCL's
     process group and collectives, rank-0 writes): the train path's
     files, K1-K3 launched on the rank, last-epoch steps/s beside the
     train path's; then two ranks sharing cuda:0 over a gloo group, each a
     process with 3 of the float32 step's 6 rows, against the same step in
     one process: loss 1e-4, gradients 1e-2 of the model's largest,
     BatchNorm statistics 1e-4 of each tensor's largest, and the ranks'
     gradients and statistics equal
  fold mesh (M5.2a): two ranks sharing cuda:0 over a gloo group, each a
     process training 2 of 4 folds (8, 6, 7 and 8 clips x 5 s, float32,
     the predict path's width, the recipe's augmentation) on its
     ``FoldMesh``: K1 once a stacked step and K2 and K3 twice on each
     rank, each call held against its plain twin on the same arguments;
     the losses of 2 steps within 1e-4 of the one process stacking all 4,
     the last gradients within 1e-2 of each fold's largest of the one
     process stacking the rank's folds alone (the stack of all 4 printed
     beside: float32's rounding of the stack width); each rank's stacked
     steps/s beside the one process's; and, beside the ranks from the
     start, the train path's CLI with ``--fold_parallel --folds 0 1``
     for 1 epoch under ``torchrun --standalone --nproc_per_node 1`` (one
     NCCL rank, the layout path) and as a plain child at once: the same
     files and launches, each fold's final weights within
     RESUME_WEIGHT_TOL
  profile: the train CLI at the recipe's width with ``--profile``, 2
     epochs of fold 0 apart from the train path: a trace of epoch 1 under
     ``summaries/profile`` that names K1, K2 and K3
  then: the 2d ensemble fused (K4/K5, then K8 with ``fused_head``), the
     hierarchical predict CLI and its fused ensemble (K6), the backbone
     predict CLI and its fused ensemble (K7: 13 launches per fold and
     batch), each with its launch count, its probabilities against the
     unfused CSV and against the plain versions, and ms per batch in turns;
     the hierarchical train and finetune CLIs and the backbone train CLI
     (K1-K3 launched, losses finite, parameters moved, steps/s)
  recipe: the kit as a child on the card, 2 epochs a round, batch 20, on
     a mini dataset (the first 50 of the train path's clips as the curated
     set, 15 noisy clips of which a third carry a wrong or an extra label,
     5 test clips): exit 0; the class map's 8 classes; two experiments,
     each with five OOF and five test prediction files, a submission.csv
     that is their mean (1e-6), a results metric that is the lwlrap of its
     OOF CSVs (1e-9), model_on_epoch_0.npz in every fold; noisy
     probabilities for all 15 clips; 15 relabelled rows (scoring_1000); a
     blend submission of the 8 classes for the 5 test clips; each step's
     wall time. Launches on its two rounds are estimated from the train
     path's counts per fold and epoch (the kit's children cannot report
     theirs)
  evaluate: evaluate_2d_cnn on the kit's curated experiment: its overall
     OOF lwlrap against results.json within one rank swap, K1 launched;
     then --n_tta 2 --tta_shift_max_s 0.5
  probe: V1 and V3 once each with the counts reset just before each; K1
     launched once in V1, K9 once in V3; V3 within its tolerance of V1 while
     neighbouring clips differ by more than twice it; ms per call in turns
  bench: the bench as a subprocess; its last line parses and every number
     in it is finite and positive; K1 launched in each workload, K2 and K3
     in the augmented train step
  rnn: the GRU's cuDNN route against its step-by-step twin at the 2d
     recipe's four GRU shapes (20 x 161 / 80 / 40 / 20 frames, float32,
     TF32 off; ``probes/rnn_step.ROUTE_TOL``), and what vmap does with the
     cuDNN route; the recipe's train CLI with ``--aggregation_type rnn``
     over 2 epochs of fold 0, and with ``--fold_parallel`` over the two
     folds of ``--n_folds 2``, each a child (the two at once, beside the
     route checks) whose K1-K3 launches come back through
     ``$FSC_LAUNCH_LOG``: every kernel launched, losses finite,
     every fold's files, last-epoch steps/s; the bf16 predict CLI on the
     stacked run's two folds (K1 launched, probabilities in [0, 1]); the
     rnn train step against the max one in turns at B = 64 x 10 s, and
     the stacked rnn step alone (``rnn_step.compare``)
  ssl: ``train_apc`` and ``train_cpc`` (mel_2048_1024_128, batch 32, 10 s,
     the chain at 0.75) over 2 epochs of fold 0 with K1-K3 counted: every
     fold file of the family, a finite validation score, steps/s, the KNN
     accuracy; each family's step on the card against the CPU on the same
     features, float32 and float64 (``ssl_f32_step``)
  adversarial: ``adversarial_test`` over the labelled clips against the
     predict path's clips, 2 epochs, K1 counted: an AUC in [0, 1] printed
     each epoch, a class table of 80 rows
  8. float32 step: one train step (no augmentation, TF32 off) on the card
     against the same step on the CPU: loss 1e-4, gradients over the
     model's largest gradient 1e-2
Each phase ends with a ``phase <name>: <seconds> s`` line. Then one JSON
line of the kernels, and last the device line. Kernel times
are CUDA-event means in turns (kernel, plain, plain, kernel). Exits non-zero
with no result when CUDA is not available.

Precision: the plain twins' float32 matmuls and convolutions run in full
float32 (TF32 is switched off below), so the comparisons measure the kernels.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import csv
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import wave

import numpy as np
import torch

from freesound_classification_tpu_torch.probes.kernel_turns import (
    chain_wave,
    cuda_ms,
    device_kernels,
    k2_inputs,
    k9_inputs,
)

SR = 44100
N_CLIPS = 200
N_FOLDS = 5
N_CLASSES = 80
FEATURES = "mel_2048_1024_128"
NETWORK = {"num_conv_blocks": 6, "start_deep_supervision_on": 2,
           "conv_base_depth": 64, "growth_rate": 1.5, "output_dropout": 0.0,
           "aggregation_type": "max"}
MAX_BATCH_ELEMS = 128 * SR * 10  # the bench's similar-length batch budget
K1_TOL = 1e-4  # log-mel: float32 sums of 1025 non-negative terms, any order
# K2: the kernel and its twin do the same float32 operations, each rounded on
# its own; 1e-6 leaves room for a last-bit difference on samples of ~1
K2_TOL = 1e-6
# K3: one bf16 step of the largest output (2^-7 of it): a bf16 re/im or
# synthesis value flips its rounding where the kernel's sincosf or its
# tensor-core sums differ in the last float32 bit from the twin's
K3_REL_TOL = 2.0 ** -7
CHAIN_ROWS = 48  # round(0.75 * 64): the chain's rows of the bench batch
CHAIN_LEN = 10 * SR
PEAK_HBM = 3.35e12  # bytes/s, H100 SXM HBM3
PEAK_F32 = 67e12  # float32 FLOP/s outside the tensor cores
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s
ENSEMBLE_BF16_TOL = 2e-2  # probabilities, bf16 model: inputs round to bf16
ENSEMBLE_F32_TOL = 1e-4  # probabilities, f32 model, every batch
DEVICE = "cuda"  # one card: the first
# the published recipe (scripts/reproduce_reference.sh:54-85), one fold
RECIPE = ["--num_conv_blocks", "5", "--conv_base_depth", "100",
          "--growth_rate", "1.5", "--start_deep_supervision_on", "1",
          "--aggregation_type", "max", "--output_dropout", "0.5",
          "--features", "mel_2048_1024_128", "--max_audio_length", "15",
          "--optimizer", "adam", "--lr", "0.003",
          "--scheduler", "1cycle_0.0001_0.005", "--weight_decay", "0.0",
          "--p_mixup", "0.5", "--p_aug", "0.75", "--batch_size", "20",
          "--bf16"]
N_TRAIN_CLIPS = 150  # 5 folds: 120 train clips, 6 steps of 20 per epoch
TRAIN_SECONDS = (8.5, 15.0)  # every labelled clip in the 15 s crop's bucket
TRAIN_EPOCHS = 2
TRAIN_CLASSES = 8
STEP_TOL_LOSS = 1e-4
STEP_TOL_GRAD = 1e-2  # each gradient over the model's largest
# the fused blocks' shapes on the paths: every block of the hierarchical
# model over 10 s (215 frames after block0's pool, halved by each block), and
# every block of the 2d predict model (128 mels x 215 frames, halved)
K6_SHAPES = ((128, 64, 215), (128, 96, 107), (128, 144, 53),
             (128, 216, 26), (128, 324, 13), (128, 486, 6))
K45_SHAPES = ((128, 64, 64, 215), (128, 96, 32, 107), (128, 144, 16, 53),
              (128, 216, 8, 26), (128, 324, 4, 13), (128, 486, 2, 6))
# the backbone path's identity blocks over 10 s (431 frames -> 216 after
# conv1 -> 108 after the max-pool), one shape per stage; and the 2d path's
# block0 head
BACKBONE = "resnet34"
K7_SHAPES = ((128, 64, 32, 108), (128, 128, 16, 54), (128, 256, 8, 27),
             (128, 512, 4, 14))
K8_SHAPE = (128, 2, 128, 431)
# the hierarchical model at NETWORK's width with the published recipe's
# optimizer and augmentation flags (the repo publishes no hierarchical recipe)
HIER_RECIPE = [*(f"--{k}={v}" for k, v in NETWORK.items()),
               "--features", FEATURES,
               "--max_audio_length", "15", "--optimizer", "adam",
               "--lr", "0.003", "--scheduler", "1cycle_0.0001_0.005",
               "--weight_decay", "0.0", "--p_mixup", "0.5", "--p_aug", "0.75",
               "--batch_size", "20", "--bf16"]
HIER_TRAIN_EPOCHS = 2
FINETUNE_EPOCHS = 1
# the backbone (resnet34, the deeper of the CLI's two) with the published
# recipe's optimizer and augmentation flags (the repo publishes no backbone
# recipe)
BACKBONE_RECIPE = ["--backbone", BACKBONE, "--aggregation_type", "max",
                   "--output_dropout", "0.5", "--features", FEATURES,
                   "--max_audio_length", "15", "--optimizer", "adam",
                   "--lr", "0.003", "--scheduler", "1cycle_0.0001_0.005",
                   "--weight_decay", "0.0", "--p_mixup", "0.5",
                   "--p_aug", "0.75", "--batch_size", "20", "--bf16"]
BACKBONE_TRAIN_EPOCHS = 2
# fused against unfused bf16 ensemble probabilities: the bf16 tolerance of
# the ensemble comparisons above (the two round at different points)
FUSED_BF16_TOL = 2e-2
# fused through the kernels against the plain versions: the two round at the
# same points, but their sums' order flips one bf16 step in up to ~2% of a
# block's outputs (the K phases), and a flip travels through the later bf16
# layers as any rounding does; half the bf16 tolerance
FUSED_PLAIN_TOL = 1e-2
# K9 and the probe: the bench shape, 64 clips x 10 s (431 frames)
K9_CLIPS = 64
# K9: the kernel and its twin round |S| at the same points, so only the
# float32 sums of 1025 non-negative products differ, in order: as K1
K9_TOL = K1_TOL
# V3 (fast featurization, K9) against V1 (float32 log-mel, K1), both 5-fold
# bf16 ensembles: the single-pass bf16 DFT errs by ~2^-8 of each block's
# level, so a quiet band's log-mel moves by up to ~0.5 (0.46 on 8 clips x 3 s
# on the CPU, median 1.9e-3), and the bf16 model rounds its input at ~2^-8
# relative; at full width on the CPU the probabilities moved by 1.0e-2
PROBE_TOL = 5e-2
BENCH_KEYS = ("value", "vs_baseline", "mfu", "train_step_ms_noaug",
              "train_step_ms_aug", "train_mfu_noaug", "train_mfu_aug",
              "train_mfu")
BENCH_TIMEOUT = 600
# the recipe phase: the port's kit on an FSDKaggle2019-layout mini dataset
# (the curated set is the first RECIPE_CURATED of the train path's clips:
# 40 train clips a fold, 2 steps of 20 an epoch), two epochs a round, so
# that epoch 0 runs the effects chain (K2, K3)
RECIPE_CURATED = 50
RECIPE_NOISY = 15
RECIPE_TEST = 5
RECIPE_EPOCHS = 2
RECIPE_BATCH = 20
RECIPE_TIMEOUT = 900
# the resume phase: the recipe's 2d train CLI on fold 0 of 125 of the
# labelled clips (100 train clips: 5 steps of 20 an epoch, odd, so that a
# partial accumulation of 2 crosses the epoch's end), 2 epochs
RESUME_SAMPLES = 125
RESUME_TIMEOUT = 600
# final weights of the resumed run against the uninterrupted one, relative
# L2 over every parameter: the card's reductions are not bitwise
# repeatable, and a bf16 model rounds at 2^-8 relative, so the two runs may
# part by about that; an order of magnitude below a run on other folds is
# demanded besides
RESUME_WEIGHT_TOL = 1e-2
# TTA: the averaged probabilities of 3 passes, one of them clean, against
# one clean pass, as the mean |difference| over every clip and class: more
# than 0 (the passes were perturbed) and under a quarter of the range. Not
# the largest difference: the trained fold's bf16 sigmoids saturate at 0
# and 1, so one logit that changes sign in both perturbed passes moves an
# entry by 2/3, the most the average can move
TTA_MEAN_DIFF = 0.25
WRAPPER_KERNEL = {  # ops/kernels.launch_counts' names, as the kernels line
    "mel_project_log": "K1", "resample_linear": "K2", "pv_resynth": "K3",
    "resnet_block_2d_fused": "K4/K5", "resnet_block_1d_fused": "K6",
    "basic_block_fused": "K7", "conv_head_fused": "K8",
    "mel_log_split": "K9"}


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_in_turns(kernel, plain, *others) -> tuple:
    """Mean ms of ``kernel``, ``plain`` and any ``others`` over runs in
    turns (kernel, plain, others..., then back: ..., plain, kernel), and
    each one's runs."""
    fns = (kernel, plain, *others)
    runs = [[] for _ in fns]
    for i in (*range(len(fns)), *reversed(range(len(fns)))):
        runs[i].append(cuda_ms(fns[i]))
    return (*(float(np.mean(r)) for r in runs), runs)


def kernel_split(fn, calls: int = 5) -> str:
    """``device_kernels`` of ``fn`` launched on every call, as one line, or
    "not measured" where the profiler sees no device time."""
    parts = [f"{name[:60]} {ms:.4f} ms x{n:g}"
             for name, ms, n in device_kernels(fn, calls) if n >= 1]
    return "; ".join(parts) or "not measured"


def bound_ms(n_bytes: float, flops: float, peak: float) -> tuple:
    """The least time for the work: bytes over the HBM rate or operations
    over their peak rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_HBM * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(smi)
    return smi


def bytecode_cache() -> None:
    """Keep the compiled bytecode of every module this process and its
    children import under the checkout's git-ignored ``build/pycache``
    (``PYTHONPYCACHEPREFIX``, which the children inherit), written even
    where ``PYTHONDONTWRITEBYTECODE`` is set. Where the interpreter's
    packages ship no valid bytecode, each child otherwise compiles torch's
    sources anew at its import; with the cache only the first children
    do. ``probes/child_start.py`` times a child with and without it."""
    prefix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False
    log(f"bytecode cache: {prefix}")


def phase_build() -> None:
    from freesound_classification_tpu_torch.ops import build

    t0 = time.time()
    lib = build.build()
    build.load_library()
    log(f"build: {time.time() - t0:.2f} s -> {lib}")
    log(lib.with_suffix(".log").read_text().strip())


def phase_k1() -> dict:
    from freesound_classification_tpu_torch.ops import dsp, kernels

    feat = dsp.parse_features(FEATURES)
    gen = torch.Generator(device="cuda").manual_seed(0)
    wave = 0.1 * torch.randn(128, 10 * SR, device="cuda", generator=gen)
    fb = torch.from_numpy(
        dsp.mel_filterbank(SR, feat.n_fft, feat.n_mel)).cuda()
    spec = dsp.stft(wave, feat.n_fft, feat.hop_size)
    # a dense filterbank (no zero entry: every band spans every bin) at the
    # mel bands' scale, and two wrong inputs: the bands one bin up, the
    # frames one along
    dense = torch.rand(fb.shape, device="cuda", generator=gen) / 16 + 1e-3
    shifted_fb = torch.roll(fb, 1, dims=1)
    shifted_spec = torch.roll(spec, 1, dims=2)

    def check(label, spec_, fb_):
        got_ = kernels.mel_project_log(spec_, fb_)
        want_ = kernels.mel_project_log_reference(spec_, fb_)
        torch.cuda.synchronize()
        if got_.shape != want_.shape or not torch.isfinite(got_).all():
            raise RuntimeError(f"K1 {label}: bad output {tuple(got_.shape)}")
        err_ = (got_ - want_).abs().max().item()
        if not err_ <= K1_TOL:
            raise RuntimeError(f"K1 disagrees with its plain twin on the "
                               f"{label}: {err_}")
        return got_, want_, err_

    got, want, err = check("mel filterbank", spec, fb)
    _, _, dense_err = check("dense filterbank", spec, dense)
    wrong_bands = (kernels.mel_project_log(spec, shifted_fb)
                   - want).abs().max().item()
    wrong_frames = (kernels.mel_project_log(shifted_spec, fb)
                    - want).abs().max().item()
    log(f"K1 {tuple(spec.shape)} -> {tuple(got.shape)}: max_abs_err {err:.3e}"
        f" (tolerance {K1_TOL:g}), on a dense filterbank {dense_err:.3e}; "
        f"bands one bin up give {wrong_bands:.3e}, frames shifted by one "
        f"{wrong_frames:.3e}")
    if not min(wrong_bands, wrong_frames) > 100 * K1_TOL:
        raise RuntimeError("K1's comparison cannot tell a wrong input")
    ms, plain_ms, times = timed_in_turns(
        lambda: kernels.mel_project_log(spec, fb),
        lambda: kernels.mel_project_log_reference(spec, fb))
    b, f, t = spec.shape
    m = fb.shape[0]
    # the work these inputs need: |S| once per bin (3 flops), one FMA per
    # non-zero filterbank entry per frame, a log per output
    nnz = int((fb != 0).sum())
    flops = b * t * (3 * f + 2 * nnz + m)
    n_bytes = spec.numel() * 8 + fb.numel() * 4 + got.numel() * 4
    bound, bound_by = bound_ms(n_bytes, flops, PEAK_F32)
    # the design: the spectrum and the log-mel once, fb once by the band
    # ranges' reductions and their (M,) results; the kernel's reads of the
    # bands' ranges of fb (8 KB) stay in L1/L2
    design = spec.numel() * 8 + got.numel() * 4 + fb.numel() * 4 + m * 16
    log(f"K1 time: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms "
        f"(runs {times}); bound {bound:.4f} ms by {bound_by} "
        f"({nnz} of {fb.numel()} filterbank entries non-zero; the function "
        f"needs {n_bytes / 1e6:.1f} MB, the design moves "
        f"{design / 1e6:.1f} MB)")
    log(f"K1 by launch (torch.profiler): "
        f"{kernel_split(lambda: kernels.mel_project_log(spec, fb))}")
    return {"name": "mel_log_kernel", "route": "cuda",
            "source": "freesound_classification_tpu_torch/csrc/mel_log.cu",
            "replaces": "freesound_classification_tpu/ops/pallas_kernels.py:40",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


def phase_k2() -> dict:
    """K2 at the chain's shape for the bench's train batch, unmasked and
    masked as the chain calls it (valid lengths of half to all of a row),
    each against its plain twin; three wrong inputs that must fail by far
    (a factor 0.1% off, the wave shifted by one sample, the lengths a tenth
    of a clip short); then the masked call in turns with its plain twin,
    the unmasked call and the library yardstick (``grid_sample`` and the
    same mask), each call's bound from the samples its data loads (a
    masked output loads none), and each call's device time by launch."""
    from freesound_classification_tpu_torch.ops import kernels

    wave, factor, lengths = k2_inputs(CHAIN_ROWS, CHAIN_LEN)
    got = kernels.resample_linear(wave, factor)
    want = kernels.resample_linear_reference(wave, factor)
    got_m = kernels.resample_linear(wave, factor, lengths)
    want_m = kernels.resample_linear_reference(wave, factor, lengths)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    err_m = (got_m - want_m).abs().max().item()
    wrong_factor = (kernels.resample_linear(wave, factor * 1.001)
                    - want).abs().max().item()
    shifted = (kernels.resample_linear(torch.roll(wave, 1, dims=1), factor)
               - want).abs().max().item()
    short = (kernels.resample_linear(wave, factor, lengths - CHAIN_LEN // 10)
             - want_m).abs().max().item()
    log(f"K2 {tuple(wave.shape)}, factors [{factor.min().item():.3f}, "
        f"{factor.max().item():.3f}]: max_abs_err {err:.3e} unmasked, "
        f"{err_m:.3e} masked to lengths [{lengths.min().item()}, "
        f"{lengths.max().item()}] (tolerance {K2_TOL:g}); factor x 1.001 "
        f"gives {wrong_factor:.3e}, the wave shifted by one sample "
        f"{shifted:.3e}, the lengths a tenth of a clip short {short:.3e}")
    if not max(err, err_m) <= K2_TOL:
        raise RuntimeError(f"K2 disagrees with its plain twin: {err}, "
                           f"masked {err_m}")
    if not min(wrong_factor, shifted, short) > 100 * K2_TOL:
        raise RuntimeError("K2's comparison cannot tell a wrong input")
    # library yardstick: grid_sample computes the same two-tap lerp with
    # zeros outside, from positions normalized to [-1, 1]; then the mask
    pos = (torch.arange(CHAIN_LEN, device="cuda", dtype=torch.float32)[None]
           * factor[:, None])
    grid = torch.stack([2 * pos / (CHAIN_LEN - 1) - 1,
                        torch.zeros_like(pos)], dim=-1)[:, None]
    image = wave[:, None, None, :]
    valid = lengths.float()[:, None]

    def library():
        return torch.where(pos < valid, torch.nn.functional.grid_sample(
            image, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)[:, 0, 0], 0.0)

    lib_err = (library() - want_m).abs().max().item()

    def masked():
        return kernels.resample_linear(wave, factor, lengths)

    def unmasked():
        return kernels.resample_linear(wave, factor)

    ms, plain_ms, unmasked_ms, library_ms, times = timed_in_turns(
        masked, lambda: kernels.resample_linear_reference(
            wave, factor, lengths), unmasked, library)
    # the work these inputs need: a row's source samples up to the last tap
    # read, 1 + floor of the largest position that loads taps (pos <
    # lengths[b] when masked, pos < L otherwise: taps past L read 0), each
    # read once; the whole output written once; 6 operations an output that
    # loads taps
    rows, length = wave.shape

    def work(loads):
        last = torch.where(loads, pos, -1.0).amax(dim=1)
        read = torch.clamp(torch.floor(last).long() + 2, 0, length)
        return 4 * (int(read.sum()) + rows * length), 6 * int(loads.sum())

    n_bytes, flops = work(pos < valid)
    n_bytes += 4 * (factor.numel() + lengths.numel())
    bound, bound_by = bound_ms(n_bytes, flops, PEAK_F32)
    n_bytes_u, flops_u = work(pos < length)
    bound_u, bound_by_u = bound_ms(n_bytes_u + 4 * factor.numel(), flops_u,
                                   PEAK_F32)
    log(f"K2 time, masked as the chain calls it: kernel {ms:.4f} ms, plain "
        f"twin {plain_ms:.4f} ms, bound {bound:.4f} ms by {bound_by} "
        f"({n_bytes / 1e6:.1f} MB); unmasked {unmasked_ms:.4f} ms, bound "
        f"{bound_u:.4f} ms by {bound_by_u} ({n_bytes_u / 1e6:.1f} MB); "
        f"grid_sample and the mask {library_ms:.4f} ms (its max |diff| "
        f"{lib_err:.2e}); runs {times}")
    log(f"K2 by launch (torch.profiler), masked: {kernel_split(masked)}; "
        f"unmasked: {kernel_split(unmasked)}")
    return {"name": "resample_kernel", "route": "cuda",
            "source": "freesound_classification_tpu_torch/csrc/resample.cu",
            "replaces":
                "freesound_classification_tpu/ops/pallas_kernels.py:137",
            "max_abs_err": max(err, err_m), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms}


def k3_args() -> tuple:
    """K3's inputs at the chain's shape for the bench's train batch (48
    rows x 10 s, n_fft 1024, hop 256), from a real analysis, with the
    bases ``ops/pv.py`` passes."""
    from freesound_classification_tpu_torch.ops import pv

    n_fft, hop = 1024, 256
    t_out = (CHAIN_LEN + n_fft // 2) // hop + 2
    mag, dphi, phase0 = pv.analysis(chain_wave(CHAIN_ROWS, CHAIN_LEN, 3),
                                    n_fft, hop)
    gen = torch.Generator(device="cuda").manual_seed(4)
    # the chain's stretch rates 1 / 2^(cents/1200), |cents| < 300
    rate = torch.exp2(-(600 * torch.rand(CHAIN_ROWS, device="cuda",
                                         generator=gen) - 300) / 1200)
    icos, isin = pv._bases(n_fft, mag.device)
    return mag, dphi, phase0, rate, icos, isin, hop, t_out


def k3_design_bytes(mag, rate, rows: int, hop: int) -> dict:
    """The bytes the K3 kernels move from device memory on these inputs,
    by part: each pass's distinct picked frames of dphi (the tile sums'
    and the main pass's) and of mag (the lerp's two frames), the float32
    rows, and the small tile sums, spill and fixed-up rows. The basis that
    every block streams (2.2 MB, L2-resident) is given apart."""
    b, t_in, f = mag.shape
    pos = torch.arange(rows, device=mag.device)[None] * rate[:, None]
    lo = torch.floor(torch.clamp(pos, 0.0, t_in - 1.0)).long()
    picks_d = torch.floor(torch.clamp(pos, 0.0, t_in - 2.0)).long()

    def distinct(idx):
        return sum(int(torch.unique(row).numel()) for row in idx)

    frames_m = distinct(torch.cat([lo, torch.clamp(lo + 1, max=t_in - 1)],
                                  dim=1))
    frames_d = distinct(picks_d)
    n_tiles, n_blocks = -(-rows // 128), -(-rows // 64)
    sums = b * n_tiles * 8 * f * 4  # a running sum every 16 frames
    spill = b * n_blocks * 6 * hop * 2  # bf16 terms
    parts = {
        "dphi, tile sums": frames_d * f * 4,
        "dphi, main": frames_d * f * 4,
        "mag, main": frames_m * f * 4,
        "rows out": b * rows * hop * 4,
        "sums, spill, fix-up": 2 * sums + 2 * spill
                               + 2 * b * (n_blocks - 1) * 3 * hop * 4,
    }
    parts["total"] = sum(parts.values())
    parts["basis from L2"] = b * n_blocks * 4 * 2 * (-(-f // 16) * 16) \
        * 256 * 2
    return parts


@contextlib.contextmanager
def plain_twins(*names: str):
    """``ops/kernels``' wrappers ``names`` swapped for their plain twins
    (``<name>_reference``) inside the block."""
    from freesound_classification_tpu_torch.ops import kernels

    real = {name: getattr(kernels, name) for name in names}
    try:
        for name in names:
            setattr(kernels, name, getattr(kernels, f"{name}_reference"))
        yield
    finally:
        for name, fn in real.items():
            setattr(kernels, name, fn)


def k3_pitch_shift() -> None:
    """``pv.pitch_shift`` of the chain's rows (n_fft 1024, hop 256, cents
    U(-300, 300), every other row half long) through K3 and K2 against
    the same call with both wrappers swapped for their plain twins: the
    lengths equal and the waves within ``K3_REL_TOL`` of the largest."""
    from freesound_classification_tpu_torch.ops import kernels, pv

    wave = chain_wave(CHAIN_ROWS, CHAIN_LEN, 6)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cents = 600 * torch.rand(CHAIN_ROWS, device="cuda", generator=gen) - 300
    lengths = torch.full((CHAIN_ROWS,), CHAIN_LEN, dtype=torch.int32,
                         device="cuda")
    lengths[1::2] = CHAIN_LEN // 2
    wave[1::2, CHAIN_LEN // 2:] = 0.0
    before = (kernels.pv_resynth.launches, kernels.resample_linear.launches)
    got, got_len = pv.pitch_shift(wave, lengths, cents, 1024, 256)
    launched = (kernels.pv_resynth.launches - before[0],
                kernels.resample_linear.launches - before[1])
    with plain_twins("pv_resynth", "resample_linear"):
        want, want_len = pv.pitch_shift(wave, lengths, cents, 1024, 256)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = K3_REL_TOL * want.abs().max().item()
    log(f"K3 and K2 in pv.pitch_shift {tuple(wave.shape)}: launches K3 "
        f"{launched[0]}, K2 {launched[1]}; against the plain twins' route "
        f"max_abs_err {err:.3e} (tolerance {tol:.3e}), lengths equal "
        f"{bool(torch.equal(got_len, want_len))}")
    if min(launched) < 1 or not torch.isfinite(got).all():
        raise RuntimeError(f"pitch_shift: launches {launched}")
    if not (err <= tol and torch.equal(got_len, want_len)):
        raise RuntimeError(f"pitch_shift disagrees with its plain route: "
                           f"{err}")


def phase_k3() -> dict:
    from freesound_classification_tpu_torch.ops import kernels

    args = k3_args()
    mag, dphi, phase0, rate, icos, isin, hop, t_out = args
    n_fft = icos.shape[1]
    got = kernels.pv_resynth(*args)
    want = kernels.pv_resynth_reference(*args)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"K3: bad output {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    tol = K3_REL_TOL * want.abs().max().item()
    frac_diff = (got != want).float().mean().item()
    shifted = (kernels.pv_resynth(torch.roll(mag, 1, dims=1),
                                  torch.roll(dphi, 1, dims=1), *args[2:])
               - want).abs().max().item()
    log(f"K3 mag {tuple(mag.shape)} -> {tuple(got.shape)}, rates "
        f"[{rate.min().item():.3f}, {rate.max().item():.3f}]: max_abs_err "
        f"{err:.3e} (tolerance {tol:.3e}), {100 * frac_diff:.4f}% of samples "
        f"differ; frames shifted by one give {shifted:.3e}")
    if not err <= tol:
        raise RuntimeError(f"K3 disagrees with its plain twin: {err}")
    if not shifted > 10 * tol:
        raise RuntimeError("K3's comparison cannot tell shifted frames")
    k3_pitch_shift()
    ms, plain_ms, times = timed_in_turns(
        lambda: kernels.pv_resynth(*args),
        lambda: kernels.pv_resynth_reference(*args))
    b, t_in, f = mag.shape
    rows = got.shape[1]  # frames synthesized: t_out + r - 1
    n_bytes = ((mag.numel() + dphi.numel() + phase0.numel() + b) * 4
               + 2 * icos.numel() * 2 + got.numel() * 4)
    bound, bound_by = bound_ms(n_bytes, 2.0 * b * rows * 2 * f * n_fft,
                               PEAK_BF16)
    design = k3_design_bytes(mag, rate, rows, hop)
    log(f"K3 time: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms "
        f"(runs {times}); bound {bound:.4f} ms by {bound_by}; the function "
        f"needs {n_bytes / 1e9:.4f} GB, the design moves "
        f"{design['total'] / 1e9:.4f} GB ("
        + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in design.items()
                    if k != "total") + ")")
    log(f"K3 by launch (torch.profiler): "
        f"{kernel_split(lambda: kernels.pv_resynth(*args))}")
    return {"name": "pv_resynth_kernels", "route": "cuda",
            "source":
                "freesound_classification_tpu_torch/csrc/pv_resynth.cu",
            "replaces":
                "freesound_classification_tpu/ops/pallas_kernels.py:297",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


# ---------------------------------------------------------------------------
# K6 and K4/K5: the fused eval resnet blocks
# ---------------------------------------------------------------------------


def random_resnet_block(model_kind: str, channels: int, seed: int):
    """A ResnetBlock1d or ResnetBlock2d of ``channels`` in eval mode on the
    card, with the random fold weights of ``interop`` (BatchNorm statistics
    and PReLU slopes away from their defaults)."""
    from freesound_classification_tpu_torch import interop
    from freesound_classification_tpu_torch.models import blocks

    params, stats = interop.random_jax_variables(
        num_conv_blocks=1, start_deep_supervision_on=0,
        conv_base_depth=channels, growth_rate=1.0, n_classes=2, seed=seed,
        model_kind=model_kind, input_dim=8)
    pre = "blocks.0.resnet."
    sd = {k[len(pre):]: v
          for k, v in interop.from_jax_variables(params, stats).items()
          if k.startswith(pre)}
    cls = (blocks.ResnetBlock1d if model_kind == "hierarchical_cnn"
           else blocks.ResnetBlock2d)
    block = cls(channels)
    block.load_state_dict(sd)
    return block.to(DEVICE).eval()


def check_kernel(label: str, kernel, plain, x, wts, other, raised,
                 wrong_halo, folded=None) -> dict:
    """``kernel`` against ``plain`` on the same inputs, within one bf16 step
    of the largest output, and three wrong inputs that must fail by far:
    frames (the last dim) shifted by one, another fold's weights ``other``,
    and ``wrong_halo`` (a plain variant that pads the wrong tensor) against
    the kernel with the weights ``raised``, under which the wrong padding
    shows. Returns the error and the times, with ``folded()`` (the bf16
    folded twin on cuDNN, a yardstick the kernel path never calls) timed in
    the same turns where it is given."""
    got = kernel(x, wts)
    want = plain(x, wts)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"{label}: bad output {tuple(got.shape)}")
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    # one bf16 step (2^-7 relative) of the largest output
    tol = 2.0 ** -7 * want.abs().max().item()
    frac = (got != want).float().mean().item()
    shifted = (kernel(torch.roll(x, 1, dims=-1), wts).float()
               - want).abs().max().item()
    wrong_fold = (kernel(x, other).float() - want).abs().max().item()
    want_raised = plain(x, raised).float()
    err_raised = (kernel(x, raised).float() - want_raised).abs().max().item()
    tol_raised = 2.0 ** -7 * want_raised.abs().max().item()
    halo = (wrong_halo(x, raised).float() - want_raised).abs().max().item()
    torch.cuda.synchronize()
    log(f"{label} {tuple(x.shape)} {x.dtype}: max_abs_err {err:.3e} "
        f"(tolerance {tol:.3e}, one bf16 step of the largest output), "
        f"{100 * frac:.4f}% of elements differ; frames shifted by one give "
        f"{shifted:.3e}, another fold's weights {wrong_fold:.3e}; with the "
        f"raised weights the kernel gives {err_raised:.3e} (tolerance "
        f"{tol_raised:.3e}) and the wrong padding {halo:.3e}")
    if not err <= tol:
        raise RuntimeError(f"{label} disagrees with its plain version: {err}")
    if not err_raised <= tol_raised:
        raise RuntimeError(f"{label} with raised weights disagrees: "
                           f"{err_raised}")
    if not min(shifted, wrong_fold) > 10 * tol or not halo > 10 * tol_raised:
        raise RuntimeError(f"{label}'s comparison cannot tell a wrong input")
    ms, plain_ms, *folded_ms, times = timed_in_turns(
        lambda: kernel(x, wts), lambda: plain(x, wts),
        *([folded] if folded else []))
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "times": times}
    if folded_ms:
        out["folded_ms"] = folded_ms[0]
    return out


def bf16_folded(fold_params: dict) -> dict:
    """A block's float32 fold cast to bf16 once, so that the folded twin
    runs in bf16 with no casts of its own."""
    return {k: v.to(torch.bfloat16) for k, v in fold_params.items()}


def check_fused_block(label: str, model_kind: str, shape: tuple,
                      seed: int) -> dict:
    """One fused block kernel against its plain version at ``shape`` (B, C,
    T) or (B, C, H, W) in bf16 (2d maps in channels_last memory, as the
    model holds them), through ``check_kernel``: b1 raised by 8, and a plain
    variant whose conv2 reads a non-zero h1 halo (x zero-padded instead of
    h1). Returns the numbers."""
    from freesound_classification_tpu_torch.ops import kernels, resnet_infer

    one_d = model_kind == "hierarchical_cnn"
    kernel = (kernels.resnet_block_1d_fused if one_d
              else kernels.resnet_block_2d_fused)
    plain = (kernels.resnet_block_1d_fused_reference if one_d
             else kernels.resnet_block_2d_fused_reference)
    fold = (resnet_infer.fold_block_params_1d if one_d
            else resnet_infer.fold_block_params)
    channels = shape[1]
    block = random_resnet_block(model_kind, channels, seed)
    wts = resnet_infer.fused_weights(block, fold)
    folded_twin = (resnet_infer.resnet_block_1d_infer_folded if one_d
                   else resnet_infer.resnet_block_2d_infer_folded)
    fp = bf16_folded(fold(block))
    other = resnet_infer.fused_weights(
        random_resnet_block(model_kind, channels, seed + 1), fold)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = channels_contiguous(
        torch.randn(shape, device=DEVICE, generator=gen).to(torch.bfloat16))
    bias = wts.bias.clone()
    bias[0, :channels] += 8.0
    pad = (1, 1) if one_d else (1, 1, 1, 1)
    crop = (..., slice(1, -1)) if one_d else (..., slice(1, -1),
                                              slice(1, -1))

    def padded_x(x_, w_):
        return plain(torch.nn.functional.pad(x_, pad), w_)[crop]

    out = check_kernel(label, kernel, plain, x, wts, other,
                       wts._replace(bias=bias), padded_x,
                       folded=lambda: folded_twin(x, fp))
    positions = x[0, 0].numel() * shape[0]
    taps = 3 if one_d else 9
    flops = 2.0 * positions * channels * channels * (2 + taps)
    weight_bytes = (2 + taps) * channels * channels * 2 + 6 * channels * 4
    n_bytes = 2 * x.numel() * 2 + weight_bytes
    cp = kernels._round16(channels)
    plan = (kernels.resnet_block_1d_plan(positions, channels, cp) if one_d
            else (kernels.conv_plan(positions, cp, cp),
                  kernels.tail_plan(positions, cp)))
    # the design also writes h1 and reads it back (cp channels), and h2
    # where it runs three launches
    design = n_bytes + 2 * (len(plan) - 1) * positions * cp * 2
    bound, bound_by = bound_ms(n_bytes, flops, PEAK_BF16)
    log(f"{label} {tuple(shape)} time: kernel {out['ms']:.4f} ms, plain "
        f"version {out['plain_ms']:.4f} ms, bf16 folded twin "
        f"{out['folded_ms']:.4f} ms (runs {out.pop('times')}); bound "
        f"{bound:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, "
        f"{n_bytes / 1e6:.1f} MB; the design moves {design / 1e6:.1f} MB) "
        f"in {len(plan)} launches: "
        + ", ".join(f"{p.bm} x {p.bn} tiles, grid {p.grid_m} x {p.grid_n}"
                    for p in plan))
    log(f"{label} {tuple(shape)} by launch (torch.profiler): "
        f"{kernel_split(lambda: kernel(x, wts))}")
    return dict(out, bound_ms=bound, bound_by=bound_by, x=x, wts=wts)


def channels_contiguous(x: torch.Tensor) -> torch.Tensor:
    """x's values with contiguous channels, as the fused paths hold their
    maps: (B, C, T) as (B, T, C) in memory, NCHW as channels_last."""
    if x.dim() == 4:
        return x.contiguous(memory_format=torch.channels_last)
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def k6_input_strides() -> str:
    """The strides of the map each ResnetBlock1d of the hierarchical model
    (NETWORK's width, bf16, eval, ``fused_infer``) is handed on the card,
    on 4 random clips of 10 s of features: the layout K6 reads."""
    from freesound_classification_tpu_torch.models import blocks, classifiers

    model = classifiers.HierarchicalCNN(
        128, dtype=torch.bfloat16, fused_infer=True, **NETWORK)
    model = model.to(DEVICE).to(torch.bfloat16).eval()
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda _, args: seen.append((tuple(args[0].shape),
                                     args[0].stride())))
        for m in model.modules() if isinstance(m, blocks.ResnetBlock1d)]
    gen = torch.Generator(device=DEVICE).manual_seed(24)
    feats = torch.randn(4, 431, 128, device=DEVICE, generator=gen)
    with torch.no_grad():
        model(feats, torch.full((4,), 431, device=DEVICE))
    for h in hooks:
        h.remove()
    return "; ".join(f"{shape} strides {stride}" for shape, stride in seen)


def phase_k6() -> dict:
    """K6 at every block shape of the hierarchical path, and the layout the
    path hands it."""
    from freesound_classification_tpu_torch.ops import kernels

    log(f"K6 inputs on the hierarchical fused path: {k6_input_strides()}")
    outs = [check_fused_block("K6", "hierarchical_cnn", shape, 20 + 2 * i)
            for i, shape in enumerate(K6_SHAPES)]
    log("K6 at the six block shapes, ms: kernel "
        + " / ".join(f"{o['ms']:.4f}" for o in outs)
        + f" (sum {sum(o['ms'] for o in outs):.4f}); bf16 folded twin "
        + " / ".join(f"{o['folded_ms']:.4f}" for o in outs)
        + f" (sum {sum(o['folded_ms'] for o in outs):.4f})")
    # the layout the unfused conv1d hands a block: time-major, copied to
    # channel rows by the wrapper on every call
    first = outs[0]
    x, wts = first.pop("x"), first.pop("wts")
    time_major = x.contiguous()
    rows_ms, copied_ms, _ = timed_in_turns(
        lambda: kernels.resnet_block_1d_fused(x, wts),
        lambda: kernels.resnet_block_1d_fused(time_major, wts))
    log(f"K6 {tuple(x.shape)}: channels-contiguous x {rows_ms:.4f} ms, "
        f"time-major x (a padded copy a call) {copied_ms:.4f} ms")
    for o in outs:
        for key in ("folded_ms", "x", "wts"):
            o.pop(key, None)
    return {"name": "resnet_block_1d_kernel", "route": "cuda",
            "source": "freesound_classification_tpu_torch/csrc/"
                      "conv_blocks.cu",
            "replaces":
                "freesound_classification_tpu/ops/pallas_resnet1d.py:107",
            **first, "library_ms": None}


def phase_k45() -> dict:
    """K4/K5 at every block shape of the 2d predict path."""
    outs = [check_fused_block("K4/K5", "2d_cnn", shape, 30 + 2 * i)
            for i, shape in enumerate(K45_SHAPES)]
    gap = sum(25 * (o["ms"] - o["bound_ms"]) for o in outs)
    log("K4/K5 at the six block shapes, ms: kernel "
        + " / ".join(f"{o['ms']:.4f}" for o in outs)
        + f" (sum {sum(o['ms'] for o in outs):.4f}); bound "
        + " / ".join(f"{o['bound_ms']:.4f}" for o in outs)
        + "; bf16 folded twin "
        + " / ".join(f"{o['folded_ms']:.4f}" for o in outs)
        + f"; gap at 25 launches a shape {gap:.2f} ms")
    for o in outs:
        for key in ("folded_ms", "x", "wts"):
            o.pop(key, None)
    first = outs[0]
    return {"name": "resnet_block_2d_kernel", "route": "cuda",
            "source": "freesound_classification_tpu_torch/csrc/"
                      "conv_blocks.cu",
            "replaces":
                "freesound_classification_tpu/ops/pallas_resnet.py:111, "
                "freesound_classification_tpu/ops/pallas_resnet.py:269",
            **first, "library_ms": None}


# ---------------------------------------------------------------------------
# K7 and K8: the backbone's fused BasicBlock and the 2d CNN's fused head
# ---------------------------------------------------------------------------


def random_basic_block(channels: int, seed: int):
    """An identity (stride-1, ``channels`` wide) BasicBlock in eval mode on
    the card, with the random fold weights of ``interop`` for the
    backbone."""
    from freesound_classification_tpu_torch import interop
    from freesound_classification_tpu_torch.models import backbone

    params, stats = interop.random_jax_variables(
        n_classes=2, seed=seed, model_kind="backbone_cnn",
        backbone=BACKBONE)
    stage = {64: 0, 128: 1, 256: 2, 512: 3}[channels]
    pre = f"trunk.stage{stage}_block1."
    sd = {k[len(pre):]: v
          for k, v in interop.from_jax_variables(params, stats).items()
          if k.startswith(pre)}
    block = backbone.BasicBlock(channels, channels)
    block.load_state_dict(sd)
    return block.to(DEVICE).eval()


def phase_k7() -> dict:
    """K7 at the four stage shapes of the backbone path (B 128 x 10 s), with
    b1 raised by 8 for the halo check (the plain version on x padded by one,
    whose h1 ring is then relu(b1 + ...), not 0)."""
    from freesound_classification_tpu_torch.ops import (
        backbone_infer,
        kernels,
        resnet_infer,
    )

    first = None
    for shape in K7_SHAPES:
        channels = shape[1]

        def weights(seed):
            return resnet_infer.fused_weights(
                random_basic_block(channels, seed),
                backbone_infer.fold_basic_params, kernels.pack_basic_block)

        wts, other = weights(40), weights(41)
        fp = bf16_folded(backbone_infer.fold_basic_params(
            random_basic_block(channels, 40)))
        bias = wts.bias.clone()
        bias[0, :channels] += 8.0
        gen = torch.Generator(device=DEVICE).manual_seed(channels)
        x = torch.randn(shape, device=DEVICE, generator=gen).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

        def padded_x(x_, w_):
            return kernels.basic_block_fused_reference(
                torch.nn.functional.pad(x_, (1, 1, 1, 1)), w_)[
                ..., 1:-1, 1:-1]

        out = check_kernel(
            "K7", kernels.basic_block_fused,
            kernels.basic_block_fused_reference, x, wts, other,
            wts._replace(bias=bias), padded_x,
            folded=lambda: backbone_infer.basic_block_infer_folded(x, fp))
        positions = shape[0] * shape[2] * shape[3]
        flops = 2.0 * 2 * 9 * channels * channels * positions
        n_bytes = (2 * x.numel() * 2 + 2 * 9 * channels * channels * 2
                   + 2 * channels * 4)
        # x is read twice (conv1, the residual); h1 written and read back
        design = n_bytes + 3 * x.numel() * 2
        bound, bound_by = bound_ms(n_bytes, flops, PEAK_BF16)
        plan = kernels.conv_plan(positions, channels, channels)
        log(f"K7 {shape} time: kernel {out['ms']:.4f} ms, plain version "
            f"{out['plain_ms']:.4f} ms, bf16 folded twin "
            f"{out.pop('folded_ms'):.4f} ms (runs {out.pop('times')}); "
            f"bound {bound:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, "
            f"{n_bytes / 1e6:.1f} MB; the design moves {design / 1e6:.1f} "
            f"MB) on {plan}")
        log(f"K7 {shape} by launch (torch.profiler): "
            f"{kernel_split(lambda: kernels.basic_block_fused(x, wts))}")
        if first is None:
            first = dict(out, bound_ms=bound, bound_by=bound_by)
    return {"name": "basic_block_kernel", "route": "cuda",
            "source": "freesound_classification_tpu_torch/csrc/"
                      "conv_blocks.cu",
            "replaces":
                "freesound_classification_tpu/ops/pallas_backbone.py:101",
            **first, "library_ms": None}


def phase_k8() -> dict:
    """K8 at the 2d path's block0 (B 128 x 10 s, 128 mels, the spectrogram
    and its frequency encoding, bf16) -> (128, 64, 64, 215), with t_in
    raised by 8 for the padding check (the plain version fed x padded
    before bn_in, whose SAME zeros become t_in)."""
    from freesound_classification_tpu_torch import interop
    from freesound_classification_tpu_torch.models import blocks
    from freesound_classification_tpu_torch.ops import (
        head_infer,
        kernels,
        resnet_infer,
    )

    def head_block(seed):
        params, stats = interop.random_jax_variables(
            num_conv_blocks=1, start_deep_supervision_on=0,
            conv_base_depth=NETWORK["conv_base_depth"], growth_rate=1.0,
            n_classes=2, seed=seed)
        block = blocks.ConvBlock2d(K8_SHAPE[1], NETWORK["conv_base_depth"])
        block.load_state_dict({
            k[len("blocks.0."):]: v
            for k, v in interop.from_jax_variables(params, stats).items()
            if k.startswith("blocks.0.")})
        return block.to(DEVICE).eval()

    def weights(seed):
        return resnet_infer.fused_weights(head_block(seed),
                                          head_infer.fold_head_params,
                                          kernels.pack_conv_head)

    wts, other = weights(50), weights(51)
    fp = bf16_folded(head_infer.fold_head_params(head_block(50)))
    raised = wts._replace(t_in=wts.t_in + 8.0)
    b, c_in, h, w = K8_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(52)
    spec = 3.0 * torch.randn(b, h, w, 1, device=DEVICE, generator=gen) - 5.0
    freq = torch.linspace(-1.0, 1.0, h, device=DEVICE)[None, :, None, None]
    x = torch.cat([spec, freq.expand(b, h, w, 1)], dim=-1).to(
        torch.bfloat16).permute(0, 3, 1, 2)  # NCHW, channels_last memory

    def padded_before_bn(x_, w_):
        xp = torch.nn.functional.pad(x_.float(), (1, 1, 1, 1))
        xa = (xp * w_.s_in.view(1, -1, 1, 1) + w_.t_in.view(1, -1, 1, 1)) \
            .to(torch.bfloat16).float()
        y = torch.nn.functional.max_pool2d(torch.nn.functional.conv2d(
            xa, kernels.head_conv_weight(w_)), 2)
        y = y * w_.scale.view(1, -1, 1, 1) + w_.shift.view(1, -1, 1, 1)
        return torch.where(y >= 0, y, w_.alpha.view(1, -1, 1, 1) * y) \
            .to(torch.bfloat16)

    def folded_twin():
        # bn_in, then cuDNN's bf16 conv (SAME), the 2x2 max, bn_out, PReLU
        xa = x * fp["s_in"].view(1, -1, 1, 1) + fp["t_in"].view(1, -1, 1, 1)
        y = torch.nn.functional.max_pool2d(torch.nn.functional.conv2d(
            xa, fp["kern"].permute(3, 2, 0, 1), padding=1), 2)
        y = y * fp["scale"].view(1, -1, 1, 1) + fp["bias"].view(1, -1, 1, 1)
        return torch.nn.functional.prelu(y, fp["alpha"])

    out = check_kernel("K8", kernels.conv_head_fused,
                       kernels.conv_head_fused_reference, x, wts, other,
                       raised, padded_before_bn, folded=folded_twin)
    depth = fp["scale"].shape[0]
    positions = b * (h // 2) * (w // 2) * 4  # the conv outputs pooled
    flops = 2.0 * positions * 9 * c_in * depth
    n_bytes = (x.numel() * 2 + b * depth * (h // 2) * (w // 2) * 2
               + wts.w.numel() * 2 + (2 * c_in + 3 * depth) * 4)
    bound, bound_by = bound_ms(n_bytes, flops, PEAK_BF16)
    log(f"K8 {K8_SHAPE} -> {(b, depth, h // 2, w // 2)} time: kernel "
        f"{out['ms']:.4f} ms, plain version {out['plain_ms']:.4f} ms, bf16 "
        f"folded twin {out.pop('folded_ms'):.4f} ms (runs "
        f"{out.pop('times')}); bound {bound:.4f} ms by {bound_by} "
        f"({flops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB)")
    log(f"K8 by launch (torch.profiler): "
        f"{kernel_split(lambda: kernels.conv_head_fused(x, wts))}")
    return {"name": "conv_head_kernel", "route": "cuda",
            "source": "freesound_classification_tpu_torch/csrc/conv_head.cu",
            "replaces": "freesound_classification_tpu/ops/pallas_head.py:135",
            **out, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None}


def phase_k9() -> dict:
    """K9 at the probe's shape (64 clips x 10 s: 431 frames, F 1025, M 128)
    on the spectrum the fast featurization gives it from clip-like waves,
    on the mel filterbank and on a dense one (every entry non-zero: each
    band's range is every bin), and three wrong inputs that must fail by
    far: im_offset one bin off, frames shifted by one, and the magnitude as
    one float32 chain rounded to bf16 once (swapping re and im would not
    show: |S| is symmetric in them)."""
    from freesound_classification_tpu_torch.ops import kernels

    spec, fb_t = k9_inputs(K9_CLIPS)
    n_freq = fb_t.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(10)
    dense = (torch.rand(fb_t.shape, device="cuda", generator=gen) / 16
             + 1e-3).to(torch.bfloat16)

    def check(label, fb_):
        got_ = kernels.mel_log_split(spec, fb_, n_freq, n_freq)
        want_ = kernels.mel_log_split_reference(spec, fb_, n_freq, n_freq)
        torch.cuda.synchronize()
        if got_.shape != want_.shape or not torch.isfinite(got_).all():
            raise RuntimeError(f"K9 {label}: bad output {tuple(got_.shape)}")
        err_ = (got_ - want_).abs().max().item()
        if not err_ <= K9_TOL:
            raise RuntimeError(f"K9 disagrees with its plain twin on the "
                               f"{label}: {err_}")
        return got_, want_, err_

    got, want, err = check("mel filterbank", fb_t)
    _, _, dense_err = check("dense filterbank", dense)

    def far(out):
        return (out - want).abs().max().item()

    wide = torch.nn.functional.pad(spec, (0, 1))  # room for im one bin on
    off_by_one = far(kernels.mel_log_split(wide, fb_t, n_freq, n_freq + 1))
    shifted = far(kernels.mel_log_split(torch.roll(spec, 1, dims=1), fb_t,
                                        n_freq, n_freq))
    re, im = spec[..., :n_freq].float(), spec[..., n_freq:].float()
    mag = torch.sqrt(re * re + im * im).to(torch.bfloat16)
    chain = far(torch.log(mag.float() @ fb_t.float() + kernels.LOG_EPS)
                .transpose(-1, -2))
    log(f"K9 {tuple(spec.shape)} -> {tuple(got.shape)}: max_abs_err "
        f"{err:.3e}, on a dense filterbank {dense_err:.3e} (tolerance "
        f"{K9_TOL:g}); im_offset one bin off gives {off_by_one:.3e}, frames "
        f"shifted by one {shifted:.3e}, the float32 chain magnitude "
        f"{chain:.3e}")
    if not min(off_by_one, shifted, chain) > 10 * K9_TOL:
        raise RuntimeError("K9's comparison cannot tell a wrong input")
    try:  # frames that are not back to back: refused, never another path
        kernels.mel_log_split(spec.transpose(0, 1), fb_t, n_freq, n_freq)
    except ValueError as refusal:
        log(f"K9 on a spectrum with its frames apart: {refusal}")
    else:
        raise RuntimeError("K9 took a spectrum whose frames are apart")

    def kernel():
        return kernels.mel_log_split(spec, fb_t, n_freq, n_freq)

    ms, plain_ms, times = timed_in_turns(
        kernel,
        lambda: kernels.mel_log_split_reference(spec, fb_t, n_freq, n_freq))
    b, t, _ = spec.shape
    m = fb_t.shape[1]
    # the work these inputs need, float32 on the CUDA cores: |S| once per
    # bin (4 operations), one FMA per non-zero filterbank entry per frame,
    # a log per output
    nnz = int((fb_t != 0).sum())
    flops = b * t * (4 * n_freq + 2 * nnz + m)
    n_bytes = b * t * 2 * n_freq * 2 + fb_t.numel() * 2 + got.numel() * 4
    bound, bound_by = bound_ms(n_bytes, flops, PEAK_F32)
    log(f"K9 time: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms "
        f"(runs {times}); bound {bound:.4f} ms by {bound_by} "
        f"({flops / 1e9:.3f} GFLOP, {nnz} of {fb_t.numel()} filterbank "
        f"entries non-zero, {n_bytes / 1e6:.1f} MB)")
    log(f"K9 by launch (torch.profiler): {kernel_split(kernel)}")
    return {"name": "mel_log_split_kernel", "route": "cuda",
            "source": "freesound_classification_tpu_torch/csrc/"
                      "mel_log_split.cu",
            "replaces": "scripts/probe_dft_context.py:95",
            "max_abs_err": max(err, dense_err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None}


def phase_no_sync() -> None:
    """``augment.resample_rate`` (K2) and ``kernels.pv_resynth`` (K3) at the
    chain's shape, each once under ``torch.cuda.set_sync_debug_mode("error")``
    after a warm-up call: neither wrapper waits for the card (their domain
    checks run in the kernels)."""
    from freesound_classification_tpu_torch.ops import augment, kernels

    wave = chain_wave(CHAIN_ROWS, CHAIN_LEN, 5)
    lengths = torch.full((CHAIN_ROWS,), CHAIN_LEN - 1000, dtype=torch.int32,
                         device="cuda")
    factor = torch.linspace(0.84, 1.31, CHAIN_ROWS, device="cuda")
    args = k3_args()
    calls = (lambda: augment.resample_rate(wave, lengths, factor),
             lambda: kernels.pv_resynth(*args))
    for call in calls:
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("K2 (augment.resample_rate) and K3 (kernels.pv_resynth) ran under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync")


# each run in a child process: a factor and a rate out of the kernels'
# domains must end the child with a device-side error naming the kernel
DOMAIN_CHILDREN = {
    "resample_kernel": """
import torch
from freesound_classification_tpu_torch.ops import kernels
wave = torch.zeros(4, 44100, device="cuda")
factor = torch.tensor([1.0, 1.1, 1.81, 0.9], device="cuda")
kernels.resample_linear(wave, factor)
torch.cuda.synchronize()
""",
    "pv_tile_sum_kernel": """
import torch
from freesound_classification_tpu_torch.ops import kernels
mag = torch.rand(2, 20, 513, device="cuda")
dphi = torch.rand(2, 19, 513, device="cuda")
phase0 = torch.zeros(2, 513, device="cuda")
rate = torch.tensor([1.0, 1.31], device="cuda")
icos, isin = (torch.from_numpy(x).to("cuda", torch.bfloat16)
              for x in kernels.synthesis_basis(1024))
kernels.pv_resynth(mag, dphi, phase0, rate, icos, isin, 256, 20)
torch.cuda.synchronize()
"""}


def phase_domain() -> None:
    """An out-of-domain factor (K2, 1.81 > 1.8) and rate (K3, 1.31 > 1.3),
    each in its own child process, both started together: each child must
    exit non-zero, and its output must name the kernel that stopped it."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, code in DOMAIN_CHILDREN.items()}
    for name, proc in procs.items():
        output = proc.communicate(timeout=300)[0]
        tail = " | ".join(line.strip() for line in output.splitlines()
                          if name in line or "Error" in line)[:400]
        log(f"out-of-domain child for {name}: exit {proc.returncode}; "
            f"{tail}")
        if proc.returncode == 0 or name not in output:
            raise RuntimeError(f"an out-of-domain input did not stop "
                               f"{name} (exit {proc.returncode}):\n"
                               f"{output[-2000:]}")


def phase_step_split(smi: str) -> None:
    """One augmented train step of the bench (``bench_train_steps``'s
    program: B = 64 x 10 s, the bf16 reference-scale model, the chain at
    p_aug 0.75) split by kernel with torch.profiler: the device's busy time
    against the step's CUDA-event time (the rest is the idle share), K1's
    and K3's time and share of the step, and the ten longest kernels."""
    from freesound_classification_tpu_torch import bench

    device = torch.device(DEVICE)
    engine = bench.train_engine(device, bench.NETWORK, True, 16)
    wave, lengths, labels = bench.train_batch(device)

    def step():
        engine.train_step(wave, lengths, labels)

    step_ms = cuda_ms(step, iters=5)
    found = device_kernels(step, calls=3)
    busy = sum(ms for _, ms, _ in found)

    def part(prefix):
        return sum(ms for name, ms, _ in found if name.startswith(prefix))

    k1, k3 = part("mel_log_kernel"), part("pv_")
    log(f"augmented train step (B=64 x 10 s, torch.profiler over 3 steps): "
        f"{step_ms:.3f} ms a step by CUDA events, device busy {busy:.3f} ms "
        f"(idle share {1 - busy / step_ms:.3f}); K1 {k1:.4f} ms "
        f"({100 * k1 / step_ms:.2f}% of the step), K3 {k3:.4f} ms "
        f"({100 * k3 / step_ms:.2f}%) on {smi}")
    log("  ten longest kernels a step: " + "; ".join(
        f"{name[:50]} {ms:.4f} ms x{n:g}" for name, ms, n in found[:10]))

    from freesound_classification_tpu_torch.probes import train_step_split

    for key, stages in (("train", train_step_split.train_stages),
                        ("inference", train_step_split.inference_stages)):
        rows = train_step_split.split(stages(device))
        log(f"{key} stages (probes/train_step_split.py; ms per call by CUDA "
            f"events, busy ms and launches per call by torch.profiler) on "
            f"{smi}:\n" + train_step_split.table(rows))
        log(f"# {key} split " + json.dumps(rows))
        idle = [r["stage"] for r in rows if not r["launches"] > 0]
        if idle:
            raise RuntimeError(f"a stage launched nothing on the card: "
                               f"{idle}")


def phase_ablation(smi: str) -> None:
    """``probes/model_ablation.py``'s variants at the bench shape (B = 64 x
    10 s): featurization with K1, its plain tail and ``torch.stft`` alone;
    the bf16 eval forward at depths 1-6; train mode, float32 and the fused
    blocks at depth 6. ms per call by CUDA events."""
    from freesound_classification_tpu_torch.probes import model_ablation

    rows = []
    for name, fn in model_ablation.variants(torch.device(DEVICE)):
        rows.append((name, cuda_ms(fn, iters=10)))
    log(f"model ablation (probes/model_ablation.py, B=64 x 10 s, ms per call "
        f"by CUDA events) on {smi}:\n" + "\n".join(
            f"  {name:46s} {ms:9.3f} ms" for name, ms in rows))


def synthetic_clip_lengths(n: int, seed: int = 0) -> np.ndarray:
    """The bench's test length distribution: lognormal, clipped to 1-15 s."""
    rng = np.random.RandomState(seed)
    secs = np.clip(rng.lognormal(mean=1.45, sigma=0.6, size=n), 1.0, 15.0)
    return (secs * SR).astype(np.int64)


def clip_draws(n: int, rng: np.random.RandomState) -> tuple:
    """What ``synthetic_clip`` draws from ``rng``, in its order: the noise,
    its spectral tilt, three (amplitude, frequency) tones, the level."""
    noise = rng.randn(n)
    tilt = rng.uniform(0.0, 1.5)
    tones = [(rng.uniform(0.0, 2.0), rng.uniform(60.0, 12000.0))
             for _ in range(3)]
    return noise, tilt, tones, rng.uniform(-3.0, -0.5)


def synthetic_clip(n: int, rng: np.random.RandomState) -> np.ndarray:
    """One clip whose log-mel image differs from its neighbours': noise with
    a random spectral tilt plus three tones, at a level drawn over 50 dB, so
    the random-weight model's outputs vary across clips."""
    noise, tilt, tones, level = clip_draws(n, rng)
    spectrum = np.fft.rfft(noise)
    spectrum *= np.arange(1, spectrum.size + 1) ** -tilt
    noise = np.fft.irfft(spectrum, n)
    t = np.arange(n) / SR
    audio = noise / noise.std() + sum(
        amp * np.sin(2 * np.pi * freq * t) for amp, freq in tones)
    return audio * (10.0 ** level / np.abs(audio).max())


def wav_job(path: str, n: int, rng: np.random.RandomState,
            tones: tuple = (), scale: float = 1.0) -> tuple:
    """A ``render_wav`` job for the next ``synthetic_clip(n, rng)``: the
    generator's state at the clip, which then moves past the clip's draws
    as ``synthetic_clip`` moves it."""
    state = rng.get_state()
    clip_draws(n, rng)
    return path, n, state, tuple(tones), scale


def render_wav(job: tuple) -> None:
    """Write ``scale`` x (the job's ``synthetic_clip`` plus 0.2 x a sine of
    each of its tone frequencies, added in turn) as a WAV."""
    path, n, state, tones, scale = job
    rng = np.random.RandomState()
    rng.set_state(state)
    audio = synthetic_clip(n, rng)
    t = np.arange(n) / SR
    for freq in tones:
        audio = audio + 0.2 * np.sin(2 * np.pi * freq * t)
    write_wav(path, scale * audio if scale != 1.0 else audio)


def render_wavs(jobs: list) -> None:
    """``render_wav`` over ``jobs`` on a thread a core: the FFTs of awkward
    lengths and the sines dominate, and numpy runs them without the
    interpreter lock. The same bytes as in turn."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(render_wav, jobs))


def write_wav(path: str, audio: np.ndarray) -> None:
    """Mono 16-bit PCM at ``SR``."""
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(audio, -1.0, 1.0) * 32767.0)
                      .astype("<i2").tobytes())


def write_inputs(root: str) -> dict:
    """WAVs, test CSV, class map and a 5-fold experiment dir of each family
    under ``root``."""
    rng = np.random.RandomState(1)
    test_dir = os.path.join(root, "test")
    os.makedirs(test_dir)
    fnames, jobs = [], []
    for i, n in enumerate(synthetic_clip_lengths(N_CLIPS)):
        fname = f"clip{i:03d}.wav"
        jobs.append(wav_job(os.path.join(test_dir, fname), int(n), rng))
        fnames.append(fname)
    render_wavs(jobs)
    test_csv = os.path.join(root, "test.csv")
    with open(test_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["fname"])
        writer.writerows([name] for name in fnames)
    classes = [f"class_{c:02d}" for c in range(N_CLASSES)]
    classmap = os.path.join(root, "classmap.json")
    with open(classmap, "w") as f:
        json.dump({c: i for i, c in enumerate(classes)}, f)

    return {"test_dir": test_dir, "test_csv": test_csv, "classmap": classmap,
            "experiment": write_experiment(root, "2d_cnn", 100),
            "hier_experiment": write_experiment(root, "hierarchical_cnn",
                                                200),
            "backbone_experiment": write_experiment(root, "backbone_cnn",
                                                    300),
            "fnames": fnames, "classes": classes}


def write_experiment(root: str, model_kind: str, seed: int) -> str:
    """A ``N_FOLDS``-fold experiment dir of ``model_kind`` at ``NETWORK``'s
    width (the backbone: ``BACKBONE``) over ``FEATURES``, its folds random
    from ``seed`` in the JAX package's layout, as a JAX-trained experiment
    exported for the port."""
    from freesound_classification_tpu_torch import interop
    from freesound_classification_tpu_torch.ops import dsp

    exp = os.path.join(root, f"experiment_{model_kind}")
    config = {"network": dict(NETWORK, backbone=BACKBONE),
              "data": {"features": FEATURES, "_n_folds": N_FOLDS,
                       "_n_classes": N_CLASSES},
              "train": {}, "label": "chip_smoke"}
    network = {k: NETWORK[k] for k in ("num_conv_blocks",
                                       "start_deep_supervision_on",
                                       "conv_base_depth", "growth_rate")}
    for k in range(N_FOLDS):
        fold_dir = os.path.join(exp, "checkpoints", f"fold_{k}")
        os.makedirs(fold_dir)
        params, stats = interop.random_jax_variables(
            **network, n_classes=N_CLASSES, seed=seed + k,
            model_kind=model_kind, backbone=BACKBONE,
            input_dim=dsp.parse_features(FEATURES).n_features)
        interop.save_fold_npz(os.path.join(fold_dir, "best_model.npz"),
                              params, stats)
    with open(os.path.join(exp, "config.json"), "w") as f:
        json.dump(config, f)
    return exp


def read_predictions(path: str):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], \
        np.array([[float(v) for v in r[1:]] for r in rows[1:]])


def decoded_batches(inputs: dict) -> list:
    """The predict CLI's host side: the test clips decoded and padded into
    its bucketed batches (4 threads)."""
    from freesound_classification_tpu_torch.cli import common
    from freesound_classification_tpu_torch.data.dataset import ClipDataset
    from freesound_classification_tpu_torch.data.loader import make_loader

    return list(make_loader(
        ClipDataset([os.path.join(inputs["test_dir"], f)
                     for f in inputs["fnames"]], sr=SR),
        common.default_ladder(None), max_batch_elems=MAX_BATCH_ELEMS,
        num_workers=4))


def phase_main_path(root: str, inputs: dict, smi: str) -> tuple:
    """The 2d predict CLI; returns K1's launches and the CSV's
    probabilities."""
    from freesound_classification_tpu_torch.cli import predict_2d_cnn
    from freesound_classification_tpu_torch.ops import kernels

    out_csv = os.path.join(root, "preds.csv")
    argv = ["--experiment", inputs["experiment"],
            "--test_df", inputs["test_csv"],
            "--test_data_dir", inputs["test_dir"],
            "--classmap", inputs["classmap"], "--output_df", out_csv,
            "--max_batch_elems", str(MAX_BATCH_ELEMS), "--num_workers", "4",
            "--device", DEVICE, "--bf16"]

    t0 = time.time()
    predict_2d_cnn.main(argv)  # warm-up: first launches, cuDNN set-up
    torch.cuda.synchronize()
    log(f"predict warm-up run: {time.time() - t0:.2f} s")

    kernels.mel_project_log.launches = 0
    t0 = time.time()
    predict_2d_cnn.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = kernels.mel_project_log.launches
    log(f"predict timed run: {wall:.3f} s, {N_CLIPS / wall:.2f} clips/s "
        f"end to end (decode, 5-fold bf16 ensemble, CSV) on {smi}")
    log(f"K1 launches in the timed run: {launches}")
    if launches <= 0:
        raise RuntimeError("the predict path never launched K1")

    header, fnames, probs = read_predictions(out_csv)
    if header != ["fname", *sorted(inputs["classes"])]:
        raise RuntimeError(f"bad CSV header: {header[:4]}...")
    if fnames != inputs["fnames"] or probs.shape != (N_CLIPS, N_CLASSES):
        raise RuntimeError(f"bad CSV rows: {probs.shape}")
    if not (np.isfinite(probs).all() and probs.min() >= 0
            and probs.max() <= 1):
        raise RuntimeError("predictions not finite in [0, 1]")
    # what features from the wrong clip would do: each clip's predictions
    # against the next clip's; the bf16 tolerance must sit well below this
    swapped = float(np.abs(probs - np.roll(probs, 1, axis=0)).max())
    log(f"CSV ok: {probs.shape}, probabilities in "
        f"[{probs.min():.4g}, {probs.max():.4g}], mean {probs.mean():.4g}, "
        f"std over clips {probs.std(axis=0).mean():.4g}; max |dp| between "
        f"neighbouring clips {swapped:.4g}")
    if not swapped > 2 * ENSEMBLE_BF16_TOL:
        raise RuntimeError(
            f"predictions barely depend on the clip ({swapped:.3g}): a "
            f"{ENSEMBLE_BF16_TOL:g} comparison could not tell wrong features")

    # the host side of the CLI: decode + pad, then fold models to the card
    t0 = time.time()
    host = decoded_batches(inputs)
    decode_s = time.time() - t0
    t0 = time.time()
    kernel_pred = predict_2d_cnn.build_predictor(
        inputs["experiment"], torch.device(DEVICE), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    log(f"host side: 5 fold models from .npz to the card {load_s:.3f} s; "
        f"decode + pad of {len(host)} batches (4 threads) {decode_s:.3f} s")
    plain = predict_2d_cnn.build_predictor(
        inputs["experiment"], torch.device(DEVICE), dtype=torch.bfloat16,
        mel_project=kernels.mel_project_log_reference)

    diff = float(np.abs(plain.predict_loader(host) - probs).max())
    log(f"5-fold bf16 predictions, CLI (K1) against the plain twin's: "
        f"max |dp| {diff:.3e} (tolerance {ENSEMBLE_BF16_TOL:g})")
    if not diff <= ENSEMBLE_BF16_TOL:
        raise RuntimeError(f"ensemble through K1 disagrees: {diff}")

    # float32, every batch of the run: K1's log-mel and the ensemble's
    # probabilities against the plain twin's
    f32 = [predict_2d_cnn.build_predictor(
        inputs["experiment"], torch.device(DEVICE), mel_project=fn)
        for fn in (kernels.mel_project_log, kernels.mel_project_log_reference)]
    mel_err = prob_err = 0.0
    with torch.inference_mode():
        for b in host:
            wave_, lengths = (torch.as_tensor(b[k], device=DEVICE)
                              for k in ("signal", "lengths"))
            mels = [p.frontend(wave_, lengths)[0] for p in f32]
            mel_err = max(mel_err, (mels[0] - mels[1]).abs().max().item())
            ps = [p.predict_batch(wave_, lengths) for p in f32]
            prob_err = max(prob_err, (ps[0] - ps[1]).abs().max().item())
    log(f"float32 over all {len(host)} batches "
        f"({[b['signal'].shape[0] for b in host]} clips): log-mel max |err| "
        f"{mel_err:.3e} (tolerance {K1_TOL:g}), 5-fold probabilities max "
        f"|dp| {prob_err:.3e} (tolerance {ENSEMBLE_F32_TOL:g})")
    if not mel_err <= K1_TOL:
        raise RuntimeError(f"K1's log-mel disagrees on the path: {mel_err}")
    if not prob_err <= ENSEMBLE_F32_TOL:
        raise RuntimeError(f"f32 ensemble through K1 disagrees: {prob_err}")

    # the device path alone over the decoded batches: both frontends, in turns
    batches = [(torch.as_tensor(b["signal"], device=DEVICE),
                torch.as_tensor(b["lengths"], device=DEVICE))
               for b in host]
    sweeps = {"K1": [], "plain twin": []}
    for name in ("K1", "plain twin", "plain twin", "K1"):
        pred = kernel_pred if name == "K1" else plain
        torch.cuda.synchronize()
        t0 = time.time()
        for wave_, lengths in batches:
            pred.predict_batch(wave_, lengths)
        torch.cuda.synchronize()
        sweeps[name].append(N_CLIPS / (time.time() - t0))
    log("device sweep over the decoded batches (clips/s, two runs each): "
        + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f}" for k, v in sweeps.items())
        + f" on {smi}")
    return launches, probs


def write_train_inputs(root: str) -> dict:
    """Labelled WAVs of 8.5-15 s (all in the 15 s crop's bucket, so every
    train batch is full), each class marked by its own tone, plus the train
    CSV and class map."""
    rng = np.random.RandomState(5)
    train_dir = os.path.join(root, "train")
    os.makedirs(train_dir)
    classes = [f"class_{c}" for c in range(TRAIN_CLASSES)]
    rows, jobs = [], []
    for i in range(N_TRAIN_CLIPS):
        n = int(rng.uniform(*TRAIN_SECONDS) * SR)
        label = [i % TRAIN_CLASSES] + ([(i * 3 + 1) % TRAIN_CLASSES]
                                       if i % 4 == 0 else [])
        fname = f"train{i:03d}.wav"
        jobs.append(wav_job(os.path.join(train_dir, fname), n, rng,
                            [300.0 * (c + 1) for c in label], 0.5))
        rows.append((fname, ",".join(classes[c] for c in sorted(set(label)))))
    render_wavs(jobs)
    train_csv = os.path.join(root, "train.csv")
    with open(train_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["fname", "labels"])
        writer.writerows(rows)
    classmap = os.path.join(root, "train_classmap.json")
    with open(classmap, "w") as f:
        json.dump({c: i for i, c in enumerate(classes)}, f)
    return {"train_dir": train_dir, "train_csv": train_csv,
            "classmap": classmap, "fnames": [r[0] for r in rows],
            "classes": classes}


def train_argv(inputs: dict, experiments_dir: str) -> list:
    """The train path's 2d train CLI: the recipe, fold 0 of 5,
    ``TRAIN_EPOCHS`` epochs."""
    return ["--train_df", inputs["train_csv"],
            "--train_data_dir", inputs["train_dir"],
            "--classmap", inputs["classmap"], "--device", DEVICE, *RECIPE,
            "--folds", "0", "--n_folds", "5", "--epochs", str(TRAIN_EPOCHS),
            "--num_workers", "4", "--log_interval", "1",
            "--experiments_dir", experiments_dir]


def experiment_files(experiment_dir: str) -> set:
    """Every directory and file under an experiment, relative to it (a
    summary's event file by its directory: its name has the time)."""
    return {os.path.relpath(os.path.join(
        d, "events" if name.startswith("events.out.") else name),
        experiment_dir)
        for d, dirs, files in os.walk(experiment_dir)
        for name in dirs + files}


def phase_train(root: str, inputs: dict, smi: str) -> tuple:
    from freesound_classification_tpu_torch import interop
    from freesound_classification_tpu_torch.cli import (
        predict_2d_cnn,
        train_2d_cnn,
    )
    from freesound_classification_tpu_torch.ops import kernels
    from freesound_classification_tpu_torch.training.state import (
        create_model,
    )

    argv = train_argv(inputs, os.path.join(root, "experiments"))
    counted = {"K1": kernels.mel_project_log, "K2": kernels.resample_linear,
               "K3": kernels.pv_resynth}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.time()
    experiment = train_2d_cnn.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    log(f"train CLI: {wall:.2f} s for {TRAIN_EPOCHS} epochs of fold 0 "
        f"(validation and checkpoints included); launches {launches}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"the train path missed a kernel: {launches}")

    with open(os.path.join(experiment.experiment_dir, "results.json")) as f:
        fold = json.load(f)["fold0"]
    losses = fold["train_loss"]
    if not np.isfinite(losses).all():
        raise RuntimeError(f"train losses not finite: {losses}")
    steps, seconds = fold["train_steps"][-1], fold["train_seconds"][-1]
    log(f"train epochs: mean loss {losses}, validation lwlrap "
        f"{fold['metric']:.4f}; last epoch {steps:g} steps in {seconds:.3f} "
        f"s = {steps / seconds:.3f} steps/s, "
        f"{fold['train_clips_per_sec'][-1]:.2f} clips/s (batch 20, 15 s "
        f"bucket, bf16, decode and augmentation included) on {smi}")

    fold_dir = os.path.join(experiment.experiment_dir, "checkpoints",
                            "fold_0")
    final, _ = interop.load_fold_npz(os.path.join(fold_dir,
                                                  "final_model.npz"))
    fresh, _ = interop.to_jax_variables(create_model(
        experiment.config.network, TRAIN_CLASSES, torch.bfloat16, 42,
        torch.device("cpu")).state_dict())
    blocks = sorted(k for k in final if k.startswith("block"))
    moved = {k: float(np.abs(final[k]["conv"]["kernel"]
                             - fresh[k]["conv"]["kernel"]).max())
             for k in (blocks[0], blocks[-1])}
    moved["head.fc2"] = float(np.abs(final["head"]["fc2"]["kernel"]
                                     - fresh["head"]["fc2"]["kernel"]).max())
    log(f"parameters moved from their init by (max |dw|): {moved}")
    if not min(moved.values()) > 0:
        raise RuntimeError("the train path did not move the parameters")

    test_csv = os.path.join(root, "train_test.csv")
    with open(test_csv, "w") as f:
        f.write("fname\n" + "".join(n + "\n" for n in inputs["fnames"][:8]))
    out_csv = os.path.join(root, "train_preds.csv")
    predict_2d_cnn.main([
        "--experiment", experiment.experiment_dir, "--test_df", test_csv,
        "--test_data_dir", inputs["train_dir"],
        "--classmap", inputs["classmap"], "--output_df", out_csv,
        "--device", DEVICE, "--bf16", "--folds", "0"])
    header, fnames, probs = read_predictions(out_csv)
    if (header != ["fname", *inputs["classes"]]
            or probs.shape != (8, TRAIN_CLASSES)
            or not np.isfinite(probs).all()
            or probs.min() < 0 or probs.max() > 1):
        raise RuntimeError(f"bad predictions from the trained fold: "
                           f"{header[:3]} {probs.shape}")
    log(f"best_model.npz through the predict CLI: {probs.shape} finite "
        f"probabilities in [{probs.min():.4g}, {probs.max():.4g}]")
    return launches, experiment.experiment_dir


def phase_profile(root: str, inputs: dict, smi: str) -> None:
    """The 2d train CLI with ``--profile`` at the recipe's width, 2 epochs
    of fold 0, apart from ``phase_train`` (whose last-epoch rate would
    otherwise be taken under the profiler): a trace of epoch 1 lands under
    ``summaries/profile`` and names K1, K2 and K3."""
    from freesound_classification_tpu_torch.cli import train_2d_cnn

    argv = ["--train_df", inputs["train_csv"],
            "--train_data_dir", inputs["train_dir"],
            "--classmap", inputs["classmap"], "--device", DEVICE, *RECIPE,
            "--folds", "0", "--n_folds", "5", "--epochs", "2",
            "--num_workers", "4", "--log_interval", "10", "--profile",
            "--label", "profile",
            "--experiments_dir", os.path.join(root, "experiments")]
    t0 = time.time()
    experiment = train_2d_cnn.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    profile = os.path.join(experiment.experiment_dir, "summaries", "profile")
    traces = sorted(os.listdir(profile)) if os.path.isdir(profile) else []
    if not traces:
        raise RuntimeError(f"--profile wrote no trace under {profile}")
    # the identifiers in the names of the trace's device kernels
    launched = collections.Counter()
    for t in traces:
        with open(os.path.join(profile, t)) as f:
            events = json.load(f)["traceEvents"]
        for e in events:
            if e.get("cat") == "kernel":
                launched.update(set(re.findall(r"\w+", e.get("name", ""))))
    wanted = {"K1": ("mel_log_kernel",), "K2": ("resample_kernel",),
              "K3": ("pv_tile_sum_kernel", "pv_resynth_kernel",
                     "pv_ola_fix_kernel")}
    named = {k: {n: launched[n] for n in names}
             for k, names in wanted.items()}
    log(f"profile: train CLI --profile, {wall:.2f} s for 2 epochs of fold 0; "
        f"{len(traces)} trace(s) of epoch 1, device kernel events by name "
        f"{named} on {smi}")
    if not all(n > 0 for names in named.values() for n in names.values()):
        raise RuntimeError(f"the trace misses a kernel: {named}")


def phase_hier_train(root: str, inputs: dict, smi: str) -> tuple:
    """The hierarchical train CLI at full width; returns the experiment and
    the K1/K2/K3 launches of its run."""
    from freesound_classification_tpu_torch import interop
    from freesound_classification_tpu_torch.cli import train_hierarchical_cnn
    from freesound_classification_tpu_torch.ops import dsp, kernels
    from freesound_classification_tpu_torch.training.state import (
        create_model,
    )

    argv = ["--train_df", inputs["train_csv"],
            "--train_data_dir", inputs["train_dir"],
            "--classmap", inputs["classmap"], "--device", DEVICE,
            *HIER_RECIPE, "--folds", "0", "--n_folds", "5",
            "--epochs", str(HIER_TRAIN_EPOCHS), "--num_workers", "4",
            "--log_interval", "1", "--label", "hier_pretrain",
            "--experiments_dir", os.path.join(root, "experiments")]
    counted = {"K1": kernels.mel_project_log, "K2": kernels.resample_linear,
               "K3": kernels.pv_resynth}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.time()
    experiment = train_hierarchical_cnn.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    log(f"hierarchical train CLI: {wall:.2f} s for {HIER_TRAIN_EPOCHS} "
        f"epochs of fold 0 (validation and checkpoints included); launches "
        f"{launches}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"the hierarchical train path missed a kernel: "
                           f"{launches}")
    fold = train_results(experiment, smi)
    final, _ = interop.load_fold_npz(os.path.join(
        experiment.experiment_dir, "checkpoints", "fold_0",
        "final_model.npz"))
    fresh, _ = interop.to_jax_variables(create_model(
        experiment.config.network, TRAIN_CLASSES, torch.bfloat16, 42,
        torch.device("cpu"), model_kind="hierarchical_cnn",
        input_dim=dsp.parse_features(FEATURES).n_features).state_dict())
    moved = {k: float(np.abs(final[k]["conv"]["kernel"]
                             - fresh[k]["conv"]["kernel"]).max())
             for k in ("block0", f"block{NETWORK['num_conv_blocks'] - 1}")}
    moved["head.fc2"] = float(np.abs(final["head"]["fc2"]["kernel"]
                                     - fresh["head"]["fc2"]["kernel"]).max())
    log(f"hierarchical parameters moved from their init by (max |dw|): "
        f"{moved}; validation lwlrap {fold['metric']:.4f}")
    if not min(moved.values()) > 0:
        raise RuntimeError("the hierarchical train path did not move the "
                           "parameters")
    return experiment, launches


def train_results(experiment, smi: str) -> dict:
    """Fold 0's results.json entry, checked finite, with its last epoch's
    rate logged."""
    with open(os.path.join(experiment.experiment_dir, "results.json")) as f:
        fold = json.load(f)["fold0"]
    losses = fold["train_loss"]
    if not np.isfinite(losses).all():
        raise RuntimeError(f"train losses not finite: {losses}")
    steps, seconds = fold["train_steps"][-1], fold["train_seconds"][-1]
    log(f"  mean losses {losses}; last epoch {steps:g} steps in "
        f"{seconds:.3f} s = {steps / seconds:.3f} steps/s, "
        f"{fold['train_clips_per_sec'][-1]:.2f} clips/s (batch 20, 15 s "
        f"bucket, bf16, decode and augmentation included) on {smi}")
    return fold


def _leaves(tree: dict, prefix: str = ""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", np.asarray(value)


def phase_hier_finetune(root: str, inputs: dict, pretrained, smi: str
                        ) -> None:
    """The finetune CLI from the pretrained experiment's fold 0, one epoch,
    asked for fewer blocks (the pretrained config's must win). Its first
    train step must start from the pretrained weights and statistics
    exactly."""
    from freesound_classification_tpu_torch import interop
    from freesound_classification_tpu_torch.cli import (
        finetune_hierarchical_cnn,
    )
    from freesound_classification_tpu_torch.ops import kernels
    from freesound_classification_tpu_torch.training import engine as eng

    best = os.path.join(pretrained.experiment_dir, "checkpoints", "fold_0",
                        "best_model.npz")
    want = dict(_leaves(dict(zip(("params", "batch_stats"),
                                 interop.load_fold_npz(best)))))
    first = {}
    train_step = eng.Engine.train_step

    def checked_step(self, *args, **kwargs):
        if not first:  # the state the first optimizer step starts from
            got = dict(_leaves(dict(zip(
                ("params", "batch_stats"),
                interop.to_jax_variables(self.model.state_dict())))))
            first["keys"] = got.keys() == want.keys()
            first["max_diff"] = max(float(np.abs(got[k] - want[k]).max())
                                    for k in want) if first["keys"] else None
        return train_step(self, *args, **kwargs)

    argv = ["--train_df", inputs["train_csv"],
            "--train_data_dir", inputs["train_dir"],
            "--classmap", inputs["classmap"], "--device", DEVICE,
            *HIER_RECIPE,
            "--num_conv_blocks", str(NETWORK["num_conv_blocks"] // 2),
            "--folds", "0",
            "--n_folds", "5", "--epochs", str(FINETUNE_EPOCHS),
            "--num_workers", "4", "--log_interval", "1",
            "--label", "hier_finetune",
            "--pretrained_model", pretrained.experiment_dir,
            "--pretrained_fold", "0",
            "--experiments_dir", os.path.join(root, "experiments")]
    kernels.mel_project_log.launches = 0
    eng.Engine.train_step = checked_step
    t0 = time.time()
    try:
        experiment = finetune_hierarchical_cnn.main(argv)
    finally:
        eng.Engine.train_step = train_step
    torch.cuda.synchronize()
    log(f"hierarchical finetune CLI: {time.time() - t0:.2f} s for "
        f"{FINETUNE_EPOCHS} epoch; K1 launches "
        f"{kernels.mel_project_log.launches}; the first step started from "
        f"the pretrained fold's arrays: same keys {first.get('keys')}, max "
        f"|diff| {first.get('max_diff')}")
    if not (first.get("keys") and first["max_diff"] == 0.0):
        raise RuntimeError("the finetune CLI did not start from the "
                           "pretrained weights")
    if (int(experiment.config.network.num_conv_blocks)
            != NETWORK["num_conv_blocks"]):
        raise RuntimeError("the finetune CLI did not take the pretrained "
                           "architecture")
    if kernels.mel_project_log.launches <= 0:
        raise RuntimeError("the finetune path never launched K1")
    train_results(experiment, smi)


class plain_fused_blocks:
    """Within the block, the fused resnet blocks run their plain PyTorch
    versions on the card in place of the kernels (to compare the two on
    the same path)."""

    names = ("resnet_block_1d_fused", "resnet_block_2d_fused",
             "basic_block_fused", "conv_head_fused")

    def __enter__(self):
        from freesound_classification_tpu_torch.ops import kernels

        self.saved = {n: getattr(kernels, n) for n in self.names}
        for n in self.names:
            setattr(kernels, n, getattr(kernels, f"{n}_reference"))

    def __exit__(self, *exc):
        from freesound_classification_tpu_torch.ops import kernels

        for n, fn in self.saved.items():
            setattr(kernels, n, fn)


def ensemble_ms_per_batch(predictors: dict, host: list) -> dict:
    """Mean ms per batch of each predictor over the same decoded batches,
    by CUDA events, in turns (first, second, second, first)."""
    batches = [(torch.as_tensor(b["signal"], device=DEVICE),
                torch.as_tensor(b["lengths"], device=DEVICE)) for b in host]
    first, second = predictors
    times = {name: [] for name in predictors}
    for name in (first, second, second, first):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for wave_, lengths in batches:
            predictors[name].predict_batch(wave_, lengths)
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / len(batches))
    return times


def fused_ensemble(label: str, model_kind: str, experiment: str,
                   csv_probs: np.ndarray, host: list, counter, smi: str,
                   per_model: int | None = None,
                   option: str = "fused_infer") -> int:
    """The 5-fold bf16 ensemble of ``experiment`` through
    ``build_predictor(..., option=True)`` (``fused_infer`` or
    ``fused_head``) over the decoded batches: the kernel's launches
    (``per_model`` per fold and batch, by default one per block of
    ``NETWORK``), the fused probabilities against the
    unfused CLI's CSV and against the fused path through the plain
    versions, and the fused and unfused ensembles' ms per batch. Returns
    the launches."""
    from freesound_classification_tpu_torch.cli import predict_2d_cnn

    def predictor(fused):
        return predict_2d_cnn.build_predictor(
            experiment, torch.device(DEVICE), dtype=torch.bfloat16,
            model_kind=model_kind, **{option: fused})

    unfused, fused = predictor(False), predictor(True)
    counter.launches = 0
    probs = fused.predict_loader(host)
    torch.cuda.synchronize()
    launches = counter.launches
    if per_model is None:
        per_model = NETWORK["num_conv_blocks"]
    expected = per_model * N_FOLDS * len(host)
    with plain_fused_blocks():
        plain = fused.predict_loader(host)
    vs_unfused = float(np.abs(probs - csv_probs).max())
    vs_plain = float(np.abs(probs - plain).max())
    log(f"{label} fused ensemble ({len(host)} batches): {launches} launches "
        f"(expected {expected}); probabilities in [{probs.min():.4g}, "
        f"{probs.max():.4g}]; max |dp| against the unfused CLI's CSV "
        f"{vs_unfused:.3e} (tolerance {FUSED_BF16_TOL:g}), against the "
        f"fused path through the plain versions {vs_plain:.3e} (tolerance "
        f"{FUSED_PLAIN_TOL:g})")
    if launches != expected:
        raise RuntimeError(f"{label}: {launches} fused launches, expected "
                           f"{expected}")
    if not (np.isfinite(probs).all() and vs_unfused <= FUSED_BF16_TOL):
        raise RuntimeError(f"{label}: fused ensemble disagrees with the "
                           f"unfused one: {vs_unfused}")
    if not vs_plain <= FUSED_PLAIN_TOL:
        raise RuntimeError(f"{label}: fused ensemble through the kernel "
                           f"disagrees with the plain versions: {vs_plain}")
    times = ensemble_ms_per_batch({"unfused": unfused, "fused": fused}, host)
    log(f"{label} 5-fold bf16 ensemble, ms per batch (mean over the "
        f"{len(host)} batches, runs in turns): "
        + ", ".join(f"{k} {np.mean(v):.3f} ({v[0]:.3f} / {v[1]:.3f})"
                    for k, v in times.items()) + f" on {smi}")
    return launches


def phase_hier_predict(root: str, inputs: dict, host: list, smi: str
                       ) -> int:
    """The predict CLI with ``--model_kind hierarchical_cnn`` over the 200
    test clips, then the same ensemble fused; returns K6's launches."""
    from freesound_classification_tpu_torch.cli import predict_2d_cnn
    from freesound_classification_tpu_torch.ops import kernels

    out_csv = os.path.join(root, "hier_preds.csv")
    t0 = time.time()
    predict_2d_cnn.main([
        "--experiment", inputs["hier_experiment"],
        "--test_df", inputs["test_csv"], "--test_data_dir",
        inputs["test_dir"], "--classmap", inputs["classmap"],
        "--output_df", out_csv, "--max_batch_elems", str(MAX_BATCH_ELEMS),
        "--num_workers", "4", "--device", DEVICE, "--bf16",
        "--model_kind", "hierarchical_cnn"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    header, fnames, probs = read_predictions(out_csv)
    if (header != ["fname", *sorted(inputs["classes"])]
            or fnames != inputs["fnames"]
            or probs.shape != (N_CLIPS, N_CLASSES)
            or not np.isfinite(probs).all() or probs.min() < 0
            or probs.max() > 1):
        raise RuntimeError(f"bad hierarchical CSV: {probs.shape}")
    swapped = float(np.abs(probs - np.roll(probs, 1, axis=0)).max())
    log(f"hierarchical predict CLI: {wall:.3f} s (first run), "
        f"{N_CLIPS / wall:.2f} clips/s; CSV {probs.shape} in "
        f"[{probs.min():.4g}, {probs.max():.4g}]; max |dp| between "
        f"neighbouring clips {swapped:.4g}")
    if not swapped > 2 * FUSED_BF16_TOL:
        raise RuntimeError("hierarchical predictions barely depend on the "
                           "clip")
    return fused_ensemble("hierarchical", "hierarchical_cnn",
                          inputs["hier_experiment"], probs, host,
                          kernels.resnet_block_1d_fused, smi)


def phase_backbone_predict(root: str, inputs: dict, host: list, smi: str
                           ) -> int:
    """The predict CLI with ``--model_kind backbone_cnn`` (5 folds of
    ``BACKBONE`` in bf16) over the 200 test clips, a warm-up run and a
    timed one, then the same ensemble with ``fused_infer``; returns K7's
    launches (13 identity blocks of resnet34 per fold and batch)."""
    from freesound_classification_tpu_torch.cli import predict_2d_cnn
    from freesound_classification_tpu_torch.models.backbone import (
        RESNET_STAGES,
    )
    from freesound_classification_tpu_torch.ops import kernels

    out_csv = os.path.join(root, "backbone_preds.csv")
    argv = ["--experiment", inputs["backbone_experiment"],
            "--test_df", inputs["test_csv"], "--test_data_dir",
            inputs["test_dir"], "--classmap", inputs["classmap"],
            "--output_df", out_csv, "--max_batch_elems",
            str(MAX_BATCH_ELEMS), "--num_workers", "4", "--device", DEVICE,
            "--bf16", "--model_kind", "backbone_cnn"]
    walls = []
    for _ in range(2):  # warm-up, then timed
        t0 = time.time()
        predict_2d_cnn.main(argv)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    header, fnames, probs = read_predictions(out_csv)
    if (header != ["fname", *sorted(inputs["classes"])]
            or fnames != inputs["fnames"]
            or probs.shape != (N_CLIPS, N_CLASSES)
            or not np.isfinite(probs).all() or probs.min() < 0
            or probs.max() > 1):
        raise RuntimeError(f"bad backbone CSV: {probs.shape}")
    swapped = float(np.abs(probs - np.roll(probs, 1, axis=0)).max())
    log(f"backbone predict CLI ({BACKBONE}, 5 folds, bf16): warm-up "
        f"{walls[0]:.3f} s, timed {walls[1]:.3f} s = "
        f"{N_CLIPS / walls[1]:.2f} clips/s end to end on {smi}; CSV "
        f"{probs.shape} in [{probs.min():.4g}, {probs.max():.4g}]; max |dp| "
        f"between neighbouring clips {swapped:.4g}")
    if not swapped > 2 * FUSED_BF16_TOL:
        raise RuntimeError("backbone predictions barely depend on the clip")
    identity = sum(n - (stage > 0)
                   for stage, n in enumerate(RESNET_STAGES[BACKBONE]))
    return fused_ensemble("backbone", "backbone_cnn",
                          inputs["backbone_experiment"], probs, host,
                          kernels.basic_block_fused, smi,
                          per_model=identity)


def phase_backbone_train(root: str, inputs: dict, smi: str) -> dict:
    """The backbone train CLI (``BACKBONE_RECIPE``) on fold 0; returns the
    K1/K2/K3 launches of its run."""
    from freesound_classification_tpu_torch import interop
    from freesound_classification_tpu_torch.cli import train_backbone_cnn
    from freesound_classification_tpu_torch.models.backbone import (
        RESNET_STAGES,
    )
    from freesound_classification_tpu_torch.ops import kernels
    from freesound_classification_tpu_torch.training.state import (
        create_model,
    )

    argv = ["--train_df", inputs["train_csv"],
            "--train_data_dir", inputs["train_dir"],
            "--classmap", inputs["classmap"], "--device", DEVICE,
            *BACKBONE_RECIPE, "--folds", "0", "--n_folds", "5",
            "--epochs", str(BACKBONE_TRAIN_EPOCHS), "--num_workers", "4",
            "--log_interval", "1", "--label", "backbone",
            "--experiments_dir", os.path.join(root, "experiments")]
    counted = {"K1": kernels.mel_project_log, "K2": kernels.resample_linear,
               "K3": kernels.pv_resynth}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.time()
    experiment = train_backbone_cnn.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    log(f"backbone train CLI ({BACKBONE}): {wall:.2f} s for "
        f"{BACKBONE_TRAIN_EPOCHS} epochs of fold 0 (validation and "
        f"checkpoints included); launches {launches}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"the backbone train path missed a kernel: "
                           f"{launches}")
    if experiment.config.network.backbone != BACKBONE:
        raise RuntimeError("config.json lacks network.backbone")
    fold = train_results(experiment, smi)
    final, _ = interop.load_fold_npz(os.path.join(
        experiment.experiment_dir, "checkpoints", "fold_0",
        "final_model.npz"))
    fresh, _ = interop.to_jax_variables(create_model(
        experiment.config.network, TRAIN_CLASSES, torch.bfloat16, 42,
        torch.device("cpu"), model_kind="backbone_cnn").state_dict())
    last = f"stage3_block{RESNET_STAGES[BACKBONE][-1] - 1}"
    trunk, fresh_trunk = final["trunk"], fresh["trunk"]
    moved = {
        "trunk.conv1": float(np.abs(trunk["conv1"]["kernel"]
                                    - fresh_trunk["conv1"]["kernel"]).max()),
        f"trunk.{last}.conv2": float(np.abs(
            trunk[last]["conv2"]["kernel"]
            - fresh_trunk[last]["conv2"]["kernel"]).max())}
    moved["head.fc2"] = float(np.abs(final["head"]["fc2"]["kernel"]
                                     - fresh["head"]["fc2"]["kernel"]).max())
    log(f"backbone parameters moved from their init by (max |dw|): "
        f"{moved}; validation lwlrap {fold['metric']:.4f}")
    if not min(moved.values()) > 0:
        raise RuntimeError("the backbone train path did not move the "
                           "parameters")
    return launches


def write_recipe_layout(root: str, curated: dict) -> dict:
    """An FSDKaggle2019-layout mini dataset under ``root/fsd``: the curated
    set is the first ``RECIPE_CURATED`` rows of ``write_train_inputs``'
    CSV, over its clips; ``train_noisy/`` holds
    ``RECIPE_NOISY`` clips of ``TRAIN_SECONDS``, every third with a wrong
    or an extra label; ``test/`` holds ``RECIPE_TEST`` clips with the
    bench's lengths and ``sample_submission.csv`` (fname and a zero column
    a class)."""
    data = os.path.join(root, "fsd")
    for sub in ("train_noisy", "test"):
        os.makedirs(os.path.join(data, sub))
    os.symlink(curated["train_dir"], os.path.join(data, "train_curated"))
    with open(curated["train_csv"]) as f, \
            open(os.path.join(data, "train_curated.csv"), "w") as g:
        g.writelines(f.readlines()[:1 + RECIPE_CURATED])
    classes = curated["classes"]
    rng = np.random.RandomState(21)
    rows, jobs = [], []
    for i in range(RECIPE_NOISY):
        n = int(rng.uniform(*TRAIN_SECONDS) * SR)
        c = int(rng.randint(TRAIN_CLASSES))
        fname = f"noisy{i:03d}.wav"
        jobs.append(wav_job(os.path.join(data, "train_noisy", fname), n,
                            rng, [300.0 * (c + 1)], 0.5))
        label = {c}
        if i % 3 == 0:  # a wrong label, or an extra one
            other = (c + 1 + i // 3 % (TRAIN_CLASSES - 1)) % TRAIN_CLASSES
            label = {other} if i % 2 == 0 else {c, other}
        rows.append((fname, ",".join(classes[k] for k in sorted(label))))
    with open(os.path.join(data, "train_noisy.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["fname", "labels"])
        writer.writerows(rows)
    test = []
    for i, n in enumerate(synthetic_clip_lengths(RECIPE_TEST, seed=22)):
        fname = f"test{i:03d}.wav"
        jobs.append(wav_job(os.path.join(data, "test", fname), int(n), rng))
        test.append(fname)
    render_wavs(jobs)
    with open(os.path.join(data, "sample_submission.csv"), "w",
              newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["fname", *classes])
        writer.writerows([name, *([0] * len(classes))] for name in test)
    return {"data": data, "classes": classes, "test": test,
            "noisy": [r[0] for r in rows]}


def run_logged(cmd: list, env: dict, timeout: float) -> tuple:
    """``cmd`` as a child leading a new process group, its output read as
    it comes; returns (exit code, output, [(line, seconds since start)] of
    the ``== `` step lines). At ``timeout``, and whatever happens, the child's
    whole process group is killed, grandchildren included."""
    t0 = time.time()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)

    def kill_group():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    timer = threading.Timer(timeout, kill_group)
    timer.start()
    lines, steps = [], []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("== "):
                steps.append((line.strip(), time.time() - t0))
        rc = proc.wait()
    finally:
        timer.cancel()
        kill_group()
        proc.wait()
    steps.append(("end", time.time() - t0))
    return rc, "".join(lines), steps


def recipe_launches(path: str) -> dict:
    """The kernel launches of the kit's runs by step, from the lines its CLI
    processes append to ``$FSC_LAUNCH_LOG`` at exit (each from 0 at its
    start): the curated round, the noisy scoring and the noisy round, each
    one process."""
    steps = collections.defaultdict(list)
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            program = os.path.basename(rec["argv"][0])
            if program == "train_2d_cnn.py":
                step = ("noisy round" if "--noisy_train_df" in rec["argv"]
                        else "curated round")
            elif program == "predict_2d_cnn.py":
                step = "noisy scoring"
            else:
                raise RuntimeError(f"launch log of {program}")
            steps[step].append({WRAPPER_KERNEL[k]: n
                                for k, n in rec["launches"].items()})
    if sorted(steps) != ["curated round", "noisy round", "noisy scoring"] \
            or any(len(v) != 1 for v in steps.values()):
        raise RuntimeError(f"the kit's launch log: {dict(steps)}")
    return {step: runs[0] for step, runs in steps.items()}


def phase_recipe(root: str, curated: dict, smi: str) -> dict:
    """The port's kit (``recipes/reproduce_reference.sh``) on the card as a
    child, at ``RECIPE_EPOCHS`` epochs a round and batch ``RECIPE_BATCH``
    (the recipe's 20), on the mini
    dataset of ``write_recipe_layout``; then every step's artifacts are
    checked against what the recipe promises. Returns each step's kernel
    launches, counted in the kit's own processes: K1, K2 and K3 must each
    launch in both rounds, and K1 in the noisy scoring."""
    from freesound_classification_tpu_torch.data.dataset import (
        read_csv_columns,
    )
    from freesound_classification_tpu_torch.data.folds import (
        binarize_label_strings,
    )
    from freesound_classification_tpu_torch.data.tables import (
        read_prediction_files,
        read_predictions,
    )
    from freesound_classification_tpu_torch.ops.metrics import lwlrap

    t0 = time.time()
    layout = write_recipe_layout(root, curated)
    log(f"recipe inputs: {RECIPE_CURATED} curated, {RECIPE_NOISY} noisy "
        f"and {RECIPE_TEST} test clips ({time.time() - t0:.1f} s to write)")
    work = os.path.join(root, "recipe_work")
    here = os.path.dirname(os.path.abspath(__file__))
    launch_log = os.path.join(root, "recipe_launches.jsonl")
    if os.path.exists(launch_log):
        os.remove(launch_log)
    env = dict(os.environ, DATA_DIR=layout["data"], WORK=work,
               EPOCHS=str(RECIPE_EPOCHS), NOISY_EPOCHS=str(RECIPE_EPOCHS),
               BATCH_SIZE=str(RECIPE_BATCH), DEVICE=DEVICE,
               PY=sys.executable, FSC_LAUNCH_LOG=launch_log)
    torch.cuda.empty_cache()  # leave the card's memory to the kit
    rc, out, steps = run_logged(
        ["bash", os.path.join(here, "freesound_classification_tpu_torch",
                              "recipes", "reproduce_reference.sh")],
        env, RECIPE_TIMEOUT)
    log("recipe kit steps (wall s): " + "; ".join(
        f"{name.strip('= ')} {t1 - t0_:.1f}"
        for (name, t0_), (_, t1) in zip(steps, steps[1:])))
    if rc != 0:
        raise RuntimeError(f"the recipe kit failed ({rc}):\n{out[-6000:]}")
    with open(os.path.join(work, "classmap.json")) as f:
        class_map = json.load(f)
    if sorted(class_map) != sorted(layout["classes"]):
        raise RuntimeError(f"class map: {sorted(class_map)}")
    exp_root = os.path.join(work, "experiments")
    experiments = sorted(os.listdir(exp_root))
    if len(experiments) != 2:
        raise RuntimeError(f"the kit made {experiments}")
    classes = sorted(class_map, key=class_map.get)
    fnames, label_cells = read_csv_columns(
        os.path.join(layout["data"], "train_curated.csv"),
        ["fname", "labels"])
    # the curated labels in fname order, as finalize_results sorts them
    order = sorted(range(len(fnames)), key=lambda i: fnames[i])
    truth = binarize_label_strings([label_cells[i] for i in order],
                                   class_map)
    summary = {}
    for name in experiments:
        exp = os.path.join(exp_root, name)
        pred = os.path.join(exp, "predictions")
        files = sorted(os.listdir(pred))
        val = [f"val_preds_fold_{k}.csv" for k in range(5)]
        test = [f"test_preds_fold_{k}.csv" for k in range(5)]
        if not set(val + test + ["submission.csv"]) <= set(files):
            raise RuntimeError(f"{name}: predictions {files}")
        folds = [read_predictions(os.path.join(pred, f)) for f in test]
        sub_f, sub_c, sub_v = read_predictions(os.path.join(
            pred, "submission.csv"))
        mean = np.mean([v for _, _, v in folds], axis=0)
        sub_err = float(np.abs(sub_v - mean).max())
        if (sub_f != layout["test"] or sub_c != classes
                or not sub_err <= 1e-6):
            raise RuntimeError(f"{name}: submission.csv is not the folds' "
                               f"mean ({sub_err})")
        oof_f, _, oof_v = read_prediction_files(
            [os.path.join(pred, f) for f in val], classes)
        rows = sorted(range(len(oof_f)), key=lambda i: oof_f[i])
        if sorted(oof_f) != sorted(fnames):
            raise RuntimeError(f"{name}: the OOF rows are not the curated "
                               "set")
        metric = lwlrap(truth, oof_v[rows])
        with open(os.path.join(exp, "results.json")) as f:
            results = json.load(f)
        if not abs(results["metric"] - metric) <= 1e-9:
            raise RuntimeError(f"{name}: metric {results['metric']} against "
                               f"the OOF CSVs' {metric}")
        for k in range(5):
            if not os.path.isfile(os.path.join(
                    exp, "checkpoints", f"fold_{k}", "model_on_epoch_0.npz")):
                raise RuntimeError(f"{name}: fold {k} has no "
                                   "model_on_epoch_0.npz")
        with open(os.path.join(exp, "config.json")) as f:
            label = json.load(f)["label"]
        summary[label] = {
            "metric": round(metric, 6),
            "folds": [round(results[f"fold{k}"]["metric"], 4)
                      for k in range(5)],
            "submission_err": sub_err}
    noisy_f, _, noisy_v = read_predictions(os.path.join(
        work, "predictions", "noisy_probabilities.csv"))
    if sorted(noisy_f) != sorted(layout["noisy"]) or \
            not np.isfinite(noisy_v).all():
        raise RuntimeError("the noisy probabilities miss clips")
    with open(os.path.join(work, "predictions",
                           "train_noisy_relabeled_1k.csv")) as f:
        relabeled = list(csv.reader(f))[1:]
    if len(relabeled) != RECIPE_NOISY:
        raise RuntimeError(f"relabelled CSV: {len(relabeled)} rows")
    blend_f, blend_c, blend_v = read_predictions(os.path.join(
        work, "predictions", "blend_submission.csv"))
    if (sorted(blend_f) != sorted(layout["test"]) or blend_c != classes
            or not np.isfinite(blend_v).all()):
        raise RuntimeError(f"blend submission: {blend_c} x {len(blend_f)}")
    log(f"recipe kit: exit 0 in {steps[-1][1]:.1f} s, every artifact "
        f"checked; {summary} on {smi}")
    launches = recipe_launches(launch_log)
    log(f"recipe launches, counted in the kit's processes ({RECIPE_EPOCHS} "
        f"epochs x 5 folds a round): {launches} on {smi}")
    needed = {"curated round": ("K1", "K2", "K3"),
              "noisy round": ("K1", "K2", "K3"), "noisy scoring": ("K1",)}
    missed = [(step, k) for step, ks in needed.items() for k in ks
              if launches[step][k] <= 0]
    if missed:
        raise RuntimeError(f"the kit's run missed a kernel: {missed}")
    return launches


# ---------------------------------------------------------------------------
# resume, TTA and evaluate (slice 11)
# ---------------------------------------------------------------------------


def resume_argv(inputs: dict, experiments_dir: str, seed: int = 42) -> list:
    """The 2d train CLI at the recipe's width on fold 0 of
    ``RESUME_SAMPLES`` labelled clips, 2 epochs, accumulation 2, MixUp off:
    its partner pool restarts empty on resume (as in JAX), so a resumed run
    with MixUp is another run by design; the effects chain (K2, K3) and
    chunk shuffle stay on."""
    return ["--train_df", inputs["train_csv"],
            "--train_data_dir", inputs["train_dir"],
            "--classmap", inputs["classmap"], "--device", DEVICE, *RECIPE,
            "--p_mixup", "0.0",
            "--folds", "0", "--n_folds", "5", "--epochs", "2",
            "--max_samples", str(RESUME_SAMPLES), "--accumulation_steps", "2",
            "--kfold_seed", str(seed), "--num_workers", "4",
            "--log_interval", "10", "--label", "resume",
            "--experiments_dir", experiments_dir]


def fold0_files(experiments_dir: str) -> tuple:
    """(fold 0's checkpoint dir, the experiment dir) of the one experiment
    under ``experiments_dir``, or (None, None) before it exists."""
    names = (os.listdir(experiments_dir) if os.path.isdir(experiments_dir)
             else [])
    if len(names) != 1:
        return None, None
    exp = os.path.join(experiments_dir, names[0])
    return os.path.join(exp, "checkpoints", "fold_0"), exp


def final_params(fold_dir: str) -> np.ndarray:
    from freesound_classification_tpu_torch import interop

    params, _ = interop.load_fold_npz(os.path.join(fold_dir,
                                                   "final_model.npz"))
    return np.concatenate([v.ravel() for _, v in sorted(_leaves(params))])


def save_record(fold_dir: str) -> str:
    """Each save under ``fold_dir`` in ``checkpoints.save_times``: its
    file, its ms on the loop's thread and its write's ms."""
    from freesound_classification_tpu_torch.training import checkpoints

    return "; ".join(
        f"{os.path.basename(r['path'])} {r['loop_ms']:.1f} / "
        f"{r['write_ms']:.1f}" for r in checkpoints.save_times
        if os.path.dirname(r["path"]) == os.path.abspath(fold_dir))


# the writer-overlap turns: steps timed a turn, and bundles enqueued before
# a busy turn, enough that the writer is still writing when the turn's
# steps end (the line says whether it was)
OVERLAP_STEPS = 20
OVERLAP_SAVES = 6


def card_writer_checks() -> list:
    """A bundle of a live model on the card (the recipe's width, float32)
    and its Adam state enqueued on the writer, an optimizer step at once
    (in place, on the card), then a drain: the file holds the values
    before the step, bit for bit. Then that train step's ms, by the host's
    clock around synchronized runs of ``OVERLAP_STEPS``, in turns with the
    writer idle and busy (``OVERLAP_SAVES`` bundles enqueued before the
    turn, untimed): the writer's cost to the steps it overlaps. Returns
    the two log lines' words."""
    from freesound_classification_tpu_torch.models.classifiers import (
        TwoDimensionalCNN,
    )
    from freesound_classification_tpu_torch.training import checkpoints

    torch.manual_seed(21)
    model = TwoDimensionalCNN(**F32_NET, aggregation_type="max",
                              n_classes=TRAIN_CLASSES).to(DEVICE).train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    x = torch.randn(4, 128, 431, 1, device=DEVICE)
    frames = torch.tensor([431, 300, 431, 200], device=DEVICE)

    def step():
        opt.zero_grad()
        model(x, frames).float().pow(2).mean().backward()
        opt.step()

    step()
    want = {"model": {k: t.to("cpu", copy=True)
                      for k, t in model.state_dict().items()},
            "optimizer": {i: {k: t.to("cpu", copy=True)
                              for k, t in state.items()}
                          for i, state in opt.state_dict()["state"].items()}}
    path = os.path.join(tempfile.mkdtemp(prefix="snapshot_"), "last.pt")
    t0 = time.perf_counter()
    checkpoints.save_bundle(path, {"model": model.state_dict(),
                                   "optimizer": opt.state_dict()})
    loop_ms = 1e3 * (time.perf_counter() - t0)
    step()
    torch.cuda.synchronize()
    moved = not all(torch.equal(t.cpu(), want["model"][k])
                    for k, t in model.state_dict().items())
    got = checkpoints.load_bundle(path)
    same = all(torch.equal(got["model"][k], t)
               for k, t in want["model"].items()) and all(
        torch.equal(got["optimizer"]["state"][i][k], t)
        for i, state in want["optimizer"].items() for k, t in state.items())
    n_bytes = os.path.getsize(path)
    if not (moved and same):
        raise RuntimeError(f"card snapshot: the step moved the weights "
                           f"{moved}, the file holds the pre-step values "
                           f"{same}")

    def steps_ms() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OVERLAP_STEPS):
            step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / OVERLAP_STEPS

    turns = ("idle", "busy", "busy", "idle", "idle", "busy")
    ms, busy_through = {"idle": [], "busy": []}, []
    steps_ms()  # warm
    for turn in turns:
        if turn == "busy":
            for _ in range(OVERLAP_SAVES):
                checkpoints.save_bundle(path, {"model": model.state_dict(),
                                               "optimizer": opt.state_dict()})
            last = checkpoints.save_times[-1]
        ms[turn].append(steps_ms())
        if turn == "busy":
            busy_through.append(last["write_ms"] is None)
            checkpoints.wait_for_saves()
    ratio = float(np.median(ms["busy"]) / np.median(ms["idle"]))
    return [f"card snapshot: a {n_bytes / 1e6:.1f} MB bundle of a live "
            f"model and its Adam state enqueued ({loop_ms:.1f} ms on the "
            f"loop), an Adam step at once, the file equal to the pre-step "
            f"values bit for bit",
            f"writer overlap: that float32 step (B=4 x 431 frames), "
            f"{OVERLAP_STEPS} steps a turn in turns {list(turns)}: ms a "
            f"step with the writer idle "
            f"{[round(v, 3) for v in ms['idle']]}, busy writing "
            f"{OVERLAP_SAVES} bundles {[round(v, 3) for v in ms['busy']]} "
            f"(still writing at each busy turn's end: {busy_through}); "
            f"busy over idle, medians, {ratio:.3f}"]


def phase_resume(root: str, inputs: dict, smi: str) -> None:
    """Three runs of the 2d train CLI (``resume_argv``): (i) straight
    through; (ii) a child process SIGKILLed once its epoch-0 bundle is on
    disk, then run again with ``--resume``; (iii) straight through on other
    folds (``--kfold_seed 43``), the yardstick of "different", with its
    saves synchronous (``checkpoints.ASYNC_SAVES`` off). The resumed
    run must start at epoch 1, launch K1, K2 and K3, end with (i)'s
    ``global_step`` and epoch-0 score, and its final weights must lie
    within ``RESUME_WEIGHT_TOL`` of (i)'s and 10x nearer to them than to
    (iii)'s. Prints each save's ms on the loop's thread beside its
    write's, of (i) and (iii), and the last epoch's steps/s of (i) (its
    epoch 1 overlaps epoch 0's writes), of (ii)'s resumed run (the same
    epoch, no write in flight) and of (iii); and
    ``card_writer_checks``' lines."""
    from freesound_classification_tpu_torch.cli import train_2d_cnn
    from freesound_classification_tpu_torch.ops import kernels
    from freesound_classification_tpu_torch.training import checkpoints

    base = os.path.join(root, "resume")
    checkpoints.save_times.clear()
    t0 = time.time()
    train_2d_cnn.main(resume_argv(inputs, os.path.join(base, "straight")))
    torch.cuda.synchronize()
    straight_s = time.time() - t0
    straight_dir, straight_exp = fold0_files(os.path.join(base, "straight"))
    straight_saves = save_record(straight_dir)
    straight_rate = last_epoch_rate(straight_exp, 0)
    want = checkpoints.load_bundle(os.path.join(straight_dir,
                                                "last_model.pt"))

    killed = os.path.join(base, "killed")
    here = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()  # leave the card's memory to the child
    t0 = time.time()
    with open(os.path.join(root, "resume_child.log"), "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "freesound_classification_tpu_torch.cli.train_2d_cnn",
             *resume_argv(inputs, killed)],
            cwd=here, stdout=out, stderr=subprocess.STDOUT,
            start_new_session=True)
        try:
            bundle_path = None
            while time.time() - t0 < RESUME_TIMEOUT:
                fold_dir, _ = fold0_files(killed)
                if fold_dir and os.path.isfile(
                        os.path.join(fold_dir, "last_model.pt")):
                    bundle_path = os.path.join(fold_dir, "last_model.pt")
                    break
                if proc.poll() is not None:
                    break
                time.sleep(0.02)
        finally:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    kill_s = time.time() - t0
    if bundle_path is None:
        with open(os.path.join(root, "resume_child.log")) as f:
            raise RuntimeError("the killed run wrote no bundle:\n"
                               + f.read()[-4000:])
    at_kill = checkpoints.load_bundle(bundle_path)
    if at_kill["meta"]["epoch"] != 0 or at_kill["micro_step"] != 1:
        raise RuntimeError(f"the kill came late: the bundle holds epoch "
                           f"{at_kill['meta']['epoch']}, micro-step "
                           f"{at_kill['micro_step']}")
    # what a kill in the middle of the bundle's write would have left: the
    # resumed run's next write of the bundle clears it (F6)
    planted = f"{bundle_path}.tmp-{socket.gethostname()}-{proc.pid}"
    with open(planted, "wb") as f:
        f.write(b"half a bundle")

    counted = {"K1": kernels.mel_project_log, "K2": kernels.resample_linear,
               "K3": kernels.pv_resynth}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.time()
    resumed_exp = train_2d_cnn.main(resume_argv(inputs, killed)
                                    + ["--resume"])
    torch.cuda.synchronize()
    resumed_s = time.time() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    got = checkpoints.load_bundle(bundle_path)
    epochs_run = len(resumed_exp.results["fold0"]["train_steps"])
    resumed_rate = (resumed_exp.results["fold0"]["train_steps"][-1],
                    resumed_exp.results["fold0"]["train_seconds"][-1])

    checkpoints.save_times.clear()
    checkpoints.ASYNC_SAVES = False
    t0 = time.time()
    try:
        train_2d_cnn.main(resume_argv(inputs, os.path.join(base, "other"),
                                      43))
    finally:
        checkpoints.ASYNC_SAVES = True
    torch.cuda.synchronize()
    other_s = time.time() - t0
    other_dir, other_exp = fold0_files(os.path.join(base, "other"))
    other_saves = save_record(other_dir)
    other_rate = last_epoch_rate(other_exp, 0)

    w_straight = final_params(straight_dir)
    w_resumed = final_params(os.path.dirname(bundle_path))
    w_other = final_params(other_dir)
    d_same = float(np.linalg.norm(w_resumed - w_straight)
                   / np.linalg.norm(w_straight))
    d_other = float(np.linalg.norm(w_resumed - w_other)
                    / np.linalg.norm(w_other))
    log(f"resume: (i) {straight_s:.1f} s; (ii) killed at {kill_s:.1f} s "
        f"with its epoch-0 bundle (micro-step {at_kill['micro_step']} of 2, "
        f"global_step {at_kill['global_step']}), resumed in "
        f"{resumed_s:.1f} s ({epochs_run} epoch), launches {launches}; "
        f"(iii) {other_s:.1f} s on {smi}")
    log(f"resume: global_step {got['global_step']} against "
        f"{want['global_step']}; epoch-0 score {got['meta']['scores'][0]!r} "
        f"against {want['meta']['scores'][0]!r}; final weights, relative "
        f"L2: resumed to (i) {d_same:.3e} (tolerance {RESUME_WEIGHT_TOL:g}),"
        f" resumed to (iii) {d_other:.3e}")
    log(f"resume saves, file ms on the loop / ms of the write: (i) on the "
        f"writer: {straight_saves}; (iii) synchronous: {other_saves}; "
        f"the last epoch's steps/s: (i) {straight_rate[0]} steps in "
        f"{straight_rate[1]:.3f} s = "
        f"{straight_rate[0] / straight_rate[1]:.3f} (epoch 0's writes in "
        f"flight), (ii) the same epoch resumed {resumed_rate[0]} in "
        f"{resumed_rate[1]:.3f} s = {resumed_rate[0] / resumed_rate[1]:.3f} "
        f"(none), (iii) {other_rate[0]} in {other_rate[1]:.3f} s = "
        f"{other_rate[0] / other_rate[1]:.3f} (none) on {smi}")
    left = sorted(
        os.path.relpath(os.path.join(d, name), base)
        for d, _, files in os.walk(base) for name in files
        if ".tmp-" in name)
    log(f"resume: a dead writer's temporary {os.path.basename(planted)} "
        f"planted beside the killed run's bundle: "
        f"{'gone' if not os.path.exists(planted) else 'still there'} after "
        f"the resumed run; temporaries left in the three runs' checkpoint "
        f"directories: {left or 'none'}")
    for line in card_writer_checks():
        log(f"resume: {line} on {smi}")
    if os.path.exists(planted) or left:
        raise RuntimeError(f"resume: temporaries left behind: {left}")
    if epochs_run != 1:
        raise RuntimeError(f"the resumed run trained {epochs_run} epochs")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"the resumed run missed a kernel: {launches}")
    if got["global_step"] != want["global_step"]:
        raise RuntimeError("the resumed run's global_step differs")
    if got["meta"]["scores"][0] != want["meta"]["scores"][0]:
        raise RuntimeError("the resumed run's epoch-0 score differs")
    if not (d_same <= RESUME_WEIGHT_TOL and 10 * d_same <= d_other):
        raise RuntimeError(f"resumed weights: {d_same} from the straight "
                           f"run, {d_other} from another run")


# the folds of the fold-parallel resume: 2 of the 5 (the depth the whole
# smoke's time allows; the CLI and the turns stack all 5)
RESUME_FOLDS = 2


def fold_parallel_argv(argv: list, n_folds: int = N_FOLDS) -> list:
    """A train CLI's argv with folds 0 to ``n_folds`` - 1 trained
    together."""
    return [*argv, "--folds", *map(str, range(n_folds)), "--fold_parallel"]


def fold_finals(experiment_dir: str, n_folds: int = N_FOLDS) -> list:
    """``final_params`` of each of the experiment's first ``n_folds``
    folds."""
    return [final_params(os.path.join(experiment_dir, "checkpoints",
                                      f"fold_{k}"))
            for k in range(n_folds)]


def fold_parallel_cli(root: str, inputs: dict, smi: str) -> dict:
    """The 2d train CLI at the recipe's width with ``--fold_parallel`` over
    the five folds, ``TRAIN_EPOCHS`` epochs; K1-K3 counted over the run
    and within the stacked epochs; the artifacts of every fold; fold 0's
    best model through the predict CLI. Returns the run's launches."""
    from freesound_classification_tpu_torch import interop
    from freesound_classification_tpu_torch.cli import (
        predict_2d_cnn,
        train_2d_cnn,
    )
    from freesound_classification_tpu_torch.ops import kernels
    from freesound_classification_tpu_torch.training import multifold
    from freesound_classification_tpu_torch.training.state import (
        create_model,
    )

    counted = {"K1": kernels.mel_project_log, "K2": kernels.resample_linear,
               "K3": kernels.pv_resynth}
    epochs = []
    train_epoch = multifold.MultiFoldEngine.train_epoch

    def counted_epoch(self, *args, **kwargs):
        before = {k: fn.launches for k, fn in counted.items()}
        stats = train_epoch(self, *args, **kwargs)
        epochs.append(({k: fn.launches - before[k]
                        for k, fn in counted.items()}, stats["steps"]))
        return stats

    stack_batches = multifold.stack_batches
    stack_s = []

    def timed_stack(batches, shape=None):
        t0 = time.perf_counter()
        out = stack_batches(batches, shape)
        stack_s.append(time.perf_counter() - t0)
        return out

    argv = fold_parallel_argv([
        "--train_df", inputs["train_csv"],
        "--train_data_dir", inputs["train_dir"],
        "--classmap", inputs["classmap"], "--device", DEVICE, *RECIPE,
        "--n_folds", str(N_FOLDS), "--epochs", str(TRAIN_EPOCHS),
        "--num_workers", "4", "--log_interval", "1",
        "--label", "fold_parallel",
        "--experiments_dir", os.path.join(root, "fp_experiments")])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    multifold.MultiFoldEngine.train_epoch = counted_epoch
    multifold.stack_batches = timed_stack
    try:
        t0 = time.time()
        experiment = train_2d_cnn.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        multifold.MultiFoldEngine.train_epoch = train_epoch
        multifold.stack_batches = stack_batches
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: fn.launches for k, fn in counted.items()}
    steps = sum(n for _, n in epochs)
    in_epochs = {k: sum(e[k] for e, _ in epochs) for k in counted}
    log(f"fold-parallel CLI: {wall:.2f} s for {TRAIN_EPOCHS} epochs of "
        f"{N_FOLDS} folds together (validation and checkpoints included); "
        f"launches over the run {launches}, within the stacked epochs "
        f"{in_epochs} over {steps} stacked steps (K1 once a stacked step; "
        f"K2 and K3 once a fold's chain: {N_FOLDS * steps} if every fold "
        f"draws effect rows); peak memory {peak:.2f} GB on {smi}")
    if in_epochs["K1"] != steps:
        raise RuntimeError(f"K1 ran {in_epochs['K1']} times in {steps} "
                           "stacked steps")
    if not min(in_epochs["K2"], in_epochs["K3"]) > steps:
        raise RuntimeError(f"K2/K3 not launched per fold: {in_epochs}")

    exp = experiment.experiment_dir
    with open(os.path.join(exp, "results.json")) as f:
        results = json.load(f)
    missing = [
        path for k in range(N_FOLDS) for path in (
            os.path.join(exp, "checkpoints", f"fold_{k}", "best_model.npz"),
            os.path.join(exp, "checkpoints", f"fold_{k}", "final_model.npz"),
            os.path.join(exp, "predictions", f"val_preds_fold_{k}.csv"))
        if not os.path.isfile(path)]
    metrics = [results.get(f"fold{k}", {}).get("metric")
               for k in range(N_FOLDS)]
    if missing or None in metrics or "metric" not in results:
        raise RuntimeError(f"fold-parallel artifacts missing: {missing}, "
                           f"fold metrics {metrics}, keys {list(results)}")
    losses = [results[f"fold{k}"]["train_loss"] for k in range(N_FOLDS)]
    if not np.isfinite(losses).all():
        raise RuntimeError(f"fold-parallel losses not finite: {losses}")
    fold = results["fold0"]
    n, secs = fold["train_steps"][-1], fold["train_seconds"][-1]
    log(f"fold-parallel epochs: validation lwlrap per fold "
        f"{np.round(metrics, 4).tolist()}, global OOF "
        f"{results['metric']:.4f}; last epoch {n:g} stacked steps in "
        f"{secs:.3f} s = {n / secs:.3f} stacked steps/s = "
        f"{N_FOLDS * n / secs:.3f} fold-steps/s (5 x batch 20, 15 s bucket, "
        f"bf16, decode and augmentation included); the host's "
        f"stack_batches {1e3 * np.median(stack_s):.1f} ms a stacked step "
        f"(median of {len(stack_s)}) on {smi}")

    final = fold_finals(exp)
    fresh_params, _ = interop.to_jax_variables(create_model(
        experiment.config.network, TRAIN_CLASSES, torch.bfloat16, 42,
        torch.device("cpu")).state_dict())
    fresh = np.concatenate([v.ravel() for _, v in
                            sorted(_leaves(fresh_params))])
    moved = [float(np.abs(w - fresh).max()) for w in final]
    apart = min(float(np.abs(final[i] - final[j]).max())
                for i in range(N_FOLDS) for j in range(i))
    log(f"fold-parallel parameters: moved from their init by (max |dw|) "
        f"{np.round(moved, 5).tolist()}; the closest two folds apart by "
        f"{apart:.4g}")
    if not (min(moved) > 0 and apart > 0):
        raise RuntimeError("the folds did not train, or not apart")

    test_csv = os.path.join(root, "fp_test.csv")
    with open(test_csv, "w") as f:
        f.write("fname\n" + "".join(n + "\n" for n in inputs["fnames"][:8]))
    out_csv = os.path.join(root, "fp_preds.csv")
    predict_2d_cnn.main([
        "--experiment", exp, "--test_df", test_csv,
        "--test_data_dir", inputs["train_dir"],
        "--classmap", inputs["classmap"], "--output_df", out_csv,
        "--device", DEVICE, "--bf16", "--folds", "0"])
    header, _, probs = read_predictions(out_csv)
    if (header != ["fname", *inputs["classes"]]
            or probs.shape != (8, TRAIN_CLASSES)
            or not np.isfinite(probs).all()
            or probs.min() < 0 or probs.max() > 1):
        raise RuntimeError(f"bad predictions from fold 0 of the stacked "
                           f"run: {header[:3]} {probs.shape}")
    log(f"fold 0's best_model.npz through the predict CLI: {probs.shape} "
        f"finite probabilities in [{probs.min():.4g}, {probs.max():.4g}]")
    return launches


def fold_parallel_turns(smi: str) -> None:
    """The stacked step over 5 folds against 5 single-fold steps on the
    same batches at the recipe's shapes, and against itself with cuDNN
    free of the engine's determinism (``probes/fold_parallel.py``): ms by
    CUDA events in turns, busy ms and launches by torch.profiler, and
    peak memory, for each."""
    from freesound_classification_tpu_torch.probes import fold_parallel

    torch.cuda.empty_cache()
    out = fold_parallel.compare(DEVICE)
    for name, row in out.items():
        if not (np.isfinite(row["ms"]) and row["ms"] > 0
                and row["launches"] > 0):
            raise RuntimeError(f"fold-parallel turns: {name} {row}")
        log(f"fold-parallel turns, {name}: {row['ms']:.3f} ms by events "
            f"(runs {np.round(row['runs'], 3).tolist()}), busy "
            f"{row['busy_ms']:.3f} ms ({row['busy_ms'] / row['ms']:.3f}), "
            f"{row['launches']:.1f} launches, peak {row['peak_gb']:.2f} GB "
            f"(5 folds x 20 x 15 s, bf16, augmented) on {smi}")
    stacked, free = out["stacked"], out["stacked, cuDNN free"]
    log(f"fold-parallel turns: stacked / sequential = "
        f"{stacked['ms'] / out['sequential']['ms']:.3f} by events, "
        f"{stacked['busy_ms'] / out['sequential']['busy_ms']:.3f} busy; "
        f"deterministic / free stacked = {stacked['ms'] / free['ms']:.3f} "
        f"by events, {stacked['busy_ms'] / free['busy_ms']:.3f} busy")


def fold_parallel_truth() -> None:
    """The stacked step's first float32 step against each fold's
    single-fold step on the card, from ``phase_f32_step``'s weights and on
    its kind of batch (5 folds of 6 synthetic clips x 5 s, the first
    ``phase_f32_step``'s own; no augmentation, dropout 0, TF32 off):
    losses within ``STEP_TOL_LOSS``; each fold's gradients within
    ``STEP_TOL_GRAD`` of that fold's largest gradient, as
    ``phase_f32_step`` holds the card against the CPU. Beside each fold,
    the single step's own spread with its rows reversed (the same
    function, other float32 sums): the global max-pools pass a channel's
    whole gradient to one frame, so a near-tie that rounding flips moves
    it."""
    from freesound_classification_tpu_torch import interop
    from freesound_classification_tpu_torch.probes import fold_parallel

    torch.cuda.empty_cache()
    rng = np.random.RandomState(12)
    folds = [f32_step_batch(rng) for _ in range(N_FOLDS)]
    state = interop.from_jax_variables(*interop.random_jax_variables(
        **F32_NET, n_classes=TRAIN_CLASSES, seed=11))
    truth = fold_parallel.first_step_truth(
        DEVICE, dict(F32_NET, aggregation_type="max"), N_FOLDS,
        n_classes=TRAIN_CLASSES, data=tuple(np.stack(a) for a in
                                            zip(*folds)), state=state)
    grad, spread = truth["grad"], truth["rounding"]

    def fmt(rows, key):
        return [f"{row[key]:.2e}" for row in rows]

    log(f"fold-parallel truth (float32, recipe width, 5 folds x 6 x 5 s): "
        f"loss |d| per fold {[f'{d:.2e}' for d in truth['loss']]} "
        f"(tolerance {STEP_TOL_LOSS:g}); gradients over each fold's "
        f"largest: {fmt(grad, 'max')} at {[d['at'] for d in grad]} "
        f"(tolerance {STEP_TOL_GRAD:g}), relative L2 {fmt(grad, 'l2')}; "
        f"the single step against itself on reversed rows: "
        f"{fmt(spread, 'max')}, relative L2 {fmt(spread, 'l2')}")
    if not max(truth["loss"]) <= STEP_TOL_LOSS:
        raise RuntimeError("fold-parallel truth: the losses disagree")
    if not max(d["max"] for d in grad) <= STEP_TOL_GRAD:
        raise RuntimeError("fold-parallel truth: the gradients disagree")


def fold_parallel_resume(root: str, inputs: dict, smi: str,
                         meanwhile=None) -> None:
    """``resume_argv`` over ``RESUME_FOLDS`` folds with ``--fold_parallel``:
    (i) straight through; (ii) a child SIGKILLed once its epoch-0 stacked
    bundle (a partial mean in it) is on disk, then run again with
    ``--resume``: epoch 1 only, K1-K3 launched, (i)'s ``global_step``,
    every fold's final weights within ``RESUME_WEIGHT_TOL`` of (i)'s.
    ``meanwhile()``, where given, and then (i) run while the child of (ii)
    does."""
    from freesound_classification_tpu_torch.cli import train_2d_cnn
    from freesound_classification_tpu_torch.ops import kernels
    from freesound_classification_tpu_torch.training import (
        checkpoints,
        multifold,
    )

    base = os.path.join(root, "fp_resume")
    killed = os.path.join(base, "killed")
    here = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()

    def kill_at_bundle() -> tuple:
        """The child of (ii), SIGKILLed once its bundle is on disk: the
        bundle's path (None where the child ended without one) and the
        child's seconds."""
        t0 = time.time()
        with open(os.path.join(root, "fp_resume_child.log"), "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "freesound_classification_tpu_torch.cli.train_2d_cnn",
                 *fold_parallel_argv(resume_argv(inputs, killed),
                                     RESUME_FOLDS)],
                cwd=here, stdout=out, stderr=subprocess.STDOUT,
                start_new_session=True)
            path = None
            try:
                while time.time() - t0 < RESUME_TIMEOUT:
                    _, exp = fold0_files(killed)
                    found = exp and os.path.join(exp, "checkpoints",
                                                 multifold.BUNDLE)
                    if found and os.path.isfile(found):
                        path = found
                        break
                    if proc.poll() is not None:
                        break
                    time.sleep(0.02)
            finally:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        return path, time.time() - t0

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        child = pool.submit(kill_at_bundle)
        if meanwhile is not None:
            meanwhile()
        t0 = time.time()
        straight = train_2d_cnn.main(fold_parallel_argv(
            resume_argv(inputs, os.path.join(base, "straight")),
            RESUME_FOLDS))
        torch.cuda.synchronize()
        straight_s = time.time() - t0
        bundle_path, kill_s = child.result()
    want = checkpoints.load_bundle(os.path.join(
        straight.experiment_dir, "checkpoints", multifold.BUNDLE))
    if bundle_path is None:
        with open(os.path.join(root, "fp_resume_child.log")) as f:
            raise RuntimeError("the killed stacked run wrote no bundle:\n"
                               + f.read()[-4000:])
    at_kill = checkpoints.load_bundle(bundle_path)
    if at_kill["meta"]["epoch"] != 0 or at_kill["micro_step"] != 1:
        raise RuntimeError(f"the kill came late: the stacked bundle holds "
                           f"epoch {at_kill['meta']['epoch']}, micro-step "
                           f"{at_kill['micro_step']}")

    counted = {"K1": kernels.mel_project_log, "K2": kernels.resample_linear,
               "K3": kernels.pv_resynth}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.time()
    resumed = train_2d_cnn.main(fold_parallel_argv(
        resume_argv(inputs, killed), RESUME_FOLDS) + ["--resume"])
    torch.cuda.synchronize()
    resumed_s = time.time() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    got = checkpoints.load_bundle(bundle_path)
    epochs_run = len(resumed.results["fold0"]["train_steps"])
    d_same = [float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in
              zip(fold_finals(resumed.experiment_dir, RESUME_FOLDS),
                  fold_finals(straight.experiment_dir, RESUME_FOLDS))]
    log(f"fold-parallel resume: (i) {straight_s:.1f} s and (ii) killed at "
        f"{kill_s:.1f} s, (i) and the truth check beside (ii)'s child, with "
        f"its epoch-0 bundle (micro-step "
        f"{at_kill['micro_step']} of 2, global_step "
        f"{at_kill['global_step']}, loader epochs "
        f"{at_kill['loader_epochs']}), resumed in {resumed_s:.1f} s "
        f"({epochs_run} epoch), launches {launches}; global_step "
        f"{got['global_step']} against {want['global_step']}; final "
        f"weights per fold, relative L2 to (i): "
        f"{[f'{d:.3e}' for d in d_same]} (tolerance "
        f"{RESUME_WEIGHT_TOL:g}) on {smi}")
    if epochs_run != 1:
        raise RuntimeError(f"the resumed stacked run trained {epochs_run} "
                           "epochs")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"the resumed stacked run missed a kernel: "
                           f"{launches}")
    if got["global_step"] != want["global_step"]:
        raise RuntimeError("the resumed stacked run's global_step differs")
    if not max(d_same) <= RESUME_WEIGHT_TOL:
        raise RuntimeError(f"resumed stacked weights: {d_same}")


def phase_fold_parallel(root: str, inputs: dict, smi: str) -> dict:
    """M5.2's one-device layout at the recipe's width: the five folds
    through the train CLI together, the stacked step against the
    sequential ones in turns, its per-fold truth in float32, and the
    stacked resume. Returns the CLI run's K1-K3 launches."""
    t0 = time.time()
    launches = fold_parallel_cli(root, inputs, smi)
    fold_parallel_turns(smi)
    # the truth check times nothing: it runs beside the resume's child
    fold_parallel_resume(root, inputs, smi, meanwhile=fold_parallel_truth)
    log(f"fold-parallel phase: {time.time() - t0:.1f} s")
    return launches


DP_TIMEOUT = 600  # seconds for the torchrun CLI and for the gloo ranks
DP_STAT_TOL = 1e-4  # BN running statistics over each tensor's largest
DP_RANK_CHILD = """
import sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
chip_smoke.dp_rank(int(sys.argv[1]), sys.argv[2], sys.argv[3])
"""


def dp_f32_step(mesh, device) -> dict:
    """One float32 step of ``F32_NET`` through the ``Engine`` on
    ``phase_f32_step``'s batch (6 x 5 s, dropout 0, no augmentation), on
    ``mesh``'s rank over its rows of the batch, or in one process with
    ``mesh`` None: the reported loss, the gradients and the BatchNorm
    running statistics after the step."""
    import types

    from freesound_classification_tpu_torch import interop
    from freesound_classification_tpu_torch.models.classifiers import (
        TwoDimensionalCNN,
    )
    from freesound_classification_tpu_torch.models.frontend import Frontend
    from freesound_classification_tpu_torch.parallel import mesh as mesh_lib
    from freesound_classification_tpu_torch.training.engine import Engine

    params, stats = interop.random_jax_variables(
        **F32_NET, n_classes=TRAIN_CLASSES, seed=11)
    wave, lengths, labels = f32_step_batch(np.random.RandomState(12))
    batch = {"signal": wave, "lengths": lengths, "labels": labels,
             "index": np.arange(len(wave))}
    if mesh is not None:
        batch = mesh_lib.shard_batch(batch, mesh.rank, mesh.world_size)
    model = TwoDimensionalCNN(**F32_NET, aggregation_type="max",
                              n_classes=TRAIN_CLASSES)
    model.load_state_dict(interop.from_jax_variables(params, stats))
    engine = Engine(model, Frontend(FEATURES, "2d", sr=SR, device=device),
                    types.SimpleNamespace(optimizer="momentum",
                                          learning_rate=1e-3,
                                          scheduler="steplr_1_0.5",
                                          weight_decay=0.0),
                    loss="lsep_naive", device=device, mesh=mesh)
    engine.make_optimizer(1, 1)
    out = engine.train_step(*engine.to_device(batch), aug_scale=0.0,
                            rows=engine.batch_rows(batch))
    return {"loss": float(out["loss"]),
            "grads": {k: p.grad.detach().cpu()
                      for k, p in model.named_parameters()},
            "stats": {k: b.detach().cpu()
                      for k, b in model.named_buffers()}}


def dp_rank(rank: int, rendezvous: str, out: str) -> None:
    """Rank ``rank`` of 2 sharing ``cuda:0`` over a gloo group (NCCL refuses
    two ranks on one card): ``dp_f32_step`` on its rows, saved to
    ``out``."""
    import datetime

    import torch.distributed as dist

    from freesound_classification_tpu_torch.parallel import mesh as mesh_lib

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=DP_TIMEOUT))
    try:
        mesh = mesh_lib.Mesh(rank, 2, dist.group.WORLD, device)
        torch.save(dp_f32_step(mesh, device), out)
    finally:
        dist.destroy_process_group()


def data_parallel_cli(root: str, inputs: dict, train_files: set,
                      train_experiment: str, smi: str) -> None:
    """The train path's CLI under ``torchrun --standalone --nproc_per_node
    1 ... --mesh_devices 1``: NCCL's real process group and collectives,
    the rank-0 writes. Its experiment holds the train path's files; K1, K2
    and K3 launched on the rank (``$FSC_LAUNCH_LOG``); its last epoch's
    steps/s beside the train path's."""
    log_path = os.path.join(root, "dp_launches.jsonl")
    experiments = os.path.join(root, "experiments_dp")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m",
           "freesound_classification_tpu_torch.cli.train_2d_cnn",
           *train_argv(inputs, experiments), "--mesh_devices", "1"]
    env = dict(os.environ, FSC_LAUNCH_LOG=log_path)
    t0 = time.time()
    rc, out, _ = run_logged(cmd, env, DP_TIMEOUT)
    wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"the train CLI under torchrun exited {rc}:\n"
                           f"{out[-4000:]}")
    with open(log_path) as f:
        records = [json.loads(line) for line in f]
    if [r["rank"] for r in records] != [0]:
        raise RuntimeError(f"torchrun: launch records of ranks "
                           f"{[r['rank'] for r in records]}, not [0]")
    launches = {WRAPPER_KERNEL[k]: n
                for k, n in records[0]["launches"].items() if n}
    if min(launches.get(k, 0) for k in ("K1", "K2", "K3")) <= 0:
        raise RuntimeError(f"torchrun: the train path missed a kernel: "
                           f"{launches}")
    (name,) = os.listdir(experiments)
    experiment = os.path.join(experiments, name)
    files = experiment_files(experiment)
    if files != train_files:
        raise RuntimeError(
            f"torchrun's experiment differs from the train path's: only "
            f"there {sorted(files - train_files)}, missing "
            f"{sorted(train_files - files)}")
    steps, seconds = last_epoch_rate(experiment, 0)
    want_steps, want_seconds = last_epoch_rate(train_experiment, 0)
    log(f"train CLI under torchrun (1 rank, NCCL, --mesh_devices 1): "
        f"{wall:.1f} s wall, {len(files)} files as the train path's; rank 0 "
        f"launches {launches}; last epoch {steps / seconds:.3f} steps/s "
        f"against the train path's {want_steps / want_seconds:.3f} "
        f"({steps:g} steps in {seconds:.3f} s and {want_seconds:.3f} s) on "
        f"{smi}")


def data_parallel_step() -> None:
    """Two ranks sharing ``cuda:0`` over a gloo group, each a process that
    takes 3 of ``phase_f32_step``'s 6 rows, against the same float32 step
    in one process: the losses within STEP_TOL_LOSS, every gradient within
    STEP_TOL_GRAD of the model's largest, the BatchNorm running statistics
    within DP_STAT_TOL of each tensor's largest, and the two ranks'
    gradients and statistics the same bit for bit."""
    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="dp_step_")
    t0 = time.time()
    procs, logs = [], []
    for rank in range(2):
        logs.append(open(os.path.join(work, f"rank{rank}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", DP_RANK_CHILD, str(rank),
             os.path.join(work, "rendezvous"),
             os.path.join(work, f"rank{rank}.pt")],
            cwd=here, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        for proc in procs:
            proc.wait(timeout=DP_TIMEOUT)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    for rank, proc in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(work, f"rank{rank}.log")) as f:
                raise RuntimeError(f"gloo rank {rank} on cuda:0 exited "
                                   f"{proc.returncode}:\n{f.read()[-4000:]}")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in (0, 1)]
    rank_s = time.time() - t0
    want = dp_f32_step(None, DEVICE)
    for name in ("grads", "stats"):
        for k, t in ranks[0][name].items():
            if not torch.equal(t, ranks[1][name][k]):
                raise RuntimeError(f"2 ranks: {name} {k} differ by rank")
    loss_d = abs(ranks[0]["loss"] - want["loss"])
    top = max(g.abs().max().item() for g in want["grads"].values())
    grad_d, grad_name = max(
        ((ranks[0]["grads"][k] - g).abs().max().item() / top, k)
        for k, g in want["grads"].items())
    stat_d, stat_name = max(
        ((ranks[0]["stats"][k] - t).abs().max().item()
         / max(t.abs().max().item(), 1e-5), k)
        for k, t in want["stats"].items() if t.is_floating_point())
    log(f"2 gloo ranks on cuda:0 against one process, one float32 step of "
        f"the recipe's width on 2 x 3 of 6 x 5 s rows ({rank_s:.1f} s for "
        f"the ranks): loss {ranks[0]['loss']:.6f} vs {want['loss']:.6f} "
        f"(|d| {loss_d:.2e}, tolerance {STEP_TOL_LOSS:g}); gradients over "
        f"the model's largest: max |d| {grad_d:.2e} at {grad_name} "
        f"(tolerance {STEP_TOL_GRAD:g}); BatchNorm statistics: max |d| "
        f"{stat_d:.2e} of the tensor's largest at {stat_name} (tolerance "
        f"{DP_STAT_TOL:g})")
    if not loss_d <= STEP_TOL_LOSS:
        raise RuntimeError("2 ranks: the losses disagree")
    if not grad_d <= STEP_TOL_GRAD:
        raise RuntimeError("2 ranks: the gradients disagree")
    if not stat_d <= DP_STAT_TOL:
        raise RuntimeError("2 ranks: the BatchNorm statistics disagree")


def phase_data_parallel(root: str, inputs: dict, train_files: set,
                        train_experiment: str, smi: str) -> None:
    """M5.1 on the one card: the train path's CLI as one NCCL rank under
    ``torchrun``, and the data-parallel arithmetic on two gloo ranks
    sharing ``cuda:0``."""
    t0 = time.time()
    data_parallel_cli(root, inputs, train_files, train_experiment, smi)
    data_parallel_step()
    log(f"data-parallel phase: {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# fold-parallel training over ranks: one fold group a rank (M5.2a), and a
# fold group of two ranks, each with half of every fold's rows (M5.2b)
# ---------------------------------------------------------------------------

FOLD_MESH_ROWS = (8, 6, 7, 8)  # 4 folds, 2 a rank: each fold's clips a batch
# the 1 x 2 layout's folds: the first 3 of them, each rank all 3 and half
# of each fold's 8 padded rows; the chain's round(0.75 * 8) = 6 rows of a
# fold are 3 on each rank, so K2 and K3 launch once per fold a step there
FOLD_DATA_FOLDS = 3
FOLD_MESH_SECONDS = 5
FOLD_MESH_BATCHES = 2  # a fold's batches: the compared epoch's steps
FOLD_MESH_TIMEOUT = 300  # seconds for the gloo ranks and the CLI children
# the compared steps' learning rate: small enough that the first update does
# not amplify the stack width's float32 rounding (2 or 4 folds a stack: at
# 1e-3 the second step's gradients parted by 15-28% of a fold's largest on
# an NVIDIA H100), so that the second step still checks what the ranks
# must reproduce (the generators' draws, the MixUp pool, the padding) at
# STEP_TOL_LOSS and STEP_TOL_GRAD
FOLD_MESH_LR = 1e-6
FOLD_MESH_RANK_CHILD = """
import sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
chip_smoke.fold_mesh_rank(int(sys.argv[1]), sys.argv[2], sys.argv[3],
                          sys.argv[4])
"""


def fold_mesh_batches() -> list:
    """Each fold's ``FOLD_MESH_BATCHES`` batches of ``FOLD_MESH_ROWS``
    synthetic clips of ``FOLD_MESH_SECONDS`` (``f32_step_batch``'s kind),
    from one seed: a fold's batches as its loader yields them."""
    rng = np.random.RandomState(17)
    folds = []
    for rows in FOLD_MESH_ROWS:
        batches = []
        for _ in range(FOLD_MESH_BATCHES):
            wave, lengths, labels = f32_step_batch(rng, rows,
                                                   FOLD_MESH_SECONDS)
            batches.append({"signal": wave, "lengths": lengths,
                            "labels": labels, "index": np.arange(rows)})
        folds.append(batches)
    return folds


def fold_mesh_template(fold_mesh, device, augmented: bool,
                       dtype: torch.dtype, record: dict, checking: list,
                       checkpoint_dir: str | None = None):
    """The template engine of ``fold_mesh_steps`` and ``fold_mesh_fit``:
    the 2d CNN at ``NETWORK``'s width in ``dtype`` (dropout 0, weights
    from a seed) over ``FEATURES`` through K1, each K1 call appending its
    largest difference from its twin to ``record["K1"]`` while
    ``checking[0]``; the recipe's augmentation where ``augmented``;
    momentum at lr ``FOLD_MESH_LR``; on ``fold_mesh``'s fold group where
    it has two ranks."""
    import types

    from freesound_classification_tpu_torch import interop
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

    net = {k: v for k, v in NETWORK.items() if k != "output_dropout"}
    params, stats = interop.random_jax_variables(
        **net, n_classes=TRAIN_CLASSES, seed=13)
    model = TwoDimensionalCNN(**dict(NETWORK, output_dropout=0.0),
                              n_classes=TRAIN_CLASSES, dtype=dtype)
    model.load_state_dict(interop.from_jax_variables(params, stats))

    def k1(spec, fb):
        got = kernels.mel_project_log(spec, fb)
        if checking[0]:
            want = kernels.mel_project_log_reference(spec, fb)
            record["K1"].append((got - want).abs().max().item())
        return got

    return Engine(
        model, Frontend(FEATURES, "2d", sr=SR, device=device, mel_project=k1),
        types.SimpleNamespace(optimizer="momentum",
                              learning_rate=FOLD_MESH_LR,
                              scheduler="steplr_1_0.5", weight_decay=0.0),
        loss="lsep_naive", augment=make_augmenter(AugmentConfig(
            p_mixup=0.5, p_aug=0.75, p_shuffle=0.5, sr=SR))
        if augmented else None,
        checkpoint_dir=checkpoint_dir, seed=7, device=device,
        mesh=None if fold_mesh is None else fold_mesh.data_group)


def fold_mesh_steps(fold_mesh, device, folds: list,
                    alone: list | None = None, augmented: bool = True,
                    dtype: torch.dtype = torch.float32) -> dict:
    """The stacked engine at ``NETWORK``'s width over ``FEATURES`` (float32,
    or the model in ``dtype`` from K1's float32 features; dropout 0,
    weights from a seed), the recipe's augmentation (MixUp 0.5, the chain
    0.75, chunk shuffle 0.5; none unless ``augmented``),
    momentum at lr ``FOLD_MESH_LR``: on ``fold_mesh``'s rank over its own
    folds (where its fold group has two ranks, its half of each fold's
    rows, the template engine on the group); in one process over all of
    them with ``fold_mesh`` None; or, with ``alone`` (a rank's fold
    positions), in one process over those folds alone, told what the job
    gives them (their generators' seeds by position, the job's step count
    and each step's (rows, length) over all folds). One epoch of
    ``FOLD_MESH_BATCHES`` steps with every kernel wrapper's count from 0
    and every call of K1, K2 and K3 held against its plain twin on the
    same arguments (``kernels_against_twins``; the twins launch nothing
    counted), then, in float32, a second one timed. Returns each owned
    fold's per-step losses and last gradients, the first epoch's launches,
    each kernel's largest difference from its twin and the timed epoch's
    stacked steps/s (None in another ``dtype``)."""
    from freesound_classification_tpu_torch.ops import kernels
    from freesound_classification_tpu_torch.training.multifold import (
        MultiFoldEngine,
    )

    record = {"K1": [], "K2": [], "K3": [], "n_fft": []}
    checking = [True]
    template = fold_mesh_template(fold_mesh, device, augmented, dtype,
                                  record, checking)
    fold_ids = list(range(len(folds)))
    own = (fold_mesh.own_folds if fold_mesh is not None
           else fold_ids if alone is None else list(alone))
    stack = MultiFoldEngine(template, own, fold_mesh=fold_mesh)
    loaders = [folds[f] for f in own]
    if alone is not None:
        stack.generators = [torch.Generator(device=device).manual_seed(7 + p)
                            for p in alone]
        n_job = max(len(batches) for batches in folds)
        shapes = [tuple(max(f[i % len(f)]["signal"].shape[j] for f in folds)
                        for j in (0, 1)) for i in range(n_job)]
        calls = []

        def job_shape(batches):
            calls.append(1)
            return shapes[(len(calls) - 1) % n_job]

        stack.step_shape = job_shape
        stack.epoch_steps = lambda loaders: n_job
    n_steps = stack.epoch_steps(loaders)
    stack.make_optimizer(2 * n_steps, n_steps)
    losses = []
    step = stack.train_step

    def recording(*args, **kwargs):
        out = step(*args, **kwargs)
        losses.append(out["loss"].detach().double().cpu())
        return out

    stack.train_step = recording
    for name in kernels.launch_counts():
        getattr(kernels, name).launches = 0
    with kernels_against_twins(record):
        stack.train_epoch(loaders, 1.0, log_interval=10**6, n_steps=n_steps)
    torch.cuda.synchronize()
    checking[0] = False
    launches = {WRAPPER_KERNEL[k]: n
                for k, n in kernels.launch_counts().items() if n}
    names = stack.model.param_names
    stacked = list(stack.model.stacked()[0].values())
    grads = {fold: {n: p.grad[k].detach().cpu()
                    for n, p in zip(names, stacked)}
             for k, fold in enumerate(own)}
    steps_per_s = None
    if dtype == torch.float32:
        t0 = time.perf_counter()
        stack.train_epoch(loaders, 1.0, log_interval=10**6, n_steps=n_steps)
        torch.cuda.synchronize()
        steps_per_s = n_steps / (time.perf_counter() - t0)
    return {"folds": own, "steps": n_steps, "launches": launches,
            "loss": {fold: [float(x[k]) for x in losses[:n_steps]]
                     for k, fold in enumerate(own)},
            "grads": grads,
            "twins": {k: max(record[k], default=0.0)
                      for k in ("K1", "K2", "K3")},
            "steps_per_s": steps_per_s}


class FoldBatches(list):
    """A fold's batches as its train loader, with the epoch counter that
    the stacked bundle keeps."""
    _epoch = 0


def fold_mesh_fit(fold_mesh, device, folds: list, root: str,
                  augmented: bool = True, dtype: torch.dtype = torch.float32,
                  stop: int | None = None, resume: bool = False) -> dict:
    """``MultiFoldEngine.fit`` of 2 epochs of ``fold_mesh_template``'s
    stacked engine over each fold's batches (its first one to validate),
    with the checkpoints under ``root``: on ``fold_mesh``'s rank over its
    folds, or over all of them in one process; stopped before epoch
    ``stop`` as a crash would, or resumed from ``root``'s bundle. With
    every kernel wrapper's count from 0 and every call of K1, K2 and K3
    held against its plain twin. Returns the fit's launches, each
    kernel's largest difference from its twin, each owned fold's per-step
    losses of the run and last gradients, and on world rank 0 (or alone)
    each bundle save's ms on the loop (of it the gather's) and its write's
    on the checkpoint writer, and the bundle's bytes."""
    from freesound_classification_tpu_torch.ops import kernels
    from freesound_classification_tpu_torch.training import checkpoints
    from freesound_classification_tpu_torch.training.multifold import (
        BUNDLE,
        MultiFoldEngine,
    )

    record = {"K1": [], "K2": [], "K3": [], "n_fft": []}
    template = fold_mesh_template(
        fold_mesh, device, augmented, dtype, record, [True],
        checkpoint_dir=os.path.join(root, "checkpoints"))
    own = (fold_mesh.own_folds if fold_mesh is not None
           else list(range(len(folds))))
    stack = MultiFoldEngine(template, own, fold_mesh=fold_mesh)
    losses, saves = [], {"save_ms": [], "gather_ms": []}
    step, gather, save = (stack.train_step, stack.gather_fold_tensors,
                          stack.save_stacked_bundle)

    def recording(*args, **kwargs):
        out = step(*args, **kwargs)
        losses.append(out["loss"].detach().double().cpu())
        return out

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            saves[key].append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    stack.train_step = recording
    stack.gather_fold_tensors = timed(gather, "gather_ms")
    stack.save_stacked_bundle = timed(save, "save_ms")
    if stop is not None:
        train_epoch, started = stack.train_epoch, []

        def stopping(*args, **kwargs):
            if len(started) == stop:
                raise KeyboardInterrupt(f"stopped before epoch {stop}")
            started.append(1)
            return train_epoch(*args, **kwargs)

        stack.train_epoch = stopping
    for name in kernels.launch_counts():
        getattr(kernels, name).launches = 0
    checkpoints.save_times.clear()
    try:
        with kernels_against_twins(record):
            stack.fit([FoldBatches(folds[f]) for f in own],
                      [[folds[f][0]] for f in own], epochs=2,
                      log_interval=10**6, resume=resume)
    except KeyboardInterrupt:
        pass
    torch.cuda.synchronize()
    checkpoints.wait_for_saves()  # a stopped fit leaves its last in flight
    names = stack.model.param_names
    stacked = list(stack.model.stacked()[0].values())
    bundle = os.path.join(root, "checkpoints", BUNDLE)
    writer = fold_mesh is None or fold_mesh.world.rank == 0
    saves["write_ms"] = [r["write_ms"] for r in checkpoints.save_times
                         if r["path"] == os.path.abspath(bundle)]
    return {"folds": own,
            "launches": {WRAPPER_KERNEL[k]: n
                         for k, n in kernels.launch_counts().items() if n},
            "twins": {k: max(record[k], default=0.0)
                      for k in ("K1", "K2", "K3")},
            "loss": {fold: [float(x[k]) for x in losses]
                     for k, fold in enumerate(own)},
            "grads": {fold: {n: p.grad[k].detach().cpu()
                             for n, p in zip(names, stacked)}
                      for k, fold in enumerate(own)},
            **(dict(saves, bundle_bytes=os.path.getsize(bundle))
               if writer else {})}


def fold_mesh_rank(rank: int, rendezvous: str, inputs_path: str,
                   out: str) -> None:
    """Rank ``rank`` of 2 sharing ``cuda:0`` over a gloo group (NCCL
    refuses two ranks on one card), through ``fold_mesh_steps``: its
    ``FoldMesh`` over the 4 folds, a fold group of two folds
    (``by_fold``); then over the first ``FOLD_DATA_FOLDS`` folds, JAX's 1
    x 2 layout, a fold group of both ranks holding every fold, with the
    recipe's augmentation (``by_data``) and without it, the model in
    float64 (``by_data_plain``); then ``fold_mesh_fit`` over the 4 folds,
    the job's bundle of epoch 0 of 2 left under ``inputs_path``'s
    directory with the augmentation (``stopped``) and, without it in
    float64, 2 epochs straight (``straight_plain``) and a bundle of epoch
    0 for ``fold_mesh_resume`` to resume."""
    import datetime

    import torch.distributed as dist

    from freesound_classification_tpu_torch.parallel import mesh as mesh_lib
    from freesound_classification_tpu_torch.training import multifold

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=2,
        timeout=datetime.timedelta(seconds=FOLD_MESH_TIMEOUT))
    try:
        world = mesh_lib.Mesh(rank, 2, dist.group.WORLD, device)
        folds = torch.load(inputs_path, weights_only=False)
        fold_mesh = multifold.make_fold_mesh(world, list(range(len(folds))))
        result = {"by_fold": fold_mesh_steps(fold_mesh, device, folds)}
        three = folds[:FOLD_DATA_FOLDS]
        group = multifold.make_fold_mesh(world, list(range(len(three))))
        result["by_data"] = fold_mesh_steps(group, device, three)
        result["by_data_plain"] = fold_mesh_steps(
            group, device, three, augmented=False, dtype=torch.float64)
        # the job's bundles, for one process to resume
        work = os.path.dirname(inputs_path)
        result["stopped"] = fold_mesh_fit(
            fold_mesh, device, folds, os.path.join(work, "resume_aug"),
            stop=1)
        result["straight_plain"] = fold_mesh_fit(
            fold_mesh, device, folds, os.path.join(work, "straight_plain"),
            augmented=False, dtype=torch.float64)
        fold_mesh_fit(fold_mesh, device, folds,
                      os.path.join(work, "resume_plain"), augmented=False,
                      dtype=torch.float64, stop=1)
        torch.save(result, out)
    finally:
        dist.destroy_process_group()


def fold_mesh_ranks(smi: str) -> None:
    """Two ranks sharing ``cuda:0`` over a gloo group, each a process that
    trains 2 of the 4 folds (``fold_mesh_steps``), against one process on
    the card: on each rank K1 once a stacked step and K2 and K3 once per
    owned fold's chain (twice a step), each call of K1-K3 held against its
    plain twin on the same arguments (``K1_TOL``, ``K2_TOL``,
    ``K3_REL_TOL``); each fold's losses at each step within
    ``STEP_TOL_LOSS`` of the one process stacking all 4; its last
    gradients within ``STEP_TOL_GRAD`` of the fold's largest against the
    one process stacking the rank's 2 folds alone with the job's seeds,
    step count and shapes (``alone``), and, printed beside them, against
    the stack of all 4: that distance is float32's rounding of the stack
    width (2 folds a grouped convolution or 4), which a max-pool near-tie
    turns into percents of a gradient (as ``fold_parallel_truth``'s single
    step against itself on reversed rows shows); each rank's stacked
    steps/s beside the one process's. Then the 1 x 2 layout on the same
    ranks (``fold_data_mesh``), and the ranks' bundle resumed by one
    process (``fold_mesh_resume``)."""
    from freesound_classification_tpu_torch.probes.fold_parallel import (
        gradient_distance,
    )

    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="fold_mesh_")
    folds = fold_mesh_batches()
    inputs = os.path.join(work, "folds.pt")
    torch.save(folds, inputs)
    t0 = time.time()
    procs, logs = [], []
    for rank in range(2):
        logs.append(open(os.path.join(work, f"rank{rank}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", FOLD_MESH_RANK_CHILD, str(rank),
             os.path.join(work, "rendezvous"), inputs,
             os.path.join(work, f"rank{rank}.pt")],
            cwd=here, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        for proc in procs:
            proc.wait(timeout=FOLD_MESH_TIMEOUT)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    for rank, proc in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(work, f"rank{rank}.log")) as f:
                raise RuntimeError(f"fold mesh: gloo rank {rank} on cuda:0 "
                                   f"exited {proc.returncode}:\n"
                                   f"{f.read()[-4000:]}")
    results = [torch.load(os.path.join(work, f"rank{r}.pt"),
                          weights_only=False) for r in (0, 1)]
    ranks = [r["by_fold"] for r in results]
    rank_s = time.time() - t0
    torch.cuda.empty_cache()
    want = fold_mesh_steps(None, DEVICE, folds)
    n = want["steps"]
    if n != FOLD_MESH_BATCHES:
        raise RuntimeError(f"fold mesh: {n} steps an epoch, not "
                           f"{FOLD_MESH_BATCHES}")
    for r, got in enumerate(ranks):
        expect = {"K1": n, "K2": 2 * n, "K3": 2 * n}
        log(f"fold mesh rank {r} (folds {got['folds']}): launches "
            f"{got['launches']} in {got['steps']} stacked steps (expected "
            f"{expect}); each call against its twin: K1 "
            f"{got['twins']['K1']:.2e} (tolerance {K1_TOL:g}), K2 "
            f"{got['twins']['K2']:.2e} ({K2_TOL:g}), K3 "
            f"{got['twins']['K3']:.2e} of its largest ({K3_REL_TOL:g}); "
            f"{got['steps_per_s']:.3f} stacked steps/s")
        if got["steps"] != n:
            raise RuntimeError(f"fold mesh rank {r}: {got['steps']} steps an "
                               f"epoch, the one process {n}")
        if any(got["launches"].get(k) != v for k, v in expect.items()):
            raise RuntimeError(f"fold mesh rank {r}: launches "
                               f"{got['launches']}, expected {expect}")
        tols = {"K1": K1_TOL, "K2": K2_TOL, "K3": K3_REL_TOL}
        if any(not got["twins"][k] <= tol for k, tol in tols.items()):
            raise RuntimeError(f"fold mesh rank {r}: a kernel disagrees with "
                               f"its twin: {got['twins']}")
    losses, grads, width, alone_width, exact = [], [], [], [], True
    for got in ranks:
        alone = fold_mesh_steps(None, DEVICE, folds, alone=got["folds"])
        for fold in got["folds"]:
            losses.append(max(abs(a - b) for a, b in zip(
                got["loss"][fold], want["loss"][fold])))
            grads.append(gradient_distance(got["grads"][fold],
                                           alone["grads"][fold]))
            width.append(gradient_distance(got["grads"][fold],
                                           want["grads"][fold]))
            alone_width.append(gradient_distance(alone["grads"][fold],
                                                 want["grads"][fold]))
            exact &= all(torch.equal(t, alone["grads"][fold][k])
                         for k, t in got["grads"][fold].items())

    def fmt(rows, key="max"):
        return [f"{row[key]:.2e}" for row in rows]

    log(f"2 gloo ranks on cuda:0 against one process, 4 folds of "
        f"{list(FOLD_MESH_ROWS)} x {FOLD_MESH_SECONDS} s, {n} float32 "
        f"augmented steps at {NETWORK['num_conv_blocks']} blocks, depth "
        f"{NETWORK['conv_base_depth']}, {FEATURES}, lr {FOLD_MESH_LR:g} "
        f"({rank_s:.1f} s for the ranks): loss |d| per fold against the "
        f"stack of all 4 {[f'{d:.2e}' for d in losses]} (tolerance "
        f"{STEP_TOL_LOSS:g}); last gradients over each fold's largest "
        f"against the rank's folds stacked alone in one process "
        f"{fmt(grads)} (tolerance {STEP_TOL_GRAD:g}; bit for bit: {exact}); "
        f"against the stack of all 4 {fmt(width)} at "
        f"{[d['at'] for d in width]}, relative L2 {fmt(width, 'l2')}, where "
        f"the one process's stack of 2 is {fmt(alone_width)} from its stack "
        f"of 4; the one process launched {want['launches']}; stacked "
        f"steps/s: ranks {[round(g['steps_per_s'], 3) for g in ranks]} (2 "
        f"folds each, at once), one process {want['steps_per_s']:.3f} (4 "
        f"folds) on {smi}")
    if want["launches"] != {"K1": n, "K2": 4 * n, "K3": 4 * n}:
        raise RuntimeError(f"fold mesh: the one process launched "
                           f"{want['launches']}")
    if not max(losses) <= STEP_TOL_LOSS:
        raise RuntimeError("fold mesh: the losses disagree")
    if not max(d["max"] for d in grads) <= STEP_TOL_GRAD:
        raise RuntimeError("fold mesh: the gradients disagree")
    fold_data_mesh(results, folds[:FOLD_DATA_FOLDS], smi)
    fold_mesh_resume(results, work, folds, smi)


def fold_mesh_resume(results: list, work: str, folds: list,
                     smi: str) -> None:
    """Elastic resume on the card: the job's one bundle of epoch 0 of 2,
    written by the two gloo ranks sharing ``cuda:0`` (the 2 x 1 layout,
    the recipe's augmentation), resumed by one process over all 4 folds
    for epoch 1: K1 once a stacked step and once a fold's validation
    batch, K2 and K3 once a fold a step, each call held against its plain
    twin (``K1_TOL``, ``K2_TOL``, ``K3_REL_TOL``). Without augmentation
    and with the model in float64, the ranks' bundle of epoch 0 resumed in
    one process against the ranks' uninterrupted 2 epochs: each fold's
    epoch 1 losses within ``STEP_TOL_LOSS`` and its last gradients within
    ``STEP_TOL_GRAD`` of the fold's largest. Prints each bundle save's ms
    on rank 0's loop (the gather to rank 0 and the snapshot), the gather
    among them, the write's ms on its checkpoint writer, and the bundle's
    size."""
    from freesound_classification_tpu_torch.probes.fold_parallel import (
        gradient_distance,
    )

    stopped, straight = (results[0]["stopped"],
                         results[0]["straight_plain"])
    torch.cuda.empty_cache()
    t0 = time.time()
    got = fold_mesh_fit(None, DEVICE, folds, os.path.join(work, "resume_aug"),
                        resume=True)
    n = FOLD_MESH_BATCHES
    expect = {"K1": n + len(folds), "K2": len(folds) * n,
              "K3": len(folds) * n}
    tols = {"K1": K1_TOL, "K2": K2_TOL, "K3": K3_REL_TOL}

    def ms(values):
        return [round(v, 1) for v in values]

    log(f"fold mesh bundle of {len(folds)} folds (the 2 x 1 layout on 2 "
        f"gloo ranks sharing cuda:0, {NETWORK['num_conv_blocks']} blocks, "
        f"depth {NETWORK['conv_base_depth']}, weights and momentum): "
        f"float32 {stopped['bundle_bytes'] / 1e6:.1f} MB, a save on the "
        f"loop {ms(stopped['save_ms'])} ms, of it the gather to rank 0 "
        f"{ms(stopped['gather_ms'])} ms, its write on the writer "
        f"{ms(stopped['write_ms'])} ms; the float64 runs' (float64 "
        f"arithmetic, float32 weights) {straight['bundle_bytes'] / 1e6:.1f} "
        f"MB, saves on the loop {ms(straight['save_ms'])} ms, gathers "
        f"{ms(straight['gather_ms'])} ms, writes "
        f"{ms(straight['write_ms'])} ms; one process's save of the resumed "
        f"epoch (no gather) on the loop "
        f"{ms(got['save_ms'])} ms, its write {ms(got['write_ms'])} ms on "
        f"{smi}")
    log(f"fold mesh resume of the ranks' bundle in one process on cuda:0 "
        f"(epoch 1 of 2, {len(folds)} folds, augmented): launches "
        f"{got['launches']} (expected {expect}); each call against its twin: "
        f"K1 {got['twins']['K1']:.2e} (tolerance {K1_TOL:g}), K2 "
        f"{got['twins']['K2']:.2e} ({K2_TOL:g}), K3 "
        f"{got['twins']['K3']:.2e} of its largest ({K3_REL_TOL:g})")
    if got["launches"] != expect:
        raise RuntimeError(f"fold mesh resume: launches {got['launches']}, "
                           f"expected {expect}")
    if any(not got["twins"][k] <= tol for k, tol in tols.items()):
        raise RuntimeError(f"fold mesh resume: a kernel disagrees with its "
                           f"twin: {got['twins']}")
    plain = fold_mesh_fit(None, DEVICE, folds,
                          os.path.join(work, "resume_plain"), augmented=False,
                          dtype=torch.float64, resume=True)
    want = {"loss": {}, "grads": {}}
    for r in results:
        for key in want:
            want[key].update(r["straight_plain"][key])
    losses, top, l2 = [], [], []
    for fold in range(len(folds)):
        losses.append(max(abs(a - b) for a, b in zip(
            plain["loss"][fold], want["loss"][fold][-n:])))
        d = gradient_distance(plain["grads"][fold], want["grads"][fold])
        top.append(d["max"])
        l2.append(d["l2"])

    def fmt(values):
        return [f"{v:.2e}" for v in values]

    log(f"fold mesh resume without augmentation, the model in float64: the "
        f"ranks' bundle of epoch 0 resumed in one process against the "
        f"ranks' 2 epochs straight, per fold epoch 1 loss |d| {fmt(losses)} "
        f"(tolerance {STEP_TOL_LOSS:g}), last gradients' largest |d| over "
        f"the fold's largest {fmt(top)} (tolerance {STEP_TOL_GRAD:g}), "
        f"relative L2 {fmt(l2)}; the two resumes {time.time() - t0:.1f} s "
        f"on {smi}")
    if not max(losses) <= STEP_TOL_LOSS:
        raise RuntimeError("fold mesh resume: the losses disagree")
    if not max(top) <= STEP_TOL_GRAD:
        raise RuntimeError("fold mesh resume: the gradients disagree")


def fold_data_mesh(results: list, folds: list, smi: str) -> None:
    """JAX's 1 x 2 layout of ``folds`` (``FOLD_DATA_FOLDS``) on the two
    gloo ranks sharing ``cuda:0``: each rank all the folds and its half of
    each fold's rows, BatchNorm's statistics and the gradients summed over
    the two. On each rank, with the recipe's augmentation, K1 once a
    stacked step and K2 and K3 once per fold a step (each rank's share of
    a fold's chain rows is 3), each call held against its plain twin
    (``K1_TOL``, ``K2_TOL``, ``K3_REL_TOL``); each rank's stacked steps/s
    beside one process stacking the folds over whole rows. Without
    augmentation (each rank draws its own) and with the model in float64
    from K1's float32 features, against that one process: each fold's
    per-step losses within ``STEP_TOL_LOSS`` (the whole batch's, alike on
    both ranks) and its last gradients within ``STEP_TOL_GRAD`` of the
    fold's largest entry, their relative L2 distance printed. In float32
    the same comparison measured a relative L2 of 1.02e-2 and 2.03e-2 of
    a fold's largest entry on an NVIDIA H100: the rounding of BatchNorm
    sums over two ranks, which max-pool near-ties amplify, as large as
    the stack width's (``fold_mesh_ranks``: 1.14e-2 and 1.83e-2 in the
    same run)."""
    from freesound_classification_tpu_torch.probes.fold_parallel import (
        gradient_distance,
    )

    ranks = [r["by_data"] for r in results]
    plain = [r["by_data_plain"] for r in results]
    torch.cuda.empty_cache()
    want = fold_mesh_steps(None, DEVICE, folds)
    want_plain = fold_mesh_steps(None, DEVICE, folds, augmented=False,
                                 dtype=torch.float64)
    n = want["steps"]
    expect = {"K1": n, "K2": len(folds) * n, "K3": len(folds) * n}
    tols = {"K1": K1_TOL, "K2": K2_TOL, "K3": K3_REL_TOL}
    for r, got in enumerate(ranks):
        log(f"fold data mesh rank {r} (1 x 2, folds {got['folds']}, half "
            f"the rows): launches {got['launches']} in {got['steps']} "
            f"stacked steps (expected {expect}); each call against its "
            f"twin: K1 {got['twins']['K1']:.2e} (tolerance {K1_TOL:g}), K2 "
            f"{got['twins']['K2']:.2e} ({K2_TOL:g}), K3 "
            f"{got['twins']['K3']:.2e} of its largest ({K3_REL_TOL:g}); "
            f"{got['steps_per_s']:.3f} stacked steps/s")
        if got["folds"] != list(range(len(folds))) or got["steps"] != n:
            raise RuntimeError(f"fold data mesh rank {r}: folds "
                               f"{got['folds']}, {got['steps']} steps")
        if got["launches"] != expect:
            raise RuntimeError(f"fold data mesh rank {r}: launches "
                               f"{got['launches']}, expected {expect}")
        if any(not got["twins"][k] <= tol for k, tol in tols.items()):
            raise RuntimeError(f"fold data mesh rank {r}: a kernel "
                               f"disagrees with its twin: {got['twins']}")
    losses, grads = [], []
    for got in plain:
        for fold in got["folds"]:
            losses.append(max(abs(a - b) for a, b in zip(
                got["loss"][fold], want_plain["loss"][fold])))
            grads.append(gradient_distance(got["grads"][fold],
                                           want_plain["grads"][fold]))
    l2, top = [d["l2"] for d in grads], [d["max"] for d in grads]
    log(f"1 x 2 fold group of 2 gloo ranks on cuda:0 against one process, "
        f"{len(folds)} folds of {list(FOLD_MESH_ROWS[:len(folds)])} x "
        f"{FOLD_MESH_SECONDS} s, {n} steps without augmentation at lr "
        f"{FOLD_MESH_LR:g}, the model in float64: per fold (rank 0's, then "
        f"rank 1's) loss |d| {[f'{d:.2e}' for d in losses]} (tolerance "
        f"{STEP_TOL_LOSS:g}); last "
        f"gradients' largest |d| over each fold's largest entry "
        f"{[f'{d:.2e}' for d in top]} (tolerance {STEP_TOL_GRAD:g}), "
        f"relative L2 {[f'{d:.2e}' for d in l2]}, at "
        f"{[d['at'] for d in grads]}; the one process launched "
        f"{want['launches']} augmented; stacked steps/s: ranks "
        f"{[round(g['steps_per_s'], 3) for g in ranks]} (all {len(folds)} "
        f"folds each, half the rows, at once), one process "
        f"{want['steps_per_s']:.3f} (whole rows) on {smi}")
    if want["launches"] != expect:
        raise RuntimeError(f"fold data mesh: the one process launched "
                           f"{want['launches']}")
    if not max(losses) <= STEP_TOL_LOSS:
        raise RuntimeError("fold data mesh: the losses disagree")
    if not max(top) <= STEP_TOL_GRAD:
        raise RuntimeError("fold data mesh: the gradients disagree")


def fold_mesh_cli(root: str, inputs: dict, smi: str) -> None:
    """The train path's CLI over folds 0 and 1 with ``--fold_parallel``, 1
    epoch, under ``torchrun --standalone --nproc_per_node 1`` (the layout
    path on one NCCL rank: its all-gathers, its fold group of one) and as
    a plain child of the same run, the two at once: the layout's line in
    the torchrun child's output, the same files, K1-K3 launched alike
    (``$FSC_LAUNCH_LOG``), each fold's final weights within
    ``RESUME_WEIGHT_TOL`` relative L2 of the plain child's (bit for bit
    printed)."""
    module = "freesound_classification_tpu_torch.cli.train_2d_cnn"
    runs = {}

    def run(name: str, launcher: list) -> None:
        experiments = os.path.join(root, f"fm_{name}")
        log_path = os.path.join(root, f"fm_{name}_launches.jsonl")
        argv = [*train_argv(inputs, experiments), "--folds", "0", "1",
                "--fold_parallel", "--epochs", "1"]
        t0 = time.time()
        rc, out, _ = run_logged([*launcher, "-m", module, *argv],
                                dict(os.environ, FSC_LAUNCH_LOG=log_path),
                                FOLD_MESH_TIMEOUT)
        runs[name] = (rc, out, experiments, log_path, time.time() - t0)

    threads = [threading.Thread(target=run, args=(name, launcher))
               for name, launcher in (
                   ("torchrun", [sys.executable, "-m",
                                 "torch.distributed.run", "--standalone",
                                 "--nproc_per_node", "1"]),
                   ("plain", [sys.executable]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    found = {}
    for name, (rc, out, experiments, log_path, wall) in runs.items():
        if rc != 0:
            raise RuntimeError(f"fold mesh CLI ({name}) exited {rc}:\n"
                               f"{out[-4000:]}")
        with open(log_path) as f:
            records = [json.loads(line) for line in f]
        if [r["rank"] for r in records] != [0]:
            raise RuntimeError(f"fold mesh CLI ({name}): launch records of "
                               f"ranks {[r['rank'] for r in records]}")
        (exp,) = os.listdir(experiments)
        exp = os.path.join(experiments, exp)
        found[name] = (exp, {WRAPPER_KERNEL[k]: n for k, n in
                             records[0]["launches"].items() if n}, wall)
    layout = "layout 1 x 1 (fold x data) on 1 rank, folds [0, 1]"
    if layout not in runs["torchrun"][1]:
        raise RuntimeError("fold mesh CLI: the torchrun child did not take "
                           "the layout path")
    (t_exp, t_k, t_wall), (p_exp, p_k, p_wall) = (found["torchrun"],
                                                  found["plain"])
    t_files, p_files = experiment_files(t_exp), experiment_files(p_exp)
    d = [float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in (
        (final_params(os.path.join(t_exp, "checkpoints", f"fold_{k}")),
         final_params(os.path.join(p_exp, "checkpoints", f"fold_{k}")))
        for k in (0, 1))]
    log(f"fold-parallel CLI under torchrun (1 NCCL rank, {layout}) and "
        f"plain, at once: {t_wall:.1f} and {p_wall:.1f} s wall, "
        f"{len(t_files)} and {len(p_files)} files; launches {t_k} and {p_k}; "
        f"final weights per fold, relative L2 {[f'{x:.3e}' for x in d]} "
        f"(tolerance {RESUME_WEIGHT_TOL:g}; bit for bit: {max(d) == 0.0}) "
        f"on {smi}")
    if t_files != p_files:
        raise RuntimeError(f"fold mesh CLI: only under torchrun "
                           f"{sorted(t_files - p_files)}, only plain "
                           f"{sorted(p_files - t_files)}")
    if t_k != p_k or min(t_k.get(k, 0) for k in ("K1", "K2", "K3")) <= 0:
        raise RuntimeError(f"fold mesh CLI: launches {t_k} against {p_k}")
    if not max(d) <= RESUME_WEIGHT_TOL:
        raise RuntimeError(f"fold mesh CLI: final weights {d}")


def phase_fold_mesh(root: str, inputs: dict, smi: str) -> None:
    """M5.2a and M5.2b on the one card: 4 folds on two gloo ranks sharing
    it, 2 a rank, and 3 folds on the same ranks in the 1 x 2 layout, each
    against one process, the ranks' bundle resumed by one process (elastic
    resume), and, beside them, the fold-parallel train CLI on one NCCL
    rank under ``torchrun`` against a plain child."""
    t0 = time.time()
    # the CLI's two children beside the ranks: both compare results, not
    # times (the ranks' stacked steps/s are taken beside the children)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cli = pool.submit(fold_mesh_cli, root, inputs, smi)
        fold_mesh_ranks(smi)
        cli.result()
    log(f"fold mesh phase: {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the reference's host transform API (M4.5)
# ---------------------------------------------------------------------------

# clip lengths of the compat phase: four under 3277 samples (buffer 4096,
# where the phase vocoder takes n_fft 512 and hop 128), one just above, and
# up to a clip that SampleLongAudio crops to 15 s
COMPAT_LENGTHS = (2000, 2500, 3000, 3276, 3277, 30000, 2 * SR, 5 * SR,
                  10 * SR, 15 * SR, 17 * SR)
COMPAT_CLASSES = {"a": 0, "b": 1, "c": 2}
COMPAT_WORKERS = 2
COMPAT_TIMEOUT = 300  # seconds a spawn worker may take for one sample
# the one-clip chain timed by events: a short clip (n_fft 512), 5 s, 15 s
CHAIN_CLIP_LENGTHS = (3000, 5 * SR, 15 * SR)
CHAIN_PARAMS = (25.0, 25.0, 150.0, 6.0, 1.0)  # reverb, room, cents, gain, speed


class TwinChecked:
    """The ``kernels`` module as the effects chain's callers see it inside
    ``kernels_against_twins``: K2's and K3's wrappers run as they are, and
    then their plain twins on the same arguments; each call appends to
    ``record`` K2's max |difference|, K3's over the largest output of its
    twin, and K3's n_fft. The wrapper's launch is the caller's; the twins
    launch nothing counted. Every other name is the module's."""

    def __init__(self, record: dict):
        from freesound_classification_tpu_torch.ops import kernels

        self._kernels = kernels
        self._record = record

    def __getattr__(self, name: str):
        return getattr(self._kernels, name)

    def resample_linear(self, *args, **kwargs):
        got = self._kernels.resample_linear(*args, **kwargs)
        want = self._kernels.resample_linear_reference(*args, **kwargs)
        self._record["K2"].append((got - want).abs().max().item())
        return got

    def pv_resynth(self, *args, **kwargs):
        got = self._kernels.pv_resynth(*args, **kwargs)
        want = self._kernels.pv_resynth_reference(*args, **kwargs)
        self._record["K3"].append((got - want).abs().max().item()
                                  / want.abs().max().item())
        self._record["n_fft"].append(int(args[4].shape[1]))
        return got


@contextlib.contextmanager
def kernels_against_twins(record: dict):
    """Inside, the chain's two callers of K2 and K3 (``ops/augment.py``,
    ``ops/pv.py``) reach them through ``TwinChecked(record)``."""
    from freesound_classification_tpu_torch.ops import augment, pv

    checked = TwinChecked(record)
    saved = augment.kernels, pv.kernels
    augment.kernels = pv.kernels = checked
    try:
        yield
    finally:
        augment.kernels, pv.kernels = saved


class ChainProbe:
    """The compat phase's ``AudioAugmentation``, wrapped: each call runs
    with K2 and K3 held against their plain twins
    (``kernels_against_twins``) and adds to the sample, as "probe", what
    the call launched, those differences, K3's n_fft, the clip's lengths in
    and out, and the DataLoader worker that read it (-1: the phase's own
    process)."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, dataset=None, **inputs):
        from freesound_classification_tpu_torch.ops import kernels

        record = {"K2": [], "K3": [], "n_fft": []}
        before = kernels.launch_counts()
        with kernels_against_twins(record):
            out = self.inner(dataset=dataset, **inputs)
        after = kernels.launch_counts()
        worker = torch.utils.data.get_worker_info()
        out["probe"] = dict(
            record, worker=-1 if worker is None else worker.id,
            launches={WRAPPER_KERNEL[k]: after[k] - before[k] for k in after},
            n_in=int(inputs["audio"].size), n_out=int(out["audio"].size))
        return out


def seed_compat_worker(worker_id: int) -> None:
    """A spawn worker's numpy and ``random`` streams, from its id."""
    import random

    np.random.seed(worker_id)
    random.seed(worker_id)


def write_compat_clips(root: str) -> tuple:
    """``COMPAT_LENGTHS`` clips as WAVs, and their labels of
    ``COMPAT_CLASSES``."""
    rng = np.random.RandomState(7)
    clip_dir = os.path.join(root, "compat")
    os.makedirs(clip_dir)
    names = sorted(COMPAT_CLASSES)
    files, labels = [], []
    for i, n in enumerate(COMPAT_LENGTHS):
        files.append(os.path.join(clip_dir, f"clip{i:02d}.wav"))
        write_wav(files[-1], synthetic_clip(int(n), rng))
        labels.append([names[i % 3]] if i % 4 else names[:2])
    return files, labels


def compat_run(files: list, labels: list, workers: int) -> tuple:
    """The reference's train stack (``train_2d_cnn.py:310-322``:
    LoadAudio, SampleLongAudio(15), MapLabels, ShuffleAudio, MixUp(0.5),
    AudioAugmentation(1.0) on the card, AudioFeatures, DropFields) over a
    ``SoundDataset`` of ``files``, read once through a
    ``torch.utils.data.DataLoader`` with ``workers`` spawn workers (0: in
    this process, after numpy's and ``random``'s seeds 0); returns (the
    samples, the wall seconds)."""
    import random

    from freesound_classification_tpu_torch.data import transforms as tr
    from freesound_classification_tpu_torch.data.sound_dataset import (
        SoundDataset,
    )

    clean = [tr.LoadAudio(), tr.SampleLongAudio(max_length=15),
             tr.MapLabels(class_map=COMPAT_CLASSES)]
    transform = tr.Compose([
        *clean, tr.ShuffleAudio(chunk_length=0.5, p=0.5), tr.MixUp(p=0.5),
        ChainProbe(tr.AudioAugmentation(p=1.0, device=DEVICE)),
        tr.AudioFeatures(FEATURES), tr.DropFields(("audio", "filename",
                                                   "sr"))])
    dataset = SoundDataset(files, labels=labels, transform=transform,
                           clean_transform=tr.Compose(clean))
    options = ({} if workers == 0 else dict(
        num_workers=workers, multiprocessing_context="spawn",
        worker_init_fn=seed_compat_worker, timeout=COMPAT_TIMEOUT))
    np.random.seed(0)
    random.seed(0)
    t0 = time.time()
    samples = list(torch.utils.data.DataLoader(dataset, batch_size=None,
                                               **options))
    torch.cuda.synchronize()
    return samples, time.time() - t0


def check_compat_samples(label: str, samples: list, workers: int) -> dict:
    """Every sample of one compat run: a finite (n, 1) signal and (3,)
    labels; K2 and K3 launched once for its chain call, and no other
    kernel; each within its ``phase_k2``/``phase_k3`` tolerance of its
    plain twin; read by the expected workers; and a chain call at n_fft
    512. Returns the run's numbers."""
    if len(samples) != len(COMPAT_LENGTHS):
        raise RuntimeError(f"compat {label}: {len(samples)} samples")
    k2_err = k3_rel = 0.0
    n_ffts, workers_seen = set(), set()
    for s in samples:
        probe = s["probe"]
        signal_ = s["signal"]
        if (signal_.ndim != 2 or signal_.shape[1] != 1
                or signal_.shape[0] != probe["n_out"]
                or not torch.isfinite(signal_).all()
                or tuple(s["labels"].shape) != (len(COMPAT_CLASSES),)):
            raise RuntimeError(f"compat {label}: bad sample "
                               f"{tuple(signal_.shape)} {probe}")
        want = {k: int(k in ("K2", "K3")) for k in probe["launches"]}
        if probe["launches"] != want:
            raise RuntimeError(f"compat {label}: one chain call launched "
                               f"{probe['launches']}, not K2 and K3 once")
        k2_err = max(k2_err, *probe["K2"])
        k3_rel = max(k3_rel, *probe["K3"])
        n_ffts.update(probe["n_fft"])
        workers_seen.add(probe["worker"])
    log(f"compat {label}: {len(samples)} samples, chain inputs of "
        f"{sorted(s['probe']['n_in'] for s in samples)} samples, K3 at "
        f"n_fft {sorted(n_ffts)}; K2 and K3 once per chain call; K2 max "
        f"|err| {k2_err:.3e} (tolerance {K2_TOL:g}), K3 max |err| "
        f"{k3_rel:.3e} of the largest output (tolerance {K3_REL_TOL:g})")
    if not k2_err <= K2_TOL:
        raise RuntimeError(f"compat {label}: K2 disagrees: {k2_err}")
    if not k3_rel <= K3_REL_TOL:
        raise RuntimeError(f"compat {label}: K3 disagrees: {k3_rel}")
    if 512 not in n_ffts:
        raise RuntimeError(f"compat {label}: no chain call at n_fft 512")
    if workers_seen != (set(range(workers)) if workers else {-1}):
        raise RuntimeError(f"compat {label}: read by {workers_seen}")
    return {"K2": len(samples), "K3": len(samples)}


def phase_compat(root: str, smi: str) -> dict:
    """M4.5 on the card: the reference's train stack with the port's chain
    (``compat_run``) twice with no worker and once with ``COMPAT_WORKERS``
    spawn workers, each checked (``check_compat_samples``) and its
    samples/s printed; then the one-clip chain (``host_ops.effects_chain_with``) at
    ``CHAIN_CLIP_LENGTHS``: ms by CUDA events and its device launches by
    torch.profiler; and what ``dsp.iir_matrices`` holds after the run.
    Returns the K2 and K3 launches of the two runs."""
    from freesound_classification_tpu_torch.data import host_ops
    from freesound_classification_tpu_torch.ops import dsp

    t0 = time.time()
    files, labels = write_compat_clips(root)
    launches = collections.Counter()
    # no worker twice: the first pass meets each buffer length for the
    # first time (cuFFT plans, the IIR's matrices), the second does not
    for label, workers in (("no worker, first pass", 0),
                           ("no worker, second pass", 0),
                           (f"{COMPAT_WORKERS} spawn workers",
                            COMPAT_WORKERS)):
        samples, wall = compat_run(files, labels, workers)
        launches.update(check_compat_samples(label, samples, workers))
        log(f"compat {label}: {len(samples) / wall:.3f} samples/s ({wall:.2f}"
            f" s for {len(samples)} clips of {min(COMPAT_LENGTHS)}-"
            f"{max(COMPAT_LENGTHS)} samples, decode, MixUp and the twin "
            f"checks included"
            + (", the workers' start included" if workers else "")
            + f") on {smi}")
    rng = np.random.RandomState(8)
    for n in CHAIN_CLIP_LENGTHS:
        clip = synthetic_clip(n, rng).astype(np.float32)

        def chain():
            return host_ops.effects_chain_with(clip, *CHAIN_PARAMS, sr=SR,
                                               device=DEVICE)

        ms = cuda_ms(chain, iters=10)
        ops = device_kernels(chain, calls=3)
        log(f"one-clip chain, {n} samples (buffer "
            f"{host_ops.effects_buffer(n)}): {ms:.3f} ms by CUDA events "
            f"(copies in and out included), "
            f"{sum(k for _, _, k in ops):g} device launches a call, "
            f"{sum(t for _, t, _ in ops):.3f} device ms; longest: "
            + "; ".join(f"{name[:50]} {t:.4f} ms x{k:g}"
                        for name, t, k in ops[:4]) + f" on {smi}")
    log(f"dsp.iir_matrices after the compat phase: "
        f"{dsp.iir_matrices.cache_info()} (one entry per chain buffer and "
        f"device: the buffers here "
        f"{sorted({host_ops.effects_buffer(n) for n in COMPAT_LENGTHS})} "
        f"and the paths' own)")
    log(f"compat phase: {time.time() - t0:.1f} s")
    return dict(launches)


# ---------------------------------------------------------------------------
# fold-ensemble inference on a mesh (M5.4)
# ---------------------------------------------------------------------------

MESH_TIMEOUT = 300  # seconds for each CLI child and for the gloo ranks
MESH_RANK_CHILD = """
import sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
chip_smoke.mesh_rank(int(sys.argv[1]), sys.argv[2], sys.argv[3],
                     sys.argv[4])
"""


def mesh_rank(rank: int, rendezvous: str, inputs_path: str,
              out: str) -> None:
    """Rank ``rank`` of 2 sharing the card over a gloo group: the 5-fold
    bf16 ensemble of the predict path over its decoded batches through
    ``predict_loader(mesh=...)``, once to warm up and once timed with K1's
    count from 0; saves the probabilities, K1's launches and the
    seconds."""
    import datetime

    import torch.distributed as dist

    from freesound_classification_tpu_torch.cli import predict_2d_cnn
    from freesound_classification_tpu_torch.ops import kernels
    from freesound_classification_tpu_torch.parallel import mesh as mesh_lib

    device = torch.device(DEVICE, 0) if DEVICE == "cuda" else \
        torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    try:
        with open(inputs_path) as f:
            inputs = json.load(f)
        mesh = mesh_lib.Mesh(rank, 2, dist.group.WORLD, device)
        host = decoded_batches(inputs)
        predictor = predict_2d_cnn.build_predictor(
            inputs["experiment"], device, dtype=torch.bfloat16)
        predictor.predict_loader(host, mesh=mesh)
        kernels.mel_project_log.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        probs = predictor.predict_loader(host, mesh=mesh)
        torch.cuda.synchronize()
        torch.save({"probs": probs, "seconds": time.time() - t0,
                    "K1": kernels.mel_project_log.launches,
                    "batches": len(host)}, out)
    finally:
        dist.destroy_process_group()


def mesh_cli_children(root: str, inputs: dict, plain_k1: int,
                      plain_probs: np.ndarray, smi: str) -> None:
    """The predict path's CLI as a child, then under ``torchrun
    --standalone --nproc_per_node 1 ... --mesh_devices 1`` (NCCL), each
    with its launches through ``$FSC_LAUNCH_LOG``: the torchrun CSV equals
    the in-process CLI's within ``ENSEMBLE_BF16_TOL``, K1's launches equal
    its, rank 0 alone reports; each child's predict loop clips/s (the
    CLI's line) and wall."""
    module = "freesound_classification_tpu_torch.cli.predict_2d_cnn"
    runs = {}
    for name in ("plain", "torchrun"):
        out_csv = os.path.join(root, f"mesh_{name}.csv")
        log_path = os.path.join(root, f"mesh_{name}_launches.jsonl")
        argv = ["--experiment", inputs["experiment"],
                "--test_df", inputs["test_csv"],
                "--test_data_dir", inputs["test_dir"],
                "--classmap", inputs["classmap"], "--output_df", out_csv,
                "--max_batch_elems", str(MAX_BATCH_ELEMS),
                "--num_workers", "4", "--device", DEVICE, "--bf16"]
        cmd = ([sys.executable, "-m", module, *argv] if name == "plain" else
               [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1", "-m", module, *argv,
                "--mesh_devices", "1"])
        t0 = time.time()
        rc, out, _ = run_logged(cmd, dict(os.environ, FSC_LAUNCH_LOG=log_path),
                                MESH_TIMEOUT)
        wall = time.time() - t0
        if rc != 0:
            raise RuntimeError(f"the {name} predict CLI exited {rc}:\n"
                               f"{out[-4000:]}")
        with open(log_path) as f:
            records = [json.loads(line) for line in f]
        rate = re.search(r"predicted in ([0-9.]+) s, ([0-9.]+) clips/s", out)
        if len(records) != 1 or rate is None:
            raise RuntimeError(f"the {name} predict CLI: {len(records)} "
                               f"launch records, output {out[-2000:]}")
        _, fnames, probs = read_predictions(out_csv)
        runs[name] = {"rank": records[0].get("rank"), "wall": wall,
                      "K1": records[0]["launches"]["mel_project_log"],
                      "rate": float(rate.group(2)), "fnames": fnames,
                      "diff": float(np.abs(probs - plain_probs).max())}
    for name, run in runs.items():
        log(f"predict CLI child, {name}: {run['rate']:.2f} clips/s in its "
            f"predict loop, {N_CLIPS / run['wall']:.2f} clips/s over the "
            f"child's {run['wall']:.2f} s wall (start and model load "
            f"included); K1 {run['K1']} launches; its CSV against the "
            f"in-process CLI's: max |dp| {run['diff']:.3e} on {smi}")
    for name, run in runs.items():
        if run["rank"] != 0:
            raise RuntimeError(f"the {name} child's launch record is rank "
                               f"{run['rank']}'s")
        if run["fnames"] != inputs["fnames"]:
            raise RuntimeError(f"the {name} child's CSV rows")
        if not run["diff"] <= ENSEMBLE_BF16_TOL:
            raise RuntimeError(f"the {name} child's CSV disagrees: "
                               f"{run['diff']}")
        if run["K1"] != plain_k1:
            raise RuntimeError(f"the {name} child launched K1 {run['K1']} "
                               f"times, the plain CLI {plain_k1}")
    log(f"torchrun predict CLI (1 NCCL rank) against the plain CLI child: "
        f"{runs['torchrun']['rate'] / runs['plain']['rate']:.3f}x in the "
        f"predict loop on {smi}")


def mesh_gloo_ranks(root: str, inputs: dict, plain_k1: int,
                    plain_probs: np.ndarray, smi: str) -> None:
    """Two ranks sharing the card over a gloo group (NCCL refuses two ranks
    on one card), each a process running ``mesh_rank``: both return the
    same probabilities, within ``ENSEMBLE_BF16_TOL`` of the predict path's
    CSV, and each launched K1 once a batch, as the plain CLI; clips/s of
    the pair's timed pass."""
    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="mesh_ranks_", dir=root)
    inputs_path = os.path.join(work, "inputs.json")
    with open(inputs_path, "w") as f:
        json.dump(inputs, f)
    t0 = time.time()
    procs, logs = [], []
    for rank in range(2):
        logs.append(open(os.path.join(work, f"rank{rank}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MESH_RANK_CHILD, str(rank),
             os.path.join(work, "rendezvous"), inputs_path,
             os.path.join(work, f"rank{rank}.pt")],
            cwd=here, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        for proc in procs:
            proc.wait(timeout=MESH_TIMEOUT)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    for rank, proc in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(work, f"rank{rank}.log")) as f:
                raise RuntimeError(f"gloo predict rank {rank} exited "
                                   f"{proc.returncode}:\n{f.read()[-4000:]}")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in (0, 1)]
    diff = float(np.abs(ranks[0]["probs"] - plain_probs).max())
    log(f"2 gloo ranks on the card, predict_loader(mesh=...): "
        f"{time.time() - t0:.1f} s for the pair; timed pass over the "
        f"decoded batches {N_CLIPS / max(r['seconds'] for r in ranks):.2f} "
        f"clips/s (one process: the predict path's device sweep); K1 "
        f"{[r['K1'] for r in ranks]} launches over {ranks[0]['batches']} "
        f"batches (plain CLI {plain_k1}); max |dp| against the predict "
        f"path's CSV {diff:.3e} (tolerance {ENSEMBLE_BF16_TOL:g}) on {smi}")
    if not np.array_equal(ranks[0]["probs"], ranks[1]["probs"]):
        raise RuntimeError("2 gloo predict ranks returned different rows")
    if not diff <= ENSEMBLE_BF16_TOL:
        raise RuntimeError(f"2 gloo predict ranks disagree: {diff}")
    if [r["K1"] for r in ranks] != [plain_k1] * 2:
        raise RuntimeError(f"2 gloo predict ranks launched K1 "
                           f"{[r['K1'] for r in ranks]} times, not "
                           f"{plain_k1} each")


def phase_mesh_predict(root: str, inputs: dict, plain_k1: int,
                       plain_probs: np.ndarray, smi: str) -> None:
    """M5.4 on the one card: the predict CLI as one NCCL rank under
    ``torchrun`` beside the plain CLI, and ``predict_loader`` on two gloo
    ranks sharing the card."""
    t0 = time.time()
    mesh_cli_children(root, inputs, plain_k1, plain_probs, smi)
    mesh_gloo_ranks(root, inputs, plain_k1, plain_probs, smi)
    log(f"mesh predict phase: {time.time() - t0:.1f} s")


def phase_tta(root: str, inputs: dict, experiment: str, smi: str) -> None:
    """The predict CLI on ``phase_train``'s fold over its own labelled
    clips, bf16: ``--n_tta 1`` bit for bit the ensemble's clean pass as the
    CLI ran it before TTA (rows put back in dataset order); then ``--n_tta
    3`` with the shift, noise and shuffle knobs, and ``--n_tta 3
    --tta_max_audio_length 5``: K1 launches once a batch and pass,
    probabilities in [0, 1] whose mean |difference| from the clean ones is
    more than 0 and under ``TTA_MEAN_DIFF``; clips/s of each."""
    from freesound_classification_tpu_torch.cli import common, predict_2d_cnn
    from freesound_classification_tpu_torch.data.dataset import ClipDataset
    from freesound_classification_tpu_torch.data.loader import make_loader
    from freesound_classification_tpu_torch.ops import kernels

    files = [os.path.join(inputs["train_dir"], f) for f in inputs["fnames"]]
    base = ["--experiment", experiment, "--test_df", inputs["train_csv"],
            "--test_data_dir", inputs["train_dir"],
            "--classmap", inputs["classmap"], "--device", DEVICE, "--bf16",
            "--folds", "0", "--num_workers", "4"]

    def batches(max_audio_length=None) -> int:
        return len(make_loader(
            ClipDataset(files, sr=SR, max_audio_length=max_audio_length),
            common.default_ladder(None), batch_size=64))

    runs = {"n_tta 1": (["--n_tta", "1"], 1, batches()),
            "n_tta 3 shift, noise, shuffle": (
                ["--n_tta", "3", "--tta_shift_max_s", "0.5",
                 "--tta_noise_snr_db", "20", "--tta_shuffle_p", "0.5"], 3,
                batches()),
            "n_tta 3 crops of 5 s": (
                ["--n_tta", "3", "--tta_max_audio_length", "5"], 3,
                batches(5))}
    probs = {}
    for name, (extra, passes, n_batches) in runs.items():
        out_csv = os.path.join(root, f"tta_{passes}_{len(extra)}.csv")
        kernels.mel_project_log.launches = 0
        t0 = time.time()
        predict_2d_cnn.main(base + ["--output_df", out_csv, *extra])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = kernels.mel_project_log.launches
        _, fnames, probs[name] = read_predictions(out_csv)
        log(f"TTA {name}: {len(files) / wall:.2f} clips/s ({wall:.2f} s, "
            f"{passes} pass(es) of {n_batches} batches, decode included), "
            f"K1 {launches} launches on {smi}")
        if fnames != inputs["fnames"] or launches != passes * n_batches:
            raise RuntimeError(f"TTA {name}: rows or K1 launches "
                               f"({launches})")
    # the clean pass as the CLI computed it before TTA: the ensemble over
    # the loader, rows put back by index
    predictor = predict_2d_cnn.build_predictor(
        experiment, torch.device(DEVICE), dtype=torch.bfloat16, folds=[0])
    chunks, index = [], []
    for batch in make_loader(ClipDataset(files, sr=SR),
                             common.default_ladder(None), batch_size=64,
                             num_workers=4):
        chunks.append(predictor.predict_batch(batch["signal"],
                                              batch["lengths"]).cpu().numpy())
        index.append(batch["index"])
    clean = np.zeros((len(files), chunks[0].shape[1]), np.float32)
    clean[np.concatenate(index)] = np.concatenate(chunks)
    # the CSV holds 9 significant digits of each float32
    written = np.array([[float(f"{v:.9g}") for v in row] for row in clean])
    if not np.array_equal(probs["n_tta 1"], written):
        raise RuntimeError("--n_tta 1 is not the clean pass bit for bit")
    for name, p in probs.items():
        diff = np.abs(p - probs["n_tta 1"])
        log(f"TTA {name}: probabilities in [{p.min():.4g}, {p.max():.4g}], "
            f"|difference| from --n_tta 1: mean {diff.mean():.4g} (bound "
            f"{TTA_MEAN_DIFF}), largest {diff.max():.4g}, "
            f"{100 * (diff > 0.1).mean():.2f}% of entries above 0.1")
        if p.min() < 0 or p.max() > 1 or not np.isfinite(p).all():
            raise RuntimeError(f"TTA {name}: probabilities out of [0, 1]")
        if name != "n_tta 1" and not 0 < diff.mean() < TTA_MEAN_DIFF:
            raise RuntimeError(f"TTA {name}: mean difference {diff.mean()}")


def rnn_argv(inputs: dict, experiments_dir: str, label: str,
             *extra: str, n_folds: int = 5) -> list:
    """The train CLI at the recipe's width with ``--aggregation_type rnn``
    over ``TRAIN_EPOCHS`` epochs."""
    recipe = [a if a != "max" else "rnn" for a in RECIPE]
    return ["--train_df", inputs["train_csv"],
            "--train_data_dir", inputs["train_dir"],
            "--classmap", inputs["classmap"], "--device", DEVICE, *recipe,
            "--n_folds", str(n_folds), "--epochs", str(TRAIN_EPOCHS),
            "--num_workers", "4", "--log_interval", "10", "--label", label,
            "--experiments_dir", experiments_dir, *extra]


def logged_cli(module: str, argv: list, timeout: float) -> tuple:
    """``python -m <module> argv`` as a child with ``$FSC_LAUNCH_LOG`` set:
    (its output, its kernel launches by K name, its wall seconds). A
    non-zero exit raises."""
    log_path = os.path.join(tempfile.mkdtemp(prefix="launch_log_"),
                            "launches.jsonl")
    env = dict(os.environ, FSC_LAUNCH_LOG=log_path)
    t0 = time.time()
    rc, out, _ = run_logged([sys.executable, "-m", module, *argv], env,
                            timeout)
    wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"{module} exited {rc}:\n{out[-4000:]}")
    with open(log_path) as f:
        records = [json.loads(line) for line in f]
    if len(records) != 1:
        raise RuntimeError(f"{module}: {len(records)} launch records")
    return out, {WRAPPER_KERNEL[k]: n
                 for k, n in records[0]["launches"].items() if n}, wall


def last_epoch_rate(experiment_dir: str, fold: int) -> tuple:
    """(steps, seconds) of ``fold``'s last train epoch in results.json."""
    with open(os.path.join(experiment_dir, "results.json")) as f:
        result = json.load(f)[f"fold{fold}"]
    if not np.isfinite(result["train_loss"]).all():
        raise RuntimeError(f"fold {fold}: train losses not finite")
    return result["train_steps"][-1], result["train_seconds"][-1]


# the rnn phase's stacked child: every fold of --n_folds 2 (75 train clips
# a fold, 3 steps of 20 an epoch), enough to drive the GRUs' vmap route
RNN_STACKED_FOLDS = 2


def phase_rnn(root: str, inputs: dict, smi: str) -> dict:
    """The ``rnn`` aggregation at the recipe's width: the GRU's cuDNN route
    against its step-by-step twin at the 2d model's four GRU shapes
    (float32, TF32 off; ``probes/rnn_step.route_check``), the train CLI
    with ``--aggregation_type rnn`` over 2 epochs of fold 0 of 5 and with
    ``--fold_parallel`` over both folds of ``RNN_STACKED_FOLDS`` (the
    stacked step runs the GRUs' vmap route), each a child counting K1-K3
    through ``$FSC_LAUNCH_LOG``, the two at once beside the route checks,
    then the bf16 predict CLI on the stacked run's folds, and the rnn
    train step against the max one in turns (``rnn_step.compare``).
    Returns the launches of the two train runs."""
    from freesound_classification_tpu_torch.cli import predict_2d_cnn
    from freesound_classification_tpu_torch.ops import kernels
    from freesound_classification_tpu_torch.probes import rnn_step

    experiments = os.path.join(root, "experiments")
    module = "freesound_classification_tpu_torch.cli.train_2d_cnn"
    launches = {}
    stacked = [str(k) for k in range(RNN_STACKED_FOLDS)]
    runs = {"sequential": (("--folds", "0"), 5),
            "fold-parallel": (("--folds", *stacked, "--fold_parallel"),
                              RNN_STACKED_FOLDS)}
    # the two children at once, beside the route checks (no timing there)
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        children = {
            name: pool.submit(logged_cli, module, rnn_argv(
                inputs, experiments, f"rnn_{name}", *extra,
                n_folds=n_folds), RESUME_TIMEOUT)
            for name, (extra, n_folds) in runs.items()}
        for row in rnn_step.route_check(DEVICE):
            log(f"rnn: GRU block {row['block']} {row['shape']} float32, "
                f"cuDNN route against the step-by-step one: outputs max "
                f"|d| {row['out']:.3e}, gradients {row['grad']:.3e} of each "
                f"parameter's largest (tolerance {rnn_step.ROUTE_TOL:g}); "
                f"cuDNN in bf16 against float32 {row['bf16']:.3e} of the "
                f"largest")
            if not max(row["out"], row["grad"]) <= rnn_step.ROUTE_TOL:
                raise RuntimeError("rnn: the GRU's two routes disagree")
        log(f"rnn: torch.func.vmap of the cuDNN route: "
            f"{rnn_step.vmap_of_fused(DEVICE)}")
        done = {name: child.result() for name, child in children.items()}
    for name, (_, launches[name], wall) in done.items():
        label = f"rnn_{name}"
        found = [d for d in os.listdir(experiments) if label in d]
        if len(found) != 1:
            raise RuntimeError(f"rnn: experiments {found}")
        experiment = os.path.join(experiments, found[0])
        steps, seconds = last_epoch_rate(experiment, 0)
        log(f"rnn: train CLI {name}, {wall:.2f} s as a child for "
            f"{TRAIN_EPOCHS} epochs (the two children at once, beside the "
            f"route checks); launches {launches[name]}; last epoch "
            f"{steps:g} {'stacked ' if 'parallel' in name else ''}steps in "
            f"{seconds:.3f} s = {steps / seconds:.3f} steps/s on {smi}")
        if any(launches[name].get(k, 0) <= 0 for k in ("K1", "K2", "K3")):
            raise RuntimeError(f"rnn: the train run missed a kernel: "
                               f"{launches[name]}")
    for fold in range(RNN_STACKED_FOLDS):
        fold_dir = os.path.join(experiment, "checkpoints", f"fold_{fold}")
        for name in ("best_model.npz", "final_model.npz"):
            if not os.path.isfile(os.path.join(fold_dir, name)):
                raise RuntimeError(f"rnn: fold {fold} has no {name}")

    test_csv = os.path.join(root, "rnn_test.csv")
    fnames = inputs["fnames"][:40]
    with open(test_csv, "w") as f:
        f.write("fname\n" + "".join(n + "\n" for n in fnames))
    out_csv = os.path.join(root, "rnn_preds.csv")
    kernels.mel_project_log.launches = 0
    predict_2d_cnn.main([
        "--experiment", experiment, "--test_df", test_csv,
        "--test_data_dir", inputs["train_dir"],
        "--classmap", inputs["classmap"], "--output_df", out_csv,
        "--device", DEVICE, "--bf16"])
    torch.cuda.synchronize()
    k1 = kernels.mel_project_log.launches
    header, _, probs = read_predictions(out_csv)
    if (header != ["fname", *inputs["classes"]]
            or probs.shape != (len(fnames), TRAIN_CLASSES)
            or not np.isfinite(probs).all()
            or probs.min() < 0 or probs.max() > 1 or k1 <= 0):
        raise RuntimeError(f"rnn: bad {RNN_STACKED_FOLDS}-fold predictions "
                           f"{probs.shape}, K1 {k1}")
    log(f"rnn: predict CLI, {RNN_STACKED_FOLDS} folds bf16: {probs.shape} "
        f"probabilities in "
        f"[{probs.min():.4g}, {probs.max():.4g}], K1 {k1} launches")

    steps = rnn_step.compare(DEVICE)
    for name, row in steps.items():
        shape = "5 x 20 x 15 s" if name.startswith("stacked") \
            else "B=64 x 10 s"
        log(f"rnn: {name} train step ({shape}, bf16, no augmentation) "
            f"{row['ms']:.3f} ms by events, busy {row['busy_ms']:.3f} ms, "
            f"{row['launches']:.1f} launches on {smi}")
    return launches


SSL_ARGS = ["--features", FEATURES, "--batch_size", "32",
            "--max_audio_length", "10", "--p_aug", "0.75",
            "--optimizer", "adam", "--lr", "0.001", "--folds", "0",
            "--n_folds", "5", "--epochs", "2", "--num_workers", "4",
            "--log_interval", "10"]


# the families whose float32 step is held to the step tolerances; CPC's
# float32 gradient moves by ~1.3e-2 of its largest entry between any two
# summation orders of its input BatchNorm's statistics (see ssl_f32_step),
# so CPC's float64 step is held instead and its float32 one printed
SSL_F32_HELD = ("apc",)


def ssl_f32_step(kind: str) -> None:
    """One self-supervised step of ``kind`` at its default width (no
    augmentation, TF32 off) on the card and on the CPU from the same
    weights and the same features (the card's K1 log-mel of 4 synthetic
    clips of 5 s), in float32 and in float64: loss STEP_TOL_LOSS,
    gradients STEP_TOL_GRAD of the model's largest; the float32 CPU step
    on its own features beside it.

    The float64 step is held for every family, the float32 one for those
    of ``SSL_F32_HELD``. CPC's input BatchNorm takes flax's fast variance,
    E[x^2] - E[x]^2, in float32: over log-mel features (a band's mean near
    -9, its variance near 0.15) both terms are near 80 and their
    difference cancels, so the card's sums, in another order than the
    CPU's, move the normalized input by ~6e-5 of its largest value, and
    CPC's gradient, whose sensitivity to its input is ~200 there, by
    ~1.3e-2 of its largest entry (my chip runs, PR 13; the same with the
    model in float64 and the statistics in float32). In float64 the
    statistics are float64 too."""
    import argparse

    from freesound_classification_tpu_torch.cli import ssl_common
    from freesound_classification_tpu_torch.models.blocks import loss_terms
    from freesound_classification_tpu_torch.models.frontend import Frontend

    parser = argparse.ArgumentParser()
    ssl_common.add_ssl_arguments(parser)
    args = parser.parse_args(["--train_df", "x", "--train_data_dir", "x",
                              "--classmap", "x", *SSL_ARGS])
    rng = np.random.RandomState(13)
    wave = np.stack([synthetic_clip(5 * SR, rng)
                     for _ in range(4)]).astype(np.float32)
    lengths = np.full(4, 5 * SR, np.int32)

    def features(device):
        frontend = Frontend(FEATURES, "1d", sr=SR, device=device)
        return frontend(torch.from_numpy(wave).to(device),
                        torch.from_numpy(lengths).to(device))

    def step(device, feats, dtype):
        x, fl = (t.to(device) for t in feats)
        model = ssl_common.build_ssl_model(kind, args, x.shape[-1])
        model = model.to(device=device, dtype=dtype).train()
        model.dtype = dtype  # the compute dtype the model casts inputs to
        loss = sum(loss_terms(model(x, fl)["loss_parts"]))
        loss.backward()
        return loss.item(), {n: p.grad.detach().double().cpu().numpy()
                             for n, p in model.named_parameters()}

    def worst(got, want):
        top = max(np.abs(g).max() for g in want.values())
        diffs = {n: float(np.abs(got[n] - g).max() / top)
                 for n, g in want.items()}
        name = max(diffs, key=diffs.get)
        return diffs[name], name

    card_feats = features(DEVICE)
    for dtype in (torch.float32, torch.float64):
        loss_gpu, g_gpu = step(DEVICE, card_feats, dtype)
        loss_cpu, g_cpu = step("cpu", card_feats, dtype)
        err, at = worst(g_gpu, g_cpu)
        held = dtype == torch.float64 or kind in SSL_F32_HELD
        line = (f"ssl: {kind} {str(dtype)[6:]} step, card against CPU on "
                f"the card's features (B=4 x 5 s): loss {loss_gpu:.6f} vs "
                f"{loss_cpu:.6f} (|d| {abs(loss_gpu - loss_cpu):.2e}); "
                f"gradients over the model's largest: max |d| {err:.2e} at "
                f"{at}; " + (f"held to {STEP_TOL_LOSS:g} and {STEP_TOL_GRAD:g}"
                             if held else "printed, not held"))
        if dtype == torch.float32:
            _, g_own = step("cpu", features("cpu"), dtype)
            spread, spread_at = worst(g_own, g_cpu)
            line += (f"; the CPU step on its own features moves by "
                     f"{spread:.2e} at {spread_at}")
        log(line)
        if not np.isfinite(loss_gpu) or (held and not (
                abs(loss_gpu - loss_cpu) <= STEP_TOL_LOSS
                and err <= STEP_TOL_GRAD)):
            raise RuntimeError(f"ssl: the {kind} {dtype} step disagrees")


def phase_ssl(root: str, inputs: dict, smi: str) -> dict:
    """``train_apc`` and ``train_cpc`` at their default widths over 2
    epochs of fold 0 of the labelled clips (mel_2048_1024_128, batch 32,
    10 s crops, the effects chain at 0.75) with K1-K3 counted: every fold
    file, a finite validation score, steps/s and the KNN line; then each
    family's float32 step on the card against the CPU. Returns the two
    runs' launches."""
    from freesound_classification_tpu_torch import interop
    from freesound_classification_tpu_torch.cli import train_apc, train_cpc
    from freesound_classification_tpu_torch.ops import kernels

    counted = {"K1": kernels.mel_project_log, "K2": kernels.resample_linear,
               "K3": kernels.pv_resynth}
    launches = {}
    for kind, cli in (("apc", train_apc), ("cpc", train_cpc)):
        for fn in counted.values():
            fn.launches = 0
        t0 = time.time()
        experiment = cli.main([
            "--train_df", inputs["train_csv"],
            "--train_data_dir", inputs["train_dir"],
            "--classmap", inputs["classmap"], "--device", DEVICE,
            *SSL_ARGS, "--label", kind,
            "--experiments_dir", os.path.join(root, "experiments")])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches[kind] = {k: fn.launches for k, fn in counted.items()}
        with open(os.path.join(experiment.experiment_dir,
                               "results.json")) as f:
            fold = json.load(f)["fold0"]
        fold_dir = os.path.join(experiment.experiment_dir, "checkpoints",
                                "fold_0")
        for name in ("best_model", "final_model", "model_on_epoch_0",
                     "model_on_epoch_1"):
            params, _ = interop.load_fold_npz(
                os.path.join(fold_dir, f"{name}.npz"))
            if interop.model_kind_of(params) != kind:
                raise RuntimeError(f"ssl: {kind} {name} holds "
                                   f"{interop.model_kind_of(params)}")
        steps, seconds = last_epoch_rate(experiment.experiment_dir, 0)
        log(f"ssl: train_{kind}, {wall:.2f} s for 2 epochs of fold 0; "
            f"launches {launches[kind]}; validation score (-loss) "
            f"{fold['metric']:.4f}; train losses {fold['train_loss']}; last "
            f"epoch {steps:g} steps in {seconds:.3f} s = "
            f"{steps / seconds:.3f} steps/s (batch 32, 10 s, augmentation "
            f"included); KNN accuracy {fold.get('knn_accuracy')} on {smi}")
        if not np.isfinite(fold["metric"]) or min(
                launches[kind].values()) <= 0:
            raise RuntimeError(f"ssl: {kind}: score {fold['metric']}, "
                               f"launches {launches[kind]}")
        if "knn_accuracy" not in fold:
            raise RuntimeError(f"ssl: {kind}: no projection summary")
    for kind in ("apc", "cpc"):
        ssl_f32_step(kind)
    return launches


def phase_adversarial(root: str, train_inputs: dict, inputs: dict,
                      smi: str) -> int:
    """``adversarial_test`` over the labelled clips (train) and the
    predict path's clips (test), 2 epochs, mel_2048_1024_128, the 80-class
    map, with K1 counted: an AUC in [0, 1] printed each epoch and a
    per-class table of 80 rows. Returns K1's launches."""
    import contextlib
    import io

    from freesound_classification_tpu_torch.cli import adversarial_test
    from freesound_classification_tpu_torch.ops import kernels

    # the labelled clips' classes named as in the 80-class map
    train_csv = os.path.join(root, "adversarial_train.csv")
    with open(train_inputs["train_csv"]) as f:
        rows = list(csv.reader(f))[1:]
    with open(train_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["fname", "labels"])
        for fname, labels in rows:
            writer.writerow([fname, ",".join(
                f"class_{int(c.split('_')[1]):02d}"
                for c in labels.split(","))])
    kernels.mel_project_log.launches = 0
    printed = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(printed):
        out = adversarial_test.main([
            "--train_df", train_csv,
            "--train_data_dir", train_inputs["train_dir"],
            "--test_df", inputs["test_csv"],
            "--test_data_dir", inputs["test_dir"],
            "--classmap", inputs["classmap"], "--features", FEATURES,
            "--epochs", "2", "--device", DEVICE, "--num_workers", "4",
            "--plots_dir", os.path.join(root, "plots")])
    torch.cuda.synchronize()
    wall = time.time() - t0
    k1 = kernels.mel_project_log.launches
    text = printed.getvalue()
    aucs = [float(line.split("AUC: ")[1]) for line in text.splitlines()
            if "AUC: " in line]
    table = [line for line in text.splitlines()
             if line.startswith("class_")]
    log(f"adversarial: {wall:.2f} s for 2 epochs over {len(rows)} train and "
        f"{len(inputs['fnames'])} test clips; AUC by epoch {aucs}; "
        f"{len(table)} table rows; K1 {k1} launches on {smi}")
    if (len(aucs) != 2 or not all(0.0 <= a <= 1.0 for a in aucs)
            or aucs != out["auc"] or len(table) != N_CLASSES or k1 <= 0):
        raise RuntimeError("adversarial: bad AUCs, table or launches")
    return k1


def phase_evaluate(root: str, smi: str) -> None:
    """``evaluate_2d_cnn`` on the recipe phase's curated experiment (5
    folds, float32, the kit's batch): its overall OOF lwlrap within one
    rank swap (1 / the labels' count, twice the most one swap of near-equal
    scores can move it) of the experiment's ``results.json`` metric,
    computed by the train CLI from its own OOF predictions of the same
    weights (bucket-invariant to 1e-5 on logits,
    ``test_logits_do_not_depend_on_the_bucket``, the only room for the two
    to differ); then ``--n_tta 2 --tta_shift_max_s 0.5``."""
    from freesound_classification_tpu_torch.cli import evaluate_2d_cnn
    from freesound_classification_tpu_torch.data.dataset import (
        read_csv_columns,
    )
    from freesound_classification_tpu_torch.ops import kernels

    work = os.path.join(root, "recipe_work")
    data = os.path.join(root, "fsd")
    exp_root = os.path.join(work, "experiments")
    curated = None
    for name in os.listdir(exp_root):
        with open(os.path.join(exp_root, name, "config.json")) as f:
            if json.load(f)["label"] == "parity_2d_cnn":
                curated = os.path.join(exp_root, name)
    with open(os.path.join(curated, "results.json")) as f:
        metric = json.load(f)["metric"]
    _, labels = read_csv_columns(os.path.join(data, "train_curated.csv"),
                                 ["fname", "labels"])
    tol = 1.0 / sum(len(cell.split(",")) for cell in labels)
    argv = ["--experiment", curated,
            "--train_df", os.path.join(data, "train_curated.csv"),
            "--train_data_dir", os.path.join(data, "train_curated"),
            "--classmap", os.path.join(work, "classmap.json"),
            "--batch_size", str(RECIPE_BATCH), "--num_workers", "4",
            "--device", DEVICE]
    kernels.mel_project_log.launches = 0
    t0 = time.time()
    got = evaluate_2d_cnn.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = kernels.mel_project_log.launches
    t0 = time.time()
    tta = evaluate_2d_cnn.main(argv + ["--n_tta", "2",
                                       "--tta_shift_max_s", "0.5"])
    torch.cuda.synchronize()
    tta_wall = time.time() - t0
    log(f"evaluate_2d_cnn: overall OOF lwlrap {got['overall']!r} against "
        f"results.json {metric!r} (|difference| "
        f"{abs(got['overall'] - metric):.3e}, tolerance {tol:.3e}); folds "
        f"{[round(m, 6) for m in got['folds']]}; {wall:.2f} s, K1 "
        f"{launches} launches; --n_tta 2 --tta_shift_max_s 0.5: "
        f"{tta['overall']!r} in {tta_wall:.2f} s on {smi}")
    if launches <= 0:
        raise RuntimeError("evaluate_2d_cnn launched no K1")
    if not abs(got["overall"] - metric) <= tol:
        raise RuntimeError("evaluate_2d_cnn disagrees with results.json")
    if not 0.0 <= tta["overall"] <= 1.0:
        raise RuntimeError(f"TTA evaluate lwlrap {tta['overall']}")


def phase_probe(smi: str) -> int:
    """The probe's two programs at the bench shape (64 clip-like waves x
    10 s, the bench's 5 random bf16 folds): V1 (log-mel frontend, K1) and
    V3 (fast featurization, K9) once each with the counts reset just
    before, K1 and K9 launched once each where they belong, V3 within
    ``PROBE_TOL`` of V1 while neighbouring clips differ by more than twice
    that; then ms per call in turns. Returns K9's launches."""
    from freesound_classification_tpu_torch import bench
    from freesound_classification_tpu_torch.ops import kernels
    from freesound_classification_tpu_torch.probes import dft_context

    preds = dft_context.predictors(
        bench.fold_models(bench.random_fold_variables()), DEVICE)
    rng = np.random.RandomState(13)
    length = 10 * SR
    wave = torch.from_numpy(np.stack([
        synthetic_clip(length, rng) for _ in range(K9_CLIPS)]).astype(
        np.float32)).to(DEVICE)
    lengths = torch.full((K9_CLIPS,), length, dtype=torch.int32,
                         device=DEVICE)
    counted = {"K1": kernels.mel_project_log, "K9": kernels.mel_log_split}
    probs, launches = {}, {}
    for name in ("V1", "V3"):
        for fn in counted.values():
            fn.launches = 0
        probs[name] = preds[name].predict_batch(wave, lengths)
        torch.cuda.synchronize()
        launches[name] = {k: fn.launches for k, fn in counted.items()}
    diff, corr = dft_context.compare(probs["V1"], probs["V3"])
    p1 = probs["V1"]
    swapped = (p1 - torch.roll(p1, 1, dims=0)).abs().max().item()
    log(f"probe (B={K9_CLIPS} x 10 s, 5-fold bf16): launches {launches}; "
        f"V3 against V1 max |dp| {diff:.3e} (tolerance {PROBE_TOL:g}), corr "
        f"{corr:.6f}; V1 probabilities in [{p1.min().item():.4g}, "
        f"{p1.max().item():.4g}], neighbouring clips {swapped:.4g} apart")
    if launches != {"V1": {"K1": 1, "K9": 0}, "V3": {"K1": 0, "K9": 1}}:
        raise RuntimeError(f"the probe's programs missed a kernel: "
                           f"{launches}")
    for p in probs.values():
        if (p.shape != (K9_CLIPS, N_CLASSES) or not torch.isfinite(p).all()
                or p.min() < 0 or p.max() > 1):
            raise RuntimeError(f"bad probe probabilities {tuple(p.shape)}")
    if not diff <= PROBE_TOL:
        raise RuntimeError(f"V3 disagrees with V1: {diff}")
    if not swapped > 2 * PROBE_TOL:
        raise RuntimeError(f"probe probabilities barely depend on the clip "
                           f"({swapped:.3g})")
    times = dft_context.ms_per_call(preds, wave, lengths)
    log("probe ms per 5-fold call (CUDA events, runs in turns): "
        + ", ".join(f"{k} {np.mean(v):.3f} (runs {v})"
                    for k, v in times.items()) + f" on {smi}")
    return launches["V3"]["K9"]


def phase_bench(smi: str) -> dict:
    """``python -m freesound_classification_tpu_torch.bench`` as its user
    runs it: its last line parses, every key is finite and positive, and its
    ``# kernel launches`` line shows K1 in each workload and K2 and K3 in
    the augmented step. Returns the record."""
    torch.cuda.empty_cache()  # leave the card's memory to the bench
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "freesound_classification_tpu_torch.bench"],
        capture_output=True, text=True, timeout=BENCH_TIMEOUT,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.time() - t0
    lines = proc.stdout.strip().splitlines()
    log("bench output:\n  " + "\n  ".join(lines[-6:]))
    if proc.returncode != 0:
        raise RuntimeError(f"the bench failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    record = json.loads(lines[-1])
    bad = [k for k in BENCH_KEYS
           if not (isinstance(record.get(k), (int, float))
                   and np.isfinite(record[k]) and record[k] > 0)]
    if bad or record.get("metric") != \
            "5fold_melcnn_inference_clips_per_sec_per_chip":
        raise RuntimeError(f"bench record lacks {bad}: {record}")
    prefix = "# kernel launches "
    launches = json.loads([ln for ln in lines
                           if ln.startswith(prefix)][-1][len(prefix):])
    if not (min(w["K1"] for w in launches.values()) > 0
            and min(launches["train_aug"][k] for k in ("K2", "K3")) > 0):
        raise RuntimeError(f"the bench missed a kernel: {launches}")
    log(f"bench: {wall:.1f} s as a subprocess; launches {launches} on {smi}")
    return record


F32_NET = dict(num_conv_blocks=5, start_deep_supervision_on=1,
               conv_base_depth=100, growth_rate=1.5)


def f32_step_batch(rng: np.random.RandomState, b: int = 6,
                   seconds: int = 5) -> tuple:
    """The float32 step's batch: ``b`` synthetic clips of ``seconds``, the
    odd rows a quarter shorter (zero past their lengths), and labels of
    ``TRAIN_CLASSES`` at 0.3 with class 0 always on; numpy."""
    length = seconds * SR
    wave = np.stack([synthetic_clip(length, rng)
                     for _ in range(b)]).astype(np.float32)
    lengths = np.full(b, length, np.int32)
    lengths[1::2] = length * 3 // 4
    wave[np.arange(length)[None] >= lengths[:, None]] = 0.0
    labels = (rng.rand(b, TRAIN_CLASSES) < 0.3).astype(np.float32)
    labels[:, 0] = 1.0
    return wave, lengths, labels


def phase_f32_step() -> None:
    """One float32 train step at the recipe's width (dropout 0, no
    augmentation, TF32 off) on the card and on the CPU from the same
    weights and batch: K1 on the card, its twin on the CPU.

    Each gradient is divided by the largest gradient of the whole model,
    not by its own tensor's: the max-pools and PReLUs select among near
    ties, so a float32 difference in the features flips some selections,
    and a tensor whose gradient is a small, cancelling sum (a bias ahead of
    a train-mode BatchNorm) then moves by percents of its own size. The
    phase prints that effect on the CPU alone: its step fed the card's
    features against its step fed its own.
    """
    from freesound_classification_tpu_torch import interop
    from freesound_classification_tpu_torch.models.classifiers import (
        TwoDimensionalCNN,
    )
    from freesound_classification_tpu_torch.models.frontend import Frontend
    from freesound_classification_tpu_torch.ops import losses

    params, stats = interop.random_jax_variables(
        **F32_NET, n_classes=TRAIN_CLASSES, seed=11)
    rng = np.random.RandomState(12)
    wave, lengths, labels = f32_step_batch(rng)
    b = len(wave)

    def features(device):
        frontend = Frontend(FEATURES, "2d", sr=SR, device=device)
        return frontend(torch.from_numpy(wave).to(device),
                        torch.from_numpy(lengths).to(device))

    def step(device, x, fl):
        model = TwoDimensionalCNN(**F32_NET, aggregation_type="max",
                                  n_classes=TRAIN_CLASSES)
        model.load_state_dict(interop.from_jax_variables(params, stats))
        model = model.to(device).train()
        loss = losses.lsep_loss(model(x.to(device), fl.to(device)),
                                torch.from_numpy(labels).to(device))
        loss.backward()
        return loss.item(), {k: p.grad.detach().cpu().numpy()
                             for k, p in model.named_parameters()}

    def worst(got, want, per_tensor):
        """(largest |d|, its tensor): each tensor's difference over the
        model's largest gradient, or over its own (skipping tensors below
        1e-4 of the model's largest: zero up to rounding)."""
        top = max(np.abs(g).max() for g in want.values())
        diffs = {}
        for name, g in want.items():
            scale = np.abs(g).max() if per_tensor else top
            if scale >= 1e-4 * top:
                diffs[name] = float(np.abs(got[name] - g).max() / scale)
        name = max(diffs, key=diffs.get)
        return diffs[name], name

    x_gpu, fl_gpu = features(DEVICE)
    x_cpu, fl_cpu = features("cpu")
    loss_gpu, g_gpu = step(DEVICE, x_gpu, fl_gpu)
    loss_cpu, g_cpu = step("cpu", x_cpu, fl_cpu)
    if not (np.isfinite(loss_gpu) and all(np.isfinite(g).all()
                                          for g in g_gpu.values())):
        raise RuntimeError("float32 step: card loss or gradients not finite")
    err, err_name = worst(g_gpu, g_cpu, per_tensor=False)
    own, own_name = worst(g_gpu, g_cpu, per_tensor=True)
    _, g_flip = step("cpu", x_gpu.cpu(), fl_gpu.cpu())
    flip, flip_name = worst(g_flip, g_cpu, per_tensor=True)
    log(f"float32 step, card against CPU (B={b} x 5 s, recipe width): "
        f"loss {loss_gpu:.6f} vs {loss_cpu:.6f} (|d| "
        f"{abs(loss_gpu - loss_cpu):.2e}, tolerance {STEP_TOL_LOSS:g}); "
        f"gradients over the model's largest: max |d| {err:.2e} at "
        f"{err_name} (tolerance {STEP_TOL_GRAD:g}); over each tensor's own "
        f"largest: {own:.2e} at {own_name}, where the CPU's step fed the "
        f"card's features (max |d| "
        f"{(x_gpu.cpu() - x_cpu).abs().max().item():.2e}) moves by "
        f"{flip:.2e} at {flip_name}")
    if not abs(loss_gpu - loss_cpu) <= STEP_TOL_LOSS:
        raise RuntimeError("float32 step: the losses disagree")
    if not err <= STEP_TOL_GRAD:
        raise RuntimeError("float32 step: the gradients disagree")


def timed(name: str, fn, *args):
    """``fn(*args)``, with a line of the seconds it took."""
    t0 = time.time()
    out = fn(*args)
    log(f"phase {name}: {time.time() - t0:.1f} s")
    return out


def main() -> None:
    from freesound_classification_tpu_torch.ops import kernels

    t_start = time.time()
    smi = phase_device()
    bytecode_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        # the host renders the WAVs on a thread while the build waits on
        # its slowest nvcc; the card's work all stays on this thread
        def write_all() -> tuple:
            t0 = time.time()
            return (write_inputs(root), write_train_inputs(root),
                    time.time() - t0)

        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            written = pool.submit(write_all)
            timed("build", phase_build)
            inputs, train_inputs, write_s = written.result()
        secs = float(synthetic_clip_lengths(N_CLIPS).sum()) / SR
        log(f"inputs: {N_CLIPS} test clips, {secs:.1f} s of audio, "
            f"{N_FOLDS} folds of each family; {N_TRAIN_CLIPS} labelled "
            f"clips of 8.5-15 s ({write_s:.1f} s to write, beside the "
            f"build)")
        k1 = timed("K1", phase_k1)
        k2 = timed("K2", phase_k2)
        k3 = timed("K3", phase_k3)
        k6 = timed("K6", phase_k6)
        k45 = timed("K4/K5", phase_k45)
        k7 = timed("K7", phase_k7)
        k8 = timed("K8", phase_k8)
        k9 = timed("K9", phase_k9)
        timed("no sync", phase_no_sync)
        timed("domain", phase_domain)
        timed("step split", phase_step_split, smi)
        timed("ablation", phase_ablation, smi)
        k1["launches"], probs_2d = timed("main path", phase_main_path, root,
                                         inputs, smi)
        timed("mesh predict", phase_mesh_predict, root, inputs,
              k1["launches"], probs_2d, smi)
        compat = timed("compat", phase_compat, root, smi)
        host = decoded_batches(inputs)
        k45["launches"] = timed(
            "2d fused", fused_ensemble, "2d", "2d_cnn", inputs["experiment"],
            probs_2d, host, kernels.resnet_block_2d_fused, smi)
        k8["launches"] = timed(
            "2d head fused", lambda: fused_ensemble(
                "2d head", "2d_cnn", inputs["experiment"], probs_2d, host,
                kernels.conv_head_fused, smi, per_model=1,
                option="fused_head"))
        k6["launches"] = timed("hierarchical predict", phase_hier_predict,
                               root, inputs, host, smi)
        k7["launches"] = timed("backbone predict", phase_backbone_predict,
                               root, inputs, host, smi)
        train, train_experiment = timed("train", phase_train, root,
                                        train_inputs, smi)
        train_files = experiment_files(train_experiment)
        timed("tta", phase_tta, root, train_inputs, train_experiment, smi)
        timed("resume", phase_resume, root, train_inputs, smi)
        timed("fold parallel", phase_fold_parallel, root, train_inputs, smi)
        timed("data parallel", phase_data_parallel, root, train_inputs,
              train_files, train_experiment, smi)
        timed("fold mesh", phase_fold_mesh, root, train_inputs, smi)
        timed("profile", phase_profile, root, train_inputs, smi)
        pretrained, _ = timed("hierarchical train", phase_hier_train, root,
                              train_inputs, smi)
        timed("hierarchical finetune", phase_hier_finetune, root,
              train_inputs, pretrained, smi)
        timed("backbone train", phase_backbone_train, root, train_inputs,
              smi)
        timed("recipe", phase_recipe, root, train_inputs, smi)
        timed("evaluate", phase_evaluate, root, smi)
        rnn = timed("rnn", phase_rnn, root, train_inputs, smi)
        ssl = timed("ssl", phase_ssl, root, train_inputs, smi)
        adversarial_k1 = timed("adversarial", phase_adversarial, root,
                               train_inputs, inputs, smi)
        log(f"new paths' launches: rnn {rnn}, ssl {ssl}, adversarial K1 "
            f"{adversarial_k1}, compat {compat}")
    k2["launches"], k3["launches"] = train["K2"], train["K3"]
    k9["launches"] = timed("probe", phase_probe, smi)
    timed("bench", phase_bench, smi)
    timed("float32 step", phase_f32_step)
    log(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": [k1, k2, k3, k45, k6, k7, k8, k9]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
