"""Run the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

The main path is 5-fold inference of the reference-scale 2d mel CNN (6 blocks,
base depth 64, growth 1.5, max aggregation, deep supervision from block 2, 80
classes) through the port's predict CLI, in bf16, on ~200 synthetic clips
with the bench's length distribution (1-15 s at 44.1 kHz). The fold weights
are random, made from a seed in the JAX package's layout, and reach the port
through ``interop`` as a JAX-trained fold would.

Phases, each of which raises on failure (none catches its own):
  1. device: a CUDA card is required; prints nvidia-smi's name and power limit
  2. build: compiles the port's CUDA sources, prints the seconds
  3. K1: the mel kernel against its plain twin at B=128 x 10 s,
     mel_2048_1024_128, float32: max abs error and CUDA-event times
  4. main path: the predict CLI with launch counts reset just before it; the
     CSV's schema and values; K1 launched; the predictions vary across clips
     by more than the bf16 tolerance, and the same ensemble through K1's
     plain twin agrees with them; on every batch of the run, K1's log-mel and
     the float32 ensemble's probabilities agree with the twin's; clips/s
Then one JSON line of the kernels, and last the device line. Exits non-zero
with no result when CUDA is not available.

Precision: the plain twin's float32 matmul and convolutions run in full
float32 (TF32 is switched off below), so the comparisons measure the kernel.
"""

from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

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
ENSEMBLE_BF16_TOL = 2e-2  # probabilities, bf16 model: inputs round to bf16
ENSEMBLE_F32_TOL = 1e-4  # probabilities, f32 model, every batch
DEVICE = "cuda"  # one card: the first


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events, after
    three warm-up calls."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    got = kernels.mel_project_log(spec, fb)
    want = kernels.mel_project_log_reference(spec, fb)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"K1: bad output {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    log(f"K1 {tuple(spec.shape)} -> {tuple(got.shape)}: max_abs_err {err:.3e}"
        f" (tolerance {K1_TOL:g})")
    if not err <= K1_TOL:
        raise RuntimeError(f"K1 disagrees with its plain twin: {err}")
    times = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        fn = (kernels.mel_project_log if name == "kernel"
              else kernels.mel_project_log_reference)
        times[name].append(cuda_ms(lambda: fn(spec, fb)))
    ms, plain_ms = (float(np.mean(times[k])) for k in ("kernel", "plain"))
    log(f"K1 time: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms "
        f"(runs {times})")
    return {"name": "mel_log_kernel", "route": "cuda",
            "source": "freesound_classification_tpu_torch/csrc/mel_log.cu",
            "replaces": "freesound_classification_tpu/ops/pallas_kernels.py:40",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def synthetic_clip_lengths(n: int, seed: int = 0) -> np.ndarray:
    """The bench's test length distribution: lognormal, clipped to 1-15 s."""
    rng = np.random.RandomState(seed)
    secs = np.clip(rng.lognormal(mean=1.45, sigma=0.6, size=n), 1.0, 15.0)
    return (secs * SR).astype(np.int64)


def synthetic_clip(n: int, rng: np.random.RandomState) -> np.ndarray:
    """One clip whose log-mel image differs from its neighbours': noise with
    a random spectral tilt plus three tones, at a level drawn over 50 dB, so
    the random-weight model's outputs vary across clips."""
    spectrum = np.fft.rfft(rng.randn(n))
    spectrum *= np.arange(1, spectrum.size + 1) ** -rng.uniform(0.0, 1.5)
    noise = np.fft.irfft(spectrum, n)
    t = np.arange(n) / SR
    tones = sum(rng.uniform(0.0, 2.0)
                * np.sin(2 * np.pi * rng.uniform(60.0, 12000.0) * t)
                for _ in range(3))
    audio = noise / noise.std() + tones
    return audio * (10.0 ** rng.uniform(-3.0, -0.5) / np.abs(audio).max())


def write_wav(path: str, audio: np.ndarray) -> None:
    """Mono 16-bit PCM at ``SR``."""
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(audio, -1.0, 1.0) * 32767.0)
                      .astype("<i2").tobytes())


def write_inputs(root: str) -> dict:
    """WAVs, test CSV, class map and a 5-fold experiment dir under ``root``."""
    from freesound_classification_tpu_torch import interop

    rng = np.random.RandomState(1)
    test_dir = os.path.join(root, "test")
    os.makedirs(test_dir)
    fnames = []
    for i, n in enumerate(synthetic_clip_lengths(N_CLIPS)):
        fname = f"clip{i:03d}.wav"
        write_wav(os.path.join(test_dir, fname), synthetic_clip(n, rng))
        fnames.append(fname)
    test_csv = os.path.join(root, "test.csv")
    with open(test_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["fname"])
        writer.writerows([name] for name in fnames)
    classes = [f"class_{c:02d}" for c in range(N_CLASSES)]
    classmap = os.path.join(root, "classmap.json")
    with open(classmap, "w") as f:
        json.dump({c: i for i, c in enumerate(classes)}, f)

    exp = os.path.join(root, "experiment")
    config = {"network": NETWORK,
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
            **network, n_classes=N_CLASSES, seed=100 + k)
        interop.save_fold_npz(os.path.join(fold_dir, "best_model.npz"),
                              params, stats)
    with open(os.path.join(exp, "config.json"), "w") as f:
        json.dump(config, f)
    return {"test_dir": test_dir, "test_csv": test_csv, "classmap": classmap,
            "experiment": exp, "fnames": fnames, "classes": classes}


def read_predictions(path: str):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], \
        np.array([[float(v) for v in r[1:]] for r in rows[1:]])


def phase_main_path(root: str, smi: str) -> int:
    from freesound_classification_tpu_torch.cli import common, predict_2d_cnn
    from freesound_classification_tpu_torch.data.dataset import ClipDataset
    from freesound_classification_tpu_torch.data.loader import make_loader
    from freesound_classification_tpu_torch.ops import kernels

    t0 = time.time()
    inputs = write_inputs(root)
    secs = float(synthetic_clip_lengths(N_CLIPS).sum()) / SR
    log(f"inputs: {N_CLIPS} clips, {secs:.1f} s of audio, {N_FOLDS} folds "
        f"({time.time() - t0:.1f} s to write)")
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
    loader = make_loader(
        ClipDataset([os.path.join(inputs["test_dir"], f)
                     for f in inputs["fnames"]], sr=SR),
        common.default_ladder(None), max_batch_elems=MAX_BATCH_ELEMS,
        num_workers=4)
    t0 = time.time()
    host = list(loader)
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
    return launches


def main() -> None:
    smi = phase_device()
    phase_build()
    k1 = phase_k1()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        k1["launches"] = phase_main_path(root, smi)
    log(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
