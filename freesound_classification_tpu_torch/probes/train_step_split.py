"""The bench's augmented train step and its 5-fold inference, split into
stages, each timed alone on the card: the counterpart of
``profile_train_step.py``.

    python -m freesound_classification_tpu_torch.probes.train_step_split

The train program is the bench's (``bench.train_engine`` and
``bench.train_batch``): B = 64 clips x 10 s, the reference-scale 2d CNN in
bf16, Adam, and the augmenter at p_shuffle 0.5, p_mixup 0.5, p_aug 0.75.
The stage inputs come from one run of the chain with draws fixed from one
generator (the effects chain on its round(0.75 x 64) = 48 rows):

    chunk shuffle, MixUp-OR, reverb (``freeverb.reverb_batch``), PV analysis
    (``pv.analysis``), K3 (``kernels.pv_resynth``), overdrive with its IIR
    (``dsp.iir_first_order``), K2 (``augment.resample_rate``), the whole
    chain, the whole augmenter, the frontend (K1), the train-mode forward,
    forward plus backward, the optimizer step, and the whole step with and
    without augmentation.

The inference split is the bench's program (``bench.inference_predictor``
over its 5 random bf16 folds) on one batch of its largest shape, 128 clips
x 10 s: the host-to-device copy of the waves, the featurization (K1), each
fold's forward, the sigmoid-mean, and the whole ``predict_batch``.

Each stage: ms per call by CUDA events (``kernel_turns.cuda_ms``), and the
card's busy ms and kernel launches per call by ``torch.profiler``
(``kernel_turns.device_kernels``). Busy against events is the share of the
stage's time the card works; the rest is the host's. The first line is the
card's name and power limit; then one line a stage, and last one JSON line
of both tables.

``train_stages`` and ``inference_stages`` build the stage functions on any
device (the CPU tests call them small); ``split`` times them on the card.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from freesound_classification_tpu_torch import bench
from freesound_classification_tpu_torch.ops import (
    augment,
    freeverb,
    kernels,
    pv,
)
from freesound_classification_tpu_torch.probes.kernel_turns import (
    cuda_ms,
    device_kernels,
)

SR = 44100
INFER_BATCH = 128  # the bench's 10 s bucket: 128 x 10 s of samples a batch


def train_stages(device, network: dict = bench.NETWORK, batch: int = 64,
                 seconds: float = 10, seed: int = 0) -> list:
    """[(stage, fn)] of the bench's augmented train step on ``device``."""
    device = torch.device(device)
    engine = bench.train_engine(device, network, True, 1000)
    wave, lengths, labels = bench.train_batch(device, batch, seconds)
    b, length = wave.shape
    gen = torch.Generator(device=device).manual_seed(seed)
    shuffle = augment.draw_shuffle_chunks(gen, b, length, 0.5)
    mixup = augment.draw_mixup(gen, b, b, 0.5)
    effects = augment.draw_effects(gen, b, 0.75)

    # the chain's intermediate values, from one run on the drawn rows
    rows = effects.rows
    x, x_len = wave[rows], lengths[rows]
    reverberance, room = effects.reverberance[rows], effects.room[rows]
    pitch = torch.exp2(effects.cents[rows] / 1200.0)
    gain, speed = effects.gain[rows], effects.speed[rows]
    n_fft = min(1024, max(256, length // 8))
    hop = n_fft // 4
    t_out = (length + n_fft // 2) // hop + 2
    rev, rev_len = freeverb.reverb_batch(x, x_len, reverberance, room, SR)
    mag, dphi, phase0 = pv.analysis(rev, n_fft, hop)
    icos, isin = pv._bases(n_fft, device)
    rate = (1.0 / pitch).float().contiguous()
    stretched, pv_len = pv.phase_vocoder_stretch(rev, rev_len, 1.0 / pitch,
                                                 n_fft=n_fft, hop=hop)
    driven = augment.overdrive(stretched, gain)

    model = engine.model
    with torch.no_grad():
        inputs, frame_lengths = engine.frontend(wave, lengths)

    def forward_backward():
        model.train()
        loss = engine.loss_fn(model(inputs, frame_lengths), labels,
                              average=False).mean()
        engine.optimizer.zero_grad(set_to_none=True)
        loss.backward()

    forward_backward()  # the optimizer stage steps on these gradients

    @torch.no_grad()
    def forward_train():
        model.train()
        return model(inputs, frame_lengths)

    def augmenter():
        g = torch.Generator(device=device).manual_seed(seed + 1)
        return engine.augment(wave, lengths, labels, g, 1.0)

    no_grad = torch.no_grad()
    return [
        ("chunk shuffle", no_grad(lambda: augment.apply_shuffle_chunks(
            wave, lengths, shuffle))),
        ("MixUp-OR", no_grad(lambda: augment.apply_mixup_or(
            wave, lengths, labels, mixup))),
        ("reverb", no_grad(lambda: freeverb.reverb_batch(
            x, x_len, reverberance, room, SR))),
        ("PV analysis", no_grad(lambda: pv.analysis(rev, n_fft, hop))),
        ("K3 pv_resynth", no_grad(lambda: kernels.pv_resynth(
            mag, dphi, phase0, rate, icos, isin, hop, t_out))),
        ("overdrive + IIR", no_grad(lambda: augment.overdrive(
            stretched, gain))),
        ("K2 resample_rate", no_grad(lambda: augment.resample_rate(
            driven, pv_len, speed * pitch))),
        ("effects chain", no_grad(lambda: augment.apply_effects(
            wave, lengths, effects))),
        ("augmenter", no_grad(augmenter)),
        ("frontend (K1)", no_grad(lambda: engine.frontend(wave, lengths))),
        ("forward, train mode", forward_train),
        ("forward + backward", forward_backward),
        ("optimizer step", engine.optimizer.step),
        ("step, augmented", lambda: engine.train_step(wave, lengths,
                                                      labels)),
        ("step, no augmentation", lambda: engine.train_step(
            wave, lengths, labels, aug_scale=0.0)),
    ]


def inference_stages(device, network: dict = bench.NETWORK,
                     n_folds: int = bench.N_FOLDS,
                     batch: int = INFER_BATCH, seconds: float = 10) -> list:
    """[(stage, fn)] of the bench's 5-fold inference on one batch."""
    device = torch.device(device)
    predictor = bench.inference_predictor(bench.fold_models(
        bench.random_fold_variables(n_folds, network), network), device)
    rng = np.random.RandomState(1)
    length = int(SR * seconds)
    host = (rng.randn(batch, length).astype(np.float32) * 0.1,
            np.full(batch, length, np.int32))
    wave, lengths = (torch.from_numpy(a).to(device) for a in host)
    with torch.inference_mode():
        inputs, frame_lengths = predictor.frontend(wave, lengths)
        logits = [m(inputs, frame_lengths) for m in predictor.models]

    inference = torch.inference_mode()
    stages = [
        ("host-to-device copy", lambda: [torch.from_numpy(a).to(device)
                                         for a in host]),
        ("featurization (K1)", inference(
            lambda: predictor.frontend(wave, lengths))),
    ]
    stages += [(f"fold {k} forward", inference(
        lambda m=m: m(inputs, frame_lengths)))
        for k, m in enumerate(predictor.models)]
    stages += [
        ("sigmoid-mean", inference(lambda: torch.stack(
            [torch.sigmoid(v) for v in logits]).mean(dim=0))),
        ("predict_batch", lambda: predictor.predict_batch(wave, lengths)),
    ]
    return stages


def split(stages: list, iters: int = 5, calls: int = 3) -> list:
    """Per stage: {"stage", "ms" (CUDA events), "busy_ms" and "launches"
    (torch.profiler), each per call}."""
    rows = []
    for name, fn in stages:
        ms = cuda_ms(fn, iters=iters)
        found = device_kernels(fn, calls=calls)
        rows.append({"stage": name, "ms": ms,
                     "busy_ms": sum(t for _, t, _ in found),
                     "launches": sum(n for _, _, n in found)})
    return rows


def table(rows: list) -> str:
    """One line a stage: events, busy, busy share and launches."""
    return "\n".join(
        f"  {r['stage']:24s} {r['ms']:9.3f} ms  busy {r['busy_ms']:9.3f} ms"
        f" ({r['busy_ms'] / r['ms']:.3f})  {r['launches']:7.1f} launches"
        for r in rows)


def main() -> None:
    device = torch.device("cuda")
    print(bench.device_line(device), flush=True)
    out = {}
    for key, stages in (("train", train_stages),
                        ("inference", inference_stages)):
        out[key] = split(stages(device))
        print(f"{key} stages (ms per call by CUDA events, busy ms and "
              f"launches per call by torch.profiler):\n"
              + table(out[key]), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
