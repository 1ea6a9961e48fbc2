"""Featurization and model-forward ablation on the card: the counterpart of
``profile_model.py``.

    python -m freesound_classification_tpu_torch.probes.model_ablation

At the bench's shape (B = 64 clips x 10 s, ``mel_2048_1024_128``), ms per
call by CUDA events (``kernel_turns.cuda_ms``) of:

- featurization: the log-mel frontend with K1, the same with K1's plain
  tail (``kernels.mel_project_log_reference``), and ``torch.stft`` alone;
- the bf16 eval forward of the reference-scale 2d CNN (base depth 64,
  growth 1.5, max aggregation) at depths 1-6 (deep supervision from
  min(2, depth - 1));
- at depth 6: the train-mode forward (BatchNorm on batch statistics,
  dropout, no gradient) against the eval one, float32 against bf16, and
  the fused eval blocks (``fused_infer``: K4/K5) against the unfused;
- at depth 6 with the ``rnn`` aggregation (a bidirectional GRU of 128
  after each supervised block, cuDNN's through ``torch._VF.gru``): the
  eval and the train-mode forward.

``profile_model.py``'s block-DFT precision variants have no counterpart:
they are a TPU lowering (the port featurizes through ``torch.stft``).

``variants`` builds the functions on any device (the CPU tests call it
small); ``main`` times them on the card. The first line is the card's name
and power limit, then one line a variant, and last one JSON line.
"""

from __future__ import annotations

import json
import types

import torch

from freesound_classification_tpu_torch import bench
from freesound_classification_tpu_torch.models.classifiers import (
    build_classifier,
)
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops import dsp, kernels
from freesound_classification_tpu_torch.probes.kernel_turns import cuda_ms
from freesound_classification_tpu_torch.training.state import create_model

FEATURES = bench.FEATURES
DEPTHS = (1, 2, 3, 4, 5, 6)


def _network(depth: int, network: dict) -> types.SimpleNamespace:
    return types.SimpleNamespace(**dict(
        network, num_conv_blocks=depth,
        start_deep_supervision_on=min(2, depth - 1)))


def variants(device, network: dict = bench.NETWORK,
             depths=DEPTHS, batch: int = 64, seconds: float = 10) -> list:
    """[(variant, fn)] on ``device``; the model variants at full depth use
    ``depths[-1]``."""
    device = torch.device(device)
    wave, lengths, _ = bench.train_batch(device, batch, seconds)
    feat = dsp.parse_features(FEATURES)
    frontend = Frontend(FEATURES, "2d", device=device)
    plain = Frontend(FEATURES, "2d", device=device,
                     mel_project=kernels.mel_project_log_reference)
    with torch.no_grad():
        inputs, frame_lengths = frontend(wave, lengths)
    n_classes = bench.N_CLASSES
    out = [
        ("featurize, K1", lambda: frontend(wave, lengths)),
        ("featurize, plain tail", lambda: plain(wave, lengths)),
        ("torch.stft alone", lambda: dsp.stft(wave, feat.n_fft,
                                              feat.hop_size)),
    ]
    models = {d: create_model(_network(d, network), n_classes,
                              torch.bfloat16, 0, device).eval()
              for d in depths}
    full = depths[-1]
    out += [(f"eval forward, bf16, depth {d}", lambda m=m: m(
        inputs, frame_lengths)) for d, m in models.items()]

    train_model = create_model(_network(full, network), n_classes,
                               torch.bfloat16, 0, device).train()
    f32 = create_model(_network(full, network), n_classes, torch.float32,
                       0, device).eval()
    fused = build_classifier("2d_cnn", _network(full, network), n_classes,
                             dtype=torch.bfloat16, fused_infer=True)
    fused.load_state_dict(models[full].state_dict())
    fused = fused.to(device).eval()
    rnn = types.SimpleNamespace(**dict(vars(_network(full, network)),
                                       aggregation_type="rnn"))
    rnn_eval = create_model(rnn, n_classes, torch.bfloat16, 0,
                            device).eval()
    rnn_train = create_model(rnn, n_classes, torch.bfloat16, 0,
                             device).train()
    out += [
        (f"train-mode forward, bf16, depth {full}",
         lambda: train_model(inputs, frame_lengths)),
        (f"eval forward, bf16, rnn aggregation, depth {full}",
         lambda: rnn_eval(inputs, frame_lengths)),
        (f"train-mode forward, bf16, rnn aggregation, depth {full}",
         lambda: rnn_train(inputs, frame_lengths)),
        (f"eval forward, float32, depth {full}",
         lambda: f32(inputs, frame_lengths)),
        (f"eval forward, bf16 fused (K4/K5), depth {full}",
         lambda: fused(inputs, frame_lengths)),
    ]
    no_grad = torch.no_grad()
    return [(name, no_grad(fn)) for name, fn in out]


def main() -> None:
    device = torch.device("cuda")
    print(bench.device_line(device), flush=True)
    rows = []
    for name, fn in variants(device):
        rows.append({"variant": name, "ms": cuda_ms(fn, iters=10)})
        print(f"  {name:44s} {rows[-1]['ms']:9.3f} ms", flush=True)
    print(json.dumps(rows), flush=True)


if __name__ == "__main__":
    main()
