"""The ``rnn`` aggregation on the card: the GRU's two routes against each
other, and the rnn train step against the max one, in turns.

    python -m freesound_classification_tpu_torch.probes.rnn_step

At the published recipe's width (5 blocks, base depth 100, growth 1.5,
supervision from block 1, ``mel_2048_1024_128``), with ``rnn``
aggregation (a bidirectional GRU of 128 after each of blocks 1-4):

- ``route_check``: at each GRU's input shape for a recipe batch (20 clips
  x 15 s: 161, 80, 40 and 20 frames of 150, 225, 337 and 506 channels),
  float32 with TF32 off, the fused route (cuDNN through ``torch._VF.gru``)
  against the step-by-step one (``MaskedBiGRU``'s "scan", the route
  ``torch.func.vmap`` batches), on rows of the whole length, half of it
  and one frame: the largest output difference and the largest gradient
  difference over each parameter's largest gradient; the fused route in
  bf16 against float32; and what ``torch.func.vmap`` does with the fused
  route;
- ``compare``: the train step (no augmentation, bf16, B = 64 x 10 s, Adam)
  of the rnn model against the max model, 3 warm-ups and 10 calls each in
  turns, each timed by CUDA events; busy ms and launches per call by
  ``torch.profiler``; and the fold-parallel rnn step over 5 x 20 x 15 s
  (the scan route under vmap) alone, with its launches.

The first line is the card's name and power limit, the last one JSON line.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from freesound_classification_tpu_torch.bench import device_line
from freesound_classification_tpu_torch.models.blocks import (
    MaskedBiGRU,
    block_depths,
)
from freesound_classification_tpu_torch.models.classifiers import RNN_SIZE
from freesound_classification_tpu_torch.ops import dsp
from freesound_classification_tpu_torch.probes import fold_parallel
from freesound_classification_tpu_torch.probes.kernel_turns import (
    device_kernels,
)

SR = 44100
FEATURES = fold_parallel.FEATURES
RNN_NETWORK = dict(fold_parallel.RECIPE_NETWORK, aggregation_type="rnn")
ROUTE_TOL = 1e-4  # float32 GRU sums in another order, over <= 161 steps


def gru_shapes(network: dict = RNN_NETWORK, batch: int = 20,
               seconds: float = 15, features: str = FEATURES) -> list:
    """(block, B, T, C) of each GRU's input for ``batch`` clips of
    ``seconds``: the frames halve after every block."""
    frames = dsp.feature_frames(int(SR * seconds), features)
    depths = block_depths(network["num_conv_blocks"],
                          network["conv_base_depth"], network["growth_rate"])
    out = []
    for k, depth in enumerate(depths):
        frames = max(frames // 2, 1)
        if k >= network["start_deep_supervision_on"]:
            out.append((k, batch, frames, depth))
    return out


def _gru(c: int, device, seed: int) -> MaskedBiGRU:
    gen = torch.Generator().manual_seed(seed)
    gru = MaskedBiGRU(c, RNN_SIZE)
    with torch.no_grad():
        for p in gru.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * p.shape[-1] ** -0.5)
    return gru.to(device)


def _run(gru: MaskedBiGRU, route: str, x, lengths) -> tuple:
    gru.route = route
    gru.zero_grad(set_to_none=True)
    out = gru(x, lengths)
    (out.float() * torch.linspace(-1, 1, out.shape[1],
                                  device=x.device)).sum().backward()
    return out.detach().float(), {n: p.grad.clone()
                                  for n, p in gru.named_parameters()}


def route_check(device, shapes=None, seed: int = 0) -> list:
    """Per GRU shape: ``out`` (largest |fused - scan| output), ``grad``
    (largest |fused - scan| gradient over each parameter's largest, the
    worst parameter), and ``bf16`` (the fused route in bf16 against
    float32: output, over the largest float32 output)."""
    device = torch.device(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    try:
        for k, b, t, c in shapes or gru_shapes():
            rng = np.random.RandomState(seed + k)
            x = torch.from_numpy(rng.randn(b, t, c).astype(np.float32)).to(
                device)
            lengths = torch.full((b,), t, dtype=torch.int64, device=device)
            lengths[1::3] = max(t // 2, 1)
            lengths[2::3] = 1
            gru = _gru(c, device, seed + k)
            fused, g_fused = _run(gru, "fused", x, lengths)
            scan, g_scan = _run(gru, "scan", x, lengths)
            grad = max(float((g_fused[n] - g_scan[n]).abs().max()
                             / g_fused[n].abs().max().clamp(min=1e-30))
                       for n in g_fused)
            half, _ = _run(gru.to(torch.float32), "fused",
                           x.to(torch.bfloat16), lengths)
            rows.append({
                "block": k, "shape": [b, t, c],
                "out": float((fused - scan).abs().max()), "grad": grad,
                "bf16": float((half - fused).abs().max()
                              / fused.abs().max())})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return rows


def vmap_of_fused(device) -> str:
    """What ``torch.func.vmap`` does with the fused route: "batched" or the
    error it raises."""
    gru = _gru(8, device, 0)

    def one(x, n):
        return gru(x, n)

    x = torch.randn(2, 3, 5, 8, device=device)
    n = torch.full((2, 3), 5, device=device)
    try:
        torch.func.vmap(one)(x, n)
    except RuntimeError as err:
        return str(err).splitlines()[0]
    return "batched"


def _engine(network: dict, batch: int, seconds: float, device) -> tuple:
    _, singles, (wave, lengths, labels, _) = fold_parallel.build(
        device, network, n_folds=1, batch=batch, seconds=seconds,
        augment=False)
    engine = singles[0]
    return lambda: engine.train_step(wave[0], lengths[0], labels[0])


def compare(device="cuda", batch: int = 64, seconds: float = 10) -> dict:
    """The rnn train step against the max one in turns (``ms``, ``runs``,
    ``busy_ms``, ``launches``), and the fold-parallel rnn step over 5 x 20
    x 15 s (``ms`` of 10 calls after 3, ``busy_ms``, ``launches``)."""
    fns = {"max": _engine(fold_parallel.RECIPE_NETWORK, batch, seconds,
                          device),
           "rnn": _engine(RNN_NETWORK, batch, seconds, device)}
    runs = fold_parallel.in_turns(fns)
    out = {}
    for name, fn in fns.items():
        found = device_kernels(fn, calls=3)
        out[name] = {"ms": float(np.mean(runs[name])), "runs": runs[name],
                     "busy_ms": sum(t for _, t, _ in found),
                     "launches": sum(n for _, _, n in found)}
    stack, _, stacked_batch = fold_parallel.build(device, RNN_NETWORK)

    def stacked():
        return stack.train_step(*stacked_batch)

    ms = fold_parallel.in_turns({"stacked rnn": stacked})["stacked rnn"]
    found = device_kernels(stacked, calls=2)
    out["stacked rnn"] = {"ms": float(np.mean(ms)), "runs": ms,
                          "busy_ms": sum(t for _, t, _ in found),
                          "launches": sum(n for _, _, n in found)}
    return out


def main() -> None:
    device = torch.device("cuda")
    print(device_line(device), flush=True)
    routes = route_check(device)
    for row in routes:
        print(f"  GRU block {row['block']} {row['shape']}: fused vs scan "
              f"out {row['out']:.2e}, grad {row['grad']:.2e} (tolerance "
              f"{ROUTE_TOL:g}); bf16 vs float32 {row['bf16']:.2e}",
              flush=True)
    vmapped = vmap_of_fused(device)
    print(f"  vmap of the fused route: {vmapped}", flush=True)
    steps = compare(device)
    for name, row in steps.items():
        print(f"  {name:12s} {row['ms']:9.3f} ms  busy {row['busy_ms']:9.3f}"
              f" ms  {row['launches']:8.1f} launches", flush=True)
    print(json.dumps({"routes": routes, "vmap_fused": vmapped,
                      "steps": steps}), flush=True)


if __name__ == "__main__":
    main()
