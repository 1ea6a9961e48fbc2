"""The fold-parallel train step against the folds' single-fold steps, in
turns on the card.

    python -m freesound_classification_tpu_torch.probes.fold_parallel

At the published recipe's width (5 blocks, base depth 100, growth 1.5,
supervision from block 1, head dropout 0.5, mel_2048_1024_128), bf16,
Adam, with the recipe's augmentation (MixUp 0.5, the effects chain 0.75,
chunk shuffle 0.5): 5 folds, each a batch of 20 clips x 15 s. The stacked
step (``MultiFoldEngine.train_step`` over (5, 20, L)) against 5
``Engine.train_step`` calls, one per fold, on the same batches, each fold
engine started from the same weights with the stacked engine's seed for
that fold; and the stacked step with cuDNN free of the engine's
determinism.

3 warm-up calls of each, then 10 of each in turns (stacked, sequential,
sequential, stacked, ...), each call timed alone by CUDA events; the card's
busy ms and kernel launches per call by ``torch.profiler``
(``kernel_turns.device_kernels``); the peak of allocated memory over one
call of each (``torch.cuda.max_memory_allocated``, both engines resident).
The first line is the card's name and power limit, the last one JSON line.

``build`` makes both on any device (the CPU tests call it small);
``first_step_truth`` measures the stacked step's per-fold losses and
gradients against the single-fold steps' (float32, no augmentation,
dropout 0), beside the single step's own spread under a change of row
order.
"""

from __future__ import annotations

import json
import types

import numpy as np
import torch

from freesound_classification_tpu_torch.bench import device_line
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops.augment import (
    AugmentConfig,
    make_augmenter,
)
from freesound_classification_tpu_torch.probes.kernel_turns import (
    device_kernels,
)
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.training.multifold import (
    MultiFoldEngine,
)
from freesound_classification_tpu_torch.training.state import create_model

SR = 44100
N_CLASSES = 80
FEATURES = "mel_2048_1024_128"
# scripts/reproduce_reference.sh:54-85
RECIPE_NETWORK = {"num_conv_blocks": 5, "start_deep_supervision_on": 1,
                  "conv_base_depth": 100, "growth_rate": 1.5,
                  "output_dropout": 0.5, "aggregation_type": "max"}


def build(device, network: dict = RECIPE_NETWORK, n_folds: int = 5,
          batch: int = 20, seconds: float = 15,
          dtype: torch.dtype = torch.bfloat16, augment: bool = True,
          features: str = FEATURES, seed: int = 0,
          n_classes: int = N_CLASSES, data: tuple | None = None,
          state: dict | None = None) -> tuple:
    """(the stacked engine, the ``n_folds`` single-fold engines, the
    stacked batch (wave, lengths, labels, n_real) on ``device``). ``data``
    is (waves, lengths, labels), numpy (``n_folds``, ``batch``, ...), or
    else white noise of ``seconds`` and labels from ``RandomState(seed)``,
    every row whole; every row is real. Every model starts from the
    flax-like init of ``seed``, or from the state_dict ``state``."""
    device = torch.device(device)
    train_config = types.SimpleNamespace(
        optimizer="adam", learning_rate=3e-3,
        scheduler="1cycle_0.0001_0.005", weight_decay=0.0,
        accumulation_steps=1)
    augmenter = make_augmenter(AugmentConfig(
        p_mixup=0.5, p_aug=0.75, p_shuffle=0.5)) if augment else None
    frontend = Frontend(features, "2d", sr=SR, device=device)
    net = types.SimpleNamespace(**network)

    def engine(k):
        model = create_model(net, n_classes, dtype, seed, device)
        if state is not None:
            model.load_state_dict(state)
        return Engine(model, frontend, train_config, augment=augmenter,
                      seed=seed + k, device=device)

    stack = MultiFoldEngine(engine(0), range(n_folds))
    singles = [engine(k) for k in range(n_folds)]
    for e in (stack, *singles):
        e.make_optimizer(1000, 100)
    if data is None:
        rng = np.random.RandomState(seed)
        length = int(SR * seconds)
        labels = (rng.rand(n_folds, batch, n_classes) < 0.05)
        labels[..., 0] = True
        data = (rng.randn(n_folds, batch, length) * 0.1,
                np.full((n_folds, batch), length), labels)
    wave, lengths, labels = (torch.from_numpy(np.asarray(a, t)) for a, t in
                             zip(data, (np.float32, np.int32, np.float32)))
    n_real = torch.full((n_folds,), wave.shape[1], dtype=torch.int32)
    return stack, singles, tuple(t.to(device) for t in
                                 (wave, lengths, labels, n_real))


def steps(stack: MultiFoldEngine, singles: list, batch: tuple) -> tuple:
    """(stacked step, sequential steps): functions of no argument."""
    wave, lengths, labels, n_real = batch

    def stacked():
        return stack.train_step(wave, lengths, labels, n_real)

    def sequential():
        return [e.train_step(wave[k], lengths[k], labels[k])
                for k, e in enumerate(singles)]

    return stacked, sequential


def in_turns(fns: dict, warmup: int = 3, turns: int = 10) -> dict:
    """{name: [ms of each call]}: ``warmup`` calls of each, then ``turns``
    calls of each in turns (forward, then back), each timed alone by CUDA
    events."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    names = list(fns)
    runs = {name: [] for name in names}
    for turn in range(turns):
        for name in (names if turn % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            torch.cuda.synchronize()
            runs[name].append(start.elapsed_time(end))
    return runs


def peak_bytes(fn) -> int:
    """The most memory allocated on the card over one call of ``fn``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def compare(device="cuda", **kwargs) -> dict:
    """The stacked step against the sequential ones on the card, and the
    stacked step with cuDNN free to pick nondeterministic algorithms (what
    the engine's determinism costs): per variant ``ms`` (mean of the
    turns) and ``runs``, ``busy_ms`` and ``launches`` per call, and
    ``peak_gb``."""
    stack, singles, batch = build(device, **kwargs)
    stacked, sequential = steps(stack, singles, batch)

    def stacked_free():
        stack.deterministic = False
        try:
            return stacked()
        finally:
            stack.deterministic = True

    fns = {"stacked": stacked, "sequential": sequential,
           "stacked, cuDNN free": stacked_free}
    runs = in_turns(fns)
    out = {}
    for name, fn in fns.items():
        found = device_kernels(fn, calls=3)
        out[name] = {"ms": float(np.mean(runs[name])), "runs": runs[name],
                     "busy_ms": sum(t for _, t, _ in found),
                     "launches": sum(n for _, _, n in found),
                     "peak_gb": peak_bytes(fn) / 1e9}
    return out


def gradient_distance(got: dict, want: dict) -> dict:
    """Two gradients of one model, {name: tensor}: ``l2``, the relative L2
    distance over every parameter; ``max``, the largest |got - want| over
    the largest |want| entry; ``at``, the tensor where that is."""
    names = list(want)
    diff = torch.cat([(got[n] - want[n]).flatten() for n in names])
    ref = torch.cat([want[n].flatten() for n in names])
    per = {n: float((got[n] - want[n]).abs().max()) for n in names}
    at = max(per, key=per.get)
    return {"l2": float(diff.norm() / ref.norm()),
            "max": per[at] / float(ref.abs().max()), "at": at}


def first_step_truth(device, network: dict = RECIPE_NETWORK,
                     n_folds: int = 5, batch: int = 8,
                     seconds: float = 5, features: str = FEATURES,
                     n_classes: int = N_CLASSES, data: tuple | None = None,
                     state: dict | None = None) -> dict:
    """One float32 step without augmentation, dropout 0, equal batches,
    from the same weights (``build``'s ``data`` and ``state``): the
    stacked engine's per-fold losses and gradients against each
    single-fold engine's on the same rows. Per fold: ``loss`` |d| and
    ``grad`` (``gradient_distance``); and ``rounding``, the single-fold
    step against itself on the same rows in reverse order (the same
    function; only float32 sums change order): the spread of the gradient
    that rounding alone gives."""
    network = dict(network, output_dropout=0.0)
    stack, singles, (wave, lengths, labels, n_real) = build(
        device, network, n_folds, batch, seconds, torch.float32,
        augment=False, features=features, n_classes=n_classes, data=data,
        state=state)
    init = {n: t.clone() for n, t in singles[0].model.state_dict().items()}
    names = stack.model.param_names
    loss = stack.train_step(wave, lengths, labels, n_real)["loss"]
    params = list(stack.model.stacked()[0].values())
    out = {"loss": [], "grad": [], "rounding": []}
    for k, engine in enumerate(singles):

        def single_step(rows):
            engine.model.load_state_dict(init)
            got = engine.train_step(wave[k][rows], lengths[k][rows],
                                    labels[k][rows])["loss"]
            return float(got), {n: p.grad.clone() for n, p in
                                zip(names, engine.model.parameters())}

        rows = torch.arange(wave.shape[1], device=wave.device)
        single_loss, single = single_step(rows)
        _, reverse = single_step(rows.flip(0))
        out["loss"].append(abs(float(loss[k]) - single_loss))
        out["grad"].append(gradient_distance(
            {n: p.grad[k] for n, p in zip(names, params)}, single))
        out["rounding"].append(gradient_distance(reverse, single))
    return out


def main() -> None:
    device = torch.device("cuda")
    print(device_line(device), flush=True)
    out = compare(device)
    for name, row in out.items():
        print(f"  {name:10s} {row['ms']:9.3f} ms  busy {row['busy_ms']:9.3f}"
              f" ms ({row['busy_ms'] / row['ms']:.3f})  "
              f"{row['launches']:7.1f} launches  peak {row['peak_gb']:.2f} GB",
              flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
