"""What every cell's run shares: the seeds drawn from ``--seed``, the port's
modules, the recording of the hand-written kernels' calls while tracing,
the per-layer readers, the comparison's verdict and the result line."""

from __future__ import annotations

import functools
import importlib
import json
import sys
import time
import types
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from port_bench import spec as spec_lib
from port_bench import trace as trace_lib

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA's data sheet)
PEAK_HBM = 3.35e12  # bytes/s, H100 SXM HBM3
PORT = "freesound_classification_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "freesound_classification_tpu")
SEEDS = ("data", "weights", "loader", "crop", "engine", "dropout", "sample")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def seeds(seed: int) -> dict:
    """Independent 31-bit seeds of every random part, from ``--seed``."""
    words = np.random.SeedSequence(int(seed)).generate_state(len(SEEDS))
    return {k: int(w) % (2 ** 31 - 1) for k, w in zip(SEEDS, words)}


def port() -> types.SimpleNamespace:
    """The port's modules that the cells drive."""
    names = {
        "kernels": "ops.kernels", "augment": "ops.augment", "dsp": "ops.dsp",
        "bucketing": "data.bucketing", "dataset": "data.dataset",
        "loader": "data.loader", "classifiers": "models.classifiers",
        "frontend": "models.frontend", "engine": "training.engine",
        "ensemble": "training.ensemble", "profiling": "utils.profiling",
    }
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{PORT}.{v}") for k, v in names.items()})


def ladder(p, max_seconds: Optional[float], sr: int) -> list:
    """The train and predict CLIs' bucket ladder (``default_ladder``):
    half a second doubling up to the crop, or to 30 s without one."""
    return p.bucketing.make_bucket_ladder(int((max_seconds or 30) * sr),
                                          min_length=sr // 2)


def dtype_of(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg["dtype"]]


def build_model(p, cfg: dict, state: dict, device) -> torch.nn.Module:
    """The port's classifier of ``cfg`` with the drawn weights, built as
    the CLIs build it from an experiment's configuration: each kind reads
    its own keys of ``cfg``."""
    with torch.device("meta"):
        model = p.classifiers.build_classifier(
            cfg["model_kind"], types.SimpleNamespace(**cfg),
            cfg["n_classes"], dtype=dtype_of(cfg),
            input_dim=p.dsp.parse_features(cfg["features"]).n_features)
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(device)


def frontend(p, cfg: dict, device):
    """The port's frontend for ``cfg``'s kind of model, with K1."""
    return p.frontend.Frontend(
        cfg["features"], p.frontend.MODEL_FAMILY[cfg["model_kind"]],
        sr=cfg["sr"], device=device, mel_project=p.kernels.mel_project_log)


class KernelLog:
    """While tracing, each hand-written kernel's program function
    (``kernels/<K>.py``'s ``TARGET``) is wrapped to keep what its bound
    needs of each call made while ``on``."""

    def __init__(self):
        self.entries = spec_lib.kernel_entries()
        self.calls = {k: [] for k in self.entries}
        self.on = False
        self._undo = []

    def install(self) -> None:
        for name, entry in self.entries.items():
            module = importlib.import_module(entry.TARGET[0])
            original = getattr(module, entry.TARGET[1])

            def wrapped(*args, _orig=original, _name=name, _entry=entry,
                        **kwargs):
                out = _orig(*args, **kwargs)
                if self.on:
                    self.calls[_name].append(_entry.capture(args, kwargs,
                                                            out))
                return out

            functools.update_wrapper(wrapped, original)
            setattr(module, entry.TARGET[1], wrapped)
            self._undo.append((module, entry.TARGET[1], original))

    def uninstall(self) -> None:
        for module, attr, original in reversed(self._undo):
            setattr(module, attr, original)
        self._undo = []

    def bounds(self) -> dict:
        """Each kernel's summed bound over its calls, in seconds."""
        out = {}
        for name, calls in self.calls.items():
            entry = self.entries[name]
            total = 0.0
            for call in calls:
                ops, n_bytes = entry.work(call)
                total += max(n_bytes / PEAK_HBM, ops / entry.PEAK_OPS)
            out[name] = total
        return out


@dataclass
class Window:
    """The measured window, untraced: its host seconds, the clips it took,
    the models' FLOPs over the batch shapes it handed over, and the host's
    wait in the loader's ``next()`` for each batch."""
    seconds: float
    clips: int
    flops: float
    waits: list


@dataclass
class Readings:
    """What the per-layer readers read: the measured window, and the
    profiled window after it (its trace, batches and clips, and the
    hand-written kernels' bounds and device seconds)."""
    kind: str  # "train" or "infer"
    window: Window
    trace: trace_lib.Trace
    batches: int
    clips: int
    kernel_bound_s: dict
    kernel_device_s: dict
    cuda: bool


def per_layer(cell: spec_lib.Cell, readings: Readings) -> dict:
    """Each per-layer metric of the cell that its reader finds, by name."""
    out = {}
    for metric in cell.per_layer:
        value = spec_lib.load_module("metrics", metric["name"]).read(readings)
        if value is not None:
            out[metric["name"]] = {"value": float(value),
                                   "unit": metric["unit"]}
    return out


def measure(run, cell, p, kernel_log) -> tuple:
    """The cell's window and, when traced, its profiled window after it:
    (the metrics of the result line, the readings or None)."""
    e2e = cell.window(run.seconds)
    bounded = {m["name"]: m["unit"] for m in run.cell.end_to_end}
    for name in sorted(set(e2e) - set(bounded)):
        log(f"reading {name}: {e2e[name]:.6g} (not in BENCHMARK.json)")
    if not run.trace:
        return {k: {"value": v, "unit": bounded[k]} for k, v in e2e.items()
                if k in bounded}, None
    readings = cell.traced(p, kernel_log, run.seconds)
    return per_layer(run.cell, readings), readings


def kernel_device_seconds(trace: trace_lib.Trace, log_: KernelLog) -> dict:
    return {k: trace_lib.device_seconds(trace, e.DEVICE_NAMES)
            for k, e in log_.entries.items()}


def verdict(readings: dict, limits: dict, problems: list) -> tuple:
    """(correct, the compared numbers as {name: [value, limit]}): the
    readings that the cell's file gives a limit are compared, the others
    only logged. Any problem, or a compared value above its limit or not
    finite, is not correct."""
    ok = not problems
    shown = {}
    for name, value in readings.items():
        if name in limits:
            ok = ok and bool(np.isfinite(value)) and value <= limits[name]
            shown[name] = [float(value), limits[name]]
        else:
            log(f"reading {name}: {value:.6g} (not compared)")
    missing = sorted(set(limits) - set(readings))
    if missing:
        problems = list(problems) + [f"no reading of {missing}"]
        ok = False
    for problem in problems:
        log(f"check: {problem}")
    for name, (value, limit) in shown.items():
        log(f"check {name}: {value:.6g} (limit {limit:g})")
    return ok, shown


def device_info(cuda: bool, trace: Optional[trace_lib.Trace] = None,
                peak: int = 0) -> dict:
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def emit(result: dict) -> None:
    """The result as the last line of standard output."""
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()


def now() -> float:
    return time.perf_counter()


def stamp(run, what: str) -> None:
    """Log the seconds since the process started at a point of set-up."""
    log(f"port_bench: {what} at {now() - run.start:.3f} s")
