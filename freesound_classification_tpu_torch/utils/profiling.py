"""Tracing and step timing (JAX ``utils/profiling.py``).

- ``StepTimer``: an EMA of the step time and the cumulative clips/s.
- ``maybe_trace(log_dir)``: a ``torch.profiler`` trace of the host and, with
  a card, of its kernels, written into ``log_dir`` as a Chrome/TensorBoard
  trace (``*.pt.trace.json``); a no-op when ``log_dir`` is falsy.
- ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``), and with a card an NVTX range too.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


class StepTimer:
    """EMA step timer + cumulative clips/sec counter."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.step_time: Optional[float] = None
        self.total_clips = 0
        self.total_time = 0.0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_clips: int) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.total_clips += n_clips
        self.total_time += dt
        self.step_time = (
            dt if self.step_time is None
            else self.ema * self.step_time + (1 - self.ema) * dt
        )
        return dt

    @property
    def clips_per_sec(self) -> float:
        return self.total_clips / max(self.total_time, 1e-9)


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block into ``log_dir`` when it is
    set (the card's kernels too where CUDA is available); no-op otherwise.
    The trace opens in TensorBoard's profiler plugin or ``chrome://tracing``.
    """
    if not log_dir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the profiler timeline; an NVTX range as well where
    CUDA is available (the CPU build of torch has no NVTX)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
