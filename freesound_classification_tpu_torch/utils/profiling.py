"""Tracing and step timing (JAX ``utils/profiling.py``).

- ``span(name, **attrs)``: the port's span recorder. Off (the default) it
  returns one shared no-op context after a flag check: no range is opened and
  nothing is kept. On, it opens a ``torch.profiler.record_function`` range
  (and an NVTX range where CUDA is available) and keeps one ``SpanRecord``
  in memory, from any thread: the loader's decode threads too, which
  ``torch.profiler`` does not record.
- The switch: spans are on inside ``with tracing():`` and whenever
  ``torch.profiler`` is recording (``maybe_trace``, or any profiler window
  around the port's code).
- ``spans()`` returns the records, ``reset()`` clears them. Their start and
  end are ``time.time_ns()``, the clock of the profiler's kineto events.
- ``annotate(name)``: ``span`` always on: the ranges whatever the switch, the
  record while it is on.
- ``StepTimer``: the cumulative clips/s.
- ``maybe_trace(log_dir)``: a ``torch.profiler`` trace of the host and, with
  a card, of its kernels, written into ``log_dir`` as a Chrome/TensorBoard
  trace (``*.pt.trace.json``), and the block's spans beside it
  (``spans.json``); a no-op when ``log_dir`` is falsy.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


@dataclass(slots=True)
class SpanRecord:
    """One span: its ``parent`` is the index in ``spans()`` of the span
    that enclosed it on the same thread (None at the thread's top level);
    ``end_ns`` is None while it is open."""
    name: str
    thread: int
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    attrs: dict = field(default_factory=dict)


_lock = threading.Lock()
_records: list = []
_generation = 0  # bumped by reset(): an older span is no parent
_switched_on = 0  # depth of tracing() blocks
_local = threading.local()  # each thread's open spans: (generation, index)
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether spans are on: inside ``tracing()``, or while
    ``torch.profiler`` records."""
    return bool(_switched_on or _autograd_profiler._is_profiler_enabled)


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Spans on inside the block (nestable)."""
    global _switched_on
    with _lock:
        _switched_on += 1
    try:
        yield
    finally:
        with _lock:
            _switched_on -= 1


def spans() -> list:
    """The kept ``SpanRecord``s, oldest first (not cleared)."""
    with _lock:
        return list(_records)


def reset() -> None:
    """Drop every kept record."""
    global _generation
    with _lock:
        _records.clear()
        _generation += 1


class _Span:
    __slots__ = ("name", "attrs", "keep", "record", "range", "nvtx")

    def __init__(self, name: str, attrs: dict, keep: bool):
        self.name = name
        self.attrs = attrs
        self.keep = keep

    def __enter__(self):
        self.nvtx = torch.cuda.is_available()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.record = None
        if self.keep:
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _local.stack = []
            with _lock:
                parent = (stack[-1][1] if stack and stack[-1][0] == _generation
                          else None)
                self.record = SpanRecord(self.name, threading.get_ident(),
                                         time.time_ns(), None, parent,
                                         self.attrs)
                stack.append((_generation, len(_records)))
                _records.append(self.record)
        return self

    def __exit__(self, *exc):
        if self.record is not None:
            self.record.end_ns = time.time_ns()
            _local.stack.pop()
        try:
            self.range.__exit__(*exc)
        finally:
            if self.nvtx:
                torch.cuda.nvtx.range_pop()
        return False


def span(name: str, **attrs):
    """A named span of the port's work (the module docstring): a no-op
    unless ``enabled()`` (tested inline: this is the hot path)."""
    if not (_switched_on or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, attrs, True)


def annotate(name: str, **attrs):
    """``span`` with its ranges opened whatever the switch; the record is
    kept while ``enabled()``."""
    return _Span(name, attrs, enabled())


def _write_spans(path: str, records: list) -> None:
    """``records`` as Chrome trace events (``ph`` "X"; ``ts`` and ``dur``
    in microseconds of ``time.time_ns``'s clock, ``tid`` the thread, the
    record's index, parent and attributes under ``args``), appended to the
    events already in ``path``."""
    events = []
    if os.path.exists(path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    pid = os.getpid()
    for i, r in enumerate(records):
        if r.end_ns is None:
            continue
        events.append({"name": r.name, "ph": "X", "pid": pid,
                       "tid": r.thread, "ts": r.start_ns / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3,
                       "args": dict(r.attrs, index=i, parent=r.parent)})
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


class StepTimer:
    """Cumulative clips/sec over timed spans (JAX's ``StepTimer`` without
    its EMA of the step time, which nothing here reads)."""

    def __init__(self):
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
        return dt

    @property
    def clips_per_sec(self) -> float:
        return self.total_clips / max(self.total_time, 1e-9)


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block into ``log_dir`` when it is
    set (the card's kernels too where CUDA is available); no-op otherwise.
    The trace opens in TensorBoard's profiler plugin or ``chrome://tracing``.
    The kept spans are reset as it starts; the block's spans, those of the
    loader's threads too, are added to ``log_dir/spans.json`` as it ends.
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
    reset()
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(log_dir)):
            yield
    finally:
        _write_spans(os.path.join(log_dir, "spans.json"), spans())
