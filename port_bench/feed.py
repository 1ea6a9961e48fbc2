"""The loader the port is handed: the port's own ``DataLoader``, wrapped so
that the benchmark sees each request for a batch.

At each request it runs the hooks due at that count (the set-up's reads of
the train state), times the host's wait inside the loader's ``next()``
(a ``loader_wait`` range in the profiler's trace while tracing), records
each batch's shape, and, while a window is open, records a CUDA event as
the batch is handed over: the interval between two events is one step of
the device's clock.
"""

from __future__ import annotations

import contextlib
import time

import torch


class Feed:
    def __init__(self, loader, cuda: bool):
        self.loader = loader
        self.cuda = cuda
        self.count = 0  # batches handed over
        self.hooks: dict = {}  # count -> fn(), run before fetching batch count
        self.keep = 0  # hand-overs whose batch is kept (the checked steps)
        self.kept: list = []
        self.timing = False  # record events, shapes and waits
        self.tracing = False  # mark the waits in the trace
        self.events: list = []
        self.shapes: list = []  # (rows, samples) of every batch while timing
        self.waits: list = []

    def __len__(self) -> int:
        return len(self.loader)

    def mark(self) -> None:
        """A CUDA event (a host clock reading on the CPU) now."""
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.events.append(event)
        else:
            self.events.append(time.perf_counter())

    def step_seconds(self) -> list:
        """The intervals between consecutive marks, in seconds (after a
        synchronize)."""
        if self.cuda:
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.events, self.events[1:])]
        return [b - a for a, b in zip(self.events, self.events[1:])]

    def __iter__(self):
        it = iter(self.loader)
        while True:
            hook = self.hooks.pop(self.count, None)
            if hook is not None:
                hook()
            span = (torch.profiler.record_function("loader_wait")
                    if self.tracing else contextlib.nullcontext())
            t0 = time.perf_counter()
            with span:
                try:
                    batch = next(it)
                except StopIteration:
                    return
            if self.timing:
                self.waits.append(time.perf_counter() - t0)
            if self.count < self.keep:
                self.kept.append(batch)
            if self.timing:
                self.mark()
                self.shapes.append(tuple(batch["signal"].shape))
            self.count += 1
            yield batch
