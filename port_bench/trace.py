"""A ``torch.profiler`` window over whole steps, reduced to what the
per-layer metrics read: the device's activities (kernels, copies, sets),
each attributed to the named range of the host that launched it, their
union (busy time), the idle gaps with what the host was doing, and the
device time by name."""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from typing import NamedTuple

import torch

WINDOW = "port_bench_window"
# the port's own ranges (``Engine._stage``) that device time is booked to
STAGES = ("augment", "frontend", "forward", "backward", "optimizer")


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    by_range: dict  # range name -> device seconds of what it launched
    by_name: dict  # device activity name -> (seconds, count)
    gaps: list  # (seconds, what the host was doing), longest first


@contextlib.contextmanager
def profiled(holder: dict):
    """Profile the block (CPU and CUDA activities); ``holder["trace"]``
    is its ``Trace`` afterwards, ``holder["s"]`` the host seconds."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.time_ns()
        with torch.profiler.record_function(WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        t1 = time.time_ns()
    holder["s"] = (t1 - t0) / 1e9
    holder["trace"] = reduce(prof.profiler.kineto_results.events(), t0, t1)


def _union(intervals: list) -> tuple:
    """(covered ns, the gaps between them as (start, end))."""
    covered, gaps, end = 0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    return covered, gaps


def reduce(events, t0: int, t1: int, ranges: tuple = STAGES) -> Trace:
    """``events``: the profiler's kineto events; ``t0``, ``t1``: the window
    in the profiler's clock (``time.time_ns``). A device activity is booked
    to the range of ``ranges`` open on the host when it was launched (from
    any thread: the backward's launches come from autograd's)."""
    device, launch, spans, host = [], {}, [], []
    main = None
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                device.append((max(start, t0), min(end, t1), name,
                               e.correlation_id()))
            continue
        if name == WINDOW:
            main = e.start_thread_id()
        if e.is_user_annotation():
            spans.append((start, end, name, e.start_thread_id()))
        elif name.startswith("cu") and e.correlation_id():
            launch[e.correlation_id()] = start
        host.append((start, end, name, e.start_thread_id()))
    device = [d for d in device if d[1] > d[0]]
    stages = sorted((s, e, n) for s, e, n, _ in spans if n in ranges)
    starts = [s for s, _, _ in stages]
    by_range, by_name = {}, {}
    for s, e, name, corr in device:
        dt = (e - s) / 1e9
        sec, n = by_name.get(name, (0.0, 0))
        by_name[name] = (sec + dt, n + 1)
        t = launch.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and stages[i][1] >= t:
            key = stages[i][2]
            by_range[key] = by_range.get(key, 0.0) + dt
    busy, gaps = _union([(s, e) for s, e, _, _ in device])
    if device:
        first = min(s for s, _, _, _ in device)
        last = max(e for _, e, _, _ in device)
        gaps = [(t0, first)] + gaps + [(last, t1)]
    else:
        gaps = [(t0, t1)]
    gaps = sorted(((e - s, s, e) for s, e in gaps if e > s), reverse=True)
    mains = sorted((s, e, n) for s, e, n, tid in host
                   if tid == main and n != WINDOW)
    labelled = []
    for dur, s, e in gaps[:10]:
        mid = (s + e) // 2
        inside = [(he - hs, n) for hs, he, n in mains if hs <= mid <= he]
        labelled.append((dur / 1e9, min(inside)[1] if inside else "idle"))
    return Trace(window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9,
                 by_range=by_range, by_name=by_name, gaps=labelled)


def device_seconds(trace: Trace, names: tuple) -> float:
    """Device seconds of the activities whose name holds one of ``names``
    as a word."""
    pattern = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    return sum(sec for name, (sec, _) in trace.by_name.items()
               if pattern.search(name))


def breakdown(trace: Trace) -> dict:
    top = sorted(trace.by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[name[:120], sec] for name, (sec, _) in top],
            "idle_gaps": [[what[:120], sec] for sec, what in trace.gaps]}
