"""The ms a train step that the host spends issuing it: the port's five
stage spans (``augment``, ``frontend``, ``forward``, ``backward``,
``optimizer``) on the main thread, summed over the profiled train window
and divided by its steps.

The spans are the port's own (``utils/profiling.span``), kept while the
profiled window records and read after it. The host runs 1.5-2x slower
under the profiler (PERF.md §3), so a parent and a change compare alike
but the absolute value runs high; ``loader.decode`` calls no torch op, and
the profiler barely inflates it. Read from a card's run only (on the CPU
the copy and the readback move nothing), and None where the port keeps no
such spans.
"""

import importlib
import threading

from port_bench.harness import PORT

STAGES = ("augment", "frontend", "forward", "backward", "optimizer")


def durations_ms(names: tuple):
    """The port's kept spans named one of ``names`` on the main thread, in
    ms; None where the port has no recorder."""
    profiling = importlib.import_module(PORT + ".utils.profiling")
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    main = threading.main_thread().ident
    return [(s.end_ns - s.start_ns) / 1e6 for s in spans()
            if s.name in names and s.end_ns is not None and s.thread == main]


def read(r):
    if r.kind != "train" or not r.cuda or not r.batches:
        return None
    ms = durations_ms(STAGES)
    return sum(ms) / r.batches if ms else None
