"""The port's ``h2d`` spans' summed ms a batch in the profiled infer window:
the two host-to-device copies of each batch in ``predict_loader``, pageable
copies that hold the host while they run.

The spans are the port's own (``utils/profiling.span``), kept while the
profiled window records and read after it. The host runs 1.5-2x slower
under the profiler (PERF.md §3), so a parent and a change compare alike
but the absolute value runs high; ``loader.decode`` calls no torch op, and
the profiler barely inflates it. Read from a card's run only (on the CPU
the copy and the readback move nothing), and None where the port keeps no
such spans.
"""

import importlib

from port_bench.harness import PORT


def durations_ms(name: str):
    """The port's kept spans named ``name``, in ms; None where the port
    has no recorder."""
    profiling = importlib.import_module(PORT + ".utils.profiling")
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    return [(s.end_ns - s.start_ns) / 1e6 for s in spans()
            if s.name == name and s.end_ns is not None]


def read(r):
    if r.kind != "infer" or not r.cuda or not r.batches:
        return None
    ms = durations_ms("h2d")
    return sum(ms) / r.batches if ms else None
