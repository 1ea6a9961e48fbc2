"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the metrics are the cell's end-to-end ones (``setup_s``
from the process's start to the window's first step, less the reference's
seconds within it); with ``--trace 1`` its per-layer ones, read from the
same untraced window and a profiler window after it. Either way the run
ends by comparing what the timed path produced with the plain reference
(``reference/``) and prints each compared number beside its limit, last on
standard error and under the result's last key, ``check``.

Exit codes: 0 with a result; 2 bad arguments; 3 no card, or fewer than the
cell asks for; 4 the port cannot be imported; 5 JAX or the JAX package is
loaded.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

PROCESS_START = time.perf_counter()
if __name__ == "__main__":
    # bytecode of every module, torch's too, cached at a fixed path inside
    # the checkout: only a checkout's first run compiles it
    sys.pycache_prefix = str(Path(__file__).resolve().parents[1] / "build"
                             / "pycache")

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Optional  # noqa: E402

import torch  # noqa: E402

from port_bench import harness  # noqa: E402
from port_bench import spec as spec_lib  # noqa: E402
from port_bench import trace as trace_lib  # noqa: E402


def cache_environment(root) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = root / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton_cache"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    os.environ.setdefault("USE_FLAX", "0")


@dataclass
class Run:
    cell: spec_lib.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    start: float = PROCESS_START
    setup_s: Optional[float] = None
    not_setup_s: float = 0.0  # the reference's seconds within set-up
    data_root: Path = spec_lib.ROOT  # where the corpus is written

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def setup_done(self) -> None:
        self.setup_s = harness.now() - self.start - self.not_setup_s

    def window_closed(self) -> None:
        """The reference runs in float32 with TF32 off."""
        if self.cuda:
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def execute(r: Run) -> dict:
    """The cell's run: its entry's result, with ``setup_s`` and, when
    traced, the breakdown, in the result line's order."""
    p = harness.port()
    harness.stamp(r, "port imported")
    kernel_log = harness.KernelLog()
    if r.trace:
        kernel_log.install()
    try:
        entry = importlib.import_module(
            f"port_bench.entries.{r.cell.traffic['entry']}")
        out = entry.run(r, p, kernel_log)
    finally:
        kernel_log.uninstall()
    readings = out.pop("readings")
    check = out.pop("check")
    if not r.trace:
        out["metrics"]["setup_s"] = {"value": r.setup_s, "unit": "s"}
    elif readings is not None and readings.cuda:
        out["breakdown"] = trace_lib.breakdown(readings.trace)
    out["check"] = check
    return out


def parse(argv) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", required=True, type=int)
    parser.add_argument("--seconds", required=True, type=float)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec_lib.load_cell(args.workload)
    cache_environment(spec_lib.ROOT)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        harness.log(f"port_bench: the cell {cell.name} needs {cell.chips} "
                    "CUDA card(s); torch.cuda.is_available() is "
                    f"{torch.cuda.is_available()}, device_count() "
                    f"{torch.cuda.device_count()}")
        return 3
    try:
        importlib.import_module(harness.PORT)
    except ImportError as e:
        harness.log(f"port_bench: cannot import the port: {e}")
        return 4
    r = Run(cell=cell, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), device=torch.device("cuda", 0))
    result = execute(r)
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"port_bench: JAX or the JAX package is loaded: {loaded}")
        return 5
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
