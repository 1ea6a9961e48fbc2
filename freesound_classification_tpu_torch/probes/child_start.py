"""What a new process of this interpreter pays before its first card work:
``import torch``, then one CUDA tensor, without a bytecode cache and with
one (``PYTHONPYCACHEPREFIX``).

    python -m freesound_classification_tpu_torch.probes.child_start

Every train, predict and recipe step the port runs as a CLI is such a
process, and so is every child of ``chip_smoke.py``. Where the
interpreter's packages ship no valid bytecode and
``PYTHONDONTWRITEBYTECODE`` is set, a child compiles torch's sources at
its import, which a cache spares all but the first
(``chip_smoke.bytecode_cache``). Each case starts
``runs`` children in turn and records each one's seconds to import torch
and then to its first CUDA tensor (host seconds: the child prints its own
clock):

- ``no cache``: bytecode neither read from a prefix nor written;
- ``cache, first``: a fresh prefix, which the first child fills;
- ``cache, warm``: the same prefix, read.

The first line is the card's name and power limit, the last one JSON line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from freesound_classification_tpu_torch.bench import device_line

CHILD = """
import time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.zeros(1, device={device!r}).sum().item()
t2 = time.perf_counter()
print(t1 - t0, t2 - t1)
"""
PREFIX = str(Path(__file__).resolve().parents[2] / "build"
             / "pycache_child_start")


def child(device: str, env: dict) -> dict:
    """One child's seconds: its ``import torch`` and its first tensor on
    ``device``, and its wall from the parent's side."""
    import time

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", CHILD.format(device=device)],
                         env=env, capture_output=True, text=True, check=True,
                         timeout=600).stdout.split()
    wall = time.perf_counter() - t0
    return {"import_s": float(out[0]), "tensor_s": float(out[1]),
            "wall_s": wall}


def measure(device: str = "cuda", runs: int = 2,
            prefix: str = PREFIX) -> dict:
    """``runs`` children a case (one for ``cache, first``); ``prefix`` is
    emptied first and holds the cache after."""
    base = {k: v for k, v in os.environ.items()
            if k != "PYTHONPYCACHEPREFIX"}
    shutil.rmtree(prefix, ignore_errors=True)
    cached = dict(base, PYTHONPYCACHEPREFIX=prefix)
    cached.pop("PYTHONDONTWRITEBYTECODE", None)
    return {
        "no cache": [child(device, dict(base, PYTHONDONTWRITEBYTECODE="1"))
                     for _ in range(runs)],
        "cache, first": [child(device, cached)],
        "cache, warm": [child(device, cached) for _ in range(runs)],
    }


def main() -> None:
    device = torch.device("cuda")
    print(device_line(device), flush=True)
    try:
        rows = measure("cuda")
    finally:
        shutil.rmtree(PREFIX, ignore_errors=True)
    for case, runs in rows.items():
        for r in runs:
            print(f"  {case:13s} import torch {r['import_s']:7.3f} s, first "
                  f"CUDA tensor {r['tensor_s']:7.3f} s, wall "
                  f"{r['wall_s']:7.3f} s", flush=True)
    print(json.dumps(rows), flush=True)


if __name__ == "__main__":
    main()
