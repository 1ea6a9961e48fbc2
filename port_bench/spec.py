"""``BENCHMARK.json`` and the per-name files it points to."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent  # the checkout: BENCHMARK.json and the port


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell(NamedTuple):
    """One workload of ``BENCHMARK.json`` with its files read: the
    configuration, the traffic mix, the cell's own file (the correctness
    limits, and the leaves that the worst leaf's gradient gap leaves out,
    by name prefix), and the metrics it reports."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    leave_out: tuple = ()


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, or without the key every cell that reports the end-to-end metric
    it ``moves`` (an end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def load_cell(name: str, bench: dict | None = None,
              root: Path = ROOT) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(work)}")
    w = work[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(root / config["file"]),
        traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        end_to_end=e2e, per_layer=per_layer, **checks(name))


def checks(name: str) -> dict:
    """``cells/<name>.json``: the cell's ``limits`` and ``leave_out``."""
    data = load_json(BENCH_DIR / "cells" / f"{name}.json")
    return {"limits": data["limits"],
            "leave_out": tuple(data.get("leave_out", ()))}


def load_module(kind: str, name: str):
    """``port_bench/<kind>/<name>.py`` as a module (names may hold dots,
    ``kind`` slashes)."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_" + f"{kind}_{name}".replace(".", "_").replace("/", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_entries() -> dict:
    """Every ``kernels/<K>.py`` entry, by name."""
    return {p.stem: load_module("kernels", p.stem)
            for p in sorted((BENCH_DIR / "kernels").glob("*.py"))
            if not p.stem.startswith("_")}
