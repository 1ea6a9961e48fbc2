"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
has the files the harness looks for."""

from __future__ import annotations

import json
import re

import pytest

from port_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.load_benchmark()


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word
    assert 1 <= len(BENCH["paths"]) <= 16
    for path in BENCH["paths"]:
        assert PATH.match(path) and ".." not in path
        assert (spec.ROOT / path).is_dir()


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_allowed(section):
    names = [entry["name"] for entry in BENCH[section]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if metric["name"] in e2e:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in e2e
        assert 1 <= len(metric["layer"]) <= 200
        assert (spec.BENCH_DIR / "metrics" / f"{metric['name']}.py").is_file()
        for cell in metric.get("workloads", []):
            moved = next(m for m in BENCH["end_to_end"]
                         if m["name"] == metric["moves"])
            assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    data = json.loads((spec.ROOT / config["file"]).read_text())
    assert sorted(data["reduced"]) == sorted(config["reduced"])
    assert len(config["reduced"]) <= 16
    for key in config["reduced"]:
        assert NAME.match(key) and key in data
    for text in (config["source"], config["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_workloads(work):
    assert set(work) == {"name", "config", "traffic", "chips", "why"}
    assert work["chips"] in (1, 4)
    assert 1 <= len(work["why"]) <= 200
    assert NAME.match(work["traffic"])
    cell = spec.load_cell(work["name"])
    assert cell.end_to_end and cell.per_layer
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2
    assert (spec.BENCH_DIR / "entries"
            / f"{cell.traffic['entry']}.py").is_file()


def test_each_pair_once_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_check_time_fits():
    """A full check of 24 cells at this window fits the driver's 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
