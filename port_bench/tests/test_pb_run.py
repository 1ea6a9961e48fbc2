"""The run's contract around the measurement: no card means no result and
a non-zero exit; a checkout that holds only BENCHMARK.json and the
benchmark's files cannot run; the result line's keys; a traced run reads
the per-layer metrics that a CPU run can read and no device metric."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from port_bench import harness, spec
from pb_tiny import run_tiny

ARGS = ["--workload", "melcnn2d.train_aug", "--seed", str(2 ** 31 + 3),
        "--seconds", "1", "--trace", "0"]


def test_no_card_exits_without_a_result(monkeypatch, capsys):
    from port_bench import run

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert run.main(ARGS) == 3
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_cannot_run(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    for path in spec.load_benchmark()["paths"]:
        shutil.copytree(spec.ROOT / path, tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, *spec.load_benchmark()["command"][1:], *ARGS],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_seeds_take_large_values():
    big = harness.seeds(2 ** 33 + 7)
    assert big != harness.seeds(2 ** 33 + 8)
    assert all(0 <= v < 2 ** 31 for v in big.values())


def test_result_keys_and_check_last(data_root):
    out = run_tiny("melcnn2d.train_noaug", data_root)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "check"
    assert set(out["metrics"]) == {"train_step_p95_ms", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    json.dumps(out)


@pytest.mark.parametrize("name,metrics", [
    ("melcnn2d.train_aug", {"loader_wait_ms.train"}),
    ("melcnn2d.infer_5fold", {"loader_wait_ms.infer", "clips_per_s.infer"})])
def test_traced_run_reads_host_metrics_only_on_the_cpu(name, metrics,
                                                        data_root):
    out = run_tiny(name, data_root, trace=True)
    assert set(out["metrics"]) == metrics
    assert out["device"]["busy_s"] == 0.0 and "breakdown" not in out
