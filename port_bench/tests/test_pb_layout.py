"""What a later change adds as files: every model kind of a configuration
has its reference and FLOP count in files of its own, and the code that
all cells share names no kind; the readers of the measured window and the
worst leaf's gradient gap read what their docstrings say."""

from __future__ import annotations

import numpy as np
import pytest

from port_bench import harness, spec
from port_bench import trace as trace_lib
from port_bench.entries.train import gaps

CONFIGS = sorted((spec.BENCH_DIR / "configs").glob("*.json"))
SHARED = ["harness.py", "run.py", "weights.py", "control.py", "spec.py",
          "feed.py", "corpus.py", "flops/__init__.py", "reference/model.py",
          "reference/train.py", "reference/infer.py", "entries/train.py",
          "entries/infer.py"]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_each_model_kind_has_its_own_files(path):
    kind = spec.load_json(path)["model_kind"]
    assert (spec.BENCH_DIR / "reference" / "models" / f"{kind}.py").is_file()
    assert (spec.BENCH_DIR / "flops" / f"{kind}.py").is_file()


@pytest.mark.parametrize("name", SHARED)
def test_shared_code_names_no_model_kind(name):
    text = (spec.BENCH_DIR / name).read_text()
    kinds = {spec.load_json(p)["model_kind"] for p in CONFIGS}
    for word in sorted(kinds) + ['"2d"', '"1d"']:
        assert word not in text, (name, word)


def test_worst_leaf_leaves_out_rounding_leaves_and_named_prefixes():
    names = ["a.w", "b.w", "b.bias", "c.w", "d.w"]
    ref = {"names": names, "grad": np.array([1.0, 1.0, 1e-6, 1.0, 1.0]),
           "change": np.ones(5), "losses": np.ones(3),
           "row_losses": [np.ones(4)]}
    truth = {"names": names, "grad": np.array([3.0, 1.2, 0.5, 1.0, 1.0]),
             "change": np.ones(5), "losses_first": np.ones(3),
             "row_losses": [np.ones(4)]}
    out = gaps(truth, ref, ("a.",))
    assert out["grad_gap"] == pytest.approx(2.0)
    assert out["grad_gap_worst"] == pytest.approx(0.2)
    assert gaps(truth, ref)["grad_gap_worst"] == pytest.approx(2.0)


def test_readers_take_the_measured_window():
    """MFU and the loader's wait come from the untraced window; the idle
    share scales the profiled window's busy seconds a clip to it."""
    trace = trace_lib.Trace(window_s=8.0, busy_s=2.0, by_range={},
                            by_name={}, gaps=[])
    window = harness.Window(seconds=10.0, clips=2000, flops=989e12,
                            waits=[0.1, 0.3])
    r = harness.Readings(kind="train", window=window, trace=trace,
                         batches=49, clips=1000, kernel_bound_s={},
                         kernel_device_s={}, cuda=True)

    def read(name):
        return spec.load_module("metrics", name).read(r)

    assert read("train_mfu") == pytest.approx(10.0)
    assert read("loader_wait_ms.train") == pytest.approx(200.0)
    assert read("device_idle_share.train") == pytest.approx(60.0)
    assert read("infer_mfu") is None
    assert read("clips_per_s.infer") is None
