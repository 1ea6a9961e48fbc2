"""``probes/child_start.py`` on the CPU: each case's children time their
``import torch`` and first tensor, and the cached cases fill and read a
bytecode cache under the prefix given."""

import math
import os

import pytest
import torch

from freesound_classification_tpu_torch.probes import child_start


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes, many small ops: one intra-op thread, torch's and the
    BLAS/OpenMP pools', is fastest, and keeps the suite's parallel
    workers from oversubscribing the cores."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


def test_the_cached_children_fill_the_prefix(tmp_path):
    prefix = str(tmp_path / "pycache")
    rows = child_start.measure("cpu", runs=1, prefix=prefix)
    assert list(rows) == ["no cache", "cache, first", "cache, warm"]
    for runs in rows.values():
        assert len(runs) == 1
        for r in runs:
            assert all(math.isfinite(r[k]) and r[k] > 0
                       for k in ("import_s", "tensor_s", "wall_s"))
            assert r["wall_s"] >= r["import_s"] + r["tensor_s"]
    compiled = [name for _, _, files in os.walk(prefix) for name in files
                if name.endswith(".pyc")]
    assert any(name.startswith("functional.") for name in compiled)
