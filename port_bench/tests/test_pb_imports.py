"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Top-level module names (before the
first dot) are compared whole: the port's name begins with the JAX
package's."""

from __future__ import annotations

import json
import subprocess
import sys

from port_bench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "freesound_classification_tpu"}
PORT = "freesound_classification_tpu_torch"


def loaded_after(code: str) -> set:
    """Top-level names in ``sys.modules`` of a fresh interpreter after
    ``code``."""
    probe = (code + "\nimport sys, json\n"
             "print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_cells_and_port_load_no_jax():
    code = """
from port_bench import control, harness, run, spec
from port_bench.entries import infer, train
bench = spec.load_benchmark()
for w in bench["workloads"]:
    spec.load_cell(w["name"], bench)
for m in bench["per_layer"]:
    spec.load_module("metrics", m["name"])
spec.kernel_entries()
harness.port()
"""
    names = loaded_after(code)
    assert PORT in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    code = """
from port_bench.reference import augment, frontend, infer, model, train
"""
    names = loaded_after(code)
    assert not names & (FORBIDDEN | {PORT}), names & (FORBIDDEN | {PORT})
    assert "port_bench" in names


def test_forbidden_check_compares_whole_names():
    from port_bench import harness

    assert PORT not in harness.forbidden_modules()
    assert set(harness.FORBIDDEN) == FORBIDDEN
