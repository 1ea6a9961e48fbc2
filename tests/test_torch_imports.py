"""The port stands alone: no module of ``freesound_classification_tpu_torch``
and not ``chip_smoke.py`` imports the JAX package or JAX, flax, optax,
orbax, sklearn or pandas (the card's machine has none of them).

Checked twice: by an AST scan of every import statement, and by importing
every port module in a fresh interpreter in which those names cannot be
imported.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "freesound_classification_tpu_torch"
BLOCKED = ("freesound_classification_tpu", "jax", "jaxlib", "flax", "optax",
           "orbax", "sklearn", "pandas")


def _port_files():
    root = os.path.join(REPO, PACKAGE)
    files = [os.path.join(dirpath, name)
             for dirpath, _, names in os.walk(root) for name in names
             if name.endswith(".py")]
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_blocked_import_statement(path):
    bad = sorted(set(_imported_roots(path)) & set(BLOCKED))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


_BLOCKER = """
import importlib.abc, pkgutil, sys
BLOCKED = {blocked!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {{name}}")
        return None

for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Block())
sys.path.insert(0, {repo!r})
import {package}
names = [m.name for m in pkgutil.walk_packages({package}.__path__,
                                               "{package}.")]
for name in names:
    __import__(name)
import chip_smoke
print(" ".join(names))
"""

# modules that must be among those imported (the walk finds every module;
# these pin that the newest ones are there and stand alone)
REQUIRED = ("cli.train_hierarchical_cnn", "cli.finetune_hierarchical_cnn",
            "cli.train_backbone_cnn", "ops.resnet_infer",
            "ops.backbone_infer", "ops.head_infer", "ops.kernels",
            "models.backbone", "models.blocks", "models.classifiers",
            "models.frontend", "training.engine", "bench",
            "ops.fast_featurize", "probes.dft_context",
            "probes.train_step_split", "probes.model_ablation",
            "utils.profiling", "data.tables", "cli.create_class_map",
            "cli.relabel_noisy_data", "cli.linear_blend",
            "cli.compare_to_baseline", "models.apc", "models.cpc",
            "models.adversarial", "utils.projection", "cli.ssl_common",
            "cli.train_apc", "cli.train_cpc", "cli.adversarial_test",
            "parallel.mesh", "data.host_ops", "data.transforms",
            "data.sound_dataset", "data.audio_io", "training.ensemble")


def test_every_port_module_imports_with_the_jax_stack_blocked():
    code = _BLOCKER.format(blocked=BLOCKED, repo=REPO, package=PACKAGE)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = proc.stdout.strip().splitlines()[-1].split()
    assert len(names) >= 35
    for name in REQUIRED:
        assert f"{PACKAGE}.{name}" in names, name
