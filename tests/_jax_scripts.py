"""Load one of the repository's JAX scripts (``bench.py``,
``scripts/probe_*.py``: not a package) as a module for the port's tests.

Importing such a script points JAX's persistent compilation cache at the
TPU cache directory; the three config values it sets are put back, so the
tests keep the cache their conftest chose.
"""

import importlib.util
import os

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_entry_size_bytes",
              "jax_persistent_cache_min_compile_time_secs")


def load_script(relpath: str):
    """The script at ``relpath`` (from the repository root), imported under
    the name of its file."""
    saved = {key: getattr(jax.config, key) for key in CACHE_KEYS}
    name = os.path.splitext(os.path.basename(relpath))[0]
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for key, value in saved.items():
            jax.config.update(key, value)
    return module
