"""Experiment directories (JAX ``utils/experiment.py``, the port's own copy).

A directory named from the config's values holds ``config.json``,
``command``, ``commit_hash``, ``log`` and ``results.json``;
``register_directory`` adds ``checkpoints``/``predictions``/...;
``register_result("fold0.metric", v)`` writes dotted keys into
``results.json``; ``Experiment(resume_from=path)`` reloads a config for
inference. A config whose directory exists raises unless
``implicit_resuming`` (the train CLIs' ``--resume``) enters it again.

In a data-parallel job (``mesh``) rank 0 alone makes the directory and
writes its files, and its path, or the error that stopped rank 0, reaches
the other ranks by broadcast; they keep their results in memory and write
nothing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Any, Mapping, Optional

from freesound_classification_tpu_torch.utils.config import (
    Config,
    config_name,
    flatten,
    unflatten,
)

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Tee:
    """Mirror a stream into the experiment log file."""

    def __init__(self, stream, logfile):
        self.stream = stream
        self.logfile = logfile

    def write(self, data):
        self.stream.write(data)
        self.logfile.write(data)
        return len(data)

    def flush(self):
        self.stream.flush()
        self.logfile.flush()


def _commit_hash() -> str:
    """The package checkout's git commit, or "unknown" outside git."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=_PACKAGE_DIR,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() if out.returncode == 0 else "unknown"


class Experiment:
    """Config-addressed experiment directory with a result registry."""

    def __init__(
        self,
        config: Optional[Mapping[str, Any]] = None,
        resume_from: Optional[str] = None,
        implicit_resuming: bool = False,
        experiments_dir: str = "experiments",
        mesh=None,
    ):
        if (config is None) == (resume_from is None):
            raise ValueError("pass exactly one of config / resume_from")
        self._writes = mesh is None or mesh.is_writer
        if resume_from is not None:
            self.experiment_dir = os.path.abspath(resume_from)
            with open(os.path.join(self.experiment_dir, "config.json")) as f:
                self._config = json.load(f)
            self._results = self._load_results()
        else:
            self._config = json.loads(json.dumps(dict(config)))
            made = (None, None)  # (path, rank 0's error)
            if self._writes:
                try:
                    made = (self._make_directory(experiments_dir,
                                                 implicit_resuming), None)
                except FileExistsError as err:
                    made = (None, str(err))
            if mesh is not None:
                made = mesh.broadcast_object(made)
            if made[1] is not None:
                raise FileExistsError(made[1])
            self.experiment_dir = made[0]
            self._results = self._load_results()
        self._log_file = None
        self._saved_streams = None

    def _make_directory(self, experiments_dir: str,
                        implicit_resuming: bool) -> str:
        path = os.path.abspath(os.path.join(experiments_dir,
                                            config_name(self._config)))
        if os.path.exists(path) and not implicit_resuming:
            raise FileExistsError(
                f"experiment already exists: {path} "
                "(pass --resume to continue into it)")
        os.makedirs(path, exist_ok=True)
        self.experiment_dir = path
        self._persist_metadata()
        return path

    def _persist_metadata(self) -> None:
        with open(os.path.join(self.experiment_dir, "config.json"), "w") as f:
            json.dump(self._config, f, indent=2, sort_keys=True)
        with open(os.path.join(self.experiment_dir, "command"), "w") as f:
            f.write(" ".join(sys.argv) + "\n")
        with open(os.path.join(self.experiment_dir, "commit_hash"), "w") as f:
            f.write(_commit_hash() + "\n")

    @property
    def config(self) -> Config:
        return Config(self._config)

    @property
    def name(self) -> str:
        return os.path.basename(self.experiment_dir)

    def register_directory(self, name: str) -> str:
        path = os.path.join(self.experiment_dir, name)
        if self._writes:
            os.makedirs(path, exist_ok=True)
        setattr(self, name, path)
        return path

    def _results_path(self) -> str:
        return os.path.join(self.experiment_dir, "results.json")

    def _load_results(self) -> dict:
        try:
            with open(self._results_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    @property
    def results(self) -> dict:
        """The nested results registered so far (a copy)."""
        return json.loads(json.dumps(self._results))

    def register_result(self, key: str, value: Any) -> None:
        """Dotted key -> nested results.json."""
        flat = flatten(self._results)
        flat[key] = float(value) if hasattr(value, "__float__") else value
        self._results = unflatten(flat)
        if not self._writes:
            return
        with open(self._results_path(), "w") as f:
            json.dump(self._results, f, indent=2, sort_keys=True)

    def __enter__(self) -> "Experiment":
        if not self._writes:
            return self
        self._log_file = open(os.path.join(self.experiment_dir, "log"), "a",
                              buffering=1)
        self._saved_streams = (sys.stdout, sys.stderr)
        sys.stdout = _Tee(sys.stdout, self._log_file)
        sys.stderr = _Tee(sys.stderr, self._log_file)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._saved_streams is not None:
            sys.stdout, sys.stderr = self._saved_streams
            self._saved_streams = None
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None
