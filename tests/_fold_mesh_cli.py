"""One rank of a port train CLI with ``--fold_parallel`` under
``torch.distributed.run``, for ``tests/test_torch_fold_mesh.py``.

Usage: python -m torch.distributed.run --nproc_per_node N
    tests/_fold_mesh_cli.py OUT_DIR STOP MODULE [CLI ARGS...]

Runs ``freesound_classification_tpu_torch.cli.MODULE.main(CLI ARGS)``
with every file the rank opens for writing, and every rename's target,
logged to ``OUT_DIR/writes{RANK}.txt``. ``STOP`` >= 0 stops the run as a
crash would when epoch ``STOP`` is about to start (every epoch before it
trained and saved); -1 runs it to its end.
"""

import builtins
import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from freesound_classification_tpu_torch.training import (  # noqa: E402
    multifold,
)


def main() -> None:
    out_dir, stop, module, argv = (sys.argv[1], int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4:])
    log_path = os.path.join(out_dir, f"writes{os.environ['RANK']}.txt")
    real_open, real_replace = builtins.open, os.replace

    def log(path) -> None:
        with real_open(log_path, "a") as f:
            f.write(os.path.abspath(os.fspath(path)) + "\n")

    def logged_open(file, mode="r", *args, **kwargs):
        if isinstance(file, (str, os.PathLike)) and set(mode) & set("wax+"):
            log(file)
        return real_open(file, mode, *args, **kwargs)

    def logged_replace(src, dst, *args, **kwargs):
        log(dst)
        return real_replace(src, dst, *args, **kwargs)

    builtins.open, os.replace = logged_open, logged_replace
    if stop >= 0:
        train_epoch = multifold.MultiFoldEngine.train_epoch
        started = []

        def stopping(self, *args, **kwargs):
            if len(started) == stop:
                raise KeyboardInterrupt(f"stopped before epoch {stop}")
            started.append(1)
            return train_epoch(self, *args, **kwargs)

        multifold.MultiFoldEngine.train_epoch = stopping
    cli = importlib.import_module(
        f"freesound_classification_tpu_torch.cli.{module}")
    cli.main(argv)


if __name__ == "__main__":
    main()
