"""One rank of a port inference CLI under ``torch.distributed.run``, for
``tests/test_torch_mesh_inference.py``.

Usage: python -m torch.distributed.run --nproc_per_node N
    tests/_mesh_cli.py OUT_DIR MODULE [CLI ARGS...]

Runs ``freesound_classification_tpu_torch.cli.MODULE.main(CLI ARGS)`` with
``common.write_predictions`` wrapped to log each path the rank writes to
``OUT_DIR/writes{RANK}.txt``, then saves what ``main`` returned as
``OUT_DIR/rank{RANK}.json``.
"""

import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from freesound_classification_tpu_torch.cli import common  # noqa: E402


def main() -> None:
    out_dir, module, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
    rank = int(os.environ["RANK"])
    write = common.write_predictions

    def logged(path, *args, **kwargs):
        with open(os.path.join(out_dir, f"writes{rank}.txt"), "a") as f:
            f.write(f"{path}\n")
        return write(path, *args, **kwargs)

    common.write_predictions = logged
    cli = importlib.import_module(
        f"freesound_classification_tpu_torch.cli.{module}")
    result = cli.main(argv)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()
