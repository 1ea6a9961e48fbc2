"""The port's fold saves survive a kill, on the CPU
(``interop.save_fold_npz`` / ``load_fold_npz``): a process that saves one
fold file over and over is SIGKILLed at random points, with every rename
widened by a sleep, and each time a complete save sits at the fold's path.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np

from freesound_classification_tpu_torch import interop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# saves versions start + 1, start + 2, ... of a fold: every array holds the
# version; every rename sleeps 20 ms after it, so that kills land around
# the renames
WORKER = """
import os, sys, time
import numpy as np
sys.path.insert(0, sys.argv[2])
from freesound_classification_tpu_torch import interop
real = os.replace
def slow(a, b):
    real(a, b)
    time.sleep(0.02)
os.replace = slow
i = int(sys.argv[3])
print("READY", flush=True)
while True:
    i += 1
    interop.save_fold_npz(sys.argv[1], {"w": np.full((64, 64), i, np.float32)},
                          {"s": np.full(3, i, np.float32)})
"""


def _version(path):
    params, stats = interop.load_fold_npz(path)
    v = params["w"].flat[0]
    assert params["w"].shape == (64, 64) and (params["w"] == v).all()
    assert stats["s"].shape == (3,) and (stats["s"] == v).all()
    return int(v)


def test_save_replaces_in_place_and_leaves_no_temporary(tmp_path):
    path = str(tmp_path / "best_model.npz")
    for i in (1, 2):
        interop.save_fold_npz(path, {"w": np.full((64, 64), i, np.float32)},
                              {"s": np.full(3, i, np.float32)})
        assert _version(path) == i
    assert os.listdir(tmp_path) == ["best_model.npz"]


def test_sigkill_during_saves_leaves_a_complete_fold(tmp_path):
    """Eight kills at random points of a save loop; after each, a complete
    version sits at ``path``, never older than what the previous kill left,
    and the next worker carries on over it."""
    path = str(tmp_path / "best_model.npz")
    rng = np.random.RandomState(0)
    last = 0
    for start in range(0, 8 * 100000, 100000):
        proc = subprocess.Popen(
            [sys.executable, "-c", WORKER, path, REPO, str(start)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            assert proc.stdout.readline().strip() == "READY"
            time.sleep(rng.uniform(0.05, 0.4))
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
        assert os.path.isfile(path)
        version = _version(path)
        assert version >= max(last, 1)
        last = version
    assert last > 100000  # later workers saved too
