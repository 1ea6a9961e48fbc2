"""A killed writer's temporaries are cleared by the next write of the same
path on the same host, as the JAX package's next save clears its stale swaps
(``training/checkpoints._swap_into_place``), but never a live writer's, this
process's own or another host's (``interop.clear_dead_temporaries``,
``interop.write_durably``, ``training/checkpoints.save_bundle``,
``ops/build.build``), on the CPU.
"""

import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.ops import build
from freesound_classification_tpu_torch.training import checkpoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = socket.gethostname()

# saves versions start + 1, start + 2, ... of a fold: every array holds the
# version; every fsync sleeps 20 ms after it, so that kills land while a
# temporary is on disk
WORKER = """
import os, sys, time
import numpy as np
sys.path.insert(0, sys.argv[2])
from freesound_classification_tpu_torch import interop
real = os.fsync
def slow(fd):
    real(fd)
    time.sleep(0.02)
os.fsync = slow
i = int(sys.argv[3])
print("READY", flush=True)
while True:
    i += 1
    interop.save_fold_npz(sys.argv[1], {"w": np.full((64, 64), i, np.float32)},
                          {"s": np.full(3, i, np.float32)})
"""


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


@pytest.fixture
def dead_pid():
    """The pid of a child that has exited and been reaped."""
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait(timeout=60)
    return proc.pid


@pytest.fixture
def live_pid():
    """The pid of a child that runs until the case ends."""
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(120)"])
    yield proc.pid
    proc.kill()
    proc.wait(timeout=60)


def _save(path, version):
    interop.save_fold_npz(path, {"w": np.full((64, 64), version, np.float32)},
                          {"s": np.full(3, version, np.float32)})


def _version(path):
    params, stats = interop.load_fold_npz(path)
    v = params["w"].flat[0]
    assert params["w"].shape == (64, 64) and (params["w"] == v).all()
    assert stats["s"].shape == (3,) and (stats["s"] == v).all()
    return int(v)


def _plant(directory, name):
    with open(os.path.join(directory, name), "wb") as f:
        f.write(b"half a file")
    return name


def test_the_next_save_after_kills_leaves_only_the_file(tmp_path, dead_pid):
    """Four kills at random points of a save loop, a temporary of an exited
    child planted beside them; one save of this process then leaves
    ``best_model.npz`` alone, at its version."""
    path = str(tmp_path / "best_model.npz")
    rng = np.random.RandomState(1)
    last = 0
    for start in range(0, 4 * 100000, 100000):
        proc = subprocess.Popen(
            [sys.executable, "-c", WORKER, path, REPO, str(start)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            assert proc.stdout.readline().strip() == "READY"
            time.sleep(rng.uniform(0.05, 0.4))
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
        last = _version(path)
    _plant(tmp_path, f"best_model.npz.tmp-{HOST}-{dead_pid}")
    assert len(os.listdir(tmp_path)) > 1
    _save(path, last + 1)
    assert os.listdir(tmp_path) == ["best_model.npz"]
    assert _version(path) == last + 1


@pytest.mark.parametrize("form", ["host and pid", "pid only"])
def test_a_dead_writers_temporary_is_removed(tmp_path, dead_pid, form):
    """``<path>.tmp-<host>-<pid>``, and ``<path>.tmp-<pid>`` (the name of
    earlier versions, counted as this host's), of a dead pid."""
    tag = f"{HOST}-{dead_pid}" if form == "host and pid" else str(dead_pid)
    _plant(tmp_path, f"best_model.npz.tmp-{tag}")
    _save(str(tmp_path / "best_model.npz"), 7)
    assert os.listdir(tmp_path) == ["best_model.npz"]


@pytest.mark.parametrize("kind", ["live process", "other host", "own pid",
                                  "other path"])
def test_temporaries_that_are_not_a_dead_writers_of_the_path_stay(
        tmp_path, dead_pid, live_pid, kind):
    kept = _plant(tmp_path, {
        "live process": f"best_model.npz.tmp-{HOST}-{live_pid}",
        "other host": f"best_model.npz.tmp-other-host-{dead_pid}",
        # a name of earlier versions: this process's new temporary has
        # the host in it, so the two do not collide
        "own pid": f"best_model.npz.tmp-{os.getpid()}",
        "other path": f"final_model.npz.tmp-{HOST}-{dead_pid}",
    }[kind])
    _save(str(tmp_path / "best_model.npz"), 3)
    assert sorted(os.listdir(tmp_path)) == sorted(["best_model.npz", kept])


def test_the_helper_parses_host_names_from_the_right(tmp_path, dead_pid,
                                                     live_pid, monkeypatch):
    """Host names hold ``-`` and ``.``; a suffix after the pid (a build's
    ``.<stem>.o``) belongs to the temporary."""
    monkeypatch.setattr(interop.socket, "gethostname",
                        lambda: "node-7.cluster-a")
    gone = [f"x.npz.tmp-node-7.cluster-a-{dead_pid}",
            f"x.npz.tmp-node-7.cluster-a-{dead_pid}.conv_blocks.o",
            f"x.npz.tmp-{dead_pid}"]
    kept = [f"x.npz.tmp-node-7-{dead_pid}",
            f"x.npz.tmp-cluster-a-{dead_pid}",
            f"x.npz.tmp-node-7.cluster-a-{live_pid}",
            f"x.npz.tmp-node-7.cluster-a-{os.getpid()}",
            "x.npz.tmp-node-7.cluster-a-notapid",
            "x.npz"]
    for name in gone + kept:
        _plant(tmp_path, name)
    removed = interop.clear_dead_temporaries(str(tmp_path), "x.npz.tmp-")
    assert sorted(removed) == sorted(gone)
    assert sorted(os.listdir(tmp_path)) == sorted(kept)


def _raise_oserror(f):
    f.write(b"part of the file")
    raise OSError(28, "No space left on device")


def _raise_pickling(f):
    torch.save({"w": torch.ones(3), "fn": lambda: None}, f)


@pytest.mark.parametrize("failure", ["write", "pickling", "fsync"])
def test_a_failed_write_leaves_no_temporary_and_the_previous_file(
        tmp_path, monkeypatch, failure):
    path = str(tmp_path / "best_model.npz")
    _save(path, 1)
    write = {"write": _raise_oserror, "pickling": _raise_pickling,
             "fsync": lambda f: f.write(b"the new file")}[failure]
    if failure == "fsync":
        def fsync(fd):
            raise OSError(5, "Input/output error")
        monkeypatch.setattr(interop.os, "fsync", fsync)
    with pytest.raises((OSError, pickle.PicklingError, AttributeError)):
        interop.write_durably(path, write)
    monkeypatch.undo()
    assert os.listdir(tmp_path) == ["best_model.npz"]
    assert _version(path) == 1


def test_a_bundle_on_the_writer_clears_orphans_on_the_writer_thread(
        tmp_path, dead_pid, monkeypatch):
    path = str(tmp_path / "last_model.pt")
    _plant(tmp_path, f"last_model.pt.tmp-{HOST}-{dead_pid}")
    threads = []
    clear = interop.clear_dead_temporaries

    def recorded(directory, prefix):
        threads.append(threading.current_thread())
        return clear(directory, prefix)

    monkeypatch.setattr(interop, "clear_dead_temporaries", recorded)
    checkpoints.save_bundle(path, {"step": 4, "w": torch.arange(6.0)},
                            async_save=True)
    checkpoints.wait_for_saves()
    assert os.listdir(tmp_path) == ["last_model.pt"]
    assert checkpoints.load_bundle(path)["step"] == 4
    assert threads and threading.main_thread() not in threads


def test_jax_and_the_port_clear_a_dead_writers_orphans_alike(tmp_path,
                                                              dead_pid):
    """Both saves clear what a dead process left beside the path; where the
    writer is alive JAX's clears its swap too and the port's keeps it."""
    from freesound_classification_tpu.training import checkpoints as jax_ck

    def write_dir(tmp):
        os.makedirs(tmp)
        open(os.path.join(tmp, "state"), "w").close()

    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    os.makedirs(jax_dir / f"ckpt.swap-{dead_pid}-1")
    _plant(port_dir, f"best_model.npz.tmp-{HOST}-{dead_pid}")
    jax_ck._swap_into_place(write_dir, str(jax_dir / "ckpt"))
    _save(str(port_dir / "best_model.npz"), 2)
    assert os.listdir(jax_dir) == ["ckpt"]
    assert os.listdir(port_dir) == ["best_model.npz"]

    live = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(120)"])
    try:
        os.makedirs(jax_dir / f"ckpt.swap-{live.pid}-1")
        kept = _plant(port_dir, f"best_model.npz.tmp-{HOST}-{live.pid}")
        jax_ck._swap_into_place(write_dir, str(jax_dir / "ckpt"))
        _save(str(port_dir / "best_model.npz"), 3)
    finally:
        live.kill()
        live.wait(timeout=60)
    assert os.listdir(jax_dir) == ["ckpt"]
    assert sorted(os.listdir(port_dir)) == ["best_model.npz", kept]


FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
if {fail} and "-c" in args:
    sys.exit(1)
with open(args[args.index("-o") + 1], "w") as f:
    f.write("built")
"""


@pytest.mark.parametrize("fail", [False, True])
def test_a_build_clears_a_killed_builds_temporaries(tmp_path, dead_pid,
                                                    live_pid, monkeypatch,
                                                    fail):
    """``build.build`` with a stand-in ``nvcc`` (no toolkit needed): a dead
    build's library and objects go before it compiles, a live build's
    stay, and the build leaves its library and log and no temporary of its
    own, or, where nvcc fails, nothing of its own."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, fail=fail))
    nvcc.chmod(0o755)
    out = tmp_path / "build"
    out.mkdir()
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    dead = f"libfsc_kernels_0123456789abcdef.so.tmp-{HOST}-{dead_pid}"
    live = f"libfsc_kernels_0123456789abcdef.so.tmp-{HOST}-{live_pid}"
    kept = [_plant(out, live), _plant(out, f"{live}.mel_log.o")]
    for name in (dead, f"{dead}.mel_log.o", f"{dead}.conv_blocks.o"):
        _plant(out, name)
    lib = build.library_path(str(nvcc))
    if fail:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            build.build()
        assert sorted(os.listdir(out)) == sorted(kept)
    else:
        assert build.build() == lib
        assert sorted(os.listdir(out)) == sorted(
            kept + [lib.name, lib.with_suffix(".log").name])
