"""The port's asynchronous checkpoint writer (``training/checkpoints.py``)
against the JAX package's, on the CPU.

No case depends on timing: where a case needs the writer to hold its
queue, it enqueues a ``threading.Event``'s wait through
``write_after_saves`` (``_gate``), so that what is enqueued after it is
still in flight until the case lets it go.
"""

import contextlib
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import common
from freesound_classification_tpu_torch.data import audio_io
from freesound_classification_tpu_torch.data.dataset import ClipDataset
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops.augment import (
    AugmentConfig,
    make_augmenter,
)
from freesound_classification_tpu_torch.training import checkpoints
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.training.state import create_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 44100
N_CLASSES = 4
CFG = dict(num_conv_blocks=2, start_deep_supervision_on=0,
           conv_base_depth=8, growth_rate=1.5)
GATE_TIMEOUT = 60  # seconds a held writer waits at most


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


@pytest.fixture(autouse=True)
def _drained():
    """Every case starts and ends with an empty writer and no error."""
    checkpoints.wait_for_saves()
    yield
    checkpoints.wait_for_saves()


@contextlib.contextmanager
def _gate():
    """Inside the block the writer is held: what is enqueued there stays
    in flight until the block ends."""
    gate = threading.Event()
    checkpoints.write_after_saves(lambda: gate.wait(GATE_TIMEOUT))
    try:
        yield
    finally:
        gate.set()


def _model(seed=5):
    net = types.SimpleNamespace(**CFG, aggregation_type="max",
                                output_dropout=0.0)
    return create_model(net, N_CLASSES, torch.float32, seed, "cpu")


def _adam_step(model, opt, seed):
    """One Adam step of ``model`` on a random batch of 2 (32 bands x 40
    frames); the batch statistics move too."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 32, 40, 1, generator=gen)
    model.train()
    logits = model(x, torch.tensor([40, 31]))
    opt.zero_grad()
    logits.pow(2).mean().backward()
    opt.step()


def _copy(tree):
    return {k: v.clone() for k, v in tree.items()}


def _same(got: dict, want: dict) -> bool:
    return got.keys() == want.keys() and all(
        torch.equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# the snapshot
# ---------------------------------------------------------------------------


def test_snapshot_owns_its_memory_and_keeps_the_containers():
    """Each tensor is copied once into memory of its own (a tensor that
    appears twice stays one tensor), dicts keep their type and a
    ``state_dict``'s ``_metadata``, lists and tuples theirs."""
    model = _model()
    sd = model.state_dict()
    w = sd["blocks.0.conv.weight"]
    obj = {"model": sd, "again": w, "pair": (w, 3), "rows": [1.5, "x"],
           "meta": {"epoch": 2}}
    snap = checkpoints.snapshot(obj)
    assert type(snap["model"]) is type(sd)
    assert snap["model"]._metadata == sd._metadata
    for name, t in sd.items():
        got = snap["model"][name]
        assert torch.equal(got, t) and not got.requires_grad
        assert (got.untyped_storage().data_ptr()
                != t.untyped_storage().data_ptr())
    assert snap["again"] is snap["model"]["blocks.0.conv.weight"]
    assert type(snap["pair"]) is tuple and snap["pair"][0] is snap["again"]
    assert snap["rows"] == [1.5, "x"] and snap["meta"] == {"epoch": 2}
    assert snap["meta"] is not obj["meta"]


def test_async_saves_hold_the_values_of_the_save_not_of_the_next_step(
        tmp_path):
    """An async ``save_model`` and ``save_bundle`` of a CPU model and its
    Adam state, then at once an in-place optimizer step while the writes
    are held: both files load back the values before the step, bit for
    bit (a save that kept ``state_dict``'s live tensors, or ``.numpy()``
    views of them, would write the step's)."""
    model = _model()
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    _adam_step(model, opt, 0)
    npz, pt = str(tmp_path / "best_model.npz"), str(tmp_path / "last.pt")
    want_model = _copy(model.state_dict())
    want_opt = {i: _copy(s) for i, s in opt.state_dict()["state"].items()}
    with _gate():
        checkpoints.save_model(npz, model)
        checkpoints.save_bundle(pt, {"model": model.state_dict(),
                                     "optimizer": opt.state_dict()})
        _adam_step(model, opt, 1)
        assert not _same(model.state_dict(), want_model)
    fresh = _model(seed=9)
    checkpoints.load_model(npz, fresh)
    assert _same(fresh.state_dict(), want_model)
    bundle = checkpoints.load_bundle(pt)
    assert _same(bundle["model"], want_model)
    for i, state in want_opt.items():
        assert _same(bundle["optimizer"]["state"][i], state)


# ---------------------------------------------------------------------------
# order and pruning
# ---------------------------------------------------------------------------


def test_write_after_saves_sees_every_earlier_file_whole(tmp_path):
    """A callback enqueued after a model, a bundle and a second model
    finds all three on disk whole, with the values they were saved with,
    and no temporary file beside them."""
    model = _model()
    paths = [str(tmp_path / "a" / "m1.npz"), str(tmp_path / "b" / "r.pt"),
             str(tmp_path / "a" / "m2.npz")]
    seen = []

    def look():
        with np.load(paths[0]) as data:
            seen.append(dict(data))
        seen.append(torch.load(paths[1], weights_only=True))
        with np.load(paths[2]) as data:
            seen.append(dict(data))
        seen.append(sorted(os.listdir(tmp_path / "a"))
                    + sorted(os.listdir(tmp_path / "b")))

    with _gate():
        checkpoints.save_model(paths[0], model)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
        checkpoints.save_bundle(paths[1], {"w": torch.arange(4.0),
                                           "meta": {"epoch": 3}})
        checkpoints.save_model(paths[2], model)
        checkpoints.write_after_saves(look)
    checkpoints.wait_for_saves()
    first, bundle, second, names = seen
    key = "params/block0/conv/kernel"
    np.testing.assert_array_equal(second[key], first[key] + 1.0)
    assert torch.equal(bundle["w"], torch.arange(4.0))
    assert bundle["meta"] == {"epoch": 3}
    assert names == ["m1.npz", "m2.npz", "r.pt"]


@pytest.mark.parametrize("save_every,keep", [(1, 2), (2, 2), (1, 0)])
def test_pruning_on_the_writer_keeps_what_jax_keeps(tmp_path, save_every,
                                                    keep):
    """Seven epochs of periodic saves, each followed by the pruning
    through ``write_after_saves``, and a best model on some epochs: the
    port leaves the ``model_on_epoch_N`` of JAX's writer
    (``checkpoints.save_state`` + ``write_after_saves
    (prune_epoch_checkpoints)`` + ``wait_for_saves``), and the best model
    beside them."""
    import jax.numpy as jnp

    from freesound_classification_tpu.training import checkpoints as jckpt

    model = _model()
    state = {"w": jnp.zeros((3,), jnp.float32)}
    roots = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    for epoch in range(7):
        if epoch % save_every == 0:
            jckpt.save_state(os.path.join(roots["jax"],
                                          f"model_on_epoch_{epoch}"), state)
            jckpt.write_after_saves(
                lambda d=roots["jax"]: jckpt.prune_epoch_checkpoints(d, keep))
            checkpoints.save_model(os.path.join(
                roots["port"], f"model_on_epoch_{epoch}.npz"), model)
            checkpoints.write_after_saves(
                lambda d=roots["port"]: checkpoints.prune_epoch_checkpoints(
                    d, keep))
        if epoch in (0, 3):
            jckpt.save_state(os.path.join(roots["jax"], "best_model"), state)
            checkpoints.save_model(os.path.join(roots["port"],
                                                "best_model.npz"), model)
    jckpt.wait_for_saves()
    checkpoints.wait_for_saves()
    want = sorted(os.listdir(roots["jax"]))
    assert sorted(os.listdir(roots["port"])) == [f"{n}.npz" for n in want]
    assert "best_model" in want and len(want) == 1 + (
        len(range(0, 7, save_every)) if keep == 0 else keep)


def test_concurrent_submitters_start_one_writer_and_keep_each_order(
        monkeypatch):
    """24 threads (more than the cores) race to the first submission of
    a fresh writer, with the interpreter switching threads every
    microsecond, then each enqueues 50 callbacks: one writer thread
    starts, every callback runs once, and each thread's run in the order
    it enqueued them."""
    monkeypatch.setattr(checkpoints, "_QUEUE", None)
    n_threads, n_calls = 24, 50
    ran = []
    start = threading.Barrier(n_threads)

    def submit(t):
        start.wait(timeout=GATE_TIMEOUT)
        for i in range(n_calls):
            checkpoints.write_after_saves(lambda t=t, i=i: ran.append((t, i)))

    def writers():
        return [th for th in threading.enumerate()
                if th.name == "ckpt-writer"]

    before = set(writers())
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submit, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=GATE_TIMEOUT)
        assert not any(th.is_alive() for th in threads)
        checkpoints.wait_for_saves()
    finally:
        sys.setswitchinterval(interval)
    assert len(set(writers()) - before) == 1
    assert sorted(ran) == [(t, i) for t in range(n_threads)
                           for i in range(n_calls)]
    for t in range(n_threads):
        assert [i for u, i in ran if u == t] == list(range(n_calls))


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------


def test_a_writer_error_surfaces_at_the_next_drain_and_load(tmp_path):
    """A save under a parent that is a file fails on the writer, not on
    the caller; the next ``wait_for_saves`` raises it, as JAX's does. A
    second such failure is raised by the next load instead, and then
    saves and loads work again."""
    model = _model()
    blocker = tmp_path / "blocker"
    blocker.write_text("a file, not a directory")
    checkpoints.save_model(str(blocker / "best_model.npz"), model)
    with pytest.raises(OSError):
        checkpoints.wait_for_saves()
    checkpoints.wait_for_saves()  # raised once

    good = str(tmp_path / "fold_0" / "last_model.pt")
    checkpoints.save_bundle(good, {"w": torch.ones(2)}, async_save=False)
    checkpoints.save_bundle(str(blocker / "last_model.pt"),
                            {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        checkpoints.load_bundle(good)
    checkpoints.save_bundle(good, {"w": torch.full((2,), 7.0)})
    assert torch.equal(checkpoints.load_bundle(good)["w"],
                       torch.full((2,), 7.0))


def test_a_synchronous_save_raises_an_earlier_writer_error(tmp_path):
    """``async_save=False`` drains the queue first, so a pending writer
    error is raised there, before its own write; the write after it
    works."""
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    checkpoints.save_bundle(str(blocker / "b.pt"), {"w": torch.zeros(1)})
    path = str(tmp_path / "b.pt")
    with pytest.raises(OSError):
        checkpoints.save_bundle(path, {"w": torch.ones(1)}, async_save=False)
    assert not os.path.exists(path)
    checkpoints.save_bundle(path, {"w": torch.ones(1)}, async_save=False)
    assert os.path.isfile(path)


# ---------------------------------------------------------------------------
# loads wait
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loader", ["load_model", "load_fold_npz",
                                    "load_bundle"])
def test_a_load_waits_for_the_save_in_flight(tmp_path, loader):
    """Version 1 on disk, version 2 enqueued behind a held writer that a
    timer lets go: a load issued meanwhile returns version 2."""
    model = _model()
    path = str(tmp_path / ("m.pt" if loader == "load_bundle" else "m.npz"))

    def save(v, **kw):
        with torch.no_grad():
            model.blocks[0].conv.weight.fill_(v)
        if loader == "load_bundle":
            checkpoints.save_bundle(path, {"v": torch.tensor(v)}, **kw)
        else:
            checkpoints.save_model(path, model, **kw)

    def load():
        if loader == "load_bundle":
            return float(checkpoints.load_bundle(path)["v"])
        if loader == "load_fold_npz":
            params, _ = interop.load_fold_npz(path)
            return float(params["block0"]["conv"]["kernel"].flat[0])
        fresh = _model(seed=9)
        checkpoints.load_model(path, fresh)
        return float(fresh.blocks[0].conv.weight.detach().flatten()[0])

    save(1.0, async_save=False)
    gate = threading.Event()
    checkpoints.write_after_saves(lambda: gate.wait(GATE_TIMEOUT))
    save(2.0)
    timer = threading.Timer(0.2, gate.set)
    timer.start()
    try:
        assert load() == 2.0
    finally:
        gate.set()
        timer.cancel()


# ---------------------------------------------------------------------------
# kills
# ---------------------------------------------------------------------------


# "epochs" e = start + 1, start + 2, ...: each improving epoch (e % 3 == 0)
# saves best_model.npz asynchronously, then every epoch saves the bundle,
# whose meta names the epoch and the last improving one; every model array
# holds its epoch. Every rename sleeps 20 ms after it, so that kills land
# around the renames; READY comes once the first epoch's files are on disk
KILL_WORKER = """
import os, sys, time, types
import torch
sys.path.insert(0, sys.argv[2])
from freesound_classification_tpu_torch.training import checkpoints
from freesound_classification_tpu_torch.training.state import create_model
real = os.replace
def slow(a, b):
    real(a, b)
    time.sleep(0.02)
os.replace = slow
root, e = sys.argv[1], int(sys.argv[3])
net = types.SimpleNamespace(num_conv_blocks=2, start_deep_supervision_on=0,
                            conv_base_depth=8, growth_rate=1.5,
                            aggregation_type="max", output_dropout=0.0)
model, best = create_model(net, 4, torch.float32, 5, "cpu"), None
first = True
while True:
    e += 1
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.fill_(float(e))
    if e % 3 == 0 or best is None:
        best = e
        checkpoints.save_model(os.path.join(root, "best_model.npz"), model)
    checkpoints.save_bundle(os.path.join(root, "last_model.pt"), {
        "model": {"w": torch.full((64, 64), float(e))},
        "meta": {"epoch": e, "best_epoch": best}})
    if first:
        checkpoints.wait_for_saves()
        print("READY", flush=True)
        first = False
    if e % 50 == 0:
        checkpoints.wait_for_saves()  # keep the queue short
"""


def test_sigkill_during_async_saves_leaves_files_of_one_order(tmp_path):
    """Eight kills at random points of a loop of async best-model and
    bundle saves: after each, both files load whole; the bundle is never
    older than what the previous kill left; and the best model is never
    older than the last improving epoch at or before the bundle's epoch
    (the writer's FIFO: a bundle never lands before the best model of its
    epoch)."""
    root = str(tmp_path / "fold_0")
    rng = np.random.RandomState(0)
    last = 0
    for start in range(0, 8 * 100000, 100000):
        proc = subprocess.Popen(
            [sys.executable, "-c", KILL_WORKER, root, REPO, str(start)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            line = proc.stdout.readline().strip()
            assert line == "READY", line + proc.stdout.read()
            time.sleep(rng.uniform(0.05, 0.4))
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
        bundle = checkpoints.load_bundle(os.path.join(root, "last_model.pt"))
        epoch, best_epoch = bundle["meta"]["epoch"], bundle["meta"]["best_epoch"]
        assert (bundle["model"]["w"] == epoch).all()
        assert best_epoch <= epoch and epoch >= max(last, 1)
        params, stats = interop.load_fold_npz(os.path.join(root,
                                                           "best_model.npz"))
        values = {float(v) for tree in (params, stats)
                  for v in _arrays(tree)}
        assert len(values) == 1  # one save's, whole
        assert values.pop() >= best_epoch
        last = epoch
    assert last > 100000  # later workers saved too


def _arrays(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _arrays(v)
        else:
            yield from np.unique(v)


# ---------------------------------------------------------------------------
# a fit
# ---------------------------------------------------------------------------


def _clips(root, n=12, seed=1):
    rng = np.random.RandomState(seed)
    files, labels = [], []
    for i in range(n):
        m = int(rng.uniform(1.1, 1.6) * SR)
        t = np.arange(m) / SR
        audio = 0.3 * np.sin(2 * np.pi * (250 + 200 * (i % 4)) * t) \
            + 0.02 * rng.randn(m)
        path = os.path.join(root, f"clip{i:02d}.wav")
        audio_io.write_wav(path, audio, SR)
        files.append(path)
        labels.append(f"c{i % N_CLASSES}")
    return files, labels


def _fit(root, files, labels):
    """3 epochs of the port's engine with augmentation, head dropout and
    accumulation 2, every epoch's model saved and the newest 2 kept."""
    net = types.SimpleNamespace(**CFG, aggregation_type="max",
                                output_dropout=0.5)
    cfg = types.SimpleNamespace(
        optimizer="adam", learning_rate=3e-3, scheduler="1cycle_0.0003_0.003",
        weight_decay=0.0, accumulation_steps=2,
        switch_off_augmentations_on=100, _save_every=1, _keep_checkpoints=2)
    torch.manual_seed(7)
    engine = Engine(
        create_model(net, N_CLASSES, torch.float32, 7, "cpu"),
        Frontend("mel_512_256_32", "2d", sr=SR, device="cpu"), cfg,
        augment=make_augmenter(AugmentConfig(p_aug=0.5, p_shuffle=0.5)),
        checkpoint_dir=os.path.join(root, "checkpoints"), seed=7,
        device="cpu")
    classmap = {f"c{k}": k for k in range(N_CLASSES)}
    train = make_loader(ClipDataset(files, raw_labels=labels,
                                    classmap=classmap, max_audio_length=1,
                                    sr=SR, seed=3),
                        common.default_ladder(1), batch_size=4, train=True,
                        seed=5)
    valid = make_loader(ClipDataset(files[:6], raw_labels=labels[:6],
                                    classmap=classmap, sr=SR),
                        common.default_ladder(None), batch_size=4)
    engine.fit_validate(train, valid, epochs=3, fold=0)
    engine.save_model(0, "final_model")
    fold_dir = os.path.join(root, "checkpoints", "fold_0")
    return {name: open(os.path.join(fold_dir, name), "rb").read()
            for name in os.listdir(fold_dir)}


def test_fit_through_the_writer_writes_the_synchronous_bytes(tmp_path,
                                                             monkeypatch):
    """``Engine.fit_validate`` with its saves on the writer and the same
    fit with ``ASYNC_SAVES`` off write the same files, byte for byte:
    the periodic models pruned to the newest 2, the best and final models
    and the resume bundle."""
    files, labels = _clips(str(tmp_path))
    got = _fit(str(tmp_path / "async"), files, labels)
    monkeypatch.setattr(checkpoints, "ASYNC_SAVES", False)
    want = _fit(str(tmp_path / "sync"), files, labels)
    assert sorted(got) == sorted(want) == [
        "best_model.npz", "final_model.npz", "last_model.pt",
        "model_on_epoch_1.npz", "model_on_epoch_2.npz"]
    for name, data in want.items():
        assert got[name] == data, name
