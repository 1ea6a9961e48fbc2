"""Elastic resume, on the CPU: a bundle written at one number of ranks, or
under one fold layout, resumes at any other, as the JAX package's
mesh-independent checkpoints do (``training/checkpoints.py`` saves host
arrays and ``restore_state`` takes the current shardings;
``MultiFoldEngine.fit`` writes one bundle of all folds and re-shards it).

- (a) the single-fold engine in float64, 2 ranks -> 1 process and 1
  process -> 2 ranks, against the uninterrupted run;
- (b) the same in float32 against JAX's uninterrupted ``Engine``;
- (c) fold parallel, 4 folds written on 2 ranks (2 x 1) and resumed in 1
  process, 3 folds written in 1 process and resumed on 2 ranks (1 x 2),
  against JAX's uninterrupted ``MultiFoldEngine``;
- (d) with augmentation: a same-width resume is bit for bit, and two
  resumes of one bundle at a new width are bit-identical
  (``mesh.resume_seed``);
- (e) a 2-group job killed between its gather and its rename, and
  between two epochs' saves, resumes from its last whole epoch;
- the seed rule, and the bundles of earlier versions of the port.

Ranks are processes of ``tests/_dp_worker.py`` or
``tests/_fold_mesh_worker.py`` (a gloo group over a ``file://``
rendezvous, one thread each); every wait has a timeout.
"""

import glob
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import jax

from freesound_classification_tpu.models.classifiers import (
    TwoDimensionalCNN as JaxCNN,
)
from freesound_classification_tpu.parallel import mesh as jmesh
from freesound_classification_tpu.training.engine import Engine as JaxEngine
from freesound_classification_tpu.training.multifold import (
    MultiFoldEngine as JaxMultiFoldEngine,
    _stack_batches,
    make_fold_dp_mesh,
)
import torch

import _dp_worker as dp_worker
import _fold_mesh_worker as fm_worker
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.models.classifiers import (
    TwoDimensionalCNN,
)
from freesound_classification_tpu_torch.parallel import mesh as mesh_lib
from freesound_classification_tpu_torch.training import (
    checkpoints,
    multifold,
)
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.training.multifold import (
    MultiFoldEngine,
)
from tests.test_torch_data_parallel import _feature_batches
from tests.test_torch_fold_mesh import (
    _child_env,
    _fold_batches,
    _leaves,
    _spectrogram_fold_batches,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP_WORKER = os.path.join(REPO, "tests", "_dp_worker.py")
FM_WORKER = os.path.join(REPO, "tests", "_fold_mesh_worker.py")
N_CLASSES = 4


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


def launch(tmp_path, name, worker, case, inputs, world=2, killed=False,
           timeout=150):
    """Run ``case`` of ``worker`` on ``world`` gloo ranks; every rank's
    result, in rank order. With ``killed`` rank 0 must die with
    ``fm_worker.KILLED`` (a kill point of ``_fold_mesh_worker._fit``);
    the other ranks are then killed, as ``torchrun`` does, and each
    rank's results written before the kill are returned. A rank that
    fails otherwise, or outlives ``timeout`` seconds, fails the test."""
    d = tmp_path / name
    d.mkdir()
    torch.save(dict(inputs, out_dir=str(d)), d / "inputs.pt")
    procs, logs = [], []
    for r in range(world):
        logs.append(open(d / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, worker, case, str(r), str(world),
             str(d / "rendezvous"), str(d / "inputs.pt"), str(d)],
            stdout=logs[-1], stderr=subprocess.STDOUT, env=_child_env()))
    deadline = time.monotonic() + timeout
    try:
        for p in procs[:1] if killed else procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the ranks of {name!r} did not end in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    want = [fm_worker.KILLED] if killed else [0] * world
    for r, p in enumerate(procs[:len(want)]):
        assert p.returncode == want[r], (d / f"rank{r}.log").read_text()[
            -4000:]
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _same(got: dict, want: dict) -> None:
    for name, t in want.items():
        assert torch.equal(got[name], t), name


# ---------------------------------------------------------------------------
# the seed rule
# ---------------------------------------------------------------------------


def test_resume_seed_is_deterministic_and_no_fresh_runs():
    """``resume_seed`` gives one 64-bit seed a key, the same on every call;
    every id and the step change it, and none of the seeds of a fresh
    run (``seed + k + RANK_SEED_STRIDE * j``) is drawn. An engine resumed
    at another world size seeds its augmenter and dropout with it."""
    seeds = {mesh_lib.resume_seed(7, k, j, global_step=s)
             for k in range(5) for j in range(4) for s in (1, 9, 10**6)}
    assert len(seeds) == 5 * 4 * 3
    assert mesh_lib.resume_seed(7, 3, 1, global_step=9) == \
        mesh_lib.resume_seed(7, 3, 1, global_step=9)
    assert mesh_lib.resume_seed(7, 1, global_step=9) != \
        mesh_lib.resume_seed(8, 1, global_step=9)
    fresh = {7 + k + mesh_lib.RANK_SEED_STRIDE * j
             for k in range(5) for j in range(4)}
    assert not seeds & fresh
    assert all(0 <= s < 2 ** 64 for s in seeds)
    engine = Engine(torch.nn.Linear(2, 2), None, types.SimpleNamespace(),
                    seed=7, device="cpu")
    with torch.random.fork_rng(devices=[]):
        engine.reseed(mesh_lib.resume_seed(7, 0, global_step=3))
        a = torch.rand(4, generator=engine.generator)
        b = torch.rand(4)
        engine.reseed(mesh_lib.resume_seed(7, 0, global_step=3))
        assert torch.equal(torch.rand(4, generator=engine.generator), a)
        assert torch.equal(torch.rand(4), b)


# ---------------------------------------------------------------------------
# (a), (b) the single-fold engine at another world size
# ---------------------------------------------------------------------------


def _dp_cfg(optimizer, lr):
    """Accumulation 2 over 3 batches an epoch: the bundle of epoch 0 holds
    a partial gradient mean."""
    return dict(optimizer=optimizer, learning_rate=lr,
                scheduler=f"1cycle_{lr / 10:g}_{lr:g}", weight_decay=0.0,
                accumulation_steps=2, switch_off_augmentations_on=100,
                _save_every=1000)


def _dp_inputs(state, cfg, dtype):
    """3 global batches of 8 rows an epoch and one of 8 to validate: even
    rows, so that no width pads a row into BatchNorm's statistics."""
    npd = np.float64 if dtype == torch.float64 else np.float32
    return {"state": state, "cfg": cfg, "dtype": dtype,
            "n_classes": N_CLASSES,
            "batches": _feature_batches(b=8, seed=2, dtype=npd),
            "valid": _feature_batches(n=1, b=8, seed=5, dtype=npd)}


def _elastic_runs(tmp_path, inp):
    """The resumed runs at the other width: a bundle of 1 process resumed
    on 2 ranks (each rank's result), and one of 2 ranks resumed in 1
    process; with the rank each ran as."""
    dp_worker.case_elastic(None, dict(inp, runs=[
        {"root": str(tmp_path / "one"), "stop": 1}]))
    ranks = launch(tmp_path, "ranks", DP_WORKER, "elastic", dict(inp, runs=[
        {"root": str(tmp_path / "one"), "resume": True},
        {"root": str(tmp_path / "two"), "stop": 1}]))
    alone, = dp_worker.case_elastic(None, dict(inp, runs=[
        {"root": str(tmp_path / "two"), "resume": True}]))
    assert all(r[1] is None for r in ranks)
    return [(r, ranks[r][0]) for r in range(2)] + [(0, alone)]


def test_single_fold_resume_at_another_width_equals_the_straight_run(
        tmp_path):
    """Momentum at lr 1e-2 in float64, augmentation off, 2 epochs of 3
    batches with accumulation 2: the bundle of epoch 0 written by 2 ranks resumed
    in 1 process, and that of 1 process resumed on 2 ranks, end with the
    uninterrupted run's weights and BatchNorm statistics, its epoch 1
    losses and both epochs' scores within 1e-10 (the tolerance of
    ``test_two_ranks_equal_one_process_in_float64``); each resumed rank r
    drew its generators from ``resume_seed(7, r, 3)``."""
    params, stats = interop.random_jax_variables(
        **dp_worker.CFG, n_classes=N_CLASSES, seed=4)
    state = {k: v.double() if v.is_floating_point() else v
             for k, v in interop.from_jax_variables(params, stats).items()}
    inp = _dp_inputs(state, _dp_cfg("momentum", 1e-2), torch.float64)
    want, = dp_worker.case_elastic(None, dict(inp, runs=[
        {"root": str(tmp_path / "straight")}]))
    for rank, got in _elastic_runs(tmp_path, inp):
        assert got["global_step"] == want["global_step"] == 6
        assert got["seed"] == mesh_lib.resume_seed(7, rank, global_step=3)
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(got["losses"][0], want["losses"][1],
                                   rtol=0, atol=1e-10)
        for name, t in want["state"].items():
            np.testing.assert_allclose(got["state"][name].numpy(),
                                       t.numpy(), rtol=0, atol=1e-10,
                                       err_msg=name)
    moved = max((want["state"][k] - state[k]).abs().max().item()
                for k in state if state[k].is_floating_point())
    assert moved > 1e-4


def test_single_fold_resume_at_another_width_matches_jax_engine(tmp_path):
    """Momentum at lr 1e-4 in float32, 2 epochs of 3 batches with
    accumulation 2, from JAX's initial weights: both resumes of (a)
    against JAX's uninterrupted ``Engine``, at the tolerances of
    ``test_train_steps_match_jax_engine_on_a_mesh``: epoch 1's mean loss
    and both epochs' scores within 1e-4, every parameter within 1e-5 plus
    1e-2 of its largest move from the init, the BatchNorm statistics
    within 1e-4 relative with a 1e-5 floor."""
    cfg = _dp_cfg("momentum", 1e-4)
    inp = _dp_inputs(None, cfg, torch.float32)
    jaxe = JaxEngine(JaxCNN(**dp_worker.CFG, aggregation_type="max",
                            n_classes=N_CLASSES), dp_worker.unflatten,
                     types.SimpleNamespace(**cfg), loss="lsep_naive", seed=0)
    jaxe.make_optimizer(6, 3)
    jaxe.init_state(inp["batches"][0])
    params = jax.tree.map(np.asarray, jaxe.state.params)
    stats = jax.tree.map(np.asarray, jaxe.state.batch_stats)
    init = dict(_leaves(params))
    inp["state"] = interop.from_jax_variables(params, stats)
    want_losses, want_scores = [], []
    for epoch in range(2):
        want_losses.append(jaxe.train_epoch(inp["batches"], epoch,
                                            log_interval=100)["loss"])
        want_scores.append(jaxe.evaluate(inp["valid"]))
    want_p = dict(_leaves(jax.tree.map(np.asarray, jaxe.state.params)))
    want_s = dict(_leaves(jax.tree.map(np.asarray, jaxe.state.batch_stats)))
    moved = 0.0
    for _, got in _elastic_runs(tmp_path, inp):
        np.testing.assert_allclose(got["scores"], want_scores, rtol=0,
                                   atol=1e-4)
        assert float(np.mean(got["losses"][0])) == pytest.approx(
            want_losses[1], abs=1e-4)
        got_p, got_s = interop.to_jax_variables(got["state"])
        for name, value in _leaves(got_p):
            move = np.abs(want_p[name] - init[name]).max()
            assert np.abs(value - want_p[name]).max() <= 1e-5 + 1e-2 * move, \
                name
            moved = max(moved, move)
        for name, value in _leaves(got_s):
            np.testing.assert_allclose(value, want_s[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    assert moved > 1e-4


# ---------------------------------------------------------------------------
# (c) fold parallel under another layout
# ---------------------------------------------------------------------------


def _fold_cfg():
    return dict(optimizer="momentum", learning_rate=1e-4,
                scheduler="1cycle_1e-05_0.0001", weight_decay=0.0,
                accumulation_steps=1, switch_off_augmentations_on=100,
                _save_every=1000)


@pytest.mark.parametrize("sizes,write_world,read_world", [
    ((7, 5, 6, 8), 2, 1),  # 2 x 1 on 2 ranks, resumed in 1 process
    ((7, 5, 8), 1, 2),  # 1 process, resumed on 2 ranks: 1 x 2
])
def test_fold_parallel_resume_under_another_layout_matches_jax(
        tmp_path, sizes, write_world, read_world):
    """Folds of unequal rows (the largest even, so that the 1 x 2 group's
    rows need no pad of their own), 2 epochs of 2 momentum steps at lr 1e-4
    without augmentation (dropout 0) from JAX's fold states: epoch 0 and
    the job's one bundle written under one layout, epoch 1 resumed under
    the other, against JAX's uninterrupted ``MultiFoldEngine``. Each
    fold's parameters within 1e-5 + 1e-2 of each tensor's move, its
    BatchNorm statistics within 1e-4 relative with a 1e-5 floor
    (``test_ranks_match_jax_on_a_fold_data_layout``'s tolerances); the
    places of the 1 x 2 group hold the same states bit for bit."""
    n_folds = len(sizes)
    steps = _spectrogram_fold_batches(sizes, 2)
    cfg = _fold_cfg()
    template = JaxEngine(JaxCNN(**fm_worker.CFG, aggregation_type="max",
                                n_classes=N_CLASSES), fm_worker.unflatten,
                         types.SimpleNamespace(**cfg), loss="lsep_naive",
                         mesh=jmesh.make_mesh(1), seed=0)
    jaxm = JaxMultiFoldEngine(template, n_folds, mesh=make_fold_dp_mesh(
        n_folds, devices=jax.devices()[:1]))
    jaxm.make_optimizer(4, 2)
    jaxm.init_states(steps[0][0])
    init_p = jax.tree.map(np.asarray, jaxm.states.params)
    init_s = jax.tree.map(np.asarray, jaxm.states.batch_stats)
    for _ in range(2):
        for folds in steps:
            batch, n_real = _stack_batches(folds)
            device_batch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
            clean = (device_batch["signal"], device_batch["lengths"],
                     device_batch["labels"])
            jaxm.states, _, _ = jaxm._vmapped_step(
                jaxm.states, device_batch, 0.0, jax.numpy.asarray(n_real),
                clean)
    port = TwoDimensionalCNN(**fm_worker.CFG, aggregation_type="max",
                             n_classes=N_CLASSES)
    inp = {"folds": list(range(n_folds)), "cfg": cfg, "epochs": 2,
           "n_classes": N_CLASSES, "state": port.state_dict(),
           "stacked": interop.stack_jax_fold_states(init_p, init_s),
           "batches": [[step[k] for step in steps] for k in range(n_folds)],
           "valid": [dict(steps[0][k], index=np.arange(sizes[k]))
                     for k in range(n_folds)]}
    root = str(tmp_path / "job")

    def run(world, **kw):
        if world == 1:
            return [fm_worker.case_fit(None, dict(inp, runs=[
                dict(root=root, **kw)]))[0]]
        return [r[0] for r in launch(tmp_path, "ranks", FM_WORKER, "fit",
                                     dict(inp, runs=[dict(root=root, **kw)]))]

    run(write_world, stop=1)
    bundle = checkpoints.load_bundle(os.path.join(root, "checkpoints",
                                                  multifold.BUNDLE))
    assert bundle["meta"]["epoch"] == 0 and bundle["folds"] == inp["folds"]
    assert all(len(t) == n_folds for t in bundle["model"].values())
    ranks = run(read_world, resume=True)
    got = {}
    for r in ranks:
        assert r["global_step"] == 4
        for fold, g in r["folds"].items():
            if fold in got:  # the other place of the 1 x 2 group
                _same(g["state"], got[fold]["state"])
            got[fold] = g
    assert sorted(got) == inp["folds"]
    want_p = dict(_leaves(jax.tree.map(np.asarray, jaxm.states.params)))
    want_s = dict(_leaves(jax.tree.map(np.asarray, jaxm.states.batch_stats)))
    init = dict(_leaves(init_p))
    moved = 0.0
    for k, g in got.items():
        stacked = {n: t[None] for n, t in g["state"].items()}
        got_p, got_s = interop.unstack_jax_fold_states(stacked)
        for name, value in _leaves(got_p):
            move = np.abs(want_p[name][k] - init[name][k]).max()
            err = np.abs(value[0] - want_p[name][k]).max()
            assert err <= 1e-5 + 1e-2 * move, (name, k, err, move)
            moved = max(moved, move)
        for name, value in _leaves(got_s):
            np.testing.assert_allclose(value[0], want_s[name][k], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    assert moved > 1e-5


# ---------------------------------------------------------------------------
# (d) augmented resumes, (e) kills
# ---------------------------------------------------------------------------


def _augmented_inputs():
    """Folds 0 and 1 (6 and 5 clips a batch, 2 batches) of waves through
    the frontend, the chain and chunk shuffle, Adam at lr 1e-3 (its three
    moments a fold in the bundle), on 2 ranks the 2 x 1 layout."""
    batches = _fold_batches((6, 5), (2, 2), seed=4)
    port = TwoDimensionalCNN(**fm_worker.CFG, aggregation_type="max",
                             n_classes=N_CLASSES)
    cfg = dict(_fold_cfg(), optimizer="adam", learning_rate=1e-3,
               scheduler="1cycle_0.0001_0.001")
    return {"folds": [0, 1], "cfg": cfg, "epochs": 2, "waves": True,
            "augment": True, "n_classes": N_CLASSES,
            "state": port.state_dict(), "batches": batches,
            "valid": [b[0] for b in batches]}


def test_augmented_resumes_repeat_at_the_same_and_at_a_new_width(tmp_path):
    """With the chain and chunk shuffle, 2 epochs on 2 ranks (2 x 1):
    stopped before epoch 1 and resumed on the 2 ranks, each rank ends with
    the straight run's folds bit for bit (each place's generators from
    the bundle); the same bundle (a second stopped run's, bit for bit the
    first's) resumed twice in 1 process gives two bit-identical runs,
    whose generators fold k drew from ``resume_seed(7, k, 0, 2)``, and
    which part from the straight run (other draws)."""
    inp = _augmented_inputs()
    root = {name: str(tmp_path / name) for name in ("s", "w", "x", "y")}
    ranks = launch(tmp_path, "ranks", FM_WORKER, "fit", dict(inp, runs=[
        {"root": root["s"]}, {"root": root["w"], "stop": 1},
        {"root": root["x"], "stop": 1},
        {"root": root["w"], "resume": True}]))
    for straight, _, _, resumed in ranks:
        assert resumed["seeds"] == straight["seeds"]
        for fold, want in straight["folds"].items():
            _same(resumed["folds"][fold]["state"], want["state"])
    shutil.copytree(root["x"], root["y"])
    first, second = fm_worker.case_fit(None, dict(inp, runs=[
        {"root": root["x"], "resume": True},
        {"root": root["y"], "resume": True}]))
    assert first["seeds"] == second["seeds"] == [
        mesh_lib.resume_seed(7, k, 0, global_step=2) for k in (0, 1)]
    straight = {**ranks[0][0]["folds"], **ranks[1][0]["folds"]}
    for fold in (0, 1):
        _same(second["folds"][fold]["state"], first["folds"][fold]["state"])
        assert any(not torch.equal(t, straight[fold]["state"][n]) for n, t
                   in first["folds"][fold]["state"].items())


def test_a_killed_fold_parallel_job_resumes_from_its_last_whole_epoch(
        tmp_path):
    """A 2-group job (2 x 1 on 2 ranks, the chain and chunk shuffle on)
    whose rank 0 dies as by SIGKILL between its gather and its rename of
    epoch 1's bundle, and another that dies between epoch 0's save and
    epoch 1's: each leaves the bundle of epoch 0 (the first also the
    epoch 1 bundle's temporary file), and ``resume`` on the 2 ranks ends
    with the straight run's folds bit for bit. (Before the one bundle,
    each fold group published its own bundle in a rename of its own; a
    kill between two groups' renames left bundles of two epochs, which
    ``resume`` refused on every later try.)"""
    inp = _augmented_inputs()
    root = {name: str(tmp_path / name) for name in ("s", "k1", "k2")}
    first = launch(tmp_path, "kill_rename", FM_WORKER, "fit", dict(inp, runs=[
        {"root": root["s"]}, {"root": root["k1"], "kill": "rename"}]),
        killed=True)
    straight = [r[0] for r in first]

    def bundle_epoch(name):
        return checkpoints.load_bundle(os.path.join(
            root[name], "checkpoints", multifold.BUNDLE))["meta"]["epoch"]

    assert bundle_epoch("k1") == 0
    assert glob.glob(os.path.join(root["k1"], "checkpoints",
                                  multifold.BUNDLE + ".tmp-*"))
    second = launch(tmp_path, "kill_epoch", FM_WORKER, "fit", dict(inp, runs=[
        {"root": root["k1"], "resume": True},
        {"root": root["k2"], "kill": "epoch"}]), killed=True)
    assert bundle_epoch("k2") == 0
    third = launch(tmp_path, "resume", FM_WORKER, "fit", dict(inp, runs=[
        {"root": root["k2"], "resume": True}]))
    for r in range(2):
        for resumed in (second[r][0], third[r][0]):
            assert resumed["global_step"] == straight[r]["global_step"]
            for fold, want in straight[r]["folds"].items():
                _same(resumed["folds"][fold]["state"], want["state"])


# ---------------------------------------------------------------------------
# bundles of earlier versions
# ---------------------------------------------------------------------------


def _stack(root):
    """A two-fold stacked engine on the CPU, its optimizer made."""
    cfg = types.SimpleNamespace(optimizer="adam", learning_rate=1e-3,
                                scheduler="1cycle_0.0001_0.001",
                                weight_decay=0.0, accumulation_steps=1)
    model = TwoDimensionalCNN(**fm_worker.CFG, aggregation_type="max",
                              n_classes=N_CLASSES)
    stack = MultiFoldEngine(Engine(model, None, cfg, checkpoint_dir=root,
                                   seed=7, device="cpu"), [0, 1])
    stack.make_optimizer(4, 2)
    return stack


def test_bundles_of_earlier_versions(tmp_path):
    """A one-process bundle of the earlier format (no ``folds``, no
    ``layout``, a generator state a fold, one dropout state) loads whole
    and takes back its generators; a directory with only per-group
    bundles (``multifold_resume_folds_<ids>.pt``) is refused, naming
    them."""
    root = str(tmp_path / "old")
    stack = _stack(root)
    with torch.no_grad():
        for t in stack.model.state_dict().values():
            t.fill_(3)
    gens = [torch.Generator().manual_seed(100 + k) for k in (0, 1)]
    dropout = torch.Generator().manual_seed(55).get_state()
    checkpoints.save_bundle(os.path.join(root, multifold.BUNDLE), {
        "model": stack.model.state_dict(),
        "optimizer": stack.optimizer.state_dict(), "accumulated": None,
        "micro_step": 0, "updates": 2, "global_step": 2,
        "augment_rng": gens[0].get_state(), "dropout_rng": dropout,
        "fold_augment_rngs": [g.get_state() for g in gens],
        "loader_epochs": [1, 2],
        "meta": {"epoch": 0, "best": [0.5, 0.25], "global_step": 2}})
    fresh = _stack(root)
    loaders = [types.SimpleNamespace(_epoch=0) for _ in range(2)]
    with torch.random.fork_rng(devices=[]):
        meta = fresh.load_stacked_bundle(loaders)
        assert torch.equal(torch.get_rng_state(), dropout)
    assert meta["best"] == [0.5, 0.25] and fresh.global_step == 2
    assert [loader._epoch for loader in loaders] == [1, 2]
    for name, t in fresh.model.state_dict().items():
        assert (t == 3).all(), name
    assert [g.initial_seed() for g in fresh.generators] == [100, 101]

    grouped = str(tmp_path / "grouped")
    os.makedirs(grouped)
    for name in ("multifold_resume_folds_0.pt", "multifold_resume_folds_1.pt"):
        open(os.path.join(grouped, name), "wb").close()
    with pytest.raises(ValueError, match=(
            r"only per-group stacked bundles \(multifold_resume_folds_0\.pt, "
            r"multifold_resume_folds_1\.pt\)")):
        _stack(grouped).load_stacked_bundle(loaders)
