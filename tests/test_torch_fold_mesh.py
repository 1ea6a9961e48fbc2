"""Fold-parallel training over several ranks (``training/multifold.py``'s
``fold_layout`` and ``FoldMesh``; ROADMAP M5.2a, the layouts of data width
1; M5.2b's are ``tests/test_torch_fold_data_mesh.py``'s), on the CPU: every
layout against JAX's ``make_fold_dp_mesh``, two gloo
ranks against one process that stacks every fold and against JAX's
``MultiFoldEngine`` on a 2 x 1 (fold, data) mesh, and the train CLI under
``python -m torch.distributed.run --nproc_per_node 2 ... --fold_parallel``.

Multi-rank cases start processes of ``tests/_fold_mesh_worker.py`` (a gloo
group over a ``file://`` rendezvous under ``tmp_path``, one thread each)
or ``tests/_fold_mesh_cli.py`` under ``torch.distributed.run``; the
children import only the port, and every wait has a timeout, so a hung
collective fails its test. Dropout is 0 throughout: under
``vmap(randomness="different")`` a stack of K_local folds draws other
masks than a stack of K (ROADMAP Queue 3).
"""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

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

import _fold_mesh_worker as worker
from _cli_mesh import accepted_by_the_cli
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import train_2d_cnn
from freesound_classification_tpu_torch.models.classifiers import (
    TwoDimensionalCNN,
)
from freesound_classification_tpu_torch.parallel import mesh as mesh_lib
from freesound_classification_tpu_torch.training import multifold
from freesound_classification_tpu_torch.training.multifold import (
    fold_layout,
)
from tests.test_torch_hierarchical import _train_argv, _write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_fold_mesh_worker.py")
RANK_CLI = os.path.join(REPO, "tests", "_fold_mesh_cli.py")
N_CLASSES = 4
CLIP = 8192


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


def _child_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return env


def run_ranks(tmp_path, case, inputs, world=2, timeout=150):
    """Run ``case`` of the worker on ``world`` ranks; every rank's result,
    in rank order. A rank that fails or outlives ``timeout`` seconds fails
    the test with its output."""
    d = tmp_path / f"{case}_ranks"
    d.mkdir()
    torch.save(inputs, d / "inputs.pt")
    procs, logs = [], []
    for r in range(world):
        log = open(d / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, case, str(r), str(world),
             str(d / "rendezvous"), str(d / "inputs.pt"), str(d)],
            stdout=log, stderr=subprocess.STDOUT, env=_child_env()))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"the ranks of {case!r} did not end in {timeout} s")
    finally:
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (d / f"rank{r}.log").read_text()[-4000:]
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _train_cfg(optimizer, lr):
    return dict(optimizer=optimizer, learning_rate=lr,
                scheduler=f"1cycle_{lr / 10:g}_{lr:g}", weight_decay=0.0,
                accumulation_steps=1, switch_off_augmentations_on=100,
                _save_every=1000)


def _worst(got: dict, want: dict, names) -> float:
    """The largest |got - want| over ``names`` divided by the largest
    |want| among them."""
    top = max(float(want[n].abs().max()) for n in names)
    return max(float((got[n] - want[n]).abs().max()) for n in names) / top


# ---------------------------------------------------------------------------
# (a) the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_ranks", range(1, 9))
@pytest.mark.parametrize("n_folds", range(1, 6))
def test_layout_matches_jax_fold_dp_mesh(n_folds, n_ranks, monkeypatch):
    """``fold_layout(K, n)`` has the axis names and shape of JAX's
    ``make_fold_dp_mesh(K, devices[:n])`` (auto); on a (fold, data) mesh
    each rank's fold positions are the slice of the fold axis that JAX's
    ``P("fold")`` puts on the rank's device, and each rank's rows of a
    stacked batch (``FoldLayout.rows``) the slice of the row axis that
    ``P("fold", "data")`` puts there (fold-local: every fold, and the rows
    of ``P(None, "data")``). Every layout is accepted: the train CLI's
    ``--fold_parallel`` over K folds on n ranks makes its mesh, and
    ``make_fold_mesh`` gives each rank its folds, each fold held by d
    ranks."""
    devices = jax.devices()[:n_ranks]
    want = make_fold_dp_mesh(n_folds, devices=devices)
    got = fold_layout(n_folds, n_ranks)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == tuple(want.devices.shape)
    assert got.f * got.d == n_ranks
    rows = 3 * got.d
    spec = P("fold", "data") if got.kind == "fold_dp" else P(None, "data")
    slices = NamedSharding(want, spec).devices_indices_map((n_folds, rows))
    for rank, device in enumerate(devices):
        assert (got.positions(rank)
                == range(n_folds)[slices[device][0]]), rank
        assert (range(rows)[got.rows(rank, rows)]
                == range(rows)[slices[device][1]]), rank
    assert sorted(sum((list(got.positions(r[0]))
                       for r in got.group_ranks()), [])) == list(
        range(n_folds))
    args = types.SimpleNamespace(fold_parallel=True, mesh_devices=n_ranks,
                                 folds=list(range(n_folds)), device="cpu")
    held = []
    for rank in range(n_ranks):
        world = accepted_by_the_cli(monkeypatch, args, rank)
        assert (world.rank, world.world_size) == (rank, n_ranks)
        fold_mesh = multifold.make_fold_mesh(
            mesh_lib.Mesh(rank, n_ranks), args.folds)
        assert fold_mesh.layout == got
        assert fold_mesh.own_folds == list(got.positions(rank))
        held += fold_mesh.own_folds
    assert sorted(held) == sorted(args.folds * got.d)


# ---------------------------------------------------------------------------
# (b) two gloo ranks against one process
# ---------------------------------------------------------------------------


def _fold_batches(rows, n_batches, seed=0):
    """Per fold, ``n_batches[k]`` batches of ``rows[k]`` random waves each,
    the batch's length varying by fold and batch; each clip is its batch's
    whole length (the bucket's), since zero tails within a batch make the
    float32 input BatchNorm's variance cancel (F3)."""
    rng = np.random.RandomState(seed)
    folds = []
    for k, (b, n) in enumerate(zip(rows, n_batches)):
        batches = []
        for i in range(n):
            length = CLIP - 1024 * ((k + i) % 3)
            lengths = np.full(b, length, np.int32)
            signal = (0.3 * rng.randn(b, length)).astype(np.float32)
            signal[np.arange(length)[None, :] >= lengths[:, None]] = 0.0
            labels = (rng.rand(b, N_CLASSES) < 0.4).astype(np.float32)
            labels[:, 0] = 1.0
            batches.append({"signal": signal, "lengths": lengths,
                            "labels": labels,
                            "index": np.arange(b * i, b * i + b)})
        folds.append(batches)
    return folds


@pytest.mark.parametrize("folds,rows,n_batches", [
    ([0, 1, 2, 3], (8, 6, 5, 7), (2, 2, 1, 2)),  # 2 folds a rank
    ([3, 1], (5, 8), (1, 2)),  # 1 fold a rank
])
def test_two_ranks_train_each_fold_as_one_process(tmp_path, folds, rows,
                                                  n_batches):
    """Folds of unequal rows and lengths (a short loader cycled) on 2 gloo
    ranks, each stacking its own, 2 epochs of the recipe's augmentation
    (MixUp 0.5, the effects chain 0.75, chunk shuffle 0.5), momentum at lr
    1e-3, float32, dropout 0. Each rank's folds equal bit for bit one
    process that stacks that rank's folds alone and is told what the job
    gives them (their places in the fold list for the generators' seeds,
    all folds' step count and each step's (rows, length) over all folds),
    and nearly those of the one process that stacks all the folds: the
    same step and update counts; each fold's epoch losses within 1e-5
    relative, its parameters within 1e-5 of the fold's largest, each
    BatchNorm statistic within 1e-5 of its own largest
    (``test_stacked_step_matches_single_fold_engines``' tolerances). The
    momentum buffers sum the gradients, which a max-pool near-tie moves:
    against the stack of all the folds they are held to 2e-3 of their
    largest entry, where that test holds 1e-4. On these clips the one
    process stacking folds 0-1 alone is 1.44e-3 from the one stacking
    0-3 in fold 1's buffers, with no rank involved (``worst`` below
    prints the stack width's own spread beside the ranks')."""
    torch.manual_seed(0)
    model = TwoDimensionalCNN(**worker.CFG, aggregation_type="max",
                              n_classes=N_CLASSES)
    inp = {"folds": folds, "batches": _fold_batches(rows, n_batches),
           "state": model.state_dict(), "n_classes": N_CLASSES,
           "cfg": _train_cfg("momentum", 1e-3)}
    ranks = run_ranks(tmp_path, "epochs", inp)
    want = worker.case_epochs(None, inp)
    assert want["steps"] == max(n_batches)
    got = {}
    for r, rank in enumerate(ranks):
        alone = worker.emulated_epochs(inp, r, 2)
        assert (rank["steps"], rank["updates"], rank["global_step"]) == (
            alone["steps"], alone["updates"], alone["global_step"]) == (
            want["steps"], want["updates"], want["global_step"])
        assert list(rank["folds"]) == folds[r * len(folds) // 2:
                                            (r + 1) * len(folds) // 2]
        for fold, g in rank["folds"].items():
            assert g["loss"] == alone["folds"][fold]["loss"]
            for part in ("state", "momentum"):
                for name, t in alone["folds"][fold][part].items():
                    assert torch.equal(g[part][name], t), (fold, name)
        got.update(rank["folds"])
    names = [n for n in want["folds"][folds[0]]["momentum"]]
    worst = {}
    for fold in folds:
        g, w = got[fold], want["folds"][fold]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        assert _worst(g["state"], w["state"], names) <= 1e-5, fold
        for name in w["state"]:
            if name not in names and w["state"][name].is_floating_point():
                assert _worst(g["state"], w["state"], [name]) <= 1e-5, name
        worst[fold] = _worst(g["momentum"], w["momentum"], names)
    print(f"momentum buffers against the stack of all folds: {worst}")
    assert max(worst.values()) <= 2e-3, worst
    # the folds trained apart
    assert _worst(want["folds"][folds[0]]["state"],
                  want["folds"][folds[1]]["state"], names) > 1e-4


# ---------------------------------------------------------------------------
# (c) against JAX's MultiFoldEngine on a 2 x 1 (fold, data) mesh
# ---------------------------------------------------------------------------


def _spectrogram_fold_batches(sizes, n_steps, frames=24, seed=3):
    """Per step, one batch per fold of ``sizes`` rows: random (32 x
    ``frames``) spectrograms, flattened, with ragged frame counts as the
    lengths, which ``unflatten`` hands to both packages' models as they
    are."""
    rng = np.random.RandomState(seed)
    steps = []
    for _ in range(n_steps):
        folds = []
        for rows in sizes:
            lengths = rng.randint(frames // 2, frames + 1, rows)
            lengths[0] = frames
            labels = (rng.rand(rows, N_CLASSES) < 0.4).astype(np.float32)
            labels[:, 0] = 1.0
            folds.append({
                "signal": rng.randn(rows, 32 * frames).astype(np.float32),
                "lengths": lengths.astype(np.int32), "labels": labels,
                "is_noisy": np.zeros(rows, np.float32)})
        steps.append(folds)
    return steps


def test_two_ranks_match_jax_on_a_fold_by_data_mesh(tmp_path):
    """Two folds of 8 and 5 rows, 3 momentum steps at lr 1e-4 without
    augmentation (dropout 0) through JAX's ``MultiFoldEngine`` on the
    2 x 1 (fold, data) mesh of ``make_fold_dp_mesh(2)`` over two devices
    (its ``shard_map`` over "fold") and through 2 gloo ranks of the port,
    one fold each, from JAX's fold states (``interop.
    stack_jax_fold_states``): rank 1 pads its 5 rows to 8 as JAX does.
    Each step's per-fold loss and batch lwlrap within 1e-4; each fold's
    parameters within 1e-5 + 1e-2 of each tensor's move, its BatchNorm
    statistics within 1e-4 relative with a 1e-5 floor
    (``test_stacked_step_matches_jax_multifold``' tolerances)."""
    sizes = (8, 5)
    steps = _spectrogram_fold_batches(sizes, 3)
    cfg = _train_cfg("momentum", 1e-4)
    template = JaxEngine(JaxCNN(**worker.CFG, aggregation_type="max",
                                n_classes=N_CLASSES), worker.unflatten,
                         types.SimpleNamespace(**cfg), loss="lsep_naive",
                         mesh=jmesh.make_mesh(1), seed=0)
    mesh = make_fold_dp_mesh(2, devices=jax.devices()[:2])
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "fold": 2, "data": 1}
    jaxm = JaxMultiFoldEngine(template, 2, mesh=mesh)
    jaxm.make_optimizer(6, 3)
    jaxm.init_states(steps[0][0])
    init_p = jax.tree.map(np.asarray, jaxm.states.params)
    init_s = jax.tree.map(np.asarray, jaxm.states.batch_stats)
    want_loss, want_metric = [], []
    for folds in steps:
        batch, n_real = _stack_batches(folds)
        device_batch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
        clean = (device_batch["signal"], device_batch["lengths"],
                 device_batch["labels"])
        jaxm.states, loss, metric = jaxm._vmapped_step(
            jaxm.states, device_batch, 0.0, jax.numpy.asarray(n_real), clean)
        want_loss.append(np.asarray(loss))
        want_metric.append(np.asarray(metric))

    port = TwoDimensionalCNN(**worker.CFG, aggregation_type="max",
                             n_classes=N_CLASSES)
    inp = {"folds": [0, 1], "steps": steps, "cfg": cfg,
           "n_classes": N_CLASSES, "state": port.state_dict(),
           "stacked": interop.stack_jax_fold_states(init_p, init_s)}
    ranks = run_ranks(tmp_path, "jax_steps", inp)
    got = {**ranks[0], **ranks[1]}
    assert list(ranks[0]) == [0] and list(ranks[1]) == [1]
    want_p = dict(_leaves(jax.tree.map(np.asarray, jaxm.states.params)))
    want_s = dict(_leaves(jax.tree.map(np.asarray, jaxm.states.batch_stats)))
    init = dict(_leaves(init_p))
    moved = 0.0
    for k in (0, 1):
        np.testing.assert_allclose(got[k]["loss"],
                                   [x[k] for x in want_loss], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got[k]["metric"],
                                   [x[k] for x in want_metric], rtol=0,
                                   atol=1e-4)
        stacked = {n: t[None] for n, t in got[k]["state"].items()}
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
# (d) the train CLI under torch.distributed.run
# ---------------------------------------------------------------------------


def _cli_argv(root, label, *extra, epochs=2):
    """The 2d train CLI over folds 0 and 1 together, ``epochs`` epochs,
    with test predictions; momentum, since Adam's step is a full learning rate
    wherever a gradient is at the level of float32's rounding, which
    turns the stack width's rounding into 1e-2 of a weight."""
    with open(os.path.join(root, "test.csv"), "w") as f:
        f.write("fname\n" + "".join(f"clip{i:02d}.wav\n" for i in range(5)))
    return [*_train_argv(root, label), "--optimizer", "momentum",
            "--n_folds", "2", "--folds", "0", "1", "--epochs", str(epochs),
            "--fold_parallel", "--sample_submission",
            os.path.join(root, "test.csv"), "--test_data_dir",
            os.path.join(root, "train"), *extra]


def _on_ranks(root, name, argv, stop=-1, world=2, timeout=120):
    """``train_2d_cnn`` under ``torch.distributed.run --nproc_per_node
    world``, each rank through ``tests/_fold_mesh_cli.py`` (``stop`` as
    there): (exit code, output, the paths each rank wrote)."""
    out = os.path.join(root, f"{name}_ranks")
    os.makedirs(out)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(world), RANK_CLI, out, str(stop),
         "train_2d_cnn", *argv], cwd=root, env=_child_env(),
        capture_output=True, text=True, timeout=timeout)
    writes = []
    for r in range(world):
        path = os.path.join(out, f"writes{r}.txt")
        writes.append(set(open(path).read().split())
                      if os.path.exists(path) else set())
    return proc.returncode, proc.stdout + proc.stderr, writes


def _experiment(root, label):
    names = [n for n in os.listdir(os.path.join(root, "experiments"))
             if label in n]
    assert len(names) == 1, names
    return os.path.join(root, "experiments", names[0])


def _files(experiment_dir):
    found = set()
    for dirpath, _, names in os.walk(experiment_dir):
        found |= {os.path.relpath(os.path.join(dirpath, n), experiment_dir)
                  for n in names}
    return found


def _named(files):
    """``files`` with each summary event file's name, which holds its time
    and host, cut to ``events``."""
    return {os.path.join(os.path.dirname(f), "events")
            if "tfevents" in f else f for f in files}


def _weights(experiment_dir, fold, name):
    params, stats = interop.load_fold_npz(os.path.join(
        experiment_dir, "checkpoints", f"fold_{fold}", f"{name}.npz"))
    return dict(_leaves({"params": params, "batch_stats": stats}))


def _predictions(path):
    with open(path) as f:
        rows = [line.rstrip("\n").split(",") for line in f]
    return rows[0], [r[0] for r in rows[1:]], np.asarray(
        [[float(v) for v in r[1:]] for r in rows[1:]])


def test_train_cli_on_two_ranks_writes_the_one_process_files_and_resumes(
        tmp_path):
    """The 2d train CLI with ``--fold_parallel --folds 0 1`` (augmentation
    on, 1 epoch, so that each run's best model is its epoch 0: the toy
    folds' validation lwlrap ties across epochs, which rounding may break
    either way) under ``torch.distributed.run`` against the same command
    in one process. On one rank (the layout path, its collectives on a
    group of one) every model file is the one process's bit for bit. On 2
    gloo ranks: the same files, the one stacked bundle of the job
    (``multifold_resume.pt``, recording the 2 x 1 layout) among them; each
    fold's models within 1e-4 of their largest entry, its OOF and test
    predictions and the submission within 1e-4, its metric and train
    losses within 1e-4 relative, the global OOF metric within 1e-4 (each
    rank stacks one fold where the one process stacks two: float32's
    rounding of the stack width, 2.2e-5 of the largest weight after 2
    epoch). Every file has one writer: the rank that owns its fold (rank
    1: fold 1's checkpoints, predictions and summaries) or rank 0 (the
    rest: the bundle too). Then a 2-epoch run (MixUp off, whose partner
    pool restarts on resume, as in JAX) stopped before epoch 1 and resumed
    with ``--resume`` on 2 ranks ends with the straight 2-epoch run's
    weights bit for bit; and one process resumes the same stopped run's
    bundle of 2 ranks (JAX resumes under any layout): it trains epoch 1
    alone, with other augmentation draws than the ranks', and writes the
    job's bundle of epoch 1 under its own layout."""
    root = str(tmp_path)
    _write_dataset(root)
    one = train_2d_cnn.main(_cli_argv(root, "one", epochs=1))
    rc, out, _ = _on_ranks(root, "alone",
                           _cli_argv(root, "alone", epochs=1), world=1)
    assert rc == 0, out[-4000:]
    alone = _experiment(root, "alone")
    assert _named(_files(alone)) == _named(_files(one.experiment_dir))
    for fold in (0, 1):
        for name in ("best_model", "final_model", "model_on_epoch_0"):
            want = _weights(one.experiment_dir, fold, name)
            got = _weights(alone, fold, name)
            for key, value in want.items():
                np.testing.assert_array_equal(got[key], value, err_msg=key)

    rc, out, writes = _on_ranks(root, "two",
                                _cli_argv(root, "two", epochs=1))
    assert rc == 0, out[-4000:]
    two = _experiment(root, "two")
    two_files = _files(two)
    assert _named(two_files) == _named(_files(one.experiment_dir))
    bundle = torch.load(os.path.join(two, "checkpoints", multifold.BUNDLE),
                        weights_only=True)
    assert bundle["layout"] == ("2 x 1 (fold x data) on 2 ranks, folds "
                                "[0, 1]")
    assert bundle["meta"]["epoch"] == 0 and bundle["folds"] == [0, 1]
    for fold in (0, 1):
        for name in ("best_model", "final_model", "model_on_epoch_0"):
            want = _weights(one.experiment_dir, fold, name)
            got = _weights(two, fold, name)
            top = max(np.abs(v).max() for v in want.values())
            for key, value in want.items():
                assert np.abs(got[key] - value).max() <= 1e-4 * top, key
        for csv_name in (f"val_preds_fold_{fold}.csv",
                         f"test_preds_fold_{fold}.csv", "submission.csv"):
            w_head, w_names, w = _predictions(os.path.join(
                one.experiment_dir, "predictions", csv_name))
            g_head, g_names, g = _predictions(os.path.join(
                two, "predictions", csv_name))
            assert (g_head, g_names) == (w_head, w_names)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    results = json.load(open(os.path.join(two, "results.json")))
    for fold in ("fold0", "fold1"):
        assert results[fold].keys() == one.results[fold].keys()
        assert results[fold]["train_steps"] == [2.0]
        for key in ("metric", "train_loss"):
            np.testing.assert_allclose(results[fold][key],
                                       one.results[fold][key], rtol=1e-4)
    assert results["metric"] == pytest.approx(one.results["metric"],
                                              abs=1e-4)

    # one writer a file: the fold's owner, or rank 0
    for rel in two_files:
        path = os.path.join(two, rel)
        ranks = [r for r in (0, 1) if path in writes[r]]
        owner = int("fold_1" in rel)
        assert ranks == [owner], (rel, ranks)

    # a run stopped before epoch 1, then resumed on 2 ranks
    # MixUp off: its pool of partners restarts on resume, as in JAX
    rc, out, _ = _on_ranks(root, "straight",
                           _cli_argv(root, "straight", "--p_mixup", "0"))
    assert rc == 0, out[-4000:]
    straight = _experiment(root, "straight")
    rc, out, _ = _on_ranks(root, "stopped",
                           _cli_argv(root, "resumed", "--p_mixup", "0"),
                           stop=1)
    assert rc != 0 and "stopped before epoch 1" in out, out[-4000:]
    resumed = _experiment(root, "resumed")
    bundle = torch.load(os.path.join(resumed, "checkpoints",
                                     multifold.BUNDLE), weights_only=True)
    assert bundle["meta"]["epoch"] == 0
    stopped = os.path.join(root, "stopped_copy")
    shutil.copytree(resumed, stopped)
    rc, out, _ = _on_ranks(root, "resume", _cli_argv(
        root, "resumed", "--p_mixup", "0", "--resume"))
    assert rc == 0, out[-4000:]
    results = json.load(open(os.path.join(resumed, "results.json")))
    assert results["fold1"]["train_steps"] == [2.0]
    for fold in (0, 1):
        want = _weights(straight, fold, "final_model")
        got = _weights(resumed, fold, "final_model")
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)

    # the stopped run again, resumed in one process
    shutil.move(resumed, os.path.join(root, "resumed_on_ranks"))
    shutil.copytree(stopped, resumed)
    train_2d_cnn.main(_cli_argv(root, "resumed", "--p_mixup", "0",
                                "--resume"))
    results = json.load(open(os.path.join(resumed, "results.json")))
    assert results["fold1"]["train_steps"] == [2.0]
    bundle = torch.load(os.path.join(resumed, "checkpoints",
                                     multifold.BUNDLE), weights_only=True)
    assert bundle["meta"]["epoch"] == 1
    assert bundle["layout"] == ("1 x 1 (fold x data) on 1 rank, folds "
                                "[0, 1]")
    for fold in (0, 1):
        want = _weights(straight, fold, "final_model")
        got = _weights(resumed, fold, "final_model")
        assert all(np.isfinite(v).all() for v in got.values())
        assert any(not np.array_equal(got[k], v) for k, v in want.items())
