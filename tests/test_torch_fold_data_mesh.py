"""Fold-parallel training over fold groups of d > 1 ranks and the
fold-local layout (``training/multifold.py`` on a ``FoldMesh`` whose
``data_group`` is the rank's fold group; ROADMAP M5.2b), on the CPU:
BatchNorm's all-reduce under ``torch.func.vmap`` against one BatchNorm
over the ranks' rows, ``stack_batches``' ``row_multiple`` against JAX's
``_stack_batches``, the chain's row count over a group against JAX's
``round(p B)``, gloo ranks against JAX's ``MultiFoldEngine`` on
``make_fold_dp_mesh``'s 2 x 2, 1 x 2 and fold-local meshes over the
conftest's CPU devices, and the train CLI under ``python -m
torch.distributed.run --nproc_per_node 2 ... --fold_parallel`` over 3
folds (the 1 x 2 layout).

Multi-rank cases start processes of ``tests/_fold_mesh_worker.py`` or
``tests/_fold_mesh_cli.py`` as ``tests/test_torch_fold_mesh.py`` does
(its ``run_ranks`` and ``_on_ranks``): one thread each, every wait with a
timeout, dropout 0.
"""

import csv
import json
import os
import shutil
import types

import numpy as np
import pytest
import jax
from jax.sharding import NamedSharding

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
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import train_2d_cnn
from freesound_classification_tpu_torch.data import audio_io
from freesound_classification_tpu_torch.models.blocks import BatchNorm
from freesound_classification_tpu_torch.models.classifiers import (
    TwoDimensionalCNN,
)
from freesound_classification_tpu_torch.training import checkpoints
from freesound_classification_tpu_torch.training.multifold import (
    fold_layout,
    stack_batches,
)
from freesound_classification_tpu_torch.training.state import create_model
from tests.test_torch_fold_mesh import (
    N_CLASSES,
    _experiment,
    _files,
    _fold_batches,
    _leaves,
    _named,
    _on_ranks,
    _predictions,
    _spectrogram_fold_batches,
    _train_cfg,
    _weights,
    run_ranks,
)
from tests.test_torch_hierarchical import _train_argv


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


# ---------------------------------------------------------------------------
# (a) BatchNorm's all-reduce under vmap
# ---------------------------------------------------------------------------


def test_vmapped_all_reduce_batch_norm_equals_one_over_the_ranks_rows(
        tmp_path):
    """A ``BatchNorm`` stacked over 3 folds and run under
    ``torch.func.vmap`` on 2 gloo ranks, each with its half of every
    fold's 6 rows, its statistics over the ranks (``mesh.all_reduce_sum``'s
    vmap rule), equals per fold one ``BatchNorm`` over the 6 rows: the
    forward, the gradient as to the input, the weight and bias gradients
    summed over the ranks and the running statistics, within 1e-6. The
    input is float64 (statistics and output in float64, as flax promotes),
    so that 1e-6 is far above the sums' rounding: in float32 the weight
    gradients, up to 17.5, part by their rounding, 2.1e-6."""
    rng = np.random.RandomState(5)
    k, rows, c = 3, 6, 4
    inp = {"channels": c,
           "x": torch.from_numpy(rng.randn(k, rows, c, 5, 3) * 2 + 1),
           "g": torch.from_numpy(rng.randn(k, rows, c, 5, 3)),
           "weight": torch.from_numpy(rng.rand(k, c).astype(np.float32)
                                      + 0.5),
           "bias": torch.from_numpy(rng.randn(k, c).astype(np.float32))}
    ranks = run_ranks(tmp_path, "vmap_bn", inp, timeout=60)
    for fold in range(k):
        bn = BatchNorm(c)
        with torch.no_grad():
            bn.weight.copy_(inp["weight"][fold])
            bn.bias.copy_(inp["bias"][fold])
        x = inp["x"][fold].clone().requires_grad_(True)
        y = bn(x)
        (y * inp["g"][fold]).sum().backward()
        got = {"y": torch.cat([r["y"][fold] for r in ranks]),
               "x_grad": torch.cat([r["x_grad"][fold] for r in ranks]),
               "weight_grad": sum(r["weight_grad"][fold] for r in ranks),
               "bias_grad": sum(r["bias_grad"][fold] for r in ranks)}
        want = {"y": y, "x_grad": x.grad, "weight_grad": bn.weight.grad,
                "bias_grad": bn.bias.grad}
        for name, t in want.items():
            torch.testing.assert_close(got[name], t.detach(), rtol=0,
                                       atol=1e-6, msg=name)
        for name in ("running_mean", "running_var"):
            for r in ranks:
                torch.testing.assert_close(r[name][fold], getattr(bn, name),
                                           rtol=0, atol=1e-6, msg=name)


# ---------------------------------------------------------------------------
# (b) the stacked batch's rows
# ---------------------------------------------------------------------------


def _batch(rows, length, value, classes=3):
    return {"signal": np.full((rows, length), value, "f4")
            + np.arange(rows * length, dtype="f4").reshape(rows, length),
            "lengths": np.full(rows, length, "i4"),
            "labels": np.ones((rows, classes), "f4") * value,
            "is_noisy": np.zeros(rows, "f4")}


@pytest.mark.parametrize("sizes,multiple", [
    (((6, 2), (4, 2)), 4),  # JAX's test_stacking_row_multiple
    (((7, 5), (5, 9), (6, 3)), 2),
    (((7, 5), (5, 9)), 3),
    (((3, 4), (1, 6), (2, 2)), 4),
])
def test_stack_batches_row_multiple_matches_jax(sizes, multiple):
    """``stack_batches(..., row_multiple=d)`` equals JAX's
    ``_stack_batches(..., row_multiple=d)`` bit for bit, keys, shapes,
    dtypes and ``n_real``: on JAX's ``test_stacking_row_multiple`` inputs
    (6 and 4 rows, d 4) and on uneven folds of rows and lengths."""
    batches = [_batch(r, n, 10.0 * i) for i, (r, n) in enumerate(sizes)]
    if sizes[0] == (6, 2):  # JAX's inputs as they are
        batches = [{"signal": np.arange(12, dtype="f4").reshape(6, 2),
                    "lengths": np.full(6, 2, "i4"),
                    "labels": np.ones((6, 3), "f4"),
                    "is_noisy": np.zeros(6, "f4")},
                   {"signal": np.ones((4, 2), "f4"),
                    "lengths": np.full(4, 2, "i4"),
                    "labels": np.ones((4, 3), "f4"),
                    "is_noisy": np.zeros(4, "f4")}]
    got, got_real = stack_batches(batches, row_multiple=multiple)
    want, want_real = _stack_batches(batches, row_multiple=multiple)
    assert got["signal"].shape[1] % multiple == 0
    np.testing.assert_array_equal(got_real, want_real)
    assert got_real.dtype == want_real.dtype
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


# ---------------------------------------------------------------------------
# (c) the chain's rows over a group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_folds,world,rows,p", [
    (3, 2, (7, 5, 6), 0.75),  # 1 x 2: all 3 folds on each rank
    (2, 3, (7, 5), 0.5),  # fold-local: 9 rows, 4 chain rows over 3 places
])
def test_effects_count_over_a_group_sums_to_jax_count(tmp_path, n_folds,
                                                      world, rows, p):
    """One stacked step of the effects chain alone on the ranks of a fold
    group: each fold's chain rows on the group's places sum to JAX's
    fixed count ``max(1, min(B, round(p B)))`` of the fold's padded
    stacked batch of B rows (JAX ``ops/augment.py:447``), each place
    taking ``mesh.rank_rows``' share (a place may take none)."""
    folds = list(range(n_folds))
    torch.manual_seed(0)
    model = TwoDimensionalCNN(**worker.CFG, aggregation_type="max",
                              n_classes=N_CLASSES)
    batches = _fold_batches(rows, (1,) * n_folds)
    inp = {"folds": folds, "steps": [[b[0] for b in batches]], "p": p,
           "state": model.state_dict(), "n_classes": N_CLASSES,
           "cfg": _train_cfg("momentum", 1e-4)}
    ranks = run_ranks(tmp_path, "effects", inp, world=world, timeout=120)
    layout = fold_layout(n_folds, world)
    assert layout.d == world
    padded = max(rows) + (-max(rows)) % world
    want = max(1, min(padded, int(round(padded * p))))
    for fold in folds:
        counts = [r[0]["counts"][fold] for r in ranks]
        assert all(r[0]["rows"] == padded // world for r in ranks)
        assert sum(counts) == want, (fold, counts)
        assert counts == [min(-(-want // world),
                              max(0, want - j * -(-want // world)))
                          for j in range(world)], counts


# ---------------------------------------------------------------------------
# (d) against JAX's MultiFoldEngine on make_fold_dp_mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_folds,world,sizes,shape", [
    (2, 4, (7, 5), {"fold": 2, "data": 2}),
    (3, 2, (7, 5, 6), {"fold": 1, "data": 2}),
    (2, 3, (7, 5), {"data": 3}),  # fold-local
])
def test_ranks_match_jax_on_a_fold_data_layout(tmp_path, n_folds, world,
                                               sizes, shape):
    """Folds of 7, 5 (and 6) rows, 3 momentum steps at lr 1e-4 without
    augmentation (dropout 0), through JAX's ``MultiFoldEngine`` on
    ``make_fold_dp_mesh(K)`` over ``world`` CPU devices (the batches
    placed as its ``train_epoch`` places them) and through ``world`` gloo
    ranks of the port in the same layout, from JAX's fold states
    (``interop.stack_jax_fold_states``): the rows padded to a multiple of
    d (padded rows in BatchNorm's statistics), each rank its 1/d of them.
    Each step's per-fold loss and batch lwlrap within 1e-4; each fold's
    parameters within 1e-5 + 1e-2 of each tensor's move, its BatchNorm
    statistics within 1e-4 relative with a 1e-5 floor (the tolerances of
    ``test_two_ranks_match_jax_on_a_fold_by_data_mesh``); the places of a
    group hold the same states bit for bit."""
    steps = _spectrogram_fold_batches(sizes, 3)
    cfg = _train_cfg("momentum", 1e-4)
    template = JaxEngine(JaxCNN(**worker.CFG, aggregation_type="max",
                                n_classes=N_CLASSES), worker.unflatten,
                         types.SimpleNamespace(**cfg), loss="lsep_naive",
                         mesh=jmesh.make_mesh(1), seed=0)
    mesh = make_fold_dp_mesh(n_folds, devices=jax.devices()[:world])
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == shape
    layout = fold_layout(n_folds, world)
    assert layout.shape == tuple(shape.values())
    jaxm = JaxMultiFoldEngine(template, n_folds, mesh=mesh)
    assert jaxm.dp == layout.d
    jaxm.make_optimizer(6, 3)
    jaxm.init_states(steps[0][0])
    init_p = jax.tree.map(np.asarray, jaxm.states.params)
    init_s = jax.tree.map(np.asarray, jaxm.states.batch_stats)
    sharding = NamedSharding(mesh, jaxm._batch_spec)
    want_loss, want_metric = [], []
    for folds in steps:
        batch, n_real = _stack_batches(folds, row_multiple=jaxm.dp)
        device_batch = {k: jax.device_put(v, sharding)
                        for k, v in batch.items()}
        clean = (device_batch["signal"], device_batch["lengths"],
                 device_batch["labels"])
        jaxm.states, loss, metric = jaxm._vmapped_step(
            jaxm.states, device_batch, 0.0, jax.numpy.asarray(n_real), clean)
        want_loss.append(np.asarray(loss))
        want_metric.append(np.asarray(metric))

    port = TwoDimensionalCNN(**worker.CFG, aggregation_type="max",
                             n_classes=N_CLASSES)
    inp = {"folds": list(range(n_folds)), "steps": steps, "cfg": cfg,
           "n_classes": N_CLASSES, "state": port.state_dict(),
           "stacked": interop.stack_jax_fold_states(init_p, init_s)}
    ranks = run_ranks(tmp_path, "jax_steps", inp, world=world, timeout=150)
    for r, got in enumerate(ranks):
        assert list(got) == list(layout.positions(r)), r
        first = ranks[r - layout.place(r)]
        for fold, g in got.items():
            for name, t in g["state"].items():
                assert torch.equal(t, first[fold]["state"][name]), (r, name)
    want_p = dict(_leaves(jax.tree.map(np.asarray, jaxm.states.params)))
    want_s = dict(_leaves(jax.tree.map(np.asarray, jaxm.states.batch_stats)))
    init = dict(_leaves(init_p))
    moved = 0.0
    for r, got in enumerate(ranks):
        for k, g in got.items():
            np.testing.assert_allclose(g["loss"], [x[k] for x in want_loss],
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(g["metric"],
                                       [x[k] for x in want_metric], rtol=0,
                                       atol=1e-4)
            stacked = {n: t[None] for n, t in g["state"].items()}
            got_p, got_s = interop.unstack_jax_fold_states(stacked)
            for name, value in _leaves(got_p):
                move = np.abs(want_p[name][k] - init[name][k]).max()
                err = np.abs(value[0] - want_p[name][k]).max()
                assert err <= 1e-5 + 1e-2 * move, (name, k, err, move)
                moved = max(moved, move)
            for name, value in _leaves(got_s):
                np.testing.assert_allclose(value[0], want_s[name][k],
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=name)
    assert moved > 1e-5


# ---------------------------------------------------------------------------
# (e) the train CLI on a 1 x 2 fold group
# ---------------------------------------------------------------------------


def _write_dataset(root, n=20, sr=44100):
    """``test_torch_hierarchical._write_dataset``'s tones (3 classes, a
    ``classmap.json``), each 1.05-1.4 s: the 1 s train crop fills every
    row, so no train batch has zero tails (see the test below)."""
    train_dir = os.path.join(root, "train")
    os.makedirs(train_dir)
    rng = np.random.RandomState(15)
    classes = [f"class_{c}" for c in range(3)]
    rows = []
    for i in range(n):
        m = int(rng.uniform(1.05, 1.4) * sr)
        tone = 0.3 * np.sin(2 * np.pi * (200 + 150 * (i % 3))
                            * np.arange(m) / sr)
        audio_io.write_wav(os.path.join(train_dir, f"clip{i:02d}.wav"),
                           tone + 0.01 * rng.randn(m), sr)
        rows.append((f"clip{i:02d}.wav", classes[i % 3]))
    with open(os.path.join(root, "train.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fname", "labels"])
        w.writerows(rows)
    with open(os.path.join(root, "classmap.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(classes)}, f)


def _cli_argv(root, label, *extra, epochs=2):
    """The 2d train CLI over folds 0-2 together, ``epochs`` epochs, with
    test predictions; momentum (``test_torch_fold_mesh._cli_argv``)."""
    with open(os.path.join(root, "test.csv"), "w") as f:
        f.write("fname\n" + "".join(f"clip{i:02d}.wav\n" for i in range(5)))
    return [*_train_argv(root, label), "--optimizer", "momentum",
            "--n_folds", "3", "--folds", "0", "1", "2", "--epochs",
            str(epochs), "--fold_parallel", "--sample_submission",
            os.path.join(root, "test.csv"), "--test_data_dir",
            os.path.join(root, "train"), *extra]


def _initial_weights(root, experiment):
    """The fold models' weights before the first step (``build_engine``'s
    model, seed 42), as ``_weights`` reads a fold file."""
    model = create_model(experiment.config.network, 3, torch.float32, 42,
                         "cpu", model_kind="2d_cnn", input_dim=32)
    path = os.path.join(root, "initial.npz")
    checkpoints.save_model(path, model)
    params, stats = interop.load_fold_npz(path)
    return dict(_leaves({"params": params, "batch_stats": stats}))


def test_train_cli_on_a_one_by_two_fold_group(tmp_path):
    """The 2d train CLI with ``--fold_parallel --folds 0 1 2`` under
    ``torch.distributed.run --nproc_per_node 2`` (JAX's 1 x 2 layout: each
    rank all 3 folds, half of each fold's rows; the valid and test
    loaders over the group) against the same command in one process, 1
    epoch at lr 1e-4 (the JAX comparisons' rate), augmentation off from
    epoch 0 (each place draws its own, so an augmented run is not the one
    process's): the same files, the stacked
    bundle recording the layout; each fold's parameters within 1e-5 +
    1e-2 of each tensor's move from the initial weights and its BatchNorm
    statistics within 1e-4 relative with a 1e-5 floor, its OOF and test
    predictions and the submission within 1e-4, its metric and train loss
    within 1e-4; every file written by rank 0 alone, once. The two runs
    part by float32's rounding: each BatchNorm's sums are taken over 2
    ranks in another order, and the steps amplify it. On tones of 0.7-1.4
    s (zero tails in a batch) at the recipe's lr 3e-3 fold 2's step-2
    loss is 1.2659 in one process and 1.2653 on the ranks, a weight 2.7
    times its move away; at lr 1e-4 still 25% of a move of block 0's
    kernel. With every BatchNorm's statistics in float64 the two runs give
    the same losses on those tones at lr 3e-3, and their weights agree
    within 1e-8 + 1e-2 of each move: rounding, not a different function.
    So the compared runs take clips that fill the 1 s crop
    (``_write_dataset``) at lr 1e-4. Then a 2-epoch
    run with the chain and chunk shuffle (MixUp off, whose partner pool
    restarts on resume, as in JAX) stopped before epoch 1 and resumed
    with ``--resume`` ends with the straight run's weights bit for bit
    (each place's generators restored from the bundle); and one process
    resumes the same stopped run's bundle of the group (JAX resumes under
    any layout): it trains epoch 1 alone and writes the job's bundle of
    epoch 1 under its own layout."""
    root = str(tmp_path)
    _write_dataset(root)
    plain = ("--switch_off_augmentations_on", "0", "--lr", "0.0001",
             "--scheduler", "1cycle_0.00001_0.0001")
    one = train_2d_cnn.main(_cli_argv(root, "one", *plain, epochs=1))
    rc, out, writes = _on_ranks(root, "two",
                                _cli_argv(root, "two", *plain, epochs=1),
                                timeout=150)
    assert rc == 0, out[-4000:]
    assert "layout 1 x 2 (fold x data) on 2 ranks, folds [0, 1, 2]" in out
    two = _experiment(root, "two")
    two_files = _files(two)
    assert _named(two_files) == _named(_files(one.experiment_dir))
    bundle = torch.load(os.path.join(two, "checkpoints",
                                     "multifold_resume.pt"),
                        weights_only=True)
    assert bundle["layout"] == ("1 x 2 (fold x data) on 2 ranks, folds "
                                "[0, 1, 2]")
    assert len(bundle["dropout_rng"]) == 2
    assert [len(places) for places in bundle["fold_augment_rngs"]] == [2] * 3
    init = _initial_weights(root, one)
    for fold in (0, 1, 2):
        for name in ("best_model", "final_model", "model_on_epoch_0"):
            want = _weights(one.experiment_dir, fold, name)
            got = _weights(two, fold, name)
            for key, value in want.items():
                if key.startswith("params/"):
                    move = np.abs(value - init[key]).max()
                    err = np.abs(got[key] - value).max()
                    assert err <= 1e-5 + 1e-2 * move, (fold, key, err, move)
                else:
                    np.testing.assert_allclose(got[key], value, rtol=1e-4,
                                               atol=1e-5, err_msg=key)
        for csv_name in (f"val_preds_fold_{fold}.csv",
                         f"test_preds_fold_{fold}.csv", "submission.csv"):
            w_head, w_names, w = _predictions(os.path.join(
                one.experiment_dir, "predictions", csv_name))
            g_head, g_names, g = _predictions(os.path.join(
                two, "predictions", csv_name))
            assert (g_head, g_names) == (w_head, w_names)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    results = json.load(open(os.path.join(two, "results.json")))
    for fold in ("fold0", "fold1", "fold2"):
        assert results[fold].keys() == one.results[fold].keys()
        assert results[fold]["train_steps"] == one.results[fold][
            "train_steps"]
        for key in ("metric", "train_loss"):
            np.testing.assert_allclose(results[fold][key],
                                       one.results[fold][key], rtol=0,
                                       atol=1e-4)
    assert results["metric"] == pytest.approx(one.results["metric"],
                                              abs=1e-4)
    # one writer a file: the group's place 0
    for rel in two_files:
        path = os.path.join(two, rel)
        assert [r for r in (0, 1) if path in writes[r]] == [0], rel

    # a run stopped before epoch 1, then resumed on 2 ranks
    rc, out, _ = _on_ranks(root, "straight",
                           _cli_argv(root, "straight", "--p_mixup", "0"),
                           timeout=150)
    assert rc == 0, out[-4000:]
    straight = _experiment(root, "straight")
    rc, out, _ = _on_ranks(root, "stopped",
                           _cli_argv(root, "resumed", "--p_mixup", "0"),
                           stop=1, timeout=150)
    assert rc != 0 and "stopped before epoch 1" in out, out[-4000:]
    resumed = _experiment(root, "resumed")
    bundle = torch.load(os.path.join(resumed, "checkpoints",
                                     "multifold_resume.pt"),
                        weights_only=True)
    assert bundle["meta"]["epoch"] == 0
    stopped = os.path.join(root, "stopped_copy")
    shutil.copytree(resumed, stopped)
    rc, out, _ = _on_ranks(root, "resume", _cli_argv(
        root, "resumed", "--p_mixup", "0", "--resume"), timeout=150)
    assert rc == 0, out[-4000:]
    for fold in (0, 1, 2):
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
    assert len(results["fold2"]["train_steps"]) == 1
    bundle = torch.load(os.path.join(resumed, "checkpoints",
                                     "multifold_resume.pt"),
                        weights_only=True)
    assert bundle["meta"]["epoch"] == 1
    assert bundle["layout"] == ("1 x 1 (fold x data) on 1 rank, folds "
                                "[0, 1, 2]")
    for fold in (0, 1, 2):
        got = _weights(resumed, fold, "final_model")
        assert all(np.isfinite(v).all() for v in got.values())
