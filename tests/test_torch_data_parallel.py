"""Data parallel across ranks (``parallel/mesh.py``) against the JAX
package's engine on a mesh and against one port process, on the CPU.

Multi-rank cases start 2 processes of ``tests/_dp_worker.py`` (a gloo
group over a ``file://`` rendezvous under ``tmp_path``, one thread each);
the children import only the port, and each wait has a timeout, so a hung
collective fails its test. The parent computes the references: JAX's
``Engine(mesh=make_mesh(2))`` on the 8-device CPU backend of
``tests/conftest.py``, or the worker's own case function with no mesh. The
CLI cases run the train CLIs under ``python -m torch.distributed.run
--nproc_per_node 2 ... --device cpu --mesh_devices 2``.
"""

import glob
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import jax
import torch

import _dp_worker as worker
from _cli_mesh import accepted_by_the_cli
from freesound_classification_tpu.data import loader as jloader
from freesound_classification_tpu.models.classifiers import (
    TwoDimensionalCNN as JaxCNN,
)
from freesound_classification_tpu.parallel import mesh as jmesh
from freesound_classification_tpu.training.engine import Engine as JaxEngine
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import train_2d_cnn, train_apc
from freesound_classification_tpu_torch.data import audio_io, bucketing
from freesound_classification_tpu_torch.data.loader import DataLoader
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops import augment
from freesound_classification_tpu_torch.parallel import mesh as mesh_lib
from freesound_classification_tpu_torch.training import checkpoints
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.training.state import create_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_dp_worker.py")
SR = 44100
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


def run_ranks(tmp_path, case, inputs, world=2, timeout=150):
    """Run ``case`` of the worker on ``world`` ranks; every rank's result,
    in rank order. A rank that fails or outlives ``timeout`` seconds fails
    the test with its output."""
    d = tmp_path / f"{case}_ranks"
    d.mkdir()
    torch.save(inputs, d / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    for r in range(world):
        log = open(d / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, case, str(r), str(world),
             str(d / "rendezvous"), str(d / "inputs.pt"), str(d)],
            stdout=log, stderr=subprocess.STDOUT, env=env))
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


def _feature_batches(n=3, b=7, seed=0, dtype=np.float32):
    """Random waves with ragged lengths as their mel_512_256_32 log-mel
    features, flattened (``worker.unflatten`` undoes it), with the frame
    counts as lengths, labels and dataset indices."""
    rng = np.random.RandomState(seed)
    frontend = Frontend(worker.DESCRIPTOR, "2d", sr=SR, device="cpu")
    out = []
    for i in range(n):
        lengths = rng.randint(CLIP // 2, CLIP + 1, b).astype(np.int32)
        lengths[0] = CLIP
        signal = (0.3 * rng.randn(b, CLIP)).astype(np.float32)
        signal[np.arange(CLIP)[None, :] >= lengths[:, None]] = 0.0
        labels = (rng.rand(b, N_CLASSES) < 0.4).astype(np.float32)
        labels[:, 0] = 1.0
        feats, frames = frontend(torch.from_numpy(signal),
                                 torch.from_numpy(lengths))
        out.append({"signal": feats.reshape(b, -1).numpy().astype(dtype),
                    "lengths": frames.numpy().astype(np.int32),
                    "labels": labels.astype(dtype),
                    "index": np.arange(b * i, b * i + b)})
    return out


def _train_cfg(optimizer, lr, accumulation_steps=1):
    return dict(optimizer=optimizer, learning_rate=lr,
                scheduler=f"1cycle_{lr / 10:g}_{lr:g}", weight_decay=0.0,
                accumulation_steps=accumulation_steps,
                switch_off_augmentations_on=100, _save_every=1000)


# ---------------------------------------------------------------------------
# (a) rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_local_rows_and_size_multiple_match_jax(world):
    """Exact: each rank's rows of ragged batches (1-9 rows) are JAX's
    ``_local_rows``, their real-row counts are ``rank_rows``', and the
    ranks' slices put back in order are JAX's ``pad_batch_to_multiple`` of
    the global batch; ``make_loader`` trims batch sizes to
    ``lcm(size_multiple, world)`` as JAX's, so both plan the same global
    batches."""
    lengths = np.r_[np.full(9, 20000), np.full(14, 40000)]
    ladder = bucketing.make_bucket_ladder(60000, min_length=SR // 2)
    for n in range(1, 10):
        indices = list(range(100, 100 + n))
        got = []
        for rank in range(world):
            port = DataLoader(None, None, process_index=rank,
                              process_count=world)
            jax_loader = jloader.DataLoader(None, None, process_index=rank,
                                            process_count=world)
            rows = port._local_rows(indices)
            assert rows == jax_loader._local_rows(indices)
            start, real = mesh_lib.rank_rows(n, rank, world)
            assert rows[:real] == indices[start:start + real]
            got += rows
        batch = {"index": np.asarray(indices)}
        want, n_real = jmesh.pad_batch_to_multiple(batch, world)
        assert got == list(want["index"])
        port_pad, port_n = mesh_lib.pad_batch_to_multiple(batch, world)
        np.testing.assert_array_equal(port_pad["index"], want["index"])
        assert port_n == n_real == n
        shards = [mesh_lib.shard_batch(batch, r, world)
                  for r in range(world)]
        assert [s["n_global"] for s in shards] == [n] * world
        assert sum(s["n_real"] for s in shards) == n
    for size_multiple in (1, 3):
        for batch_size in (4, 5, 7):
            ds = types.SimpleNamespace(lengths=lengths)
            for rank in range(world):
                mesh = mesh_lib.Mesh(rank, world)
                plan = make_loader(ds, ladder, batch_size=batch_size,
                                   train=True, seed=3,
                                   size_multiple=size_multiple, mesh=mesh)
                want = jloader.make_loader(
                    ds, ladder, batch_size=batch_size, train=True, seed=3,
                    size_multiple=size_multiple, process_index=rank,
                    process_count=world)
                assert plan.sampler.size_multiple == \
                    want.sampler.size_multiple
                assert list(plan.sampler) == list(want.sampler)


# ---------------------------------------------------------------------------
# (b) BatchNorm over the global batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-5)])
def test_batchnorm_takes_global_statistics(tmp_path, dtype, rtol):
    """2 ranks of 3 rows each against one process on all 6: outputs,
    input gradients, the summed weight and bias gradients and the running
    statistics, in float64 within 1e-10 and in float32 within 1e-5
    (relative, over each tensor's largest value). The running statistics
    are the same on both ranks, bit for bit."""
    g = torch.Generator().manual_seed(0)
    x = (2.0 + 3.0 * torch.randn(6, 5, 4, 3, generator=g)).to(dtype)
    inp = {"x": x, "w": torch.randn(x.shape, generator=g).to(dtype),
           "weight": 1.0 + torch.rand(5, generator=g).to(dtype),
           "bias": torch.randn(5, generator=g).to(dtype)}
    ranks = run_ranks(tmp_path, "batchnorm", inp)
    want = worker.case_batchnorm(None, inp)

    def close(got, ref, name):
        scale = ref.abs().max().item()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=rtol * scale, err_msg=name)

    close(torch.cat([r["y"] for r in ranks]), want["y"], "y")
    close(torch.cat([r["grad"] for r in ranks]), want["grad"], "grad")
    for name in ("weight_grad", "bias_grad"):
        close(ranks[0][name] + ranks[1][name], want[name], name)
    for name in ("mean", "var"):
        assert torch.equal(ranks[0][name], ranks[1][name])
        close(ranks[0][name], want[name], name)
    # the statistics a rank would take alone are far from the global ones
    alone = worker.case_batchnorm(None, dict(inp, x=x[:3], w=inp["w"][:3]))
    assert (alone["var"] - want["var"]).abs().max() > 1e3 * rtol


# ---------------------------------------------------------------------------
# (c) the train step against JAX's engine on a 2-device mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accumulation_steps", [1, 2])
def test_train_steps_match_jax_engine_on_a_mesh(tmp_path, accumulation_steps):
    """Momentum at lr 1e-4 over 3 batches of 7 rows (2 epochs of them with
    ``accumulation_steps=2``: 3 updates, one across the epoch's end), on 2
    ranks, against JAX's engine on a 2-device mesh from the same weights,
    augmentation off. The odd batch puts a padded row (a copy of the last)
    on rank 1, under the mask in the loss and the metric and inside the
    BatchNorm statistics, as in JAX's padded global batch.

    Tolerances of ``test_torch_train.py::test_train_step_matches_jax`` and
    ``test_torch_engine_rest.py::test_accumulation_matches_jax_multisteps``:
    each epoch's mean loss within 1e-4, every parameter within 1e-5 plus
    1e-2 of its largest move from the init, the BatchNorm statistics within
    1e-4 relative with a 1e-5 floor. Both ranks end with the same weights,
    bit for bit."""
    epochs = 1 if accumulation_steps == 1 else 2
    batches = _feature_batches()
    cfg = _train_cfg("momentum", 1e-4, accumulation_steps)
    jaxe = JaxEngine(JaxCNN(**worker.CFG, aggregation_type="max",
                            n_classes=N_CLASSES), worker.unflatten,
                     types.SimpleNamespace(**cfg), loss="lsep_naive",
                     mesh=jmesh.make_mesh(2), seed=0)
    jaxe.make_optimizer(3 * epochs, 3)
    jaxe.init_state(batches[0])
    params = jax.tree.map(np.asarray, jaxe.state.params)
    stats = jax.tree.map(np.asarray, jaxe.state.batch_stats)
    init = dict(_leaves(params))
    ranks = run_ranks(tmp_path, "steps", {
        "state": interop.from_jax_variables(params, stats),
        "cfg": cfg, "batches": batches, "epochs": epochs,
        "dtype": torch.float32, "n_classes": N_CLASSES})
    want_losses = [jaxe.train_epoch(batches, e, log_interval=100)["loss"]
                   for e in range(epochs)]
    for name, t in ranks[0]["state"].items():
        assert torch.equal(t, ranks[1]["state"][name]), name
    assert ranks[0]["updates"] == int(
        getattr(jaxe.state.opt_state, "gradient_step", 3))
    for got, want in zip(ranks[0]["losses"], want_losses):
        assert float(np.mean(got)) == pytest.approx(want, abs=1e-4)
    got_p, got_s = interop.to_jax_variables(ranks[0]["state"])
    want_p = dict(_leaves(jax.tree.map(np.asarray, jaxe.state.params)))
    for name, value in _leaves(got_p):
        tight = 1e-5 + 1e-2 * np.abs(want_p[name] - init[name]).max()
        assert np.abs(value - want_p[name]).max() <= tight, name
    want_s = dict(_leaves(jax.tree.map(np.asarray, jaxe.state.batch_stats)))
    for name, value in _leaves(got_s):
        np.testing.assert_allclose(value, want_s[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert max(np.abs(v - init[k]).max() for k, v in _leaves(got_p)) > 1e-4


# ---------------------------------------------------------------------------
# (d) 2 ranks against one port process in float64
# ---------------------------------------------------------------------------


def test_two_ranks_equal_one_process_in_float64(tmp_path):
    """3 momentum steps at lr 1e-2 over 3 global batches of 8 rows in
    float64: every step's loss, the epoch's lwlrap, the weights and the
    BatchNorm statistics of 2 ranks within 1e-10 of one port process on
    the whole batches."""
    params, stats = interop.random_jax_variables(
        **worker.CFG, n_classes=N_CLASSES, seed=4)
    state = {k: v.double() if v.is_floating_point() else v
             for k, v in interop.from_jax_variables(params, stats).items()}
    inp = {"state": state, "cfg": _train_cfg("momentum", 1e-2),
           "batches": _feature_batches(b=8, seed=2, dtype=np.float64),
           "epochs": 1, "dtype": torch.float64, "n_classes": N_CLASSES}
    ranks = run_ranks(tmp_path, "steps", inp)
    want = worker.case_steps(None, inp)
    for got in ranks:
        np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                                   rtol=0, atol=1e-10)
        assert got["metrics"][0] == pytest.approx(want["metrics"][0],
                                                  abs=1e-10)
        for name, t in want["state"].items():
            np.testing.assert_allclose(got["state"][name].numpy(), t.numpy(),
                                       rtol=0, atol=1e-10, err_msg=name)
    moved = max((want["state"][k] - state[k]).abs().max().item()
                for k in state if state[k].is_floating_point())
    assert moved > 1e-4


# ---------------------------------------------------------------------------
# (e) the effects chain's count and MixUp's partners
# ---------------------------------------------------------------------------


def test_effects_count_splits_the_global_round():
    """The ranks' effects-chain rows sum to JAX's ``max(1, min(B,
    round(p B)))`` of the global batch (``ops/augment.py:447-448`` of the
    JAX package), split as the loader splits rows; one rank is the
    single-process count, and ``draw_effects`` draws that many rows. For
    B = 20 at p = 0.75 on 2 ranks: 8 + 7 = 15 (rounding each rank's 7.5
    would give 16)."""
    gen = torch.Generator().manual_seed(0)
    for world in (1, 2, 3, 4):
        for local in (1, 2, 5, 10, 16):
            b = local * world
            for p in (0.1, 0.25, 0.5, 0.75, 0.9):
                k = max(1, min(b, int(round(b * p))))
                counts = [augment.effects_count(local, p, (r, world))
                          for r in range(world)]
                assert sum(counts) == k, (world, local, p)
                assert counts == [mesh_lib.rank_rows(k, r, world)[1]
                                  for r in range(world)]
                assert max(counts) <= local
                if b > 1:
                    rows = augment.draw_effects(gen, local, p, (1 % world,
                                                                world)).rows
                    assert rows.numel() == counts[1 % world]
                    assert len(set(rows.tolist())) == rows.numel()
    assert [augment.effects_count(10, 0.75, (r, 2)) for r in (0, 1)] \
        == [8, 7]
    assert augment.effects_count(20, 0.75) == 15


def test_mixup_partners_come_from_the_ranks_own_rows(tmp_path):
    """2 epochs of MixUp at p 1 through the engine on 2 ranks, over 2
    batches of 8 rows whose labels are one-hot in the dataset row: every
    label after MixUp is one of the rank's own rows (its slices of the
    batches), and across the steps some rows mixed with a partner of the
    previous batch of the same shape (the pool)."""
    batches = []
    for i in range(2):
        labels = np.zeros((8, 16), np.float32)
        labels[np.arange(8), np.arange(8 * i, 8 * i + 8)] = 1.0
        batches.append({
            "signal": np.random.RandomState(i).randn(8, 32 * 6)
            .astype(np.float32), "lengths": np.full(8, 6, np.int32),
            "labels": labels, "index": np.arange(8 * i, 8 * i + 8)})
    ranks = run_ranks(tmp_path, "mixup", {
        "batches": batches, "cfg": _train_cfg("momentum", 1e-4),
        "n_classes": 16})
    from_pool = 0
    for got in ranks:
        own = set(np.concatenate(got["index"][:2]).tolist())
        for index, labels in zip(got["index"], got["labels"]):
            for row, lab in zip(index, labels.numpy()):
                hot = set(np.flatnonzero(lab).tolist())
                assert row in hot and hot <= own
                from_pool += bool(hot - set(index.tolist()))
    assert from_pool > 0


# ---------------------------------------------------------------------------
# (f) the self-supervised losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,rows", [("apc", 3), ("cpc", 4)])
def test_ssl_losses_on_two_ranks_equal_one_process(tmp_path, kind, rows):
    """APC on 3 rows (rank 1 holds one real row and a padded one, whose
    frame count the engine zeroes) and CPC on 4, every row with its own
    frame count: both steps' losses and the validation score (-loss)
    within 1e-5 relative of one process on the real rows, and the weights
    (and CPC's BatchNorm statistics) after 2 momentum steps within 1e-6.
    APC's padded row then carries no weight at all; CPC's would (its
    encoder keeps one step of a zero-length row, as JAX's), so it is held
    on an even batch."""
    rng = np.random.RandomState(1)
    frames = torch.tensor([40, 31, 17, 26][:rows], dtype=torch.int32)
    inp = {"kind": kind, "feats": torch.from_numpy(
        rng.randn(rows, 40, 16).astype(np.float32)), "frames": frames,
        "cfg": _train_cfg("momentum", 1e-3)}
    ranks = run_ranks(tmp_path, "ssl", inp)
    want = worker.case_ssl(None, inp)
    for got in ranks:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        assert got["score"] == pytest.approx(want["score"], rel=1e-5)
        for name, t in want["state"].items():
            np.testing.assert_allclose(got["state"][name].numpy(), t.numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
    assert want["losses"][1] != want["losses"][0]


# ---------------------------------------------------------------------------
# (g) evaluate and predict
# ---------------------------------------------------------------------------


def _write_clips(root, n, seed=1, seconds=(0.4, 1.6)):
    rng = np.random.RandomState(seed)
    files, labels = [], []
    for i in range(n):
        m = int(rng.uniform(*seconds) * SR)
        t = np.arange(m) / SR
        audio = 0.3 * np.sin(2 * np.pi * (250 + 200 * (i % 4)) * t) \
            + 0.02 * rng.randn(m)
        path = os.path.join(root, f"clip{i:02d}.wav")
        audio_io.write_wav(path, audio, SR)
        files.append(path)
        labels.append(f"c{i % N_CLASSES}")
    return files, labels


def test_evaluate_and_predict_on_two_ranks_equal_one_process(tmp_path):
    """7 clips of two buckets at batch size 3 (2 on 2 ranks): the
    predictions in dataset order within 1e-5 of one process's, and the
    validation lwlrap within 1e-6, on both ranks; a batch of one clip
    leaves rank 1 a padded row, which is dropped."""
    files, labels = _write_clips(str(tmp_path), 7)
    inp = {"files": files, "labels": labels, "n_classes": N_CLASSES}
    ranks = run_ranks(tmp_path, "eval", inp)
    want = worker.case_eval(None, inp)
    for got in ranks:
        assert got["probs"].shape == (7, N_CLASSES)
        np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5)
        assert got["score"] == pytest.approx(want["score"], abs=1e-6)
    rank1 = worker._clip_loader(mesh_lib.Mesh(1, 2), inp)
    assert any(b["n_real"] < len(b["index"]) for b in rank1)


# ---------------------------------------------------------------------------
# (h) resume
# ---------------------------------------------------------------------------


def test_two_rank_resume_is_bit_for_bit_and_resumes_in_one_process(
        tmp_path):
    """2 ranks, 2 epochs straight against 1 epoch, a kill and ``resume``:
    with the effects chain, chunk shuffle, head dropout and a partial
    accumulation in the bundle, the resumed weights, scores and step count
    equal the straight run's bit for bit (each rank's generators come back
    from the bundle). One process then resumes the bundle of 2 ranks (JAX
    resumes at any mesh size) for a third epoch, its augmenter and dropout
    drawn from ``resume_seed(seed, 0, global_step)``."""
    files, labels = _write_clips(str(tmp_path), 12, seconds=(1.1, 1.6))
    cfg = dict(_train_cfg("adam", 3e-3, 2), _save_every=1)
    inp = {"files": files, "labels": labels, "n_classes": N_CLASSES,
           "cfg": cfg, "root": str(tmp_path)}
    got = run_ranks(tmp_path, "resume", inp)[0]
    assert got["scores"] == got["want_scores"]
    assert got["steps"] == (6, 6)
    for name, t in got["want"].items():
        assert torch.equal(got["got"][name], t), name
    assert max((got["got"][k].float() - got["first"][k].float()).abs().max()
               for k in got["got"]) > 1e-3
    bundle = torch.load(tmp_path / "b" / "checkpoints" / "fold_0" /
                        "last_model.pt", weights_only=True)
    assert bundle["world_size"] == 2 and len(bundle["augment_rng"]) == 2
    assert not torch.equal(*bundle["augment_rng"])
    alone, train, valid = worker._resume_engine(None, inp,
                                                str(tmp_path / "b"))
    scores = alone.fit_validate(train, valid, epochs=3, fold=0, resume=True)
    assert scores[:2] == got["scores"] and len(scores) == 3
    assert alone.global_step == 9
    assert alone.generator.initial_seed() == mesh_lib.resume_seed(
        7, 0, global_step=6)
    assert max((alone.model.state_dict()[k].float()
                - got["got"][k].float()).abs().max() for k in got["got"]) > 0


def test_ranks_take_rank_0s_files_by_broadcast(tmp_path):
    """Rank 0 writes each model file a second late, and rank 1's
    checkpoint directory is one it never sees written (a disk of its
    own). After 2 epochs every rank's ``load_model("best_model")`` holds
    the weights of rank 0's ``best_model.npz`` bit for bit, and their
    predictions are one process's from that file within 1e-5. A resumed
    third epoch then runs on both ranks from rank 0's bundle, with the
    same scores and 3 epochs' 9 steps in all."""
    files, labels = _write_clips(str(tmp_path), 12, seconds=(1.1, 1.6))
    inp = {"files": files, "labels": labels, "n_classes": N_CLASSES,
           "cfg": _train_cfg("adam", 3e-3, 2), "root": str(tmp_path)}
    ranks = run_ranks(tmp_path, "rank0_files", inp)
    assert not os.path.exists(tmp_path / "unseen1")
    alone, _, valid = worker._resume_engine(None, inp, str(tmp_path / "x"))
    checkpoints.load_model(str(tmp_path / "rank0" / "checkpoints" / "fold_0"
                               / "best_model.npz"), alone.model)
    want = alone.predict(valid)
    for got in ranks:
        for name, t in alone.model.state_dict().items():
            assert torch.equal(got["best"][name], t), name
        np.testing.assert_allclose(got["probs"], want, atol=1e-5)
        assert got["scores"] == ranks[0]["scores"]
        assert got["resumed_scores"][:2] == got["scores"]
        assert got["resumed_scores"] == ranks[0]["resumed_scores"]
        assert got["resumed_steps"] == 9


def test_warm_start_reaches_every_rank_from_rank_0(tmp_path):
    """The finetune CLI's warm start on 2 ranks, where only rank 0 can
    read the ``.npz`` (rank 1 is given a path that does not exist): both
    ranks end with the file's weights and BatchNorm statistics bit for
    bit, which differ from the fresh model's."""
    net = types.SimpleNamespace(**worker.CFG, aggregation_type="max",
                                output_dropout=0.0)
    source = create_model(net, N_CLASSES, torch.float32, 5, "cpu")
    with torch.no_grad():
        for name, t in source.state_dict().items():
            if name.endswith("running_mean"):
                t.add_(0.25)
    path = str(tmp_path / "best_model.npz")
    checkpoints.save_model(path, source)
    want = create_model(net, N_CLASSES, torch.float32, 11, "cpu")
    fresh = {k: t.clone() for k, t in want.state_dict().items()}
    checkpoints.load_model(path, want)
    for got in run_ranks(tmp_path, "warm_start",
                         {"path": path, "n_classes": N_CLASSES}):
        for name, t in want.state_dict().items():
            assert torch.equal(got[name], t), name
        for name in ("blocks.0.conv.weight", "blocks.0.bn_in.running_mean"):
            assert not torch.equal(got[name], fresh[name]), name


# ---------------------------------------------------------------------------
# (i) the train CLIs under torchrun
# ---------------------------------------------------------------------------


def _write_dataset(root, n=16):
    train_dir = os.path.join(root, "train")
    os.makedirs(train_dir)
    files, _ = _write_clips(train_dir, n, seed=10, seconds=(0.7, 1.4))
    classes = [f"class_{c}" for c in range(3)]
    with open(os.path.join(root, "train.csv"), "w") as f:
        f.write("fname,labels\n")
        for i, path in enumerate(files):
            f.write(f"{os.path.basename(path)},{classes[i % 3]}\n")
    with open(os.path.join(root, "classmap.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(classes)}, f)


CLI_ARGS = {
    "train_2d_cnn": [
        "--features", "mel_512_256_32", "--num_conv_blocks", "2",
        "--conv_base_depth", "8", "--start_deep_supervision_on", "0",
        "--aggregation_type", "max", "--optimizer", "adam", "--scheduler",
        "1cycle_0.0001_0.005", "--p_mixup", "0.5", "--p_aug", "0.75",
        "--n_folds", "4"],
    "train_apc": [
        "--features", "mel_1024_1024_16", "--optimizer", "adam",
        "--n_folds", "8", "--rnn_size", "8", "--rnn_layers", "2",
        "--p_aug", "0"],
}


def _artifacts(exp_root):
    """Every file under the experiments dir, tensorboard event files by
    their directory."""
    out = set()
    for path in glob.glob(os.path.join(exp_root, "**", "*"), recursive=True):
        rel = os.path.relpath(path, exp_root)
        if "events.out.tfevents" in rel:
            rel = os.path.join(os.path.dirname(rel), "events.out.tfevents")
        out.add(rel)
    return out


@pytest.mark.parametrize("cli,main", [("train_2d_cnn", train_2d_cnn.main),
                                      ("train_apc", train_apc.main)])
def test_cli_on_two_ranks_writes_one_process_artifacts(tmp_path, cli, main):
    """The CLI under ``torch.distributed.run --nproc_per_node 2 ...
    --mesh_devices 2`` on the CPU: its experiment holds exactly the files
    of a single-process run, its log has the fold's lines once (rank 1
    prints nothing and writes no file), the losses are finite, and each
    rank appends its launch counts to ``$FSC_LAUNCH_LOG`` with its rank.
    Without augmentation (APC's run) the ranks' weights are one process's
    up to rounding, and rank 0's representation probe over every
    validation clip gives the single-process ``knn_accuracy``: APC's fold
    holds 2 clips, so a probe over one rank's slice (1 clip, 5 frames)
    would lack the 10 frames it needs and give NaN."""
    root = str(tmp_path)
    _write_dataset(root)
    argv = ["--train_df", os.path.join(root, "train.csv"),
            "--train_data_dir", os.path.join(root, "train"),
            "--classmap", os.path.join(root, "classmap.json"),
            "--device", "cpu", "--batch_size", "4", "--max_audio_length",
            "1", "--epochs", "2", "--folds", "1", "--num_workers", "0",
            *CLI_ARGS[cli]]
    main(argv + ["--experiments_dir", os.path.join(root, "one")])
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               FSC_LAUNCH_LOG=os.path.join(root, "launches.jsonl"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         f"freesound_classification_tpu_torch.cli.{cli}", *argv,
         "--experiments_dir", os.path.join(root, "two"),
         "--mesh_devices", "2"],
        cwd=root, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert _artifacts(os.path.join(root, "two")) == \
        _artifacts(os.path.join(root, "one"))
    (log,) = glob.glob(os.path.join(root, "two", "*", "log"))
    text = open(log).read()
    assert text.count("Fold 1") == 1 and text.count("Epoch 1:") == 1
    results = [json.load(open(path))["fold1"] for path in (
        *glob.glob(os.path.join(root, "two", "*", "results.json")),
        *glob.glob(os.path.join(root, "one", "*", "results.json")))]
    losses = results[0]["train_loss"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    if cli == "train_apc":
        assert results[0]["knn_accuracy"] == results[1]["knn_accuracy"]
    lines = [json.loads(x) for x in open(env["FSC_LAUNCH_LOG"])]
    assert sorted(x["rank"] for x in lines) == [0, 1]


# ---------------------------------------------------------------------------
# (j) what raises
# ---------------------------------------------------------------------------


def test_mesh_refuses_a_launch_it_cannot_run(monkeypatch):
    """``--mesh_devices 2`` without ``torchrun`` raises and says how to
    launch; a count other than ``WORLD_SIZE`` raises; a rank whose
    ``LOCAL_RANK`` has no card of its own raises before any process group
    (no fallback to the CPU or another rank's card); ``--fold_parallel``
    with 5 folds over 2 ranks (JAX's 1 x 2 fold x data layout) and 2 folds
    over 2 ranks (a fold a rank) are launches it runs, with
    ``--mesh_devices`` or ``torchrun``'s world size alone (the mesh is
    made, the process group's set-up stubbed); and without ``torchrun``
    the mesh is the single process on the asked device."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        mesh_lib.make_mesh(2, "cpu", env={})
    alone = mesh_lib.make_mesh(None, "cpu", env={})
    assert not alone.distributed and alone.world_size == 1
    assert alone.device == torch.device("cpu")
    env = {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1"}
    with pytest.raises(ValueError, match="started 2 ranks"):
        mesh_lib.make_mesh(3, "cpu", env=env)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no card"):
        mesh_lib.make_mesh(2, "cuda", env=env)
    for folds in (list(range(5)), [0, 1]):
        for devices in (2, None):  # --mesh_devices, or torchrun's alone
            args = types.SimpleNamespace(fold_parallel=True, folds=folds,
                                         mesh_devices=devices, device="cpu")
            mesh = accepted_by_the_cli(monkeypatch, args, 1, world=2)
            assert (mesh.rank, mesh.world_size) == (1, 2)
            assert mesh.device == torch.device("cpu")


def test_engine_without_a_group_takes_the_single_process_path():
    """A ``Mesh`` without a process group leaves the engine as it was:
    no mesh, the generator on the seed itself."""
    model = torch.nn.Linear(2, 2)
    engine = Engine(model, worker.unflatten, types.SimpleNamespace(),
                    device="cpu", seed=3, mesh=mesh_lib.Mesh())
    assert engine.mesh is None
    assert torch.equal(engine.generator.get_state(),
                       torch.Generator().manual_seed(3).get_state())
