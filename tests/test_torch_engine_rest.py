"""The rest of the port's engine against the JAX package's, on the CPU:
gradient accumulation (``optax.MultiSteps``), resume bundles, summaries,
and the train CLIs' ``--resume`` and ``--accumulation_steps``.

Inputs and weights are made with numpy from seeds and handed to both sides,
float32 at a tiny width (mel_512_256_32, 2 blocks, base depth 8).
"""

import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from freesound_classification_tpu.models.classifiers import (
    TwoDimensionalCNN as JaxCNN,
)
from freesound_classification_tpu.models.frontend import Frontend as JaxFrontend
from freesound_classification_tpu.parallel import mesh as mesh_lib
from freesound_classification_tpu.training.engine import Engine as JaxEngine
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import common, train_2d_cnn
from freesound_classification_tpu_torch.data import audio_io
from freesound_classification_tpu_torch.data.dataset import ClipDataset
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.models.classifiers import (
    TwoDimensionalCNN,
)
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops import dsp
from freesound_classification_tpu_torch.ops.augment import (
    AugmentConfig,
    make_augmenter,
)
from freesound_classification_tpu_torch.training import checkpoints
from freesound_classification_tpu_torch.training.engine import (
    Engine,
    spectrogram_grid,
)
from freesound_classification_tpu_torch.training.state import create_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 44100
DESCRIPTOR = "mel_512_256_32"
N_CLASSES = 4
CLIP = 8192
CFG = dict(num_conv_blocks=2, start_deep_supervision_on=0,
           conv_base_depth=8, growth_rate=2.0)


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


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _batches(n=3, b=4, seed=0):
    """Random waves of 8192 samples with ragged lengths, zero past them as
    the loader pads, and labels."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        lengths = rng.randint(CLIP // 2, CLIP + 1, b).astype(np.int32)
        lengths[0] = CLIP
        signal = (0.3 * rng.randn(b, CLIP)).astype(np.float32)
        signal[np.arange(CLIP)[None, :] >= lengths[:, None]] = 0.0
        labels = (rng.rand(b, N_CLASSES) < 0.4).astype(np.float32)
        labels[:, 0] = 1.0
        out.append({"signal": signal, "lengths": lengths, "labels": labels,
                    "index": np.arange(b * i, b * i + b)})
    return out


def _feature_batches():
    """``_batches``' waves as their mel_512_256_32 log-mel features
    (flattened, with the frame counts as lengths), for engines whose
    frontend only unflattens them: both packages' engines then see the same
    inputs, and a comparison sees the engines, not the two featurizations
    (6.3e-5 apart, F3, which a max-pool's argmax turns into gradients
    1e-2 apart)."""
    frontend = Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu")
    out = []
    for batch in _batches():
        feats, frames = frontend(torch.from_numpy(batch["signal"]),
                                 torch.from_numpy(batch["lengths"]))
        out.append(dict(batch, signal=feats.reshape(len(feats), -1).numpy(),
                        lengths=frames.numpy().astype(np.int32)))
    return out


def _unflatten(feats, frames):
    return feats.reshape(feats.shape[0], 32, -1)[..., None], frames


def _train_cfg(optimizer, lr, accumulation_steps=2):
    return types.SimpleNamespace(
        optimizer=optimizer, learning_rate=lr,
        scheduler=f"1cycle_{lr / 10:g}_{lr:g}", weight_decay=0.0,
        accumulation_steps=accumulation_steps,
        switch_off_augmentations_on=100, _save_every=1000)


def _engines(cfg, loader):
    """JAX's engine on one device (no mesh padding in the batch
    statistics) and the port's, both from the JAX engine's init and both
    behind ``_unflatten``."""
    jaxe = JaxEngine(JaxCNN(**CFG, aggregation_type="max",
                            n_classes=N_CLASSES), _unflatten, cfg,
                     loss="lsep_naive", mesh=mesh_lib.make_mesh(1), seed=0)
    jaxe.make_optimizer(6, 3)
    jaxe.init_state(loader[0])
    params = jax.tree.map(np.asarray, jaxe.state.params)
    stats = jax.tree.map(np.asarray, jaxe.state.batch_stats)
    model = TwoDimensionalCNN(**CFG, aggregation_type="max",
                              n_classes=N_CLASSES)
    model.load_state_dict(interop.from_jax_variables(params, stats))
    port = Engine(model, _unflatten, cfg, loss="lsep_naive", device="cpu")
    return jaxe, port, params


@pytest.mark.parametrize("optimizer,lr", [("momentum", 1e-4),
                                          ("adam", 1e-3)])
def test_accumulation_matches_jax_multisteps(optimizer, lr):
    """Accumulation 2 over 2 epochs of 3 batches against JAX's engine with
    ``accumulation_steps=2`` (``optax.MultiSteps``), on the same log-mel
    inputs: a partial mean crosses the epoch's end, BatchNorm moves on
    every micro-batch, the c-th update takes the learning rate
    schedule(2 c), and Adam counts updates, not micro-batches.

    After each epoch: the update and micro-batch counts; the learning rate
    of every update within 1e-5 (relative). The gradients agree to 1e-2 of
    their largest (``test_train_step_matches_jax``: the convolutions sum in
    another order, which can move a max-pool's argmax), so a parameter is
    held to 1e-5 plus 1e-2 of its largest move from the init, that test's
    1e-5 + 1e-2 lr for one Adam step. Under momentum (lr 1e-4; at 1e-3
    its third update moves block0's kernel by a tenth of its size, and the
    two trajectories part by 11% of the move) every parameter is held so,
    and the BatchNorm statistics within 1e-5 absolute and 1e-4 relative:
    both packages take the batch variance as E[x^2] - E[x]^2, which on the
    input BatchNorm's log-mel values cancels (E[x^2] is some 40 times the
    variance), so the last bits of two sums in another order come out
    1.6e-5 apart there. Adam steps by +-lr whatever a gradient's size, so
    an element whose gradient is under the 1e-2 agreement can take the
    other sign: every element is held to 2.01 times the sum of the
    learning rates (each update's +-lr, either sign), and at most 10% of
    all elements may fall outside the tight bound (a step count advanced
    per micro-batch would move every element by about a quarter of lr);
    its statistics, which the biases ahead of a BatchNorm shift by their
    coin-flip steps, are left to momentum."""
    loader = _feature_batches()
    cfg = _train_cfg(optimizer, lr)
    jaxe, port, params = _engines(cfg, loader)
    init = dict(_leaves(params))
    port.make_optimizer(6, 3)
    lrs = []
    step = port.optimizer.step

    def recording_step(*a, **k):
        lrs.append(port.optimizer.param_groups[0]["lr"])
        return step(*a, **k)

    port.optimizer.step = recording_step
    for epoch in range(2):
        jaxe.train_epoch(loader, epoch, log_interval=100)
        port.train_epoch(loader, 1.0, log_interval=100)
        opt_state = jaxe.state.opt_state
        n_updates = int(opt_state.gradient_step)
        assert n_updates == port.updates == len(lrs) == [1, 3][epoch]
        assert int(opt_state.mini_step) == port.micro_step == [1, 0][epoch]
        # JAX's inner optimizer samples the schedule at 2 c
        np.testing.assert_allclose(
            lrs, [float(jaxe.schedule(2 * c)) for c in range(n_updates)],
            rtol=1e-5)
        got_p, got_s = interop.to_jax_variables(port.model.state_dict())
        want_p = dict(_leaves(jax.tree.map(np.asarray, jaxe.state.params)))
        outside, total = 0, 0
        for name, value in _leaves(got_p):
            err = np.abs(value - want_p[name])
            tight = 1e-5 + 1e-2 * np.abs(want_p[name] - init[name]).max()
            if optimizer == "momentum":
                assert err.max() <= tight, (name, err.max(), tight)
            else:
                assert err.max() <= 2.01 * sum(lrs), name
                outside += int((err > tight).sum())
                total += err.size
        if optimizer == "adam":
            counts = {int(s["step"]) for s in port.optimizer.state.values()}
            assert counts == {n_updates}
            assert outside <= 0.1 * total, (outside, total)
        else:
            want_s = dict(_leaves(jax.tree.map(np.asarray,
                                               jaxe.state.batch_stats)))
            for name, value in _leaves(got_s):
                np.testing.assert_allclose(value, want_s[name], rtol=1e-4,
                                           atol=1e-5, err_msg=name)
    # the parameters moved by far more than 1e-5
    assert max(np.abs(v - init[k]).max() for k, v in _leaves(got_p)) > 1e-3


# ---------------------------------------------------------------------------
# F5: the overdrive's IIR builds its matrices once
# ---------------------------------------------------------------------------


def test_iir_matrices_are_built_once_per_key():
    """A second ``iir_first_order`` call with the same (a, chunk, blocks,
    device) builds nothing (the cache keeps its size and misses, and its
    hits go up by one) and returns the same bits; another length with
    another block count adds its own entry; the entries are the
    float64-built matrices cast to float32."""
    rng = np.random.RandomState(0)
    u = torch.from_numpy(rng.randn(3, 5000).astype(np.float32))
    dsp.iir_matrices.cache_clear()
    first = dsp.iir_first_order(u, 0.995)
    before = dsp.iir_matrices.cache_info()
    again = dsp.iir_first_order(u, 0.995)
    after = dsp.iir_matrices.cache_info()
    assert (before.currsize, before.misses, before.hits) == (1, 1, 0)
    assert (after.currsize, after.misses, after.hits) == (1, 1, 1)
    assert torch.equal(first, again)
    dsp.iir_first_order(u[:, :700], 0.995)  # 2 blocks of 512, not 10
    assert dsp.iir_matrices.cache_info().currsize == 2
    tri, tri2, decay = dsp.iir_matrices(0.995, 512, 10, torch.device("cpu"))
    assert dsp.iir_matrices.cache_info().currsize == 2
    assert tri.dtype == tri2.dtype == decay.dtype == torch.float32
    assert tri[7, 2].item() == np.float32(0.995 ** 5)
    assert tri[2, 7].item() == 0.0
    assert tri2[3, 1].item() == np.float32((0.995 ** 512) ** 2)
    assert decay[4].item() == np.float32(0.995 ** 5)


# ---------------------------------------------------------------------------
# resume bundles
# ---------------------------------------------------------------------------


def _write_clips(root, n=12, seed=1):
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


def _resume_engine(root, files, labels, seed=7):
    """The port's engine with the recipe's augmentation less MixUp (whose
    partner pool restarts on resume, as in JAX), head dropout on,
    accumulation 2, over a train loader of 3 batches an epoch."""
    net = types.SimpleNamespace(**CFG, aggregation_type="max",
                                output_dropout=0.5)
    cfg = _train_cfg("adam", 3e-3)
    cfg._save_every = 1
    torch.manual_seed(seed)
    engine = Engine(
        create_model(net, N_CLASSES, torch.float32, seed, "cpu"),
        Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu"), cfg,
        augment=make_augmenter(AugmentConfig(p_aug=0.5, p_shuffle=0.5)),
        checkpoint_dir=os.path.join(root, "checkpoints"), seed=seed,
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
    return engine, train, valid


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """3 epochs straight against 1 epoch, a new engine, then
    ``resume=True``: with augmentation, dropout and a partial accumulation
    (3 micro-batches an epoch, 2 a mean) in the bundle, the resumed run
    ends with the same weights and statistics (atol 1e-7), scores and
    ``global_step``, and starts at epoch 1."""
    files, labels = _write_clips(str(tmp_path))
    straight, train, valid = _resume_engine(str(tmp_path / "a"), files,
                                            labels)
    assert len(train) == 3
    want_scores = straight.fit_validate(train, valid, epochs=3, fold=0)
    want = straight.model.state_dict()

    first, train, valid = _resume_engine(str(tmp_path / "b"), files, labels)
    calls = []
    train_epoch = first.train_epoch

    def stop_after_one(*a, **k):
        if calls:
            raise KeyboardInterrupt("killed after epoch 0")
        calls.append(1)
        return train_epoch(*a, **k)

    first.train_epoch = stop_after_one
    with pytest.raises(KeyboardInterrupt):
        first.fit_validate(train, valid, epochs=3, fold=0)
    bundle = checkpoints.load_bundle(first.bundle_path(0))
    assert bundle["meta"]["epoch"] == 0 and bundle["micro_step"] == 1
    assert bundle["accumulated"] is not None

    resumed, train, valid = _resume_engine(str(tmp_path / "b"), files,
                                           labels, seed=8)
    epochs = []
    epoch_fn = resumed.train_epoch

    def count_epochs(*a, **k):
        epochs.append(train._epoch)
        return epoch_fn(*a, **k)

    resumed.train_epoch = count_epochs
    scores = resumed.fit_validate(train, valid, epochs=3, fold=0,
                                  resume=True)
    assert epochs == [1, 2]  # the loader's epoch counter before each
    assert scores == want_scores
    assert resumed.global_step == straight.global_step == 9
    got = resumed.model.state_dict()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=1e-7, rtol=0, err_msg=name)
    assert max((got[k].float() - first.model.state_dict()[k].float())
               .abs().max().item() for k in got) > 1e-3


def test_a_fold_without_a_bundle_starts_fresh(tmp_path):
    """``resume=True`` on a fold with no bundle trains from epoch 0, as a
    run without it does."""
    files, labels = _write_clips(str(tmp_path), n=8)
    runs = []
    for name, resume in (("plain", False), ("resume", True)):
        engine, train, valid = _resume_engine(str(tmp_path / name), files,
                                              labels)
        scores = engine.fit_validate(train, valid, epochs=1, fold=3,
                                     resume=resume)
        runs.append((scores, engine.global_step,
                     engine.model.state_dict()))
        assert os.path.isfile(engine.bundle_path(3))
    (s0, g0, w0), (s1, g1, w1) = runs
    assert s0 == s1 and g0 == g1 == 2
    for name in w0:
        np.testing.assert_array_equal(w0[name].numpy(), w1[name].numpy())


# saves bundles v = start + 1, start + 2, ...: the model and the meta both
# hold v; every rename sleeps 20 ms after it, so that kills land around them
BUNDLE_WORKER = """
import os, sys, time
import torch
sys.path.insert(0, sys.argv[2])
from freesound_classification_tpu_torch.training import checkpoints
real = os.replace
def slow(a, b):
    real(a, b)
    time.sleep(0.02)
os.replace = slow
i = int(sys.argv[3])
print("READY", flush=True)
while True:
    i += 1
    checkpoints.save_bundle(sys.argv[1], {
        "model": {"w": torch.full((64, 64), float(i))},
        "optimizer": {"state": {0: {"step": torch.tensor(float(i))}}},
        "meta": {"epoch": i, "scores": [float(i)] * 3}})
"""


def test_sigkill_during_bundle_saves_leaves_a_paired_bundle(tmp_path):
    """Eight kills at random points of a bundle-save loop: after each, the
    bundle at the path is whole, its state and its progress are of one
    save (the previous one or the new one, never one without the other),
    and it is never older than what the previous kill left."""
    path = str(tmp_path / "fold_0" / "last_model.pt")
    rng = np.random.RandomState(0)
    last = 0
    for start in range(0, 8 * 100000, 100000):
        proc = subprocess.Popen(
            [sys.executable, "-c", BUNDLE_WORKER, path, REPO, str(start)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            assert proc.stdout.readline().strip() == "READY"
            time.sleep(rng.uniform(0.05, 0.4))
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
        bundle = checkpoints.load_bundle(path)
        version = bundle["meta"]["epoch"]
        assert (bundle["model"]["w"] == version).all()
        assert bundle["optimizer"]["state"][0]["step"] == version
        assert bundle["meta"]["scores"] == [float(version)] * 3
        assert version >= max(last, 1)
        last = version
    assert last > 100000


# ---------------------------------------------------------------------------
# summaries
# ---------------------------------------------------------------------------


class RecordingWriter:
    """A tensorboard writer that records what it is given."""

    def __init__(self, split, log):
        self.split, self.log = split, log

    def add_scalar(self, tag, value, step):
        self.log.append((self.split, tag, int(step), float(value)))

    def add_image(self, tag, image, step):
        self.log.append((self.split, tag, int(step),
                         np.asarray(image, np.float32)))

    def add_histogram(self, tag, values, global_step):
        self.log.append((self.split, tag, int(global_step),
                         np.sort(np.asarray(values, np.float32))))

    def close(self):
        pass


def test_summaries_match_jax():
    """``fit_validate`` for 2 epochs of 3 batches, logging every 2nd batch,
    with a recording writer on both sides and the same log-mel inputs:
    the same (split, tag, step) sequence (train loss, metric and lr at
    batches 0 and 2, the first batch's spectrogram grid, the per-sample
    loss histogram, then valid loss and metric); scalars and the grid
    within 1e-4, and the histogram's per-sample losses of train-mode
    batches within 2e-4, as ``test_train_step_matches_jax`` holds a
    train-mode batch's logits (a BatchNorm over 4 rows amplifies the
    sums' last bits). lr 1e-5 keeps the two trajectories within 2e-7 of
    each other, so the comparison sees the summaries. Then the grid of the
    two packages' log-mel frontends on the same waves, within 1e-4."""
    loader = _feature_batches()
    cfg = _train_cfg("momentum", 1e-5, accumulation_steps=1)
    logs = {"jax": [], "port": []}
    jaxe, port, _ = _engines(cfg, loader)
    jaxe._writer_factory = lambda fold, split: RecordingWriter(
        split, logs["jax"])
    port._writer_factory = lambda fold, split: RecordingWriter(
        split, logs["port"])
    jaxe.fit_validate(loader, loader, epochs=2, fold=0, log_interval=2)
    port.fit_validate(loader, loader, epochs=2, fold=0, log_interval=2)
    keys = [entry[:3] for entry in logs["jax"]]
    assert [entry[:3] for entry in logs["port"]] == keys
    assert keys[:5] == [("train", "loss", 1), ("train", "metric", 1),
                        ("train", "lr", 1), ("train", "signal", 1),
                        ("train", "loss", 3)]
    assert ("train", "losses", 3) in keys and ("valid", "metric", 6) in keys
    for want, got in zip(logs["jax"], logs["port"]):
        atol = 2e-4 if want[1] == "losses" else 1e-4
        np.testing.assert_allclose(got[3], want[3], atol=atol, rtol=0,
                                   err_msg=str(want[:3]))

    waves = _batches()[0]
    jaxe.frontend = JaxFrontend(DESCRIPTOR, "2d", sr=SR)
    jaxe.train_writer = RecordingWriter("train", logs["jax"])
    jaxe._add_image_summary({"signal": jnp.asarray(waves["signal"]),
                             "lengths": jnp.asarray(waves["lengths"])})
    want = logs["jax"][-1]
    assert want[:2] == ("train", "signal")
    feats, _ = Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu")(
        torch.from_numpy(waves["signal"]), torch.from_numpy(waves["lengths"]))
    grid = spectrogram_grid(feats)
    assert grid.shape == (1, 4 * 32, 33) and 0 <= grid.min() < grid.max()
    np.testing.assert_allclose(grid, want[3], atol=1e-4, rtol=0)


def test_build_engine_writes_summaries_where_tensorboardx_imports(
        tmp_path, monkeypatch):
    """The train CLIs' writer factory: tensorboardX's writer under
    ``summaries/fold_k/<split>`` where it imports, None where it does not
    (the card's machine has no tensorboardX)."""
    from test_torch_train import train_2d_cnn_args
    from freesound_classification_tpu_torch.utils.experiment import (
        Experiment,
    )

    args = train_2d_cnn_args(str(tmp_path), str(tmp_path))
    experiment = Experiment(common.experiment_config(args, 3, 32),
                            experiments_dir=str(tmp_path))
    engine = common.build_engine(args, experiment, 3, torch.device("cpu"))
    try:
        import tensorboardX  # noqa: F401
    except ImportError:
        assert engine._writer_factory(0, "train") is None
    else:
        writer = engine._writer_factory(2, "valid")
        writer.close()
        assert os.path.isdir(os.path.join(experiment.experiment_dir,
                                          "summaries", "fold_2", "valid"))
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    assert engine._writer_factory(0, "train") is None


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


def test_train_cli_accumulates_and_resumes(tmp_path):
    """The 2d train CLI with ``--accumulation_steps 2`` writes the fold's
    bundle; the same command with ``--resume`` re-enters the experiment
    (without it the directory exists and the CLI refuses), finds the last
    epoch done, trains no further and keeps the results; the experiment's
    config records the accumulation."""
    from test_torch_train import _write_dataset

    root = str(tmp_path)
    _write_dataset(root)
    argv = [
        "--train_df", os.path.join(root, "train.csv"),
        "--train_data_dir", os.path.join(root, "train"),
        "--classmap", os.path.join(root, "classmap.json"),
        "--device", "cpu", "--features", DESCRIPTOR,
        "--num_conv_blocks", "2", "--conv_base_depth", "8",
        "--start_deep_supervision_on", "0", "--aggregation_type", "max",
        "--optimizer", "adam", "--scheduler", "1cycle_0.0001_0.005",
        "--p_aug", "0.5", "--batch_size", "4", "--max_audio_length", "1",
        "--epochs", "2", "--n_folds", "4", "--folds", "1",
        "--num_workers", "0", "--accumulation_steps", "2",
        "--experiments_dir", os.path.join(root, "experiments")]
    experiment = train_2d_cnn.main(argv)
    fold_dir = os.path.join(experiment.experiment_dir, "checkpoints",
                            "fold_1")
    bundle = checkpoints.load_bundle(os.path.join(fold_dir, "last_model.pt"))
    assert bundle["meta"]["epoch"] == 1
    # 15 train clips: 3 batches an epoch, 6 micro-batches, 3 updates
    assert bundle["global_step"] == 6 and bundle["updates"] == 3
    assert experiment.config.train.accumulation_steps == 2
    results = dict(experiment.results)
    with pytest.raises(FileExistsError, match="--resume"):
        train_2d_cnn.main(argv)
    again = train_2d_cnn.main(argv + ["--resume"])
    assert again.experiment_dir == experiment.experiment_dir
    assert again.results["fold1"]["metric"] == results["fold1"]["metric"]
    log = open(os.path.join(experiment.experiment_dir, "log")).read()
    assert "resuming fold 1 from epoch 2" in log
