"""Fold-parallel training of the port (``training/multifold.py``) against
the JAX package's ``MultiFoldEngine`` and against K single-fold port
engines, on the CPU: batch stacking and cycling, the stacked step, MixUp
within each fold, the warm start, exact resume, and the train CLIs and
recipe kit with ``--fold_parallel``.

Inputs and weights are made with numpy from seeds and handed to both
sides, float32 at a tiny width (mel_512_256_32, 2 blocks, base depth 8,
1 s clips, 2-3 folds).
"""

import csv
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import jax
from jax.sharding import Mesh

from freesound_classification_tpu.models.classifiers import (
    TwoDimensionalCNN as JaxCNN,
)
from freesound_classification_tpu.parallel import mesh as mesh_lib
from freesound_classification_tpu.training.engine import Engine as JaxEngine
from freesound_classification_tpu.training.multifold import (
    MultiFoldEngine as JaxMultiFoldEngine,
    _cycle_to,
    _stack_batches,
)
import torch

from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import (
    common,
    finetune_hierarchical_cnn,
    predict_2d_cnn,
    train_2d_cnn,
    train_hierarchical_cnn,
)
from freesound_classification_tpu_torch.data.dataset import ClipDataset
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.models.classifiers import (
    TwoDimensionalCNN,
)
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops.augment import (
    AugmentConfig,
    make_augmenter,
)
from freesound_classification_tpu_torch.training import checkpoints
from freesound_classification_tpu_torch.training import multifold
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.training.multifold import (
    MultiFoldEngine,
    cycle_to,
    stack_batches,
)
from freesound_classification_tpu_torch.training.state import create_model
from tests.test_torch_engine_rest import (
    CFG,
    CLIP,
    DESCRIPTOR,
    N_CLASSES,
    SR,
    _leaves,
    _train_cfg,
    _unflatten,
    _write_clips,
)
from tests.test_torch_hierarchical import _train_argv
from tests.test_torch_hierarchical import _write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(rows, length, seed, n_classes=N_CLASSES):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(length // 2, length + 1, rows).astype(np.int32)
    signal = rng.randn(rows, length).astype(np.float32)
    signal[np.arange(length)[None, :] >= lengths[:, None]] = 0.0
    return {"signal": signal, "lengths": lengths,
            "labels": (rng.rand(rows, n_classes) < 0.4).astype(np.float32),
            "is_noisy": (rng.rand(rows) < 0.5).astype(np.float32)}


# ---------------------------------------------------------------------------
# (a) stacking and cycling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shapes", [
    [(4, 100), (4, 100), (4, 100)],  # equal
    [(6, 100), (4, 100), (5, 100)],  # unequal batch sizes
    [(4, 100), (4, 60), (4, 80)],  # different lengths
    [(3, 50), (6, 120), (1, 90)],  # both
])
def test_stack_batches_matches_jax(shapes):
    """The same numpy batches through JAX's ``_stack_batches`` and the
    port's ``stack_batches``: every key and ``n_real`` exactly equal."""
    batches = [_batch(rows, length, seed)
               for seed, (rows, length) in enumerate(shapes)]
    want, want_real = _stack_batches(batches)
    got, got_real = stack_batches(batches)
    np.testing.assert_array_equal(got_real, want_real)
    assert got_real.dtype == want_real.dtype
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("n_batches,n_steps", [(3, 3), (2, 5), (3, 1)])
def test_cycle_to_matches_jax(n_batches, n_steps):
    """``cycle_to`` yields what ``_cycle_to`` yields, re-iterating the
    loader as often (each pass counted), and both raise on an empty one."""

    class Counting(list):
        passes = 0

        def __iter__(self):
            self.passes += 1
            return super().__iter__()

    want_loader, got_loader = Counting(range(n_batches)), Counting(
        range(n_batches))
    assert (list(cycle_to(got_loader, n_steps))
            == list(_cycle_to(want_loader, n_steps)))
    assert got_loader.passes == want_loader.passes
    for fn in (cycle_to, _cycle_to):
        with pytest.raises(ValueError, match="empty fold loader"):
            list(fn([], 2))


# ---------------------------------------------------------------------------
# (b) the stacked step against JAX's MultiFoldEngine
# ---------------------------------------------------------------------------


def _spectrogram_fold_batches(sizes, n_steps, frames=24, seed=3):
    """Per step, one batch per fold of ``sizes`` rows: random (32 x
    ``frames``) spectrograms, flattened, with ragged frame counts as the
    lengths, which ``_unflatten`` hands to both packages' models as they
    are (well-conditioned inputs, as ``test_train_step_matches_jax``'s:
    log-mel of zero-padded noise makes the input BatchNorm's variance a
    cancelling difference, F3)."""
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
                "lengths": lengths.astype(np.int32), "labels": labels})
        steps.append(folds)
    return steps


def _port_template(cfg, frontend=_unflatten, augment=None, seed=0,
                   checkpoint_dir=None):
    model = TwoDimensionalCNN(**CFG, aggregation_type="max",
                              n_classes=N_CLASSES)
    return Engine(model, frontend, cfg, loss="lsep_naive", augment=augment,
                  checkpoint_dir=checkpoint_dir, seed=seed, device="cpu")


def test_stacked_step_matches_jax_multifold():
    """Three folds of 8, 6 and 5 rows (padding and ``n_real`` matter), 3
    momentum steps at lr 1e-4 through JAX's ``MultiFoldEngine``
    (``init_states``, ``_vmapped_step``, one device, ``aug_scale`` 0,
    dropout 0) and the port's, from JAX's fold states through
    ``interop.stack_jax_fold_states``: each step's per-fold losses and
    batch lwlrap within 1e-4; then each fold's parameters (back through
    ``unstack_jax_fold_states``) within 1e-5 + 1e-2 of each tensor's move,
    as the accumulation parity holds them (the convolutions sum in
    another order, which can move a max-pool's argmax), and the BatchNorm
    statistics within 1e-4 relative, as that test holds them, with its
    1e-5 absolute floor: some running means are zero up to rounding (the
    input BatchNorm's over the frequency-encoding channel, ~1e-8; the
    head's second, over a dense layer of normalised inputs with a zero
    bias, ~1e-7), where an entry's own scale means nothing. (At 4, 3 and 2 rows the head's
    BatchNorm normalises over two or three distinct rows, and the two
    packages' losses part by up to 1e-2 even unstacked: JAX's forward
    then strays from a float64 one by 1.5e-2 in the logits.)"""
    sizes = (8, 6, 5)
    steps = _spectrogram_fold_batches(sizes, 3)
    cfg = _train_cfg("momentum", 1e-4, accumulation_steps=1)
    template = JaxEngine(JaxCNN(**CFG, aggregation_type="max",
                                n_classes=N_CLASSES), _unflatten, cfg,
                         loss="lsep_naive", mesh=mesh_lib.make_mesh(1),
                         seed=0)
    jaxm = JaxMultiFoldEngine(
        template, len(sizes),
        mesh=Mesh(np.asarray(jax.devices()[:1]), ("fold",)))
    jaxm.make_optimizer(6, 3)
    jaxm.init_states(steps[0][0])
    init_p = jax.tree.map(np.asarray, jaxm.states.params)
    init_s = jax.tree.map(np.asarray, jaxm.states.batch_stats)

    port = MultiFoldEngine(_port_template(cfg), [0, 1, 2])
    port.make_optimizer(6, 3)
    stacked = interop.stack_jax_fold_states(init_p, init_s)
    for k in range(len(sizes)):
        port.model.load_fold(k, {n: t[k] for n, t in stacked.items()})

    for folds in steps:
        batch, n_real = stack_batches(folds)
        np.testing.assert_array_equal(n_real, sizes)
        device_batch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
        clean = (device_batch["signal"], device_batch["lengths"],
                 device_batch["labels"])
        jaxm.states, want_loss, want_metric = jaxm._vmapped_step(
            jaxm.states, device_batch, 0.0, jax.numpy.asarray(n_real), clean)
        wave, lengths, labels = port.to_device(batch)
        out = port.train_step(wave, lengths, labels,
                              torch.from_numpy(n_real), aug_scale=0.0)
        np.testing.assert_allclose(out["loss"].numpy(), want_loss,
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(out["metric"].numpy(), want_metric,
                                   rtol=0, atol=1e-4)

    params, buffers = port.model.stacked()
    got_p, got_s = interop.unstack_jax_fold_states({**params, **buffers})
    want_p = dict(_leaves(jax.tree.map(np.asarray, jaxm.states.params)))
    want_s = dict(_leaves(jax.tree.map(np.asarray, jaxm.states.batch_stats)))
    init = dict(_leaves(init_p))
    moved = 0.0
    for name, value in _leaves(got_p):
        for k in range(len(sizes)):
            move = np.abs(want_p[name][k] - init[name][k]).max()
            err = np.abs(value[k] - want_p[name][k]).max()
            assert err <= 1e-5 + 1e-2 * move, (name, k, err, move)
            moved = max(moved, move)
    assert moved > 1e-5
    for name, value in _leaves(got_s):
        np.testing.assert_allclose(value, want_s[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# (c) the stacked step against K single-fold port engines
# ---------------------------------------------------------------------------


def _wave_fold_batches(n_folds, n_batches, rows=4, seed=0, full=False):
    """Per fold, ``n_batches`` batches of random waves of one length with
    ragged valid lengths, as the loader gives them (``full``: every clip
    the whole length)."""
    rng = np.random.RandomState(seed)
    folds = []
    for _ in range(n_folds):
        batches = []
        for i in range(n_batches):
            lengths = rng.randint(CLIP // 2, CLIP + 1, rows).astype(np.int32)
            if full:
                lengths[:] = CLIP
            signal = (0.3 * rng.randn(rows, CLIP)).astype(np.float32)
            signal[np.arange(CLIP)[None, :] >= lengths[:, None]] = 0.0
            labels = (rng.rand(rows, N_CLASSES) < 0.4).astype(np.float32)
            labels[:, 0] = 1.0
            batches.append({"signal": signal, "lengths": lengths,
                            "labels": labels,
                            "index": np.arange(rows * i, rows * i + rows)})
        folds.append(batches)
    return folds


def _worst(got: dict, want: dict, names) -> float:
    """The largest |got - want| over ``names`` divided by the largest
    |want| among them."""
    top = max(float(want[n].abs().max()) for n in names)
    return max(float((got[n] - want[n]).abs().max()) for n in names) / top


@pytest.mark.parametrize("accumulation_steps", [1, 2])
def test_stacked_step_matches_single_fold_engines(accumulation_steps):
    """Three folds, 2 epochs of 2 equal batches of 8 whole-length clips,
    the recipe's augmentation (MixUp, the effects chain, chunk shuffle),
    momentum at lr 1e-3, float32, dropout 0: the stacked engine against
    three single-fold port engines started from the same weights with
    seeds ``seed + k``. The stacked frontend's rows equal each fold's
    frontend's exactly; each epoch's per-fold losses are within 1e-5
    relative; at the end each fold's parameters are within 1e-5 of the
    fold's largest parameter, each BatchNorm statistic within 1e-5 of its
    own largest entry, and the fold's slice of the momentum buffers within
    1e-4 of their largest entry (a buffer sums gradients, which a
    max-pool's near-tie moves by more than it moves the weights: the
    JAX parity holds gradients to 1e-2); the update counts are equal. Once with ``accumulation_steps=2``: the gradient
    mean is elementwise, so it stacks too. (On the CPU the float32
    forward of clips with zero tails strays from a float64 one by up to
    5e-4 in the logits, stacked or not: the input BatchNorm's variance of
    log-mel values at the floor cancels.)"""
    # the template's weights are torch's default init: drawn from a fixed
    # seed, not from whatever state earlier tests in this process left
    torch.manual_seed(0)
    cfg = _train_cfg("momentum", 1e-3, accumulation_steps)
    augment = make_augmenter(AugmentConfig(p_mixup=0.5, p_aug=0.75,
                                           p_shuffle=0.5))
    frontend = Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu")
    template = _port_template(cfg, frontend, augment, seed=7)
    init = {n: t.clone() for n, t in template.model.state_dict().items()}
    stack = MultiFoldEngine(template, [0, 1, 2])
    stack.make_optimizer(4, 2)
    singles = []
    for k in range(3):
        engine = _port_template(cfg, frontend, augment, seed=7 + k)
        engine.model.load_state_dict(init)
        engine.make_optimizer(4, 2)
        singles.append(engine)
    folds = _wave_fold_batches(3, 2, rows=8, full=True)
    stacked, _ = stack_batches([batches[0] for batches in folds])
    wave, lengths = (torch.from_numpy(stacked[k])
                     for k in ("signal", "lengths"))
    together, _ = frontend(wave.flatten(0, 1), lengths.flatten(0, 1))
    for k in range(3):
        alone, _ = frontend(wave[k], lengths[k])
        torch.testing.assert_close(together[8 * k:8 * k + 8], alone,
                                   rtol=0, atol=0)
    for _ in range(2):
        got = stack.train_epoch(folds, 1.0, log_interval=100)
        want = [e.train_epoch(b, 1.0, log_interval=100)["loss"]
                for e, b in zip(singles, folds)]
        np.testing.assert_allclose(got["loss"], want, rtol=1e-5)
    assert stack.updates == singles[0].updates == 4 // accumulation_steps
    names = stack.model.param_names
    params = list(stack.model.stacked()[0].values())
    for k, engine in enumerate(singles):
        fold = stack.model.fold_state(k)
        want = engine.model.state_dict()
        assert _worst(fold, want, names) <= 1e-5
        for name in stack.model.buffer_names:
            assert _worst(fold, want, [name]) <= 1e-5, name
        buffers = {n: engine.optimizer.state[q]["momentum_buffer"]
                   for n, q in zip(names, engine.model.parameters())}
        stacked_buffers = {n: stack.optimizer.state[p]["momentum_buffer"][k]
                           for n, p in zip(names, params)}
        assert _worst(stacked_buffers, buffers, names) <= 1e-4
    # the folds trained apart
    assert _worst(stack.model.fold_state(0), stack.model.fold_state(1),
                  names) > 1e-4


# ---------------------------------------------------------------------------
# (d) MixUp partners stay within their fold
# ---------------------------------------------------------------------------


def test_mixup_partners_stay_within_their_fold():
    """Three folds whose every sample is a constant of the fold (10^k,
    times 1 + 0.01 s on step s) and whose labels are class k, 2 steps with
    MixUp on every row (additive, so a mix of the fold's own clips stays
    within its constants): the augmented rows the frontend sees and the
    labels the loss sees hold no other fold's values. The second step's
    partners come from the previous batch's pool."""
    cfg = _train_cfg("momentum", 1e-4, 1)
    real = Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu")
    waves, label_rows = [], []

    def frontend(wave, lengths):
        waves.append(wave.clone())
        return real(wave, lengths)

    augment = make_augmenter(AugmentConfig(p_mixup=1.0,
                                           mixup_quirk_replace=False))
    stack = MultiFoldEngine(_port_template(cfg, frontend, augment), [0, 1, 2])
    stack.make_optimizer(2, 2)
    loss_fn = stack.loss_fn

    def recording_loss(logits, labels, average=True):
        label_rows.append(labels.clone())
        return loss_fn(logits, labels, average=average)

    stack.loss_fn = recording_loss
    rows = 4
    folds = []
    for k in range(3):
        batches = []
        for s in range(2):
            labels = np.zeros((rows, N_CLASSES), np.float32)
            labels[:, k] = 1.0
            batches.append({
                "signal": np.full((rows, CLIP), 10.0**k * (1 + 0.01 * s),
                                  np.float32),
                "lengths": np.full(rows, CLIP, np.int32), "labels": labels})
        folds.append(batches)
    stack.train_epoch(folds, 1.0, log_interval=100)
    assert len(waves) == len(label_rows) == 2
    for wave, labels in zip(waves, label_rows):
        for k in range(3):
            fold = wave[rows * k:rows * (k + 1)]
            lo, hi = 10.0**k, 10.0**k * 1.01
            assert fold.min() >= lo * (1 - 1e-6), (k, fold.min())
            assert fold.max() <= hi * (1 + 1e-6), (k, fold.max())
            others = [c for c in range(N_CLASSES) if c != k]
            assert (labels[rows * k:rows * (k + 1), k] == 1).all()
            assert (labels[rows * k:rows * (k + 1), others] == 0).all()
    # the second step's partners mixed the previous batch in
    assert any(float(wave.max()) > 1.0 + 1e-4 and float(wave.min()) < 1.01
               for wave in waves[1:])


# ---------------------------------------------------------------------------
# (e) the warm start of every fold
# ---------------------------------------------------------------------------


def test_finetune_fold_parallel_warm_starts_every_fold(tmp_path,
                                                       monkeypatch):
    """``finetune_hierarchical_cnn --fold_parallel`` over two folds: at its
    first stacked epoch every fold holds the pretrained fold's weights and
    BatchNorm statistics exactly (JAX's fold-parallel fit draws fresh
    weights instead), and both folds write their files."""
    root = str(tmp_path)
    _write_dataset(root)
    pre = train_hierarchical_cnn.main(
        _train_argv(root, "pre") + ["--epochs", "1"])
    want = interop.from_jax_variables(*interop.load_fold_npz(os.path.join(
        pre.experiment_dir, "checkpoints", "fold_1", "best_model.npz")))
    first = []
    train_epoch = multifold.MultiFoldEngine.train_epoch

    def checked(self, *args, **kwargs):
        if not first:
            first.extend({n: t.clone() for n, t in
                          self.model.fold_state(k).items()}
                         for k in range(len(self.fold_ids)))
        return train_epoch(self, *args, **kwargs)

    monkeypatch.setattr(multifold.MultiFoldEngine, "train_epoch", checked)
    fine = finetune_hierarchical_cnn.main(
        _train_argv(root, "fine") + [
            "--epochs", "1", "--pretrained_model", pre.experiment_dir,
            "--pretrained_fold", "1", "--fold_parallel", "--folds", "0",
            "1"])
    assert len(first) == 2
    for state in first:
        assert state.keys() == want.keys()
        for name, value in want.items():
            torch.testing.assert_close(state[name], value, rtol=0, atol=0,
                                       msg=name)
    log = open(os.path.join(fine.experiment_dir, "log")).read()
    assert "warm start of every fold from" in log
    for fold in (0, 1):
        assert {"best_model.npz", "final_model.npz"} <= set(os.listdir(
            os.path.join(fine.experiment_dir, "checkpoints", f"fold_{fold}")))


# ---------------------------------------------------------------------------
# (f) exact resume
# ---------------------------------------------------------------------------


def _resume_stack(root, files, labels, seed=7):
    """The stacked engine over two folds of 12 and 8 clips (3 and 2
    batches an epoch: the second loader is cycled, so its epoch counter
    runs ahead), with the recipe's augmentation less MixUp (whose pool
    restarts on resume, as in JAX), head dropout on, Adam with
    accumulation 2."""
    net = types.SimpleNamespace(**CFG, aggregation_type="max",
                                output_dropout=0.5)
    cfg = _train_cfg("adam", 3e-3)
    cfg._save_every = 1
    torch.manual_seed(seed)
    template = Engine(
        create_model(net, N_CLASSES, torch.float32, seed, "cpu"),
        Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu"), cfg,
        augment=make_augmenter(AugmentConfig(p_aug=0.5, p_shuffle=0.5)),
        checkpoint_dir=os.path.join(root, "checkpoints"), seed=seed,
        device="cpu")
    classmap = {f"c{k}": k for k in range(N_CLASSES)}
    train, valid = [], []
    for k, n in enumerate((12, 8)):
        train.append(make_loader(
            ClipDataset(files[:n], raw_labels=labels[:n], classmap=classmap,
                        max_audio_length=1, sr=SR, seed=3 + k),
            common.default_ladder(1), batch_size=4, train=True, seed=5))
        valid.append(make_loader(
            ClipDataset(files[n - 4:n], raw_labels=labels[n - 4:n],
                        classmap=classmap, sr=SR),
            common.default_ladder(None), batch_size=4))
    return MultiFoldEngine(template, [0, 1]), train, valid


def _record_epochs(stack, train):
    """Wrap ``stack.train_epoch`` to record the loaders' epoch counters
    before each epoch."""
    seen = []
    epoch_fn = stack.train_epoch

    def recording(*args, **kwargs):
        seen.append([loader._epoch for loader in train])
        return epoch_fn(*args, **kwargs)

    stack.train_epoch = recording
    return seen


def test_stacked_resume_equals_an_uninterrupted_run(tmp_path):
    """3 epochs straight against 1 epoch, a new engine, then
    ``resume=True``, on unequal folds: the bundle holds each loader's own
    epoch counter ([1, 2] after epoch 0: the shorter loader ran twice,
    where JAX's resume would set both to 1), the resumed run starts each
    epoch with the straight run's counters, and ends with its stacked
    weights and statistics bit for bit, its best scores and global step."""
    files, labels = _write_clips(str(tmp_path))
    straight, train, valid = _resume_stack(str(tmp_path / "a"), files, labels)
    assert [len(loader) for loader in train] == [3, 2]
    want_epochs = _record_epochs(straight, train)
    want_best = straight.fit(train, valid, epochs=3)
    want = straight.model.state_dict()
    assert want_epochs == [[0, 0], [1, 2], [2, 4]]

    first, train, valid = _resume_stack(str(tmp_path / "b"), files, labels)
    calls = []
    train_epoch = first.train_epoch

    def stop_after_one(*args, **kwargs):
        if calls:
            raise KeyboardInterrupt("killed after epoch 0")
        calls.append(1)
        return train_epoch(*args, **kwargs)

    first.train_epoch = stop_after_one
    with pytest.raises(KeyboardInterrupt):
        first.fit(train, valid, epochs=3)
    bundle = checkpoints.load_bundle(first.stacked_bundle_path())
    assert bundle["meta"]["epoch"] == 0 and bundle["micro_step"] == 1
    assert bundle["loader_epochs"] == [1, 2]
    assert len(bundle["fold_augment_rngs"]) == 2

    resumed, train, valid = _resume_stack(str(tmp_path / "b"), files,
                                          labels, seed=8)
    got_epochs = _record_epochs(resumed, train)
    best = resumed.fit(train, valid, epochs=3, resume=True)
    assert got_epochs == want_epochs[1:]
    assert best == want_best
    assert resumed.global_step == straight.global_step == 9
    got = resumed.model.state_dict()
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0,
                                   msg=name)
    assert max((got[k] - first.model.state_dict()[k]).abs().max().item()
               for k in got) > 1e-3


# saves stacked bundles v = start + 1, ...: every tensor of the stacked
# model, each loader's epoch, the progress and the step all hold v; every
# rename sleeps 20 ms after it, so that kills land around them
STACKED_BUNDLE_WORKER = """
import os, sys, time, types
sys.path.insert(0, sys.argv[2])
import torch
from freesound_classification_tpu_torch.models.classifiers import (
    TwoDimensionalCNN)
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.training.multifold import (
    MultiFoldEngine)
real = os.replace
def slow(a, b):
    real(a, b)
    time.sleep(0.02)
os.replace = slow
cfg = types.SimpleNamespace(optimizer="adam", learning_rate=1e-3,
                            scheduler="1cycle_0.0001_0.001",
                            weight_decay=0.0, accumulation_steps=1)
model = TwoDimensionalCNN(num_conv_blocks=2, start_deep_supervision_on=0,
                          conv_base_depth=8, growth_rate=2.0,
                          aggregation_type="max", n_classes=4)
stack = MultiFoldEngine(Engine(model, None, cfg, checkpoint_dir=sys.argv[1],
                               device="cpu"), [0, 1])
stack.make_optimizer(4, 2)
loaders = [types.SimpleNamespace(_epoch=0) for _ in range(2)]
i = int(sys.argv[3])
print("READY", flush=True)
while True:
    i += 1
    with torch.no_grad():
        for t in stack.model.state_dict().values():
            t.fill_(float(i))
    for loader in loaders:
        loader._epoch = i
    stack.global_step = i
    stack.save_stacked_bundle(i, [float(i)] * 2, loaders)
"""


def _bundle_stack(root):
    """The worker's two-fold stacked engine, its optimizer made."""
    cfg = _train_cfg("adam", 1e-3, accumulation_steps=1)
    stack = MultiFoldEngine(_port_template(cfg, checkpoint_dir=root), [0, 1])
    stack.make_optimizer(4, 2)
    return stack


def test_sigkill_during_stacked_bundle_saves_leaves_a_paired_bundle(
        tmp_path):
    """Six kills at random points of a loop of stacked bundle saves: after
    each, the bundle loads into a fresh stacked engine whole, with its
    weights, loader epochs, progress and step all of one save, never older
    than what the previous kill left."""
    root = str(tmp_path / "checkpoints")
    rng = np.random.RandomState(0)
    last = 0
    for start in range(0, 6 * 100000, 100000):
        proc = subprocess.Popen(
            [sys.executable, "-c", STACKED_BUNDLE_WORKER, root, REPO,
             str(start)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO)
        try:
            line = proc.stdout.readline().strip()
            assert line == "READY", line + proc.stdout.read()[-2000:]
            time.sleep(rng.uniform(0.05, 0.4))
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
        stack = _bundle_stack(root)
        loaders = [types.SimpleNamespace(_epoch=0) for _ in range(2)]
        meta = stack.load_stacked_bundle(loaders)
        version = meta["epoch"]
        for name, t in stack.model.state_dict().items():
            assert (t == version).all(), name
        assert [loader._epoch for loader in loaders] == [version] * 2
        assert meta["best"] == [float(version)] * 2
        assert meta["global_step"] == stack.global_step == version
        assert version >= max(last, 1)
        last = version
    assert last > 100000


# ---------------------------------------------------------------------------
# (g) the train CLI end to end, and the recipe kit
# ---------------------------------------------------------------------------


def _cli_argv(root, label, *extra):
    with open(os.path.join(root, "test.csv"), "w") as f:
        f.write("fname\n" + "".join(f"clip{i:02d}.wav\n" for i in range(5)))
    return [*_train_argv(root, label), "--n_folds", "2", "--folds", "0",
            "1", "--epochs", "2", "--sample_submission",
            os.path.join(root, "test.csv"), "--test_data_dir",
            os.path.join(root, "train"), *extra]


def _artifacts(experiment_dir):
    found = set()
    for sub in ("checkpoints", "predictions"):
        for dirpath, _, names in os.walk(os.path.join(experiment_dir, sub)):
            rel = os.path.relpath(dirpath, experiment_dir)
            found |= {os.path.join(rel, n) for n in names}
    return found


def test_train_cli_fold_parallel_writes_the_sequential_artifacts(tmp_path):
    """The 2d train CLI on two folds sequentially and with
    ``--fold_parallel``: the same files under checkpoints/ and
    predictions/ (each fold's best, final and periodic models, its OOF and
    test CSVs, the submission) besides the stacked bundle where the
    sequential run has each fold's, the same results keys, finite losses;
    the folds' weights differ; the predict CLI reads the stacked run's
    folds."""
    root = str(tmp_path)
    classes = _write_dataset(root)
    seq = train_2d_cnn.main(_cli_argv(root, "seq"))
    par = train_2d_cnn.main(_cli_argv(root, "par", "--fold_parallel"))
    bundles = {"checkpoints/fold_0/last_model.pt",
               "checkpoints/fold_1/last_model.pt"}
    assert (_artifacts(par.experiment_dir)
            == _artifacts(seq.experiment_dir) - bundles
            | {"checkpoints/multifold_resume.pt"})
    assert "predictions/submission.csv" in _artifacts(par.experiment_dir)
    assert par.results.keys() == seq.results.keys()
    for fold in ("fold0", "fold1"):
        assert par.results[fold].keys() == seq.results[fold].keys()
        assert np.isfinite(par.results[fold]["train_loss"]).all()
        assert par.results[fold]["train_steps"] == [2.0, 2.0]
    w0, w1 = (interop.load_fold_npz(os.path.join(
        par.experiment_dir, "checkpoints", f"fold_{k}",
        "final_model.npz"))[0] for k in (0, 1))
    assert not np.allclose(w0["head"]["fc2"]["kernel"],
                           w1["head"]["fc2"]["kernel"])

    out = os.path.join(root, "preds.csv")
    predict_2d_cnn.main([
        "--experiment", par.experiment_dir,
        "--test_df", os.path.join(root, "test.csv"),
        "--test_data_dir", os.path.join(root, "train"),
        "--classmap", os.path.join(root, "classmap.json"),
        "--output_df", out, "--device", "cpu", "--folds", "0", "1",
        "--num_workers", "0"])
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["fname", *classes]
    probs = np.asarray([[float(v) for v in r[1:]] for r in rows[1:]])
    assert probs.shape == (5, 3) and np.isfinite(probs).all()
    assert probs.min() >= 0 and probs.max() <= 1


FAKE_PY = """#!/usr/bin/env bash
# stands in for the interpreter: logs each CLI call, and makes the
# experiment directory the kit looks for after each train round
echo "$*" >> "$FAKE_LOG"
case "$*" in
  *train_2d_cnn*) mkdir -p "experiments/run$(wc -l < "$FAKE_LOG")" ;;
esac
"""


@pytest.mark.parametrize("fold_parallel", [None, "0", "1"])
def test_recipe_kit_passes_fold_parallel_to_both_train_rounds(
        tmp_path, fold_parallel):
    """The port's kit with every CLI replaced by a logging stand-in:
    ``FOLD_PARALLEL=1`` adds ``--fold_parallel`` to both train rounds (the
    curated and the noisy one) and to nothing else; unset or 0, no call
    has it."""
    fake = tmp_path / "fake_python"
    fake.write_text(FAKE_PY)
    fake.chmod(0o755)
    log = tmp_path / "calls.log"
    env = dict(os.environ, DATA_DIR=str(tmp_path / "data"), PY=str(fake),
               WORK=str(tmp_path / "work"), FAKE_LOG=str(log))
    env.pop("FOLD_PARALLEL", None)
    if fold_parallel is not None:
        env["FOLD_PARALLEL"] = fold_parallel
    subprocess.run(
        ["bash", os.path.join(REPO, "freesound_classification_tpu_torch",
                              "recipes", "reproduce_reference.sh")],
        env=env, check=True, capture_output=True, timeout=60)
    calls = log.read_text().splitlines()
    train = [c for c in calls if ".cli.train_2d_cnn" in c]
    assert len(train) == 2 and len(calls) == 8
    flagged = [c for c in calls if "--fold_parallel" in c]
    assert flagged == (train if fold_parallel == "1" else [])


def test_train_cli_fold_parallel_with_packing_accumulation_profile_resume(
        tmp_path, monkeypatch):
    """``--fold_parallel`` with ``--max_batch_elems`` (clips of 0.7-1.4 s
    in the 1 s and 2 s buckets, packed by samples: the folds' batches of
    a step differ in rows and length), ``--accumulation_steps 2`` and
    ``--profile``, 2 epochs, stopped after epoch 0; the same command with
    ``--resume`` trains epoch 1 only, from the stacked bundle, traces it
    (its steps record the five stage spans, once each) and ends with the
    straight count of steps and updates."""
    from freesound_classification_tpu_torch.utils import profiling

    root = str(tmp_path)
    _write_dataset(root)
    stages = {"augment", "frontend", "forward", "backward", "optimizer"}

    def opened():
        return [r.name for r in profiling.spans() if r.name in stages]

    profiling.reset()
    shapes = set()
    stack_fn = multifold.stack_batches

    def recording(batches, shape=None):
        shapes.add(tuple(b["signal"].shape for b in batches))
        return stack_fn(batches, shape)

    monkeypatch.setattr(multifold, "stack_batches", recording)
    epochs = []
    train_epoch = multifold.MultiFoldEngine.train_epoch

    def stop_after_one(self, *args, **kwargs):
        if epochs:
            raise KeyboardInterrupt("killed after epoch 0")
        epochs.append(train_epoch(self, *args, **kwargs))
        assert opened() == []  # epoch 0 is not traced
        return epochs[-1]

    monkeypatch.setattr(multifold.MultiFoldEngine, "train_epoch",
                        stop_after_one)
    argv = [*_train_argv(root, "opts"), "--n_folds", "2", "--folds", "0",
            "1", "--fold_parallel", "--max_audio_length", "2",
            "--max_batch_elems", str(4 * SR), "--accumulation_steps", "2",
            "--profile", "--log_interval", "100", "--epochs", "2"]
    with pytest.raises(KeyboardInterrupt):
        train_2d_cnn.main(argv)
    assert any(len({s[0] for s in step}) > 1 for step in shapes)
    assert any(len({s[1] for s in step}) > 1 for step in shapes)
    assert opened() == []
    steps = epochs[0]["steps"]

    # the stop came inside epoch 1's trace, which it closed: clear it
    profile = os.path.join(root, "experiments", os.listdir(os.path.join(
        root, "experiments"))[0], "summaries", "profile")
    shutil.rmtree(profile)
    monkeypatch.setattr(multifold.MultiFoldEngine, "train_epoch",
                        train_epoch)
    resumed = train_2d_cnn.main(argv + ["--resume"])
    assert resumed.results["fold0"]["train_steps"] == [steps]
    assert resumed.results["fold1"]["train_steps"] == [steps]
    assert len(opened()) == 5 * steps
    assert set(opened()) == stages
    traces = [t for t in os.listdir(profile) if t.endswith(".pt.trace.json")]
    assert len(traces) == 1
    spans = json.load(open(os.path.join(profile, "spans.json")))
    assert sorted(e["name"] for e in spans["traceEvents"]
                  if e["name"] in stages) == sorted(opened())
    bundle = checkpoints.load_bundle(os.path.join(
        resumed.experiment_dir, "checkpoints", multifold.BUNDLE))
    assert bundle["meta"]["epoch"] == 1
    assert bundle["global_step"] == 2 * steps
    assert bundle["updates"] == 2 * steps // 2
    log = open(os.path.join(resumed.experiment_dir, "log")).read()
    assert "resuming folds [0, 1] from epoch 1" in log


def test_fold_parallel_probe_runs_small_on_the_cpu():
    """The probe's stacked and sequential steps run at a tiny width on the
    CPU and update every fold; its first-step truth there reads within the
    card's tolerances (losses 1e-4, gradients 1e-2 of the fold's largest),
    and the single step's own spread under reversed rows is a rounding
    one."""
    from freesound_classification_tpu_torch.probes import fold_parallel

    tiny = dict(CFG, aggregation_type="max", output_dropout=0.5)
    stack, singles, batch = fold_parallel.build(
        "cpu", tiny, n_folds=3, batch=4, seconds=1, dtype=torch.float32,
        features=DESCRIPTOR)
    stacked, sequential = fold_parallel.steps(stack, singles, batch)
    out = stacked()
    assert out["loss"].shape == (3,) and torch.isfinite(out["loss"]).all()
    assert len(sequential()) == 3
    assert stack.updates == singles[0].updates == 1
    truth = fold_parallel.first_step_truth(
        "cpu", tiny, n_folds=3, batch=4, seconds=1, features=DESCRIPTOR)
    assert max(truth["loss"]) <= 1e-4, truth
    assert max(d["max"] for d in truth["grad"]) <= 1e-2, truth
    assert max(d["l2"] for d in truth["rounding"]) <= 1e-2, truth
