"""The port's self-supervised pretraining against the JAX package's, on the
CPU: APC and CPC (``loss_terms`` of their ``loss_parts`` and the valid
frames of ``output``), the weight map, one self-supervised engine step,
``best_model`` by ``-loss``, the representation probe against sklearn, and
``train_apc``/``train_cpc`` end to end and their refusals.

Inputs are made with numpy from seeds; weights are flax's init of the JAX
models (moved off their constants), carried to the port by ``interop``;
float32 at a tiny width.
"""

import argparse
import csv
import json
import os
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from freesound_classification_tpu.models.apc import APCModel as JaxAPC
from freesound_classification_tpu.models.cpc import CPCModel as JaxCPC
from freesound_classification_tpu.utils import projection as jprojection
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import (
    ssl_common,
    train_apc,
    train_cpc,
)
from freesound_classification_tpu_torch.data import audio_io
from freesound_classification_tpu_torch.models.apc import APCModel
from freesound_classification_tpu_torch.models.blocks import loss_terms
from freesound_classification_tpu_torch.models.cpc import CPCModel
from freesound_classification_tpu_torch.training import checkpoints
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.utils import projection
from tests.test_torch_engine_rest import _train_cfg

F_IN = 8
APC_NET = dict(rnn_size=6, rnn_layers=2, prediction_steps=3)
CPC_NET = dict(n_encoder_layers=2, conv_base_depth=4, growth_rate=2.0,
               context_size=5, prediction_steps=3)


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


def _moved(tree, rng):
    """Every leaf of flax's init moved by a little noise: biases and norms
    leave their constants, so the map is checked on every entry."""
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.randn(*np.shape(a))).astype(
            np.float32), tree)


def _feats(b=3, t=24, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, F_IN).astype(np.float32)
    fl = np.array([t, 5, 17][:b], np.int32)
    return x, fl


def _jax_model(kind):
    return JaxAPC(**APC_NET) if kind == "apc" else JaxCPC(**CPC_NET)


def _port_model(kind):
    return (APCModel(F_IN, **APC_NET) if kind == "apc"
            else CPCModel(F_IN, **CPC_NET))


def _variables(kind, seed=1):
    x, fl = _feats()
    init = _jax_model(kind).init(jax.random.PRNGKey(seed), jnp.asarray(x),
                                 jnp.asarray(fl), train=False)
    rng = np.random.RandomState(seed)
    params = _moved(init["params"], rng)
    stats = jax.tree.map(np.asarray, init.get("batch_stats", {}))
    if stats:
        stats = _moved(stats, rng)
        for node in stats.values():
            node["var"] = np.abs(node["var"]) + 0.5
    return params, stats


def _loaded(kind, params, stats):
    model = _port_model(kind)
    model.load_state_dict(interop.from_jax_variables(params, stats))
    return model


@pytest.mark.parametrize("kind", ["apc", "cpc"])
@pytest.mark.parametrize("train", [False, True])
def test_ssl_models_match_jax(kind, train):
    """``loss_terms`` (of the port's ``loss_parts``) within 1e-4 and
    ``output`` at every valid frame within 1e-4, float32, ragged lengths,
    eval mode and train mode (CPC's BatchNorms from the batch)."""
    params, stats = _variables(kind)
    x, fl = _feats()
    variables = {"params": params, "batch_stats": stats}
    want = jax.jit(lambda v, x, fl: _jax_model(kind).apply(
        v, x, fl, train=train, mutable=["batch_stats"] if train else False))(
        variables, jnp.asarray(x), jnp.asarray(fl))
    if train:
        want = want[0]
    model = _loaded(kind, params, stats).train(train)
    got = model(torch.from_numpy(x), torch.from_numpy(fl).long())
    assert len(got["loss_parts"]) == 3
    np.testing.assert_allclose(
        [float(t.detach()) for t in loss_terms(got["loss_parts"])],
        [float(t) for t in want["loss_terms"]], atol=1e-4, rtol=0)
    out, ref = got["output"].detach().numpy(), np.asarray(want["output"])
    assert out.shape == ref.shape
    steps = fl if kind == "apc" else np.maximum(
        (np.maximum((fl + 1) // 2, 1) + 1) // 2, 1)
    for b, n in enumerate(steps):
        np.testing.assert_allclose(out[b, :n], ref[b, :n], atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["apc", "cpc"])
def test_ssl_weight_map_round_trips(kind):
    params, stats = _variables(kind, seed=2)
    assert interop.model_kind_of(params) == kind
    sd = interop.from_jax_variables(params, stats)
    assert set(sd) == set(_port_model(kind).state_dict())
    back_p, back_s = interop.to_jax_variables(sd)
    for tree, back in ((params, back_p), (stats, back_s)):
        want = dict(_leaves(tree))
        got = dict(_leaves(back))
        assert got.keys() == want.keys()
        for name, v in got.items():
            np.testing.assert_array_equal(v, want[name], err_msg=name)


class _Features:
    """A frontend handing fixed features to the model (both packages see
    the same inputs)."""

    def __init__(self, x, fl):
        self.x, self.fl = torch.from_numpy(x), torch.from_numpy(fl).long()

    def __call__(self, wave, lengths):
        return self.x[:len(wave)], self.fl[:len(wave)]


@pytest.mark.parametrize("kind", ["apc", "cpc"])
def test_ssl_engine_step_matches_jax(kind):
    """One self-supervised ``Engine.train_step`` (loss = the sum of the
    loss terms, no metric, no per-sample losses) against JAX's loss and
    gradients of the same weights and features: loss 1e-4, each gradient
    within 1e-2 of its tensor's largest JAX gradient."""
    params, stats = _variables(kind, seed=3)
    x, fl = _feats(seed=4)

    def loss_of(p):
        out, _ = _jax_model(kind).apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(x),
            jnp.asarray(fl), train=True, mutable=["batch_stats"])
        return sum(out["loss_terms"])

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(params)
    engine = Engine(_loaded(kind, params, stats), _Features(x, fl),
                    _train_cfg("adam", 1e-3, 1), device="cpu",
                    self_supervised=True)
    engine.make_optimizer(1, 1)
    out = engine.train_step(torch.zeros(3, 10), torch.full((3,), 10),
                            torch.zeros(3, 2))
    assert out["metric"] is None and out["per_sample"] is None
    assert float(out["loss"]) == pytest.approx(float(jloss), abs=1e-4)
    # the step moved the weights; the gradients are still on them
    grads = interop.to_jax_variables(
        {k: v.grad for k, v in engine.model.named_parameters()}
        | dict(engine.model.named_buffers()))[0]
    jg = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    for name, g in _leaves(grads):
        denom = np.abs(jg[name]).max()
        np.testing.assert_allclose(g / denom, jg[name] / denom, atol=1e-2,
                                   err_msg=name)


def _batches(n, seed, b=3):
    rng = np.random.RandomState(seed)
    return [{"signal": np.zeros((b, 10), np.float32),
             "lengths": np.full(b, 10, np.int32),
             "labels": np.zeros((b, 2), np.float32),
             "index": np.arange(b)} for _ in range(n)]


def test_ssl_best_model_is_chosen_by_minus_loss(tmp_path):
    """Three epochs of APC through ``fit_validate``: the validation score
    is minus the clip-weighted mean loss, ``best_model.npz`` is the epoch
    of the highest score (checked against each epoch's saved model), and
    the epoch metric is NaN without a warning."""
    params, stats = _variables("apc", seed=5)
    x, fl = _feats(seed=6)
    cfg = _train_cfg("adam", 3e-2, 1)
    cfg._save_every = 1
    engine = Engine(_loaded("apc", params, stats), _Features(x, fl), cfg,
                    device="cpu",
                    checkpoint_dir=str(tmp_path), self_supervised=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        scores = engine.fit_validate(_batches(2, 0), _batches(1, 1),
                                     epochs=3, fold=0)
    assert all(np.isnan(e["metric"]) for e in engine.epoch_stats)
    engine.model.eval()
    with torch.no_grad():
        loss = sum(loss_terms(engine.model(
            *_Features(x, fl)(torch.zeros(3), None))["loss_parts"]))
    assert scores[-1] == pytest.approx(-float(loss), abs=1e-6)
    best = int(np.argmax(scores))
    fold = os.path.join(str(tmp_path), "fold_0")
    want, _ = interop.load_fold_npz(os.path.join(
        fold, f"model_on_epoch_{best}.npz"))
    got, _ = interop.load_fold_npz(os.path.join(fold, "best_model.npz"))
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert len(set(np.round(scores, 6))) == 3


def test_numpy_probe_equals_sklearn():
    """The split, the scaler, the 5-NN votes (ties to the smallest class)
    and the probe's accuracy equal sklearn's, and the port's
    ``plot_projection`` gives the JAX one's accuracy."""
    from sklearn.model_selection import train_test_split
    from sklearn.neighbors import KNeighborsClassifier
    from sklearn.preprocessing import StandardScaler

    rng = np.random.RandomState(7)
    for n in (10, 37, 64):
        x = rng.randn(n, 6) * rng.uniform(0.5, 3, 6)
        x[:, 2] = 1.0  # a constant column: the scaler divides by 1
        y = rng.randint(0, 4, n)
        x_fit, x_val, y_fit, y_val = train_test_split(
            x, y, shuffle=False, test_size=0.2)
        n_fit = projection.split_unshuffled(n)
        assert n_fit == len(x_fit)
        scaler = StandardScaler().fit(x_fit)
        ours = projection.standardize(x[:n_fit], x[n_fit:])
        np.testing.assert_array_equal(ours[0], scaler.transform(x_fit))
        np.testing.assert_array_equal(ours[1], scaler.transform(x_val))
        knn = KNeighborsClassifier(n_neighbors=5).fit(ours[0], y_fit)
        np.testing.assert_array_equal(
            projection.knn_predict(ours[0], y_fit, ours[1]),
            knn.predict(ours[1]))
    # vote ties: two classes with two neighbours each go to the smaller
    x_fit = np.array([[0.0], [0.1], [-0.1], [0.2], [5.0], [9.0]])
    y_fit = np.array([3, 1, 1, 3, 0, 2])
    knn = KNeighborsClassifier(n_neighbors=5).fit(x_fit, y_fit)
    np.testing.assert_array_equal(
        projection.knn_predict(x_fit, y_fit, np.array([[0.05]])),
        knn.predict([[0.05]]))
    vectors = [rng.randn(rng.randint(3, 9), 4) for _ in range(30)]
    labels = np.zeros((30, 3), np.float32)
    labels[np.arange(30), np.arange(30) % 3] = 1.0
    labels[::7, 1] = 1.0  # multi-label clips are skipped
    for i, v in enumerate(vectors):
        v += 2.0 * np.argmax(labels[i])
    _, want = jprojection.plot_projection(vectors, labels, 5)
    _, got = projection.plot_projection(vectors, labels, 5)
    assert got == want


def test_tsne_embedding_separates_clusters():
    """Three clusters of 20 points: the embedding's gap between cluster
    centres is more than 10x a cluster's mean radius (sklearn's ``TSNE
    (perplexity=19)`` gives 51x on these points, the port 53x)."""
    rng = np.random.RandomState(8)
    x = np.concatenate([rng.randn(20, 5) + 6 * c for c in range(3)])
    y = projection.tsne_embedding(x)
    assert y.shape == (60, 2) and np.isfinite(y).all()
    centres = np.stack([y[20 * c:20 * c + 20].mean(0) for c in range(3)])
    spread = max(np.linalg.norm(y[20 * c:20 * c + 20] - centres[c],
                                axis=1).mean() for c in range(3))
    gaps = [np.linalg.norm(centres[a] - centres[b])
            for a, b in ((0, 1), (0, 2), (1, 2))]
    assert min(gaps) > 10 * spread


def _write_ssl_dataset(root, n=12, seed=9):
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "train"))
    rows = []
    for i in range(n):
        m = int(rng.uniform(0.8, 1.3) * 44100)
        audio = 0.3 * np.sin(2 * np.pi * (200 + 150 * (i % 3))
                             * np.arange(m) / 44100) + 0.02 * rng.randn(m)
        name = f"clip{i:02d}.wav"
        audio_io.write_wav(os.path.join(root, "train", name), audio, 44100)
        rows.append((name, f"c{i % 3}" + (",c1" if i % 5 == 0 else "")))
    with open(os.path.join(root, "train.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fname", "labels"])
        w.writerows(rows)
    with open(os.path.join(root, "classmap.json"), "w") as f:
        json.dump({f"c{c}": c for c in range(3)}, f)


def _ssl_argv(root, *extra):
    return ["--train_df", os.path.join(root, "train.csv"),
            "--train_data_dir", os.path.join(root, "train"),
            "--classmap", os.path.join(root, "classmap.json"),
            "--features", "mel_1024_1024_16", "--optimizer", "adam",
            "--folds", "1", "--n_folds", "3", "--epochs", "2",
            "--batch_size", "4", "--max_audio_length", "1",
            "--num_workers", "0", "--device", "cpu", "--log_interval", "1",
            "--p_aug", "0.75", "--max_samples", "11",
            "--experiments_dir", os.path.join(root, "experiments"), *extra]


@pytest.mark.parametrize("cli,kind,net", [
    (train_apc, "apc", ["--rnn_size", "8", "--rnn_layers", "2"]),
    (train_cpc, "cpc", ["--n_encoder_layers", "2", "--conv_base_depth", "4",
                        "--context_size", "8"])])
def test_ssl_cli_end_to_end(tmp_path, cli, kind, net):
    """``train_apc``/``train_cpc`` on the CPU at a toy width, 2 epochs of
    one fold with the effects chain and ``--max_samples``: the fold's
    best, final and per-epoch models of the right family, a finite
    ``fold1.metric`` (minus the best validation loss), the KNN line."""
    root = str(tmp_path)
    _write_ssl_dataset(root)
    experiment = cli.main(_ssl_argv(root, *net))
    with open(os.path.join(experiment.experiment_dir, "results.json")) as f:
        results = json.load(f)
    assert np.isfinite(results["fold1"]["metric"])
    assert results["fold1"]["metric"] < 0
    assert "knn_accuracy" in results["fold1"]
    fold = os.path.join(experiment.experiment_dir, "checkpoints", "fold_1")
    for name in ("best_model", "final_model", "model_on_epoch_1"):
        params, _ = interop.load_fold_npz(os.path.join(fold, f"{name}.npz"))
        assert interop.model_kind_of(params) == kind
    model = ssl_common.build_ssl_model(kind, _parse(_ssl_argv(root, *net)),
                                       16)
    checkpoints.load_model(os.path.join(fold, "final_model.npz"), model)


def _parse(argv):
    parser = argparse.ArgumentParser()
    ssl_common.add_ssl_arguments(parser)
    return parser.parse_args(argv)


def test_ssl_cli_refuses_mesh_devices_and_a_missing_card():
    """``--mesh_devices 2`` without ``torchrun`` raises and says how to
    launch 2 ranks; ``--device`` defaults to the card, and without one the
    CLI raises before any work."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        ssl_common.run_ssl_training(
            _parse(_ssl_argv("x", "--mesh_devices", "2")), "apc")
    on_card = [a for a in _ssl_argv("x") if a not in ("--device", "cpu")]
    assert _parse(on_card).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cpc.main(on_card)
