"""Parity of the port's fold-ensemble prediction path with the JAX package's,
on the CPU: loader, ensemble, predict CLI, the weight export from JAX
checkpoints, and the port's freedom from JAX imports.
"""

import csv
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from freesound_classification_tpu.data import audio_io
from freesound_classification_tpu.data.dataset import ClipDataset as JaxClipDataset
from freesound_classification_tpu.data.loader import make_loader as jax_make_loader
from freesound_classification_tpu.models.classifiers import (
    TwoDimensionalCNN as JaxCNN,
)
from freesound_classification_tpu.models.frontend import Frontend as JaxFrontend
from freesound_classification_tpu.training.ensemble import (
    EnsemblePredictor as JaxEnsemblePredictor,
)
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import common, predict_2d_cnn
from freesound_classification_tpu_torch.data.dataset import (
    ClipDataset,
    read_manifest,
)
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.models.classifiers import (
    TwoDimensionalCNN,
)
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.training.ensemble import (
    EnsemblePredictor,
)
from freesound_classification_tpu.utils.experiment import Experiment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 44100
DESCRIPTOR = "mel_512_256_32"
CLASSES = ["Bark", "Meow", "Siren"]
N_FOLDS = 3
NETWORK = dict(num_conv_blocks=2, start_deep_supervision_on=0,
               conv_base_depth=8, growth_rate=2.0)


def _fold_variables(k):
    return interop.random_jax_variables(**NETWORK, n_classes=len(CLASSES),
                                        seed=10 + k)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Ten clips in two buckets of the default ladder, a test CSV, a class
    map, and a 3-fold experiment whose weights are fold .npz files."""
    root = tmp_path_factory.mktemp("synth")
    test_dir = root / "test"
    test_dir.mkdir()
    rng = np.random.RandomState(0)
    rows = []
    for i in range(10):
        secs = rng.uniform(0.6, 0.95) if i < 7 else rng.uniform(1.1, 1.5)
        n = int(secs * SR)
        t = np.arange(n) / SR
        audio = 0.3 * np.sin(2 * np.pi * (200 + 300 * i) * t) \
            + 0.01 * rng.randn(n)
        fname = f"clip{i}.wav"
        audio_io.write_wav(str(test_dir / fname), audio, SR)
        rows.append(fname)
    test_csv = root / "test.csv"
    with open(test_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["fname", "labels"])
        writer.writerows([name, ""] for name in rows)
    classmap = root / "classmap.json"
    classmap.write_text(json.dumps({c: i for i, c in enumerate(CLASSES)}))

    exp = root / "experiment"
    config = {
        "network": dict(NETWORK, output_dropout=0.0, aggregation_type="max"),
        "data": {"features": DESCRIPTOR, "_n_folds": N_FOLDS,
                 "_n_classes": len(CLASSES)},
        "train": {}, "label": "port",
    }
    for k in range(N_FOLDS):
        fold_dir = exp / "checkpoints" / f"fold_{k}"
        fold_dir.mkdir(parents=True)
        interop.save_fold_npz(str(fold_dir / "best_model.npz"),
                              *_fold_variables(k))
    (exp / "config.json").write_text(json.dumps(config))
    files = [str(test_dir / name) for name in rows]
    return {"root": root, "test_dir": str(test_dir), "test_csv": str(test_csv),
            "classmap": str(classmap), "experiment": str(exp),
            "files": files, "fnames": rows}


def _jax_predictor():
    model = JaxCNN(**NETWORK, aggregation_type="max", n_classes=len(CLASSES))
    frontend = JaxFrontend(DESCRIPTOR, "2d", sr=SR, dft_precision="high")
    folds = []
    for k in range(N_FOLDS):
        params, stats = _fold_variables(k)
        folds.append({"params": params, "batch_stats": stats})
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *folds)
    return JaxEnsemblePredictor(model, frontend, stacked)


def _port_predictor():
    models = []
    for k in range(N_FOLDS):
        model = TwoDimensionalCNN(**NETWORK, n_classes=len(CLASSES))
        model.load_state_dict(interop.from_jax_variables(*_fold_variables(k)))
        models.append(model)
    return EnsemblePredictor(
        models, Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu"), "cpu")


def _jax_loader(files, num_workers=0):
    ds = JaxClipDataset(files, classmap={c: i for i, c in enumerate(CLASSES)},
                        sr=SR)
    return jax_make_loader(ds, common.default_ladder(None), batch_size=4,
                           train=False, shuffle=False, drop_last=False,
                           num_workers=num_workers, process_index=0,
                           process_count=1)


def test_manifest_and_loader_batch_as_the_jax_loader(synth):
    fnames, files = read_manifest(synth["test_csv"], synth["test_dir"])
    assert fnames == synth["fnames"] and files == synth["files"]
    classmap = {c: i for i, c in enumerate(CLASSES)}
    ours = list(make_loader(ClipDataset(files, classmap=classmap, sr=SR),
                            common.default_ladder(None), batch_size=4,
                            num_workers=2))
    theirs = list(_jax_loader(files))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert set(a) == {"signal", "lengths", "labels", "index"}
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_ensemble_matches_jax(synth):
    """(d) 3-fold ensemble over bucketed batches. Tolerance 1e-4 on
    probabilities: the featurizations differ by ~1e-6 relative (FFT against
    the block-DFT), the convolutions by float32 summation order."""
    ours, theirs = _port_predictor(), _jax_predictor()
    for batch in make_loader(ClipDataset(synth["files"], sr=SR),
                             common.default_ladder(None), batch_size=4):
        want = np.asarray(theirs.predict_batch(batch["signal"],
                                               batch["lengths"]))
        got = ours.predict_batch(batch["signal"], batch["lengths"])
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_predict_loader_restores_dataset_order(synth):
    predictor = _port_predictor()
    loader = make_loader(ClipDataset(synth["files"], sr=SR),
                         common.default_ladder(None), batch_size=4)
    ordered = predictor.predict_loader(loader)
    for batch in loader:
        direct = predictor.predict_batch(batch["signal"], batch["lengths"])
        np.testing.assert_allclose(ordered[batch["index"]], direct.numpy(),
                                   atol=1e-6)
    # TTA passes are averaged in dataset order too: two clean passes are
    # the clean pass; a perturbation needs a generator for its draws
    np.testing.assert_array_equal(predictor.predict_loader(loader, n_tta=2),
                                  ordered)
    with pytest.raises(ValueError, match="Generator"):
        predictor.predict_loader(loader, tta_fn=lambda w, n, g: (w, n),
                                 n_tta=2)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], \
        np.array([[float(v) for v in r[1:]] for r in rows[1:]])


def test_predict_cli_matches_jax_predictions(synth, tmp_path):
    """(f) The port's predict CLI on the synthetic experiment against the
    JAX ensemble over the JAX loader, in dataset order; tolerance as (d)."""
    out = tmp_path / "preds.csv"
    predict_2d_cnn.main([
        "--experiment", synth["experiment"], "--test_df", synth["test_csv"],
        "--test_data_dir", synth["test_dir"], "--classmap", synth["classmap"],
        "--output_df", str(out), "--batch_size", "4", "--num_workers", "2",
        "--device", "cpu",
    ])
    header, fnames, probs = _read_csv(out)
    assert header == ["fname", *sorted(CLASSES)]
    assert fnames == synth["fnames"]
    want = _jax_predictor().predict_loader(_jax_loader(synth["files"]))
    np.testing.assert_allclose(probs, want, atol=1e-4, rtol=0)


def test_predict_cli_packs_batches_and_runs_bf16(synth, tmp_path):
    """--max_batch_elems packing and --bf16 compute: the same predictions
    within bf16 rounding (2e-2 on probabilities)."""
    out = tmp_path / "preds.csv"
    ref = tmp_path / "ref.csv"
    base = ["--experiment", synth["experiment"], "--test_df",
            synth["test_csv"], "--test_data_dir", synth["test_dir"],
            "--classmap", synth["classmap"], "--device", "cpu",
            "--num_workers", "0"]
    predict_2d_cnn.main(base + ["--output_df", str(ref)])
    predict_2d_cnn.main(base + ["--output_df", str(out), "--bf16",
                                "--max_batch_elems", str(3 * 45056)])
    _, _, want = _read_csv(ref)
    _, _, got = _read_csv(out)
    assert np.all(np.isfinite(got)) and got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_predict_cli_refuses_what_it_cannot_run(synth, tmp_path):
    base = ["--experiment", synth["experiment"], "--test_df",
            synth["test_csv"], "--test_data_dir", synth["test_dir"],
            "--classmap", synth["classmap"],
            "--output_df", str(tmp_path / "p.csv")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            predict_2d_cnn.main(base + ["--device", "cuda"])
    # a 2d experiment's folds are not a backbone's
    with pytest.raises(ValueError, match="holds a 2d_cnn model"):
        predict_2d_cnn.main(base + ["--device", "cpu",
                                    "--model_kind", "backbone_cnn"])
    assert not (tmp_path / "p.csv").exists()


def test_resolve_device():
    assert common.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        common.resolve_device("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            common.resolve_device("cuda")


def test_port_imports_no_jax():
    """(g) Every module of the port imports in a fresh interpreter without
    pulling in jax, flax, optax, orbax, sklearn or pandas."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import freesound_classification_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "assert len(names) >= 12, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'orbax', 'sklearn', "
        "'pandas') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_export_script_round_trips_a_saved_fold(tmp_path):
    """(h) A fold saved by the JAX package's checkpointing comes back through
    the export script and ``load_fold_npz`` bit-equal, and the port then
    reproduces the JAX logits (2e-4, as in test_torch_model)."""
    import optax

    from freesound_classification_tpu.training import checkpoints as ckpt_lib
    from freesound_classification_tpu.training.state import create_train_state

    rng = np.random.RandomState(0)
    spec = jnp.asarray(rng.randn(2, 32, 24, 1).astype(np.float32))
    fl = jnp.asarray(np.array([24, 13], np.int32))
    model = JaxCNN(**NETWORK, aggregation_type="max", n_classes=len(CLASSES))
    state = create_train_state(model, spec, fl, optax.adam(1e-3), seed=3)
    ckpt = tmp_path / "exp" / "checkpoints" / "fold_0" / "best_model"
    ckpt_lib.save_state(str(ckpt), state, async_save=False)

    script = os.path.join(REPO, "scripts", "export_fold_weights.py")
    spec_ = importlib.util.spec_from_file_location("export_fold_weights",
                                                   script)
    export = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(export)
    written = export.export_experiment(str(tmp_path / "exp"))
    assert written == [str(ckpt) + ".npz"]

    params, stats = interop.load_fold_npz(written[0])
    for got, want in ((params, state.params), (stats, state.batch_stats)):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, want))
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (_, a), (_, b) in zip(flat_got, flat_want):
            np.testing.assert_array_equal(a, b)

    port = TwoDimensionalCNN(**NETWORK, n_classes=len(CLASSES))
    port.load_state_dict(interop.from_jax_variables(params, stats))
    want = model.apply({"params": state.params,
                        "batch_stats": state.batch_stats}, spec, fl,
                       train=False)["class_logits"]
    got = port.eval()(torch.from_numpy(np.array(spec)),
                      torch.from_numpy(np.array(fl)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-4, rtol=2e-4)


def test_experiment_config_reaches_the_port(synth):
    """The port reads the same experiment layout through the reused
    ``utils/experiment.py``: one .npz per fold."""
    exp = Experiment(resume_from=synth["experiment"])
    paths = predict_2d_cnn.fold_weight_paths(exp)
    assert len(paths) == N_FOLDS and all(os.path.isfile(p) for p in paths)
