"""The port's recipe CLIs and train-CLI additions against the JAX
package's, on the CPU: the class map, the five relabel modes and their
threshold, the linear blend, ``finalize_results``, the baseline report, the
``--max_samples`` and ``--holdout_size`` rows, each fold's curated + noisy
train manifest, periodic checkpoints, and test predictions through the
train CLI.

Inputs are made with numpy from seeds and written as CSVs that both sides
read; the JAX CLIs read them with pandas, the port's with the ``csv``
module.
"""

import argparse
import csv
import json
import os
import types

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.model_selection import train_test_split

from freesound_classification_tpu.cli import common as jcommon
from freesound_classification_tpu.cli import create_class_map as jclassmap
from freesound_classification_tpu.cli import linear_blend as jblend
from freesound_classification_tpu.cli import relabel_noisy_data as jrelabel
from freesound_classification_tpu.ops import metrics as jmetrics
from freesound_classification_tpu.utils.experiment import (
    Experiment as JaxExperiment,
)
from freesound_classification_tpu_torch.cli import common
from freesound_classification_tpu_torch.cli import compare_to_baseline
from freesound_classification_tpu_torch.cli import create_class_map
from freesound_classification_tpu_torch.cli import linear_blend
from freesound_classification_tpu_torch.cli import relabel_noisy_data
from freesound_classification_tpu_torch.cli import train_2d_cnn
from freesound_classification_tpu_torch.data import audio_io, tables
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops import metrics
from freesound_classification_tpu_torch.training import checkpoints
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.training.state import create_model
from freesound_classification_tpu_torch.utils.experiment import Experiment
from tests._jax_scripts import load_script

CLASSES = ["Bark", "Meow", "Siren", "Tick", "Wind"]


def _write_csv(path, header, rows):
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(rows)


def _labels(rng, n, classes=CLASSES, p=0.3):
    true = rng.rand(n, len(classes)) < p
    true[true.sum(1) == 0, rng.randint(len(classes))] = True
    return true, [",".join(np.array(classes)[row]) for row in true]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# create_class_map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("missing", [None, "", "NA"])
def test_create_class_map_writes_the_jax_json(tmp_path, missing):
    """The same JSON bytes from two CSVs; a labels cell pandas reads as
    missing (empty, or "NA") is the class "nan" in both CLIs."""
    rng = np.random.RandomState(0)
    paths = []
    for k, n in enumerate((12, 7)):
        _, labels = _labels(rng, n)
        rows = [[f"f{k}_{i}.wav", lab] for i, lab in enumerate(labels)]
        if missing is not None and k == 1:
            rows[3][1] = missing
        paths.append(str(tmp_path / f"t{k}.csv"))
        _write_csv(paths[-1], ["fname", "labels"], rows)
    want, got = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jclassmap.main(["--train_dfs", *paths, "--output_file", want])
    create_class_map.main(["--train_dfs", *paths, "--output_file", got])
    assert _read(got) == _read(want)
    assert ("nan" in json.load(open(got))) == (missing is not None)


# ---------------------------------------------------------------------------
# relabel_noisy_data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,c,seed", [(300, 20, 0), (57, 5, 1), (40, 80, 2)])
@pytest.mark.parametrize("target", [0.5, 1.0, 1.5, 3.0])
def test_find_threshold_equals_jax(n, c, seed, target):
    """The sorted-count threshold equals the JAX CLI's (10000, N, C)
    comparison bit for bit, on probabilities with ties."""
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, c)
    probs[::3] = np.round(probs[::3], 2)  # ties, and ties with thresholds
    probs[1, :3] = 0.0
    probs[2, :3] = 1.0
    assert relabel_noisy_data.find_threshold(probs, target) == \
        jrelabel.find_threshold(probs, target)


def _noisy_inputs(tmp_path, n=40, seed=3):
    """A noisy CSV (rows out of fname order) and a prediction CSV written
    by the port's predict CLI writer, its probabilities rounded to two
    digits so scores tie."""
    rng = np.random.RandomState(seed)
    true, labels = _labels(rng, n)
    fnames = [f"n{i:03d}.wav" for i in rng.permutation(n)]
    noisy = str(tmp_path / "noisy.csv")
    _write_csv(noisy, ["fname", "labels"], list(zip(fnames, labels)))
    probs = np.round(np.clip(true * 0.7 + rng.rand(n, len(CLASSES)) * 0.4,
                             0, 1), 2)
    probs[::4] = np.round(probs[::4], 1)
    order = rng.permutation(n)
    preds = str(tmp_path / "preds.csv")
    common.write_predictions(preds, [fnames[i] for i in order], CLASSES,
                             probs[order])
    return noisy, preds


@pytest.mark.parametrize("mode", [
    "fullmatch_1.5", "relabelall_1.5", "relabelall-replacenan_2",
    "relabelall-merge_1.2", "scoring_7", "scoring_1000"])
def test_relabel_writes_the_jax_csv(tmp_path, mode):
    noisy, preds = _noisy_inputs(tmp_path)
    f, classes, values = tables.read_predictions(preds)
    want_df = pd.read_csv(preds)
    assert f == list(want_df.fname) and classes == CLASSES
    np.testing.assert_array_equal(values, want_df[CLASSES].values)
    want, got = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    argv = ["--noisy_df", noisy, "--noisy_predictions_df", preds,
            "--mode", mode]
    jrelabel.main(argv + ["--output_df", want])
    relabel_noisy_data.main(argv + ["--output_df", got])
    assert _read(got) == _read(want)
    assert len(pd.read_csv(got)) > 0


def test_relabel_scoring_keeps_the_jax_row_order_under_ties(tmp_path):
    """Half the rows score exactly 1.0: ``np.argsort(-scores)``'s order of
    the ties decides which rows the top-k keeps."""
    rng = np.random.RandomState(4)
    n = 30
    true, labels = _labels(rng, n)
    fnames = [f"t{i:02d}.wav" for i in range(n)]
    noisy = str(tmp_path / "noisy.csv")
    _write_csv(noisy, ["fname", "labels"], list(zip(fnames, labels)))
    probs = np.where(true, 0.9, 0.1)
    probs[n // 2:] = rng.rand(n - n // 2, len(CLASSES))
    preds = str(tmp_path / "preds.csv")
    common.write_predictions(preds, fnames, CLASSES, probs)
    for topk in (5, 16, 22):
        want, got = str(tmp_path / "j.csv"), str(tmp_path / "p.csv")
        argv = ["--noisy_df", noisy, "--noisy_predictions_df", preds,
                "--mode", f"scoring_{topk}"]
        jrelabel.main(argv + ["--output_df", want])
        relabel_noisy_data.main(argv + ["--output_df", got])
        assert _read(got) == _read(want)


def test_relabel_score_samples_equals_jax():
    rng = np.random.RandomState(5)
    true, _ = _labels(rng, 50, p=0.25)
    scores = np.round(rng.rand(50, len(CLASSES)), 1)
    np.testing.assert_array_equal(
        relabel_noisy_data.score_samples(true, scores),
        jrelabel.score_samples(true, scores))


# ---------------------------------------------------------------------------
# linear_blend
# ---------------------------------------------------------------------------


def _experiment_dir(root, name, fnames, truth, rng, quality, n_folds=3,
                    test_fnames=None):
    """An experiment dir with per-fold OOF and test prediction CSVs."""
    pred_dir = os.path.join(root, name, "predictions")
    os.makedirs(pred_dir)
    probs = np.clip(truth * quality + rng.rand(*truth.shape) * 0.6, 0, 1)
    for k in range(n_folds):
        rows = np.arange(len(fnames))[k::n_folds]
        common.write_predictions(
            os.path.join(pred_dir, f"val_preds_fold_{k}.csv"),
            [fnames[i] for i in rows], CLASSES, probs[rows])
        if test_fnames is not None:
            common.write_predictions(
                os.path.join(pred_dir, f"test_preds_fold_{k}.csv"),
                test_fnames, CLASSES, rng.rand(len(test_fnames),
                                               len(CLASSES)))
    return os.path.join(root, name)


def _blend_inputs(tmp_path):
    rng = np.random.RandomState(6)
    n = 45
    truth, labels = _labels(rng, n)
    fnames = [f"c{i:02d}.wav" for i in rng.permutation(n)]
    train = str(tmp_path / "train.csv")
    _write_csv(train, ["fname", "labels"], list(zip(fnames, labels)))
    test_fnames = [f"s{i}.wav" for i in (3, 1, 4, 0, 2, 5)]
    exps = [_experiment_dir(str(tmp_path), f"exp{k}", fnames, truth, rng, q,
                            test_fnames=test_fnames)
            for k, q in enumerate((0.5, 0.3))]
    return train, exps


def _printed_alphas(out: str, exps) -> list:
    lines = dict(line.rsplit(": ", 1) for line in out.splitlines()
                 if ": " in line)
    return [float(lines[e]) for e in exps]


@pytest.mark.parametrize("rankdata", [False, True])
def test_linear_blend_matches_jax(tmp_path, capsys, rankdata):
    """The port's lwlrap equals JAX's on the blend's inputs (COBYLA's path
    follows the objective's exact floats); then the alphas, the final
    lwlrap and the blended submission agree within 1e-6."""
    train, exps = _blend_inputs(tmp_path)
    oof = [jblend.load_oof_predictions(e) for e in exps]
    cols = [c for c in oof[0].columns if c != "fname"]
    values = [o[cols].values for o in oof]
    if rankdata:
        values = [jblend.to_ranks(v) for v in values]
    actual = linear_blend.actual_labels(train, cols)
    for alpha in ((0.5, 0.5), (0.2, 0.7), (0.9, 0.05)):
        blended = alpha[0] * values[0] + alpha[1] * values[1]
        assert metrics.lwlrap(actual, blended) == \
            jmetrics.lwlrap(actual, blended)
    port_oof = [linear_blend.load_oof_predictions(e) for e in exps]
    for (f, c, v), o in zip(port_oof, oof):
        assert f == list(o.fname) and c == cols
        np.testing.assert_array_equal(v, o[cols].values)

    flag = ["--rankdata"] if rankdata else []
    want, got = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    jblend.main(["--experiments", *exps, "--train_df", train,
                 "--output_df", want, *flag])
    jax_out = capsys.readouterr().out
    linear_blend.main(["--experiments", *exps, "--train_df", train,
                       "--output_df", got, *flag])
    port_out = capsys.readouterr().out
    np.testing.assert_allclose(_printed_alphas(port_out, exps),
                               _printed_alphas(jax_out, exps), atol=1e-6)
    final = [float(o.split("Final lwlrap: ")[1].split()[0])
             for o in (port_out, jax_out)]
    assert final[0] == pytest.approx(final[1], abs=1e-6)
    want_df, got_df = pd.read_csv(want), pd.read_csv(got)
    assert list(got_df.columns) == list(want_df.columns) == ["fname",
                                                             *CLASSES]
    assert list(got_df.fname) == list(want_df.fname)
    np.testing.assert_allclose(got_df[CLASSES].values,
                               want_df[CLASSES].values, atol=1e-6)


# ---------------------------------------------------------------------------
# finalize_results and the baseline report
# ---------------------------------------------------------------------------


def _finalize_inputs(tmp_path, n_folds=3, with_test=True):
    rng = np.random.RandomState(7)
    n = 36
    truth, labels = _labels(rng, n)
    fnames = [f"c{i:02d}.wav" for i in rng.permutation(n)]
    test_fnames = [f"s{i}.wav" for i in (2, 0, 1, 3)]
    pred_root = str(tmp_path / "preds")
    _experiment_dir(pred_root, "src", fnames, truth, rng, 0.4, n_folds,
                    test_fnames if with_test else None)
    return fnames, labels, os.path.join(pred_root, "src", "predictions")


def _copy_predictions(src, dst):
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(src):
        with open(os.path.join(src, name), "rb") as f, \
                open(os.path.join(dst, name), "wb") as g:
            g.write(f.read())


@pytest.mark.parametrize("with_test", [True, False])
def test_finalize_results_matches_jax(tmp_path, with_test):
    fnames, labels, src = _finalize_inputs(tmp_path, with_test=with_test)
    class_map = {c: i for i, c in enumerate(CLASSES)}
    config = {"label": "finalize"}
    jexp = JaxExperiment(config, experiments_dir=str(tmp_path / "jax"))
    pexp = Experiment(config, experiments_dir=str(tmp_path / "port"))
    for exp in (jexp, pexp):
        _copy_predictions(src, exp.register_directory("predictions"))
        for k in range(3):
            exp.register_result(f"fold{k}.metric", 0.5)
    jcommon.finalize_results(
        jexp, pd.DataFrame({"fname": fnames, "labels": labels}), class_map,
        3)
    common.finalize_results(pexp, common.Manifest(fnames, labels),
                            class_map, 3)
    want, got = jexp.results.as_dict(), pexp.results
    assert got["metric"] == pytest.approx(want["metric"], abs=1e-12)
    sub = [os.path.join(e.experiment_dir, "predictions", "submission.csv")
           for e in (jexp, pexp)]
    assert [os.path.isfile(p) for p in sub] == [with_test, with_test]
    if with_test:
        want_df, got_df = pd.read_csv(sub[0]), pd.read_csv(sub[1])
        assert list(got_df.fname) == list(want_df.fname)
        np.testing.assert_allclose(got_df[CLASSES].values,
                                   want_df[CLASSES].values, atol=1e-7)


def test_finalize_results_waits_for_every_fold(tmp_path):
    """No global metric while a fold of n_folds has no result, as JAX."""
    fnames, labels, src = _finalize_inputs(tmp_path)
    pexp = Experiment({"label": "partial"},
                      experiments_dir=str(tmp_path / "port"))
    _copy_predictions(src, pexp.register_directory("predictions"))
    pexp.register_result("fold0.metric", 0.5)
    common.finalize_results(pexp, common.Manifest(fnames, labels),
                            {c: i for i, c in enumerate(CLASSES)}, 3)
    assert "metric" not in pexp.results


@pytest.mark.parametrize("reference", [False, True])
def test_compare_to_baseline_prints_what_the_script_prints(tmp_path, capsys,
                                                          reference):
    """The same report, line for line, as scripts/compare_to_baseline.py:
    the global OOF lwlrap and the per-fold metrics, and with a reference
    lwlrap and OOF dir the deltas and the per-class table."""
    fnames, labels, src = _finalize_inputs(tmp_path)
    exp = str(tmp_path / "exp")
    _copy_predictions(src, os.path.join(exp, "predictions"))
    with open(os.path.join(exp, "results.json"), "w") as f:
        json.dump({"fold0": {"metric": 0.61}, "fold1": {"metric": 0.7},
                   "fold2": {"metric": 0.65}, "metric": 0.66}, f)
    train = str(tmp_path / "train.csv")
    _write_csv(train, ["fname", "labels"], list(zip(fnames, labels)))
    classmap = str(tmp_path / "classmap.json")
    with open(classmap, "w") as f:
        json.dump({c: i for i, c in enumerate(CLASSES)}, f)
    argv = ["--experiment", exp, "--train_df", train, "--classmap",
            classmap]
    if reference:
        _, _, ref = _finalize_inputs(tmp_path / "ref")
        argv += ["--reference_lwlrap", "0.9", "--reference_oof_dir", ref]
    script = load_script("scripts/compare_to_baseline.py")
    want_rc = script.main(argv)
    want = capsys.readouterr().out
    got_rc = compare_to_baseline.main(argv)
    got = capsys.readouterr().out
    assert "global OOF lwlrap (recomputed from 36 OOF rows)" in got
    assert got == want and got_rc == want_rc


# ---------------------------------------------------------------------------
# the train CLI's rows: --max_samples, --holdout_size, folds, noisy set
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_rows,n,seed", [(50, 20, 42), (37, 37, 0),
                                           (1000, 7, 5)])
def test_max_samples_rows_are_pandas_sample(n_rows, n, seed):
    df = pd.DataFrame({"i": np.arange(n_rows)})
    want = df.sample(n, random_state=seed).i.values
    np.testing.assert_array_equal(common.sample_rows(n_rows, n, seed), want)


def test_max_samples_refuses_more_rows_than_the_csv_has():
    with pytest.raises(ValueError):
        pd.DataFrame({"i": np.arange(5)}).sample(6, random_state=0)
    with pytest.raises(ValueError, match="sample of 6 from 5"):
        common.sample_rows(5, 6, 0)


@pytest.mark.parametrize("n_rows,size,seed", [(50, 0.1, 42), (37, 0.25, 3),
                                              (101, 0.333, 7)])
def test_holdout_rows_are_train_test_split(n_rows, size, seed):
    keep, held = train_test_split(np.arange(n_rows), test_size=size,
                                  random_state=seed)
    got_keep, got_held = common.holdout_rows(n_rows, size, seed)
    np.testing.assert_array_equal(got_keep, keep)
    np.testing.assert_array_equal(got_held, held)


def _train_args(add_arguments, root, **flags):
    parser = argparse.ArgumentParser()
    add_arguments(parser)
    argv = ["--train_df", f"{root}/train.csv", "--train_data_dir",
            f"{root}/train", "--classmap", f"{root}/classmap.json",
            "--features", "mel_512_256_32", "--aggregation_type", "max",
            "--optimizer", "adam", "--folds", "0", "--n_folds", "4",
            "--test_data_dir", f"{root}/test", "--sample_submission",
            f"{root}/test.csv", "--device", "cpu", "--kfold_seed", "11"]
    for flag, value in flags.items():
        argv += [f"--{flag}"] + ([] if value is True else [str(value)])
    return parser.parse_args(argv)


def _manifest_csvs(root):
    rng = np.random.RandomState(8)
    _, labels = _labels(rng, 60)
    _write_csv(f"{root}/train.csv", ["fname", "labels"],
               [[f"c{i:02d}.wav", lab] for i, lab in enumerate(labels)])
    _, noisy = _labels(rng, 23)
    _write_csv(f"{root}/noisy.csv", ["fname", "labels"],
               [[f"n{i:02d}.wav", lab] for i, lab in enumerate(noisy)])
    _write_csv(f"{root}/test.csv", ["fname", "labels"],
               [[f"s{i}.wav", ""] for i in range(9)])
    with open(f"{root}/classmap.json", "w") as f:
        json.dump({c: i for i, c in enumerate(CLASSES)}, f)


class _Captured(Exception):
    pass


def _jax_fold_datasets(monkeypatch, args):
    """The train and validation ``ClipDataset`` arguments that JAX's
    ``run_training`` builds for ``args.folds[0]``: its dataset class is
    replaced by a recorder that stops the run at the second one."""
    made = []

    def recorder(files, raw_labels=None, **kw):
        made.append((list(files), list(raw_labels)))
        if len(made) == 2:
            raise _Captured

    monkeypatch.setattr(jcommon, "ClipDataset", recorder)
    monkeypatch.setattr(
        jcommon, "build_engine", lambda *a, **k: types.SimpleNamespace(
            mesh=types.SimpleNamespace(devices=np.zeros(1))))
    with pytest.raises(_Captured):
        jcommon.run_training(args, "2d_cnn")
    return made


@pytest.mark.parametrize("share_noisy", [False, True])
@pytest.mark.parametrize("rows", ["all", "max_samples+holdout"])
@pytest.mark.parametrize("fold", [0, 3])
def test_fold_manifests_match_jax_run_training(tmp_path, monkeypatch,
                                                share_noisy, rows, fold):
    """Each fold's train set (curated train rows, then the noisy split's
    validation rows or every noisy row with --share_noisy) and validation
    set, files and label strings in order, as JAX's ``run_training``
    builds them from the same CSVs."""
    root = str(tmp_path)
    _manifest_csvs(root)
    flags = dict(noisy_train_df=f"{root}/noisy.csv",
                 noisy_train_data_dir=f"{root}/noisy",
                 experiments_dir=f"{root}/exp")
    if share_noisy:
        flags["share_noisy"] = True
    if rows != "all":
        flags.update(max_samples=50, holdout_size=0.2)
    jargs = _train_args(jcommon.add_train_arguments, root, **flags)
    jargs.folds = [fold]
    want_train, want_valid = _jax_fold_datasets(monkeypatch, jargs)

    args = _train_args(common.add_train_arguments, root, **flags)
    class_map = json.load(open(f"{root}/classmap.json"))
    sets = common.training_sets(args, class_map)
    files, labels = common.fold_train_manifest(args, sets, fold)
    assert (files, labels) == want_train
    valid = sets.train.take(sets.splits[fold][1])
    assert ([os.path.join(args.train_data_dir, f) for f in valid.fnames],
            valid.labels) == want_valid
    n_noisy = 23 if share_noisy else len(sets.noisy_splits[fold][1])
    assert sum(f.startswith(f"{root}/noisy") for f in files) == n_noisy
    if rows != "all":
        assert len(sets.train.fnames) == 40 and len(sets.holdout.fnames) == 10
        assert len(sets.test.fnames) == 9


# ---------------------------------------------------------------------------
# periodic checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("save_every", [1, 2])
@pytest.mark.parametrize("keep", [0, 1, 3])
def test_periodic_checkpoints_and_pruning(tmp_path, monkeypatch, save_every,
                                          keep):
    """``model_on_epoch_{e}.npz`` where e % save_every == 0, pruned to the
    newest ``keep`` (0 keeps all); best and final are never touched."""
    net = types.SimpleNamespace(num_conv_blocks=1,
                                start_deep_supervision_on=0,
                                conv_base_depth=8, growth_rate=1.0,
                                aggregation_type="max", output_dropout=0.0)
    cfg = types.SimpleNamespace(
        optimizer="adam", learning_rate=1e-3, scheduler="steplr_1_1.0",
        weight_decay=0.0, _save_every=save_every, _keep_checkpoints=keep)
    engine = Engine(create_model(net, 3, torch.float32, 0, "cpu"),
                    Frontend("mel_512_256_32", device="cpu"), cfg,
                    checkpoint_dir=str(tmp_path), device="cpu")
    scores = iter([0.1, 0.5, 0.3, 0.6, 0.2, 0.4, 0.1])
    monkeypatch.setattr(engine, "train_epoch", lambda *a: {
        "loss": 0.0, "metric": 0.0, "clips_per_sec": 1.0})
    monkeypatch.setattr(engine, "evaluate", lambda *a, **k: next(scores))
    epochs = 7
    engine.fit_validate([None], None, epochs=epochs, fold=2)
    engine.save_model(2, "final_model")
    saved = [e for e in range(epochs) if e % save_every == 0]
    kept = saved[-keep:] if keep else saved
    assert sorted(os.listdir(tmp_path / "fold_2")) == sorted(
        ["best_model.npz", "final_model.npz"]
        + [f"model_on_epoch_{e}.npz" for e in kept])


def test_prune_keeps_the_newest_by_epoch_number(tmp_path):
    """Epoch 10 is newer than epoch 9 (numbers, not names, are compared),
    and files that are not periodic checkpoints stay."""
    names = ["model_on_epoch_9.npz", "model_on_epoch_10.npz",
             "model_on_epoch_2.npz", "best_model.npz",
             "model_on_epoch_3.npz.tmp"]
    for name in names:
        (tmp_path / name).write_bytes(b"x")
    checkpoints.prune_epoch_checkpoints(str(tmp_path), 2)
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["model_on_epoch_9.npz", "model_on_epoch_10.npz", "best_model.npz",
         "model_on_epoch_3.npz.tmp"])


# ---------------------------------------------------------------------------
# the train CLI with the recipe's flags
# ---------------------------------------------------------------------------


def _write_wavs(root, sub, n, labelled, rng):
    os.makedirs(os.path.join(root, sub))
    rows = []
    for i in range(n):
        length = int(rng.uniform(0.6, 1.2) * 44100)
        c = i % 3
        t = np.arange(length) / 44100
        audio = (0.3 * np.sin(2 * np.pi * 300.0 * (c + 1) * t)
                 + 0.01 * rng.randn(length)).astype(np.float32)
        audio_io.write_wav(os.path.join(root, sub, f"{sub}{i}.wav"), audio,
                           44100)
        rows.append([f"{sub}{i}.wav", CLASSES[c] if labelled else ""])
    _write_csv(os.path.join(root, f"{sub}.csv"), ["fname", "labels"], rows)


def test_train_cli_writes_test_predictions_submission_and_holdout(tmp_path):
    """The train CLI with --sample_submission, the noisy set, a holdout and
    --max_samples at toy width: every fold writes its test predictions in
    the CSV's row order, submission.csv is their mean, each fold has its
    holdout lwlrap, and the global metric is the OOF rows' lwlrap."""
    root = str(tmp_path)
    rng = np.random.RandomState(9)
    _write_wavs(root, "train", 30, True, rng)
    _write_wavs(root, "noisy", 9, True, rng)
    _write_wavs(root, "test", 5, False, rng)
    with open(os.path.join(root, "classmap.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(CLASSES[:3])}, f)
    experiment = train_2d_cnn.main([
        "--train_df", f"{root}/train.csv", "--train_data_dir",
        f"{root}/train", "--noisy_train_df", f"{root}/noisy.csv",
        "--noisy_train_data_dir", f"{root}/noisy",
        "--sample_submission", f"{root}/test.csv",
        "--test_data_dir", f"{root}/test",
        "--classmap", f"{root}/classmap.json", "--device", "cpu",
        "--features", "mel_512_256_32", "--num_conv_blocks", "2",
        "--conv_base_depth", "8", "--start_deep_supervision_on", "0",
        "--aggregation_type", "max", "--optimizer", "adam",
        "--p_mixup", "0.5", "--p_aug", "0.75", "--batch_size", "4",
        "--max_audio_length", "1", "--epochs", "1", "--n_folds", "3",
        "--folds", "0", "1", "2", "--holdout_size", "0.1",
        "--max_samples", "28", "--num_workers", "2",
        "--experiments_dir", f"{root}/exp", "--log_interval", "100"])
    pred_dir = os.path.join(experiment.experiment_dir, "predictions")
    order = list(pd.read_csv(f"{root}/test.csv").sample(
        5, random_state=42).fname)
    folds = [pd.read_csv(os.path.join(pred_dir, f"test_preds_fold_{k}.csv"))
             for k in range(3)]
    for df in folds:
        assert list(df.fname) == order
    sub = pd.read_csv(os.path.join(pred_dir, "submission.csv"))
    classes = CLASSES[:3]
    np.testing.assert_allclose(
        sub[classes].values, np.mean([d[classes].values for d in folds], 0),
        atol=1e-6)
    results = experiment.results
    for k in range(3):
        assert 0.0 <= results[f"fold{k}"]["holdout_metric"] <= 1.0
    oof = pd.concat([pd.read_csv(os.path.join(
        pred_dir, f"val_preds_fold_{k}.csv")) for k in range(3)])
    assert len(oof) == 25 and oof.fname.is_unique  # 28 sampled, 3 held out
    train = pd.read_csv(f"{root}/train.csv").set_index("fname").loc[
        sorted(oof.fname)]
    truth = np.array([[lab == c for c in classes] for lab in train.labels],
                     np.float32)
    want = jmetrics.lwlrap(truth, oof.sort_values("fname")[classes].values)
    assert results["metric"] == pytest.approx(want, abs=1e-12)


def test_refuse_unported_accepts_the_recipe_flags(tmp_path):
    """The flags the recipe passes raise and warn of nothing; a test set
    without its data directory is refused before the CSVs are read."""
    import warnings

    root = str(tmp_path)
    args = _train_args(
        common.add_train_arguments, root, noisy_train_df="n.csv",
        noisy_train_data_dir="n", share_noisy=True, holdout_size=0.1,
        max_samples=5, profile=True, save_every=20, keep_checkpoints=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        common.refuse_unported(args)
    bad = type(args)(**dict(vars(args), test_data_dir=None))
    common.refuse_unported(bad)
    with pytest.raises(ValueError, match="--test_data_dir"):
        common.training_sets(bad, {})
