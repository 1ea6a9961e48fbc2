"""The port's recipe kit (``freesound_classification_tpu_torch/recipes/
reproduce_reference.sh``) end to end on the CPU, on an FSDKaggle2019-layout
mini dataset built as ``tests/test_reproduce_reference_sh.py`` builds one:
the class map, the curated 5-fold round with test predictions and its
report, the noisy set scored and relabelled, the noisy round, and the
blend, each step's artifacts checked.

DEVICE=cpu, EPOCHS=1, NOISY_EPOCHS=1, BATCH_SIZE=8; everything else (the
recipe's width, 5 folds, featurization, schedulers, the report) runs as
the kit pins it. At that width one worker takes minutes, so the test is
marked ``slow``; the parity of each step's CLI with the JAX package's is
held by ``tests/test_torch_recipe.py``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from freesound_classification_tpu_torch.data import audio_io
from freesound_classification_tpu_torch.ops import metrics

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 44100
CLASSES = ["Bark", "Meow", "Siren"]
FREQS = {"Bark": 250.0, "Meow": 1200.0, "Siren": 4000.0}


@pytest.fixture(scope="module")
def fsd_layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("mini_fsd")
    rng = np.random.RandomState(0)
    for sub in ("train_curated", "train_noisy", "test"):
        (root / sub).mkdir()

    def tone(label, n):
        t = np.arange(n) / SR
        return (0.3 * np.sin(2 * np.pi * FREQS[label] * t)
                + 0.01 * rng.randn(n)).astype(np.float32)

    rows = []
    for i in range(50):
        label = CLASSES[i % 3]
        n = rng.randint(int(0.6 * SR), int(1.2 * SR))
        audio_io.write_wav(str(root / "train_curated" / f"c{i}.wav"),
                           tone(label, n), SR)
        rows.append({"fname": f"c{i}.wav", "labels": label})
    pd.DataFrame(rows).to_csv(root / "train_curated.csv", index=False)

    rows = []
    for i in range(9):
        label = CLASSES[i % 3]
        audio_io.write_wav(str(root / "train_noisy" / f"n{i}.wav"),
                           tone(label, int(0.8 * SR)), SR)
        rows.append({"fname": f"n{i}.wav", "labels": label})
    pd.DataFrame(rows).to_csv(root / "train_noisy.csv", index=False)

    rows = []
    for i in range(6):
        audio_io.write_wav(str(root / "test" / f"s{i}.wav"),
                           tone(CLASSES[i % 3], int(0.7 * SR)), SR)
        rows.append({"fname": f"s{i}.wav", "labels": ""})
    pd.DataFrame(rows).to_csv(root / "sample_submission.csv", index=False)
    return root


@pytest.mark.slow
def test_port_kit_runs_end_to_end(fsd_layout, tmp_path):
    env = dict(os.environ, DATA_DIR=str(fsd_layout),
               WORK=str(tmp_path / "parity_run"), DEVICE="cpu", EPOCHS="1",
               NOISY_EPOCHS="1", BATCH_SIZE="8", PY=sys.executable,
               FSC_LAUNCH_LOG=str(tmp_path / "launches.jsonl"))
    proc = subprocess.run(
        ["bash", os.path.join(REPO_ROOT, "freesound_classification_tpu_torch",
                              "recipes", "reproduce_reference.sh")],
        env=env, capture_output=True, text=True, timeout=3000)
    assert proc.returncode == 0, (
        f"rc={proc.returncode}\nstdout:\n{proc.stdout[-3000:]}\n"
        f"stderr:\n{proc.stderr[-3000:]}")

    work = tmp_path / "parity_run"
    assert json.load(open(work / "classmap.json")) == {
        c: i for i, c in enumerate(CLASSES)}
    exps = sorted(os.listdir(work / "experiments"))
    assert len(exps) == 2  # curated + noisy round
    curated = pd.read_csv(fsd_layout / "train_curated.csv")
    truth = np.array([[lab == c for c in CLASSES] for lab in
                      curated.sort_values("fname").labels], np.float32)
    for name in exps:
        exp = work / "experiments" / name
        pred = exp / "predictions"
        results = json.load(open(exp / "results.json"))
        oof = pd.concat([pd.read_csv(pred / f"val_preds_fold_{k}.csv")
                         for k in range(5)]).sort_values("fname")
        assert list(oof.fname) == sorted(curated.fname)
        assert results["metric"] == pytest.approx(
            metrics.lwlrap(truth, oof[CLASSES].values), abs=1e-9)
        tests = [pd.read_csv(pred / f"test_preds_fold_{k}.csv")
                 for k in range(5)]
        sub = pd.read_csv(pred / "submission.csv")
        assert list(sub.fname) == [f"s{i}.wav" for i in range(6)]
        np.testing.assert_allclose(
            sub[CLASSES].values, np.mean([t[CLASSES].values for t in tests],
                                         axis=0), atol=1e-6)
        for k in range(5):
            # --save_every 20 with one epoch: epoch 0's periodic model
            assert sorted(os.listdir(exp / "checkpoints" / f"fold_{k}")) == [
                "best_model.npz", "final_model.npz", "last_model.pt",
                "model_on_epoch_0.npz"]
    assert proc.stdout.count("global OOF lwlrap") == 2

    noisy = pd.read_csv(work / "predictions" / "noisy_probabilities.csv")
    assert list(noisy.columns) == ["fname", *CLASSES]
    assert sorted(noisy.fname) == [f"n{i}.wav" for i in range(9)]
    relabeled = pd.read_csv(work / "predictions"
                            / "train_noisy_relabeled_1k.csv")
    assert len(relabeled) == 9  # scoring_1000 keeps every row
    blend = pd.read_csv(work / "predictions" / "blend_submission.csv")
    assert list(blend.columns) == ["fname", *CLASSES]
    assert sorted(blend.fname) == [f"s{i}.wav" for i in range(6)]
    assert np.isfinite(blend[CLASSES].values).all()
    assert "Final lwlrap" in proc.stdout

    # one launch line a kernel-running process: the two rounds and the
    # noisy scoring; the CPU runs the plain twins, which count nothing
    logged = [json.loads(line) for line in open(tmp_path / "launches.jsonl")]
    assert [os.path.basename(rec["argv"][0]) for rec in logged] == [
        "train_2d_cnn.py", "predict_2d_cnn.py", "train_2d_cnn.py"]
    assert "--noisy_train_df" in logged[2]["argv"]
    assert all(n == 0 for rec in logged for n in rec["launches"].values())
