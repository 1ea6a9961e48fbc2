"""Fold-ensemble inference on a data-parallel mesh: the predict and evaluate
CLIs under ``python -m torch.distributed.run --nproc_per_node 2 ...
--device cpu --mesh_devices 2`` (2 gloo ranks) against the same CLI in one
process, on the CPU.

Each rank runs ``tests/_mesh_cli.py``, which logs the paths the rank writes
and saves what the CLI's ``main()`` returned. The clips fall into batches
of 3, 2 and 1 rows, so a rank's slice is sometimes a padded repeat of the
last row, and the gathers must stay in step.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import (
    common,
    evaluate_2d_cnn,
    predict_2d_cnn,
)
from freesound_classification_tpu_torch.data import audio_io
from freesound_classification_tpu_torch.data.dataset import ClipDataset
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.parallel import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_CLI = os.path.join(REPO, "tests", "_mesh_cli.py")
SR = 44100
CLASSES = ["bird", "car", "dog"]
NETWORK = dict(num_conv_blocks=2, start_deep_supervision_on=0,
               conv_base_depth=8, growth_rate=2.0)
DESCRIPTOR = "mel_512_256_32"
BATCH = "3"


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread (torch's and the BLAS pools') in
    the parent, as the ranks run with ``OMP_NUM_THREADS=1``."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """13 labelled clips, 6 of 0.6-0.95 s and 7 of 1.3-2.5 s (two buckets:
    batches of 3, 3 and 3, 3, 1 at batch size 3), a class map and a 2-fold
    experiment of random folds."""
    root = tmp_path_factory.mktemp("mesh_inference")
    clip_dir = root / "clips"
    clip_dir.mkdir()
    rng = np.random.RandomState(0)
    rows = []
    for i in range(13):
        n = int((rng.uniform(0.6, 0.95) if i < 6 else rng.uniform(1.3, 2.5))
                * SR)
        t = np.arange(n) / SR
        c = i % len(CLASSES)
        audio = 0.3 * np.sin(2 * np.pi * (300 + 600 * c + 37 * i) * t) \
            + 0.02 * rng.randn(n)
        fname = f"clip{i:02d}.wav"
        audio_io.write_wav(str(clip_dir / fname), audio, SR)
        rows.append((fname, CLASSES[c] if i % 4 else
                     f"{CLASSES[c]},{CLASSES[(c + 1) % 3]}"))
    train_csv = root / "train.csv"
    with open(train_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["fname", "labels"])
        writer.writerows(rows)
    classmap = root / "classmap.json"
    classmap.write_text(json.dumps({c: i for i, c in enumerate(CLASSES)}))
    exp = root / "experiment"
    config = {
        "network": dict(NETWORK, output_dropout=0.0, aggregation_type="max"),
        "data": {"features": DESCRIPTOR, "_n_folds": 2, "_kfold_seed": 7,
                 "_n_classes": len(CLASSES)},
        "train": {}, "label": "mesh"}
    for k in range(2):
        fold_dir = exp / "checkpoints" / f"fold_{k}"
        fold_dir.mkdir(parents=True)
        interop.save_fold_npz(
            str(fold_dir / "best_model.npz"),
            *interop.random_jax_variables(**NETWORK, n_classes=len(CLASSES),
                                          seed=30 + k))
    (exp / "config.json").write_text(json.dumps(config))
    return {"root": root, "clips": str(clip_dir), "train_csv": str(train_csv),
            "classmap": str(classmap), "experiment": str(exp),
            "fnames": [r[0] for r in rows]}


def _on_two_ranks(tmp_path, module, argv, timeout=120):
    """``module``'s CLI under ``torch.distributed.run --nproc_per_node 2``
    with ``--mesh_devices 2``: (stdout, what each rank's ``main()``
    returned, the paths each rank wrote)."""
    out = tmp_path / "ranks"
    out.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", RANK_CLI, str(out), module, *argv,
         "--mesh_devices", "2"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    results = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(2)]
    writes = [(out / f"writes{r}.txt").read_text().split()
              if (out / f"writes{r}.txt").exists() else [] for r in range(2)]
    return proc.stdout, results, writes


def _read(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.asarray(
        [[float(v) for v in r[1:]] for r in rows[1:]])


def test_the_clips_make_batches_with_a_padded_rank_slice(synth):
    """Batch size 3 over the two buckets gives batches of 3 and 1 rows:
    on 2 ranks rank 1's slice of each is a padded repeat of the last row
    (a batch of 3: rows 2 and a copy of 2; of 1: a copy of row 0)."""
    files = [os.path.join(synth["clips"], f) for f in synth["fnames"]]
    loader = make_loader(ClipDataset(files, sr=SR),
                         common.default_ladder(None), batch_size=3)
    sizes = sorted(len(b["index"]) for b in loader)
    assert sizes == [1, 3, 3, 3, 3]
    for n in (1, 3):
        rows = [mesh_lib.shard_batch({"row": np.arange(n)}, r, 2)
                for r in range(2)]
        assert rows[1]["n_real"] == n // 2 and len(rows[1]["row"]) == len(
            rows[0]["row"])


@pytest.mark.parametrize("name,extra", [
    ("plain", []),
    ("perturbed", ["--n_tta", "3", "--tta_noise_snr_db", "20",
                   "--tta_shift_max_s", "0.5"]),
    ("crops", ["--n_tta", "3", "--tta_max_audio_length", "1"])])
def test_predict_cli_on_two_ranks_writes_the_one_process_csv(
        synth, tmp_path, name, extra):
    """Two gloo ranks write one CSV, from rank 0 alone, that equals the
    one-process CSV within 1e-5: the perturbation is drawn once on each
    global batch from the same generator on both ranks, and the crop
    loaders draw the same crops on both; rank 1 prints nothing."""
    def argv(path):
        return ["--experiment", synth["experiment"],
                "--test_df", synth["train_csv"],
                "--test_data_dir", synth["clips"],
                "--classmap", synth["classmap"], "--device", "cpu",
                "--batch_size", BATCH, "--num_workers", "0",
                "--output_df", str(path), *extra]

    one = tmp_path / "one.csv"
    predict_2d_cnn.main(argv(one))
    two = tmp_path / "two.csv"
    stdout, results, writes = _on_two_ranks(tmp_path, "predict_2d_cnn",
                                            argv(two))
    assert writes == [[str(two)], []]
    assert stdout.count(f"wrote {two}") == 1
    assert results == [None, None]
    head, fnames, probs = _read(two)
    want_head, want_fnames, want = _read(one)
    assert head == want_head and fnames == want_fnames == synth["fnames"]
    assert np.abs(probs - want).max() <= 1e-5
    if name == "plain":
        assert probs.std(axis=0).max() > 1e-3  # the clips' rows differ


@pytest.mark.parametrize("extra", [[], ["--n_tta", "2",
                                        "--tta_shift_max_s", "0.3"]])
def test_evaluate_cli_on_two_ranks_gives_the_one_process_lwlrap(
        synth, tmp_path, extra):
    """Each fold's lwlrap and the overall one under 2 gloo ranks equal one
    process's within 1e-6, and ``main()`` returns them on both ranks."""
    argv = ["--experiment", synth["experiment"],
            "--train_df", synth["train_csv"],
            "--train_data_dir", synth["clips"],
            "--classmap", synth["classmap"], "--device", "cpu",
            "--batch_size", BATCH, "--num_workers", "0", *extra]
    want = evaluate_2d_cnn.main(argv)
    stdout, results, writes = _on_two_ranks(tmp_path, "evaluate_2d_cnn",
                                            argv)
    assert results[0] == results[1]
    assert writes == [[], []] and stdout.count("overall OOF lwlrap") == 1
    got = results[0]
    assert len(got["folds"]) == len(want["folds"]) == 2
    np.testing.assert_allclose(got["folds"], want["folds"], rtol=0,
                               atol=1e-6)
    assert abs(got["overall"] - want["overall"]) <= 1e-6


@pytest.mark.parametrize("cli", [predict_2d_cnn, evaluate_2d_cnn])
def test_mesh_devices_without_torchrun_raises(synth, tmp_path, monkeypatch,
                                              cli):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    argv = ["--experiment", synth["experiment"],
            "--classmap", synth["classmap"], "--device", "cpu",
            "--mesh_devices", "2"]
    argv += (["--test_df", synth["train_csv"], "--test_data_dir",
              synth["clips"], "--output_df", str(tmp_path / "p.csv")]
             if cli is predict_2d_cnn else
             ["--train_df", synth["train_csv"], "--train_data_dir",
              synth["clips"]])
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        cli.main(argv)
    assert not (tmp_path / "p.csv").exists()


def test_predict_loader_on_a_mesh_refuses_a_sharded_loader(synth):
    """On a mesh the ensemble splits the rows itself: a loader that was
    built with the mesh (its batches already a rank's slice) raises."""
    mesh = mesh_lib.Mesh(0, 2, group=object(), device=torch.device("cpu"))
    files = [os.path.join(synth["clips"], f) for f in synth["fnames"]]
    loader = make_loader(ClipDataset(files, sr=SR),
                         common.default_ladder(None), batch_size=3,
                         mesh=mesh)
    predictor = predict_2d_cnn.build_predictor(synth["experiment"], "cpu")
    with pytest.raises(ValueError, match="without the mesh"):
        predictor.predict_loader(loader, mesh=mesh)
