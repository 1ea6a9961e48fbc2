"""Test-time augmentation in the port against the JAX package, on the CPU:
``tta_perturb`` and ``sample_segment`` on JAX's draws, ``make_tta_fn``, the
degenerate-TTA guard of the predict and evaluate CLIs, ``Engine.predict``'s
guards, ``EnsemblePredictor.predict_loader`` with TTA passes, the predict
CLI's TTA flags, and ``evaluate_2d_cnn`` against JAX's.

Inputs and weights are made with numpy from seeds and handed to both sides.
"""

import csv
import json
import os
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from freesound_classification_tpu.ops import augment as jaug
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import (
    common,
    evaluate_2d_cnn,
    predict_2d_cnn,
)
from freesound_classification_tpu_torch.data import audio_io
from freesound_classification_tpu_torch.data.dataset import ClipDataset
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.models.classifiers import (
    TwoDimensionalCNN,
)
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops import augment
from freesound_classification_tpu_torch.training.engine import Engine

SR = 44100
DESCRIPTOR = "mel_512_256_32"
CLASSES = ["Bark", "Meow", "Siren"]
NETWORK = dict(num_conv_blocks=2, start_deep_supervision_on=0,
               conv_base_depth=8, growth_rate=2.0)


def _waves(b=5, l=6000, seed=0):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(l // 3, l + 1, b).astype(np.int32)
    lengths[0] = l
    wave = (0.3 * rng.randn(b, l)).astype(np.float32)
    wave[np.arange(l)[None, :] >= lengths[:, None]] = 0.0
    return wave, lengths


# ---------------------------------------------------------------------------
# the ops, on JAX's draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("snr,shift_s", [(20.0, 0.0), (0.0, 0.05),
                                         (10.0, 0.1), (0.0, 0.0)])
def test_tta_perturb_matches_jax_on_its_draws(snr, shift_s):
    """``apply_tta_perturb`` on the shift and the noise that JAX's
    ``tta_perturb`` draws from its key (recomputed with jax.random) gives
    its waves and lengths within 1e-6: shifted into the padding, clipped at
    the buffer's end, noise scaled to each row's RMS over its valid
    samples and only on them."""
    wave, lengths = _waves()
    b, l = wave.shape
    key = jax.random.PRNGKey(3)
    want_w, want_l = jaug.tta_perturb(jnp.asarray(wave), jnp.asarray(lengths),
                                      key, noise_snr_db=snr,
                                      shift_max_s=shift_s, sr=SR)
    k_noise, k_shift = jax.random.split(key)
    shift = noise = None
    if shift_s > 0.0:
        shift = torch.from_numpy(np.asarray(jax.random.randint(
            k_shift, (b,), 0, max(int(shift_s * SR), 1) + 1))).long()
    if snr > 0.0:
        noise = torch.from_numpy(np.asarray(
            jax.random.normal(k_noise, (b, l), jnp.float32)))
    got_w, got_l = augment.apply_tta_perturb(
        torch.from_numpy(wave), torch.from_numpy(lengths),
        augment.TTADraws(shift, noise), noise_snr_db=snr)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert got_l.dtype == torch.int32
    if shift is not None:
        assert (got_l.numpy() > lengths).any()  # the shift lengthened rows
    if snr == shift_s == 0.0:
        np.testing.assert_array_equal(got_w.numpy(), wave)


@pytest.mark.parametrize("p", [1.0, 0.5])
def test_sample_segment_matches_jax_on_its_draws(p):
    """``apply_sample_segment`` on ``sample_segment``'s draws (recomputed
    from its key) within 1e-6, lengths exact."""
    wave, lengths = _waves(b=8, seed=1)
    key = jax.random.PRNGKey(4)
    ratio = (0.3, 0.9)
    want_w, want_l = jaug.sample_segment(jnp.asarray(wave),
                                         jnp.asarray(lengths), key, p, ratio)
    k_apply, k_ratio, k_start = jax.random.split(key, 3)
    draws = augment.SegmentDraws(
        torch.from_numpy(np.asarray(jax.random.bernoulli(k_apply, p, (8,)))),
        torch.from_numpy(np.asarray(jax.random.uniform(
            k_ratio, (8,), minval=ratio[0], maxval=ratio[1]))),
        torch.from_numpy(np.asarray(jax.random.uniform(k_start, (8,)))))
    got_w, got_l = augment.apply_sample_segment(
        torch.from_numpy(wave), torch.from_numpy(lengths), draws)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert (got_l.numpy() < lengths).any()


def test_tta_and_segment_draws_have_their_distributions():
    """The port's draws: shifts uniform over [0, shift_max_s * sr], noise
    standard normal, segment ratios in the range and applied at p."""
    gen = torch.Generator().manual_seed(0)
    d = augment.draw_tta_perturb(gen, 4000, 100, noise_snr_db=20.0,
                                 shift_max_s=0.001, sr=SR)
    assert d.shift.min() == 0 and d.shift.max() == 44
    assert abs(float(d.shift.float().mean()) - 22.0) < 1.0
    assert abs(float(d.noise.mean())) < 0.01
    assert abs(float(d.noise.std()) - 1.0) < 0.01
    assert augment.draw_tta_perturb(gen, 4, 100) == (None, None)
    s = augment.draw_sample_segment(gen, 4000, 0.25)
    assert 0.3 <= float(s.ratio.min()) and float(s.ratio.max()) < 0.9
    assert abs(float(s.apply.float().mean()) - 0.25) < 0.03


def test_make_tta_fn_shuffles_then_perturbs():
    """Off when every knob is off; else chunk shuffle at ``shuffle_p`` and
    then the shift and noise, drawn from the generator it is given: the
    same generator state gives the same batch."""
    assert common.make_tta_fn(0.0, 0.0, shuffle_p=0.0) is None
    rng = np.random.RandomState(2)
    wave = torch.from_numpy(rng.randn(3, 3 * SR).astype(np.float32))
    lengths = torch.tensor([3 * SR, 2 * SR + 7, SR + 5], dtype=torch.int32)
    fn = common.make_tta_fn(0.0, 0.0, shuffle_p=1.0)
    out, out_len = fn(wave, lengths, torch.Generator().manual_seed(1))
    assert torch.equal(out_len, lengths)
    assert not torch.equal(out[0], wave[0])  # 6 chunks reordered
    assert torch.equal(torch.sort(out[0]).values, torch.sort(wave[0]).values)
    fn = common.make_tta_fn(20.0, 0.1, shuffle_p=0.5)
    a = fn(wave, lengths, torch.Generator().manual_seed(5))
    b = fn(wave, lengths, torch.Generator().manual_seed(5))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (a[1] >= lengths).all() and not torch.equal(a[0], wave)


# ---------------------------------------------------------------------------
# the guards
# ---------------------------------------------------------------------------


def _predict_argv(n_tta, extra=()):
    return ["--experiment", "/nonexistent/exp",
            "--test_df", "/nonexistent/test.csv",
            "--test_data_dir", "/nonexistent/test",
            "--classmap", "/nonexistent/classmap.json",
            "--output_df", "/nonexistent/out.csv",
            "--n_tta", str(n_tta), "--device", "cpu", *extra]


def _evaluate_argv(n_tta, extra=()):
    return ["--experiment", "/nonexistent/exp",
            "--train_df", "/nonexistent/train.csv",
            "--train_data_dir", "/nonexistent/train",
            "--classmap", "/nonexistent/classmap.json",
            "--n_tta", str(n_tta), "--device", "cpu", *extra]


@pytest.mark.parametrize("cli,argv", [(predict_2d_cnn, _predict_argv),
                                      (evaluate_2d_cnn, _evaluate_argv)])
def test_clis_reject_degenerate_tta(cli, argv, capsys):
    """The counterpart of ``tests/test_cli_tta_guard.py``: ``--n_tta > 1``
    with every stochastic knob off is a usage error (exit 2) in both CLIs;
    a knob, or one pass, lets the CLI go on (here to a missing file)."""
    with pytest.raises(SystemExit) as exc:
        cli.main(argv(4))
    assert exc.value.code == 2
    assert "stochastic TTA mode" in capsys.readouterr().err
    for extra in (["--tta_noise_snr_db", "30"], ["--tta_shift_max_s", "0.1"],
                  ["--tta_shuffle_p", "0.5"],
                  ["--tta_max_audio_length", "2"]):
        with pytest.raises(FileNotFoundError):
            cli.main(argv(4, extra))
    with pytest.raises(FileNotFoundError):
        cli.main(argv(1))


def _engine():
    model = TwoDimensionalCNN(**NETWORK, n_classes=len(CLASSES))
    cfg = types.SimpleNamespace(optimizer="adam", learning_rate=1e-3,
                                scheduler="steplr_1_0.5", weight_decay=0.0)
    return Engine(model, Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu"),
                  cfg, device="cpu")


def test_engine_predict_guards():
    """``Engine.predict(n_tta > 1)`` raises on a deterministic loader (not
    in train mode, or with no crop) and on a shuffled one, as JAX's; a
    stochastic-crop loader in dataset order passes (and the empty fake
    then fails at the concatenation)."""
    engine = _engine()

    class FakeLoader(list):
        def __init__(self, train, max_audio_length, shuffle=False):
            super().__init__()
            self.train = train
            self.dataset = types.SimpleNamespace(
                max_audio_length=max_audio_length)
            self.sampler = types.SimpleNamespace(shuffle=shuffle)

    for loader in (FakeLoader(False, 2.0), FakeLoader(True, None)):
        with pytest.raises(ValueError, match="deterministic loader"):
            engine.predict(loader, n_tta=2)
    with pytest.raises(ValueError, match="SHUFFLED"):
        engine.predict(FakeLoader(True, 2.0, shuffle=True), n_tta=2)
    with pytest.raises(ValueError, match="at least one array"):
        engine.predict(FakeLoader(True, 2.0), n_tta=2)


# ---------------------------------------------------------------------------
# the ensemble and the CLIs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """12 labelled clips, 6 of 0.6-0.95 s and 6 of 1.3-2.5 s (two
    buckets), a class map, and a
    2-fold experiment of random folds as ``.npz`` files."""
    root = tmp_path_factory.mktemp("tta")
    clip_dir = root / "clips"
    clip_dir.mkdir()
    rng = np.random.RandomState(0)
    rows = []
    for i in range(12):
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
        "train": {"optimizer": "adam", "learning_rate": 1e-3,
                  "scheduler": "steplr_1_0.5", "weight_decay": 0.0,
                  "accumulation_steps": 1, "_loss": "lsep_naive"},
        "label": "tta"}
    for k in range(2):
        fold_dir = exp / "checkpoints" / f"fold_{k}"
        fold_dir.mkdir(parents=True)
        interop.save_fold_npz(str(fold_dir / "best_model.npz"),
                              *_fold_variables(k))
    (exp / "config.json").write_text(json.dumps(config))
    return {"root": root, "clips": str(clip_dir), "train_csv": str(train_csv),
            "classmap": str(classmap), "experiment": str(exp),
            "fnames": [r[0] for r in rows]}


def _fold_variables(k):
    return interop.random_jax_variables(**NETWORK, n_classes=len(CLASSES),
                                        seed=20 + k)


def _read(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return [r[0] for r in rows[1:]], np.asarray(
        [[float(v) for v in r[1:]] for r in rows[1:]])


def test_predict_loader_tta_passes(synth):
    """Pass 0 of ``predict_loader`` is the clean pass (``n_tta=2`` with a
    perturbation that returns the batch unchanged gives the ``n_tta=1``
    probabilities bit for bit); a perturbing ``tta_fn`` moves them; a
    ``tta_fn`` without a generator raises; and crop TTA (a train-mode
    loader over 1 s crops, shuffle off) puts every pass's rows back in
    dataset order: each clip's average is that of its own crops."""
    predictor = predict_2d_cnn.build_predictor(synth["experiment"], "cpu")
    files = [os.path.join(synth["clips"], f) for f in synth["fnames"]]
    loader = make_loader(ClipDataset(files, sr=SR),
                         common.default_ladder(None), batch_size=4)
    clean = predictor.predict_loader(loader)
    calls = []

    def identity(wave, lengths, gen):
        calls.append(gen)
        return wave, lengths

    gen = torch.Generator().manual_seed(0)
    same = predictor.predict_loader(loader, tta_fn=identity, generator=gen,
                                    n_tta=2)
    assert calls == [gen] * len(loader)  # passes > 0 only, once a batch
    np.testing.assert_array_equal(same, clean)
    moved = predictor.predict_loader(
        loader, tta_fn=common.make_tta_fn(10.0, 0.2), generator=gen,
        n_tta=3)
    assert 0 < np.abs(moved - clean).max() < 0.5
    with pytest.raises(ValueError, match="Generator"):
        predictor.predict_loader(loader, tta_fn=identity, n_tta=2)

    crops = make_loader(ClipDataset(files, sr=SR, max_audio_length=1),
                        common.default_ladder(None), batch_size=4,
                        train=True, shuffle=False, drop_last=False)
    passes = []
    for _ in range(3):
        order = np.concatenate([b["index"] for b in crops])
        crops._epoch -= 1  # replay the same pass's crops below
        passes.append(predictor.predict_loader(crops))
        assert sorted(order) == list(range(12))
    crops._epoch -= 3  # the same three passes' crops again
    avg = predictor.predict_loader(crops, n_tta=3)
    np.testing.assert_allclose(avg, np.mean(passes, axis=0), atol=1e-7)
    # the long clips' crops differ between passes, the short ones' do not
    assert np.abs(passes[0][6:] - passes[1][6:]).max() > 0
    np.testing.assert_array_equal(passes[0][:6], passes[1][:6])


def test_predict_cli_tta_flags(synth, tmp_path):
    """The predict CLI's ``--n_tta 1`` output is its output without TTA
    flags bit for bit; ``--n_tta 3`` with the shift, noise and shuffle
    knobs and ``--n_tta 3 --tta_max_audio_length 1`` give probabilities
    in [0, 1] that differ from it by more than 0 and less than 0.5."""
    base = ["--experiment", synth["experiment"],
            "--test_df", synth["train_csv"],
            "--test_data_dir", synth["clips"],
            "--classmap", synth["classmap"], "--device", "cpu",
            "--batch_size", "4", "--num_workers", "2"]
    outs = {}
    for name, extra in (("plain", []),
                        ("one", ["--n_tta", "1", "--tta_noise_snr_db", "9"]),
                        ("perturb", ["--n_tta", "3", "--tta_noise_snr_db",
                                     "20", "--tta_shift_max_s", "0.2",
                                     "--tta_shuffle_p", "0.5"]),
                        ("crop", ["--n_tta", "3",
                                  "--tta_max_audio_length", "1"])):
        path = str(tmp_path / f"{name}.csv")
        predict_2d_cnn.main(base + ["--output_df", path] + extra)
        fnames, outs[name] = _read(path)
        assert fnames == synth["fnames"]
    np.testing.assert_array_equal(outs["one"], outs["plain"])
    for name in ("perturb", "crop"):
        probs = outs[name]
        assert probs.min() >= 0 and probs.max() <= 1
        assert 0 < np.abs(probs - outs["plain"]).max() < 0.5


def _jax_experiment(synth, root):
    """The synthetic experiment with each fold also as an orbax checkpoint
    of JAX's engine (its ``best_model``), the same weights."""
    import shutil

    from freesound_classification_tpu.cli import common as jcommon
    from freesound_classification_tpu.training import checkpoints as jckpt
    from freesound_classification_tpu.utils.experiment import (
        Experiment as JaxExperiment,
    )

    exp = os.path.join(root, "experiment")
    shutil.copytree(synth["experiment"], exp)
    experiment = JaxExperiment(resume_from=exp)
    args = types.SimpleNamespace(
        features=DESCRIPTOR, aggregation_type="max", p_mixup=0.0, p_aug=0.0,
        loss="lsep_naive", mixup_exact_add=False)
    engine = jcommon.build_engine(args, experiment, "2d_cnn", len(CLASSES),
                                  writers=False)
    engine.make_optimizer(max_steps=1, steps_per_epoch=1)
    wave = np.zeros((1, SR), np.float32)
    engine.init_state({"signal": wave, "lengths": np.array([SR], np.int32)})
    for k in range(2):
        params, stats = _fold_variables(k)
        state = engine.state.replace(params=params, batch_stats=stats)
        jckpt.save_state(os.path.join(exp, "checkpoints", f"fold_{k}",
                                      "best_model"), state, async_save=False)
    return exp


def test_evaluate_cli_matches_jax(synth, tmp_path, monkeypatch, capsys):
    """The port's ``evaluate_2d_cnn`` against JAX's on the same 2-fold
    experiment (the same weights: ``.npz`` for the port, orbax for JAX):
    each fold's lwlrap and the overall OOF lwlrap within 1e-6 (JAX's
    values are read where its CLI computes them); ``--per_class`` prints
    every class; ``--n_tta 2 --tta_shift_max_s 0.5`` runs."""
    from freesound_classification_tpu.cli import evaluate_2d_cnn as jeval

    exp = _jax_experiment(synth, str(tmp_path))
    seen = []
    jlwlrap = jeval.lwlrap

    def recording(truth, scores):
        seen.append(jlwlrap(truth, scores))
        return seen[-1]

    monkeypatch.setattr(jeval, "lwlrap", recording)
    argv = ["--experiment", exp, "--train_df", synth["train_csv"],
            "--train_data_dir", synth["clips"],
            "--classmap", synth["classmap"], "--batch_size", "4",
            "--num_workers", "0", "--device", "cpu"]
    jeval.main(argv)
    assert len(seen) == 3  # two folds, then all of them
    got = evaluate_2d_cnn.main(argv + ["--per_class"])
    np.testing.assert_allclose(got["folds"], seen[:2], atol=1e-6, rtol=0)
    assert abs(got["overall"] - seen[2]) <= 1e-6
    out = capsys.readouterr().out
    assert all(f"\n{c} " in out for c in CLASSES)
    tta = evaluate_2d_cnn.main(argv + ["--n_tta", "2",
                                       "--tta_shift_max_s", "0.5"])
    assert 0.0 <= tta["overall"] <= 1.0
