"""The port's train path against the JAX package's, on the CPU: losses,
lwlrap, schedules, optimizers, one train step of the 2d CNN, the weight map
back to flax, folds, the train loader, and the train CLI end to end.

Inputs and weights are made with numpy from seeds and handed to both sides.
"""

import csv
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from freesound_classification_tpu.data import bucketing as jbucketing
from freesound_classification_tpu.data import dataset as jds
from freesound_classification_tpu.data import folds as jfolds
from freesound_classification_tpu.data import loader as jloader
from freesound_classification_tpu.models.classifiers import (
    TwoDimensionalCNN as JaxCNN,
)
from freesound_classification_tpu.ops import losses as jlosses
from freesound_classification_tpu.ops import metrics as jmetrics
from freesound_classification_tpu.ops import schedules as jsched
from freesound_classification_tpu.training import optimizers as jopt
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import common
from freesound_classification_tpu_torch.cli import predict_2d_cnn
from freesound_classification_tpu_torch.cli import train_2d_cnn
from freesound_classification_tpu_torch.data import audio_io, bucketing, folds
from freesound_classification_tpu_torch.data.dataset import ClipDataset
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.models.classifiers import (
    TwoDimensionalCNN,
)
from freesound_classification_tpu_torch.ops import losses, metrics, schedules
from freesound_classification_tpu_torch.training import optimizers

SR = 44100
N_CLASSES = 6


def _logits_targets(b=7, c=N_CLASSES, seed=0):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(b, c)).astype(np.float32)
    targets = (rng.rand(b, c) < 0.35).astype(np.float32)
    targets[0] = 0.0  # a row with no label
    targets[1] = 1.0  # and one with every label
    return logits, targets


# ---------------------------------------------------------------------------
# losses, metric, schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["lsep", "lsep_naive", "bce", "focal"])
@pytest.mark.parametrize("average", [True, False])
def test_losses_match_jax(name, average):
    logits, targets = _logits_targets()
    want = np.asarray(jlosses.make_loss(name)(
        jnp.asarray(logits), jnp.asarray(targets), average=average))
    got = losses.make_loss(name)(torch.from_numpy(logits),
                                 torch.from_numpy(targets),
                                 average=average).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def test_naive_lsep_is_non_finite_on_saturated_logits_in_both_packages():
    """The naive LSEP computes exp(s_j - s_i) times the pair mask in both
    packages, so saturated logits give the same non-finite values: a
    confident right row NaN (exp overflows to inf on a pair the mask
    zeroes: inf * 0), a confident wrong row inf."""
    logits = np.array([[-60.0, 60.0, 0.0], [60.0, -60.0, 0.0]], np.float32)
    targets = np.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    want = np.asarray(jlosses.lsep_loss(jnp.asarray(logits),
                                        jnp.asarray(targets), average=False))
    got = losses.lsep_loss(torch.from_numpy(logits),
                           torch.from_numpy(targets), average=False).numpy()
    assert np.isnan(want[0]) and np.isposinf(want[1])
    np.testing.assert_array_equal(got, want)


def test_lwlrap_matches_jax_with_ties_and_row_mask():
    logits, targets = _logits_targets(b=9, seed=1)
    scores = np.round(1 / (1 + np.exp(-logits)), 1)  # ties on purpose
    assert metrics.lwlrap(targets, scores) == pytest.approx(
        jmetrics.lwlrap(targets, scores), abs=1e-12)
    mask = np.arange(9) < 6
    want = float(jmetrics.lwlrap_jax(jnp.asarray(targets),
                                     jnp.asarray(scores, jnp.float32),
                                     row_mask=jnp.asarray(mask)))
    got = float(metrics.lwlrap_torch(
        torch.from_numpy(targets), torch.from_numpy(scores.astype("f4")),
        row_mask=torch.from_numpy(mask)))
    assert got == pytest.approx(want, abs=1e-6)
    assert got == pytest.approx(
        metrics.lwlrap(targets[:6], scores[:6]), abs=1e-6)


@pytest.mark.parametrize("descriptor", [
    "1cycle_0.0001_0.005", "steplr_2_0.5", "cyclic_0.001_0.01_7",
    "cyclic_0.001_0.01_5_triangular2", "steplr_1_0.9"])
def test_schedules_match_jax(descriptor):
    want = jsched.make_schedule(descriptor, 0.003, 60, 9)
    got = schedules.make_schedule(descriptor, 0.003, 60, 9)
    for step in range(60):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-12)


@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adam", 1e-2),
                                     ("momentum", 1e-3)])
def test_optimizer_50_step_toy_matches_jax(name, wd):
    """The JAX transforms were written torch-exact: 50 steps of a noisy
    quadratic under a 1cycle schedule end within 1e-5 of each other."""
    rng = np.random.RandomState(2)
    w0 = rng.randn(5, 3).astype(np.float32)
    targets = rng.randn(50, 5, 3).astype(np.float32)
    sched = jsched.make_schedule("1cycle_0.01_0.1", 0.0, 50, 50)
    tx = jopt.make_optimizer(name, sched, wd)
    params = jnp.asarray(w0)
    state = tx.init(params)
    grad_fn = jax.grad(lambda p, t: jnp.sum((p - t) ** 2 * (1 + t ** 2)))
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = optimizers.make_optimizer(name, [w], wd)
    tsched = schedules.make_schedule("1cycle_0.01_0.1", 0.0, 50, 50)
    for step in range(50):
        upd, state = tx.update(grad_fn(params, targets[step]), state, params)
        params = params + upd
        t = torch.from_numpy(targets[step])
        opt.zero_grad()
        (((w - t) ** 2) * (1 + t ** 2)).sum().backward()
        optimizers.set_lr(opt, tsched(step))
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the model's train step
# ---------------------------------------------------------------------------

CFG = dict(num_conv_blocks=2, start_deep_supervision_on=0,
           conv_base_depth=8, growth_rate=2.0)


def _step_inputs(b=5, h=32, w=24, seed=3):
    rng = np.random.RandomState(seed)
    spec = rng.randn(b, h, w, 1).astype(np.float32)
    frame_lengths = rng.randint(w // 2, w + 1, size=b).astype(np.int32)
    frame_lengths[0] = w
    labels = (rng.rand(b, N_CLASSES) < 0.4).astype(np.float32)
    labels[:, 0] = 1.0
    return spec, frame_lengths, labels


def _jax_step(params, stats, spec, fl, labels, lr):
    model = JaxCNN(**CFG, aggregation_type="max", n_classes=N_CLASSES)
    loss_fn = jlosses.make_loss("lsep_naive")

    def loss_of(p):
        out, mut = model.apply({"params": p, "batch_stats": stats},
                               jnp.asarray(spec), jnp.asarray(fl),
                               mutable=["batch_stats"], train=True,
                               rngs={"dropout": jax.random.PRNGKey(0)})
        logits = out["class_logits"]
        return jnp.mean(loss_fn(logits, jnp.asarray(labels),
                                average=False)), (logits,
                                                  mut["batch_stats"])

    (loss, (logits, new_stats)), grads = jax.value_and_grad(
        loss_of, has_aux=True)(params)
    tx = jopt.make_optimizer("adam", lambda s: lr, 0.0)
    upd, _ = tx.update(grads, tx.init(params), params)
    new_params = jax.tree.map(lambda p, u: p + u, params, upd)
    return (np.asarray(logits), float(loss), grads, new_params, new_stats)


def _port_step(params, stats, spec, fl, labels, lr):
    model = TwoDimensionalCNN(**CFG, aggregation_type="max",
                              n_classes=N_CLASSES)
    model.load_state_dict(interop.from_jax_variables(params, stats))
    model.train()
    logits = model(torch.from_numpy(spec), torch.from_numpy(fl))
    loss = losses.lsep_loss(logits, torch.from_numpy(labels))
    opt = optimizers.make_optimizer("adam", model.parameters())
    opt.zero_grad()
    loss.backward()
    grads = interop.to_jax_variables(
        {k: (v.grad if v.grad is not None else torch.zeros_like(v))
         for k, v in model.named_parameters()}
        | {k: b for k, b in model.named_buffers()})[0]
    optimizers.set_lr(opt, lr)
    opt.step()
    return (logits.detach().numpy(), float(loss.detach()), grads,
            *interop.to_jax_variables(model.state_dict()))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_train_step_matches_jax():
    """One Adam step in train mode, dropout 0: logits 2e-4, loss 1e-4,
    gradients 1e-2 after dividing by each tensor's largest JAX gradient
    (convolution backward sums in another order), parameters after the
    step 1e-5 + 1e-2 lr, and the BatchNorm running statistics after the
    step to 1e-5 relative: flax moves them with the biased batch variance,
    which the unbiased one would miss by n/(n-1) (5/4 for the head's 5
    rows). A bias just ahead of a train-mode BatchNorm has a gradient of
    zero up to rounding (the batch mean takes it out), as has a PReLU slope
    that sees no negative input, so both sides give noise there: those are
    held to that (1e-6 of the largest gradient), and their Adam step, whose
    first move is +-lr whatever the gradient's size, to 2 lr."""
    lr = 1e-3
    params, stats = interop.random_jax_variables(**CFG, n_classes=N_CLASSES,
                                                 seed=4)
    spec, fl, labels = _step_inputs()
    jl, jloss, jgrads, jparams, jstats = _jax_step(params, stats, spec, fl,
                                                   labels, lr)
    tl, tloss, tgrads, tparams, tstats = _port_step(params, stats, spec, fl,
                                                    labels, lr)
    np.testing.assert_allclose(tl, jl, atol=2e-4, rtol=0)
    assert tloss == pytest.approx(jloss, abs=1e-4)
    jg = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    top = max(np.abs(g).max() for g in jg.values())
    noise = {name for name, g in jg.items() if np.abs(g).max() < 1e-6 * top}
    assert "head/fc1/bias" in noise
    for name, g in _leaves(tgrads):
        if name in noise:
            assert np.abs(g).max() < 1e-6 * top, name
            continue
        denom = np.abs(jg[name]).max()
        np.testing.assert_allclose(g / denom, jg[name] / denom, atol=1e-2,
                                   err_msg=name)
    jp = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    for name, p in _leaves(tparams):
        atol = 2.01 * lr if name in noise else 1e-5 + 1e-2 * lr
        np.testing.assert_allclose(p, jp[name], atol=atol, rtol=0,
                                   err_msg=name)
    js = dict(_leaves(jax.tree.map(np.asarray, jstats)))
    for name, s in _leaves(tstats):
        np.testing.assert_allclose(s, js[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # the head's variance moved: the check above could see the trap
    assert not np.allclose(js["head/bn1/var"],
                           np.asarray(stats["head"]["bn1"]["var"]))


def test_bf16_train_forward_keeps_float32_statistics():
    """A bf16 model takes its batch statistics in float32 and still gives
    float32 logits near the float32 model's: 1e-1 on logits of about 1,
    for bf16's 2^-8 steps compounding through two blocks and the head."""
    params, stats = interop.random_jax_variables(**CFG, n_classes=N_CLASSES,
                                                 seed=5)
    spec, fl, _ = _step_inputs(seed=6)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        model = TwoDimensionalCNN(**CFG, aggregation_type="max",
                                  n_classes=N_CLASSES, dtype=dtype)
        model.load_state_dict(interop.from_jax_variables(params, stats))
        out.append(model.train()(torch.from_numpy(spec),
                                 torch.from_numpy(fl)))
        assert model.head.bn1.running_var.dtype == torch.float32
    assert out[1].dtype == torch.float32
    np.testing.assert_allclose(out[1].detach().numpy(),
                               out[0].detach().numpy(), atol=1e-1)


def test_weight_map_round_trips():
    params, stats = interop.random_jax_variables(
        num_conv_blocks=3, start_deep_supervision_on=1, conv_base_depth=8,
        growth_rate=1.5, n_classes=N_CLASSES, seed=7)
    back = interop.to_jax_variables(interop.from_jax_variables(params,
                                                               stats))
    for tree, want in zip(back, (params, stats)):
        got = dict(_leaves(tree))
        ref = dict(_leaves(want))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_flax_like_init_statistics():
    """LeCun-normal kernels (std 1/sqrt(fan_in), truncated at 2 std),
    zero biases, unit BatchNorm, PReLU 0.25, as flax's init."""
    from freesound_classification_tpu_torch.training.state import (
        create_model,
    )
    from freesound_classification_tpu_torch.utils.config import Config

    net = Config(dict(CFG, conv_base_depth=32, aggregation_type="max",
                      output_dropout=0.5))
    model = create_model(net, N_CLASSES, torch.float32, seed=0,
                         device=torch.device("cpu"))
    w = model.blocks[1].resnet.conv2.weight
    fan_in = w[0].numel()
    assert float(w.std()) == pytest.approx(fan_in ** -0.5, rel=0.05)
    assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
    assert float(model.blocks[1].resnet.conv2.bias.abs().max()) == 0.0
    assert float(model.head.prelu.weight.min()) == 0.25
    assert model.head.dropout == 0.5


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_kfold_matches_sklearn():
    from sklearn.model_selection import KFold

    for n, k, seed in ((23, 4, 42), (10, 5, 0), (7, 2, 3)):
        want = list(KFold(k, shuffle=True, random_state=seed).split(
            np.arange(n)))
        got = list(folds.train_validation_data(range(n), None, k, seed))
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_stratified_folds_match_jax():
    rng = np.random.RandomState(8)
    classmap = {f"c{i}": i for i in range(5)}
    labels = [",".join(sorted({f"c{j}" for j in rng.randint(0, 5, 1 + i % 3)}))
              for i in range(40)]
    got = list(folds.train_validation_data_stratified(
        range(40), labels, classmap, 4, 42))
    want = list(jfolds.train_validation_data_stratified(
        range(40), labels, classmap, 4, 42))
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def _write_clips(root, n, seed, lengths_s=(0.6, 1.6)):
    rng = np.random.RandomState(seed)
    files = []
    for i in range(n):
        m = int(rng.uniform(*lengths_s) * SR)
        tone = np.sin(2 * np.pi * (200 + 150 * (i % 6))
                      * np.arange(m) / SR) * 0.3
        path = os.path.join(root, f"clip{i:02d}.wav")
        audio_io.write_wav(path, tone + 0.01 * rng.randn(m), SR)
        files.append(path)
    return files


def test_train_loader_batches_as_the_jax_loader(tmp_path):
    """Train mode: per-epoch reshuffled plans, dropped short batches,
    labels, and the long-clip crops keyed on (seed, epoch, index)."""
    files = _write_clips(str(tmp_path), 14, 9)
    classmap = {f"c{i}": i for i in range(N_CLASSES)}
    labels = [f"c{i % N_CLASSES},c{(i * 5) % N_CLASSES}" for i in range(14)]
    ladder = common.default_ladder(1)
    ours = make_loader(ClipDataset(files, raw_labels=labels,
                                   classmap=classmap, max_audio_length=1,
                                   sr=SR, seed=43),
                       ladder, batch_size=3, train=True, seed=42,
                       num_workers=2)
    theirs = jloader.make_loader(
        jds.ClipDataset(files, raw_labels=labels, classmap=classmap,
                        max_audio_length=1, sr=SR, seed=43),
        ladder, batch_size=3, train=True, seed=42, num_workers=0,
        process_index=0, process_count=1)
    for _ in range(2):  # two epochs: the plans and the crops move
        a_epoch, b_epoch = list(ours), list(theirs)
        assert len(a_epoch) == len(b_epoch) > 0
        for a, b in zip(a_epoch, b_epoch):
            for key in ("signal", "lengths", "labels", "index"):
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True)])
def test_bucket_sampler_size_multiple_matches_jax(shuffle, drop_last):
    """Batch sizes trimmed to a multiple of ``size_multiple``, fixed (7 ->
    4) and packed, the same plans as the JAX sampler's."""
    lengths = np.random.RandomState(0).randint(1000, 60000, size=45)
    ladder = [16384, 32768, 65536]
    for kw in ({"batch_size": 7}, {"max_batch_elems": 5 * 32768}):
        ours = bucketing.BucketBatchSampler(
            lengths, ladder, shuffle=shuffle, seed=3, drop_last=drop_last,
            size_multiple=4, **kw)
        theirs = jbucketing.BucketBatchSampler(
            lengths, ladder, shuffle=shuffle, seed=3, drop_last=drop_last,
            size_multiple=4, **kw)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(ours) == [list(b) for b in theirs]
        # full batches are multiples of 4 (the packed short bucket's 10 is
        # trimmed to 8); only a bucket's tail is shorter
        assert {len(b) for b in ours if len(b) >= 4} <= {4, 8}
        assert 4 in {len(b) for b in ours}


# ---------------------------------------------------------------------------
# the CLIs end to end
# ---------------------------------------------------------------------------


def _write_dataset(root, n=20):
    train_dir = os.path.join(root, "train")
    os.makedirs(train_dir)
    files = _write_clips(train_dir, n, 10, lengths_s=(0.7, 1.4))
    classes = [f"class_{c}" for c in range(3)]
    with open(os.path.join(root, "train.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fname", "labels"])
        for i, path in enumerate(files):
            w.writerow([os.path.basename(path), classes[i % 3]])
    with open(os.path.join(root, "classmap.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(classes)}, f)
    return classes


def test_train_cli_end_to_end_then_predict(tmp_path):
    """The port's train CLI on CPU with the recipe's augmentation (MixUp,
    the effects chain with K2/K3's plain twins, chunk shuffle) at toy width:
    the losses are finite, the parameters move, the fold's best and final
    models and out-of-fold CSV are written, and the port's predict CLI
    reads best_model.npz."""
    root = str(tmp_path)
    classes = _write_dataset(root)
    exp_dir = os.path.join(root, "experiments")
    experiment = train_2d_cnn.main([
        "--train_df", os.path.join(root, "train.csv"),
        "--train_data_dir", os.path.join(root, "train"),
        "--classmap", os.path.join(root, "classmap.json"),
        "--device", "cpu", "--features", "mel_512_256_32",
        "--num_conv_blocks", "2", "--conv_base_depth", "8",
        "--start_deep_supervision_on", "0", "--aggregation_type", "max",
        "--output_dropout", "0.5", "--optimizer", "adam", "--lr", "0.003",
        "--scheduler", "1cycle_0.0001_0.005", "--weight_decay", "0.0",
        "--p_mixup", "0.5", "--p_aug", "0.75", "--batch_size", "4",
        "--max_audio_length", "1", "--epochs", "2", "--n_folds", "4",
        "--folds", "1", "--num_workers", "2", "--experiments_dir", exp_dir,
        "--log_interval", "1"])
    fold_dir = os.path.join(experiment.experiment_dir, "checkpoints",
                            "fold_1")
    # --save_every defaults to 1 and --keep_checkpoints to 0, as in JAX
    assert sorted(os.listdir(fold_dir)) == [
        "best_model.npz", "final_model.npz", "last_model.pt",
        "model_on_epoch_0.npz", "model_on_epoch_1.npz"]
    results = json.load(open(os.path.join(experiment.experiment_dir,
                                          "results.json")))
    assert 0.0 <= results["fold1"]["metric"] <= 1.0
    params, _ = interop.load_fold_npz(os.path.join(fold_dir,
                                                   "final_model.npz"))
    fresh, _ = interop.to_jax_variables(common.build_engine(
        train_2d_cnn_args(root, exp_dir), experiment, 3,
        torch.device("cpu")).model.state_dict())
    assert not np.allclose(params["head"]["fc2"]["kernel"],
                           fresh["head"]["fc2"]["kernel"])
    log = open(os.path.join(experiment.experiment_dir, "log")).read()
    assert "nan" not in log.lower()
    with open(os.path.join(experiment.experiment_dir, "predictions",
                           "val_preds_fold_1.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["fname", *classes] and len(rows) == 1 + 5

    out = os.path.join(root, "preds.csv")
    with open(os.path.join(root, "test.csv"), "w") as f:
        f.write("fname\n" + "".join(f"clip{i:02d}.wav\n" for i in range(6)))
    predict_2d_cnn.main([
        "--experiment", experiment.experiment_dir,
        "--test_df", os.path.join(root, "test.csv"),
        "--test_data_dir", os.path.join(root, "train"),
        "--classmap", os.path.join(root, "classmap.json"),
        "--output_df", out, "--device", "cpu", "--folds", "1",
        "--num_workers", "0"])
    with open(out) as f:
        rows = list(csv.reader(f))
    probs = np.asarray([[float(v) for v in r[1:]] for r in rows[1:]])
    assert probs.shape == (6, 3) and np.isfinite(probs).all()
    assert probs.min() >= 0 and probs.max() <= 1


def train_2d_cnn_args(root, exp_dir):
    import argparse

    parser = argparse.ArgumentParser()
    common.add_train_arguments(parser)
    return parser.parse_args([
        "--train_df", "x", "--train_data_dir", "x", "--classmap", "x",
        "--features", "mel_512_256_32", "--aggregation_type", "max",
        "--optimizer", "adam", "--folds", "0", "--num_conv_blocks", "2",
        "--conv_base_depth", "8", "--start_deep_supervision_on", "0",
        "--device", "cpu", "--experiments_dir", exp_dir])


def test_train_cli_refuses_what_waits_and_a_missing_card(tmp_path):
    args = train_2d_cnn_args(str(tmp_path), str(tmp_path))
    for flag, value in (("mesh_devices", 2),):
        bad = type(args)(**dict(vars(args), **{flag: value}))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            common.refuse_unported(bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            common.resolve_device("cuda")
