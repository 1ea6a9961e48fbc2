"""The port's hierarchical 1d CNN family against the JAX package's, on the
CPU: the stft/raw/1d frontends, ``HierarchicalCNN`` in eval and train mode,
the size-1 pool clamp, bucket invariance, the weight map, the model kinds of
``build_classifier``, the warm start, and the train -> finetune -> predict
CLIs end to end.

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

from freesound_classification_tpu.models.classifiers import (
    HierarchicalCNN as JaxHier,
)
from freesound_classification_tpu.models.frontend import Frontend as JaxFrontend
from freesound_classification_tpu.ops import losses as jlosses
from freesound_classification_tpu.training import optimizers as jopt
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import (
    finetune_hierarchical_cnn,
    predict_2d_cnn,
    train_hierarchical_cnn,
)
from freesound_classification_tpu_torch.data import audio_io
from freesound_classification_tpu_torch.models.backbone import CNNBackbone
from freesound_classification_tpu_torch.models.classifiers import (
    HierarchicalCNN,
    TwoDimensionalCNN,
    build_classifier,
)
from freesound_classification_tpu_torch.models.frontend import (
    MODEL_FAMILY,
    Frontend,
)
from freesound_classification_tpu_torch.ops import losses
from freesound_classification_tpu_torch.training import engine as engine_lib
from freesound_classification_tpu_torch.training import optimizers
from freesound_classification_tpu_torch.utils.config import Config

SR = 44100
N_CLASSES = 5
F_IN = 20  # features per frame of the toy model
CFG = dict(num_conv_blocks=3, start_deep_supervision_on=1,
           conv_base_depth=8, growth_rate=1.5)  # widths 8, 12, 18


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _variables(seed, cfg=CFG, input_dim=F_IN):
    return interop.random_jax_variables(
        **cfg, n_classes=N_CLASSES, seed=seed, model_kind="hierarchical_cnn",
        input_dim=input_dim)


def _port_model(params, stats, cfg=CFG, input_dim=F_IN):
    model = HierarchicalCNN(input_dim, **cfg, n_classes=N_CLASSES)
    model.load_state_dict(interop.from_jax_variables(params, stats))
    return model.eval()


def _jax_logits(params, stats, feats, fl, cfg=CFG):
    model = JaxHier(**cfg, n_classes=N_CLASSES)
    out = model.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(feats), jnp.asarray(fl), train=False)
    return np.asarray(out["class_logits"])


def _feats(b, t, f, seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, t, f).astype(np.float32)
    fl = rng.randint(1, t + 1, size=b).astype(np.int32)
    fl[0] = t
    return feats, fl


# ---------------------------------------------------------------------------
# frontends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("descriptor,family,atol", [
    # log-mel: FFT against the block-DFT's bf16x3 products (test_torch_dsp)
    ("mel_512_256_32", "1d", 1e-4),
    # log-STFT: the same spectra, but a bin's log(|S| + 1e-4) is not
    # smoothed by a mel sum; |S| ~ 1e-6 relative apart at |S| ~ 1e-2 puts
    # up to ~1e-4 on its log
    ("stft_512_256", "1d", 2e-4),
    ("stft_512_256", "2d", 2e-4),
    ("raw", "1d", 0.0),
])
def test_frontend_matches_jax(descriptor, family, atol):
    rng = np.random.RandomState(3)
    x = (0.1 * rng.randn(3, 9000)).astype(np.float32)
    lengths = np.array([9000, 4000, 1], np.int32)
    x[1, 4000:] = 0.0
    x[2, 1:] = 0.0
    want_in, want_fl = JaxFrontend(descriptor, family, sr=SR,
                                   dft_precision="high")(
        jnp.asarray(x), jnp.asarray(lengths))
    front = Frontend(descriptor, family, sr=SR, device="cpu")
    got_in, got_fl = front(torch.from_numpy(x), torch.from_numpy(lengths))
    assert tuple(got_in.shape) == want_in.shape
    assert front.n_features == got_in.shape[-1 if family == "1d" else 1]
    np.testing.assert_array_equal(got_fl.numpy(), np.asarray(want_fl))
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in),
                               atol=atol, rtol=0)
    assert front.frame_count(9000) == got_in.shape[1 if family == "1d"
                                                   else 2]


def test_model_family_map_matches_jax():
    from freesound_classification_tpu.models.frontend import (
        MODEL_FAMILY as JAX_FAMILY,
    )

    assert MODEL_FAMILY == JAX_FAMILY


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_random_variables_have_the_flax_layout():
    feats, fl = _feats(2, 16, F_IN, seed=0)
    init = JaxHier(**CFG, n_classes=N_CLASSES).init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(fl))
    params, stats = _variables(seed=0)
    for got, want in ((params, init["params"]), (stats, init["batch_stats"])):
        got, want = dict(_leaves(got)), dict(_leaves(want))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape, k


@pytest.mark.parametrize("t", [37, 5, 1])
def test_logits_match_jax(t):
    """Eval logits at 2e-4. T=5 and T=1 reach a size-1 time axis inside
    the tower, where the pool clamps to window 1 (MaxPool1d(2) would
    raise)."""
    params, stats = _variables(seed=t)
    feats, fl = _feats(3, t, F_IN, seed=t + 1)
    want = _jax_logits(params, stats, feats, fl)
    got = _port_model(params, stats)(torch.from_numpy(feats),
                                     torch.from_numpy(fl))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-4,
                               rtol=2e-4)


def test_raw_feature_model_matches_jax():
    """One feature per frame (``raw``): block0's convolution has one input
    channel."""
    params, stats = _variables(seed=6, input_dim=1)
    feats, fl = _feats(2, 64, 1, seed=7)
    want = _jax_logits(params, stats, feats, fl)
    got = _port_model(params, stats, input_dim=1)(torch.from_numpy(feats),
                                                  torch.from_numpy(fl))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-4,
                               rtol=2e-4)


def test_logits_do_not_depend_on_the_bucket():
    """A clip padded into a longer bucket gives the same logits (1e-5),
    with the margin of test_torch_model's 2d case: the buckets leave frames
    beyond the clip at every block, since each block's input BatchNorm maps
    masked zeros to a constant that the zero padding at the bucket's end
    is not."""
    params, stats = _variables(seed=8)
    model = _port_model(params, stats)
    rng = np.random.RandomState(9)
    valid = 45
    fl = torch.tensor([valid, 30], dtype=torch.int32)
    silence = float(np.log(1e-4))
    base = rng.randn(2, valid, F_IN).astype(np.float32)
    base[1, 30:] = silence
    outs = []
    for width in (64, 96, 177):
        feats = np.full((2, width, F_IN), silence, np.float32)
        feats[:, :valid] = base
        outs.append(model(torch.from_numpy(feats), fl).detach().numpy())
    for other in outs[1:]:
        np.testing.assert_allclose(other, outs[0], atol=1e-5, rtol=0)


def test_weight_map_round_trips():
    params, stats = _variables(seed=10)
    back = interop.to_jax_variables(interop.from_jax_variables(params,
                                                               stats))
    for tree, want in zip(back, (params, stats)):
        got, ref = dict(_leaves(tree)), dict(_leaves(want))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_build_classifier_model_kinds():
    net = Config(dict(CFG, aggregation_type="max", output_dropout=0.25))
    hier = build_classifier("hierarchical_cnn", net, N_CLASSES,
                            input_dim=F_IN, fused_infer=True)
    assert isinstance(hier, HierarchicalCNN)
    assert hier.blocks[0].conv.in_channels == F_IN
    assert hier.blocks[2].resnet.fused_infer
    assert hier.head.dropout == 0.25
    assert isinstance(build_classifier("2d_cnn", net, N_CLASSES),
                      TwoDimensionalCNN)
    backbone = build_classifier("backbone_cnn", net, N_CLASSES,
                                fused_infer=True)
    assert isinstance(backbone, CNNBackbone) and backbone.arch == "resnet18"
    assert backbone.trunk.stage0_block0.fused_infer
    assert backbone.head.dropout == 0.25
    with pytest.raises(ValueError, match="input_dim"):
        build_classifier("hierarchical_cnn", net, N_CLASSES)
    with pytest.raises(ValueError):
        build_classifier("apc", net, N_CLASSES)
    rnn = build_classifier("hierarchical_cnn",
                           Config(dict(CFG, aggregation_type="rnn")),
                           N_CLASSES, input_dim=F_IN)
    assert isinstance(rnn, HierarchicalCNN)
    assert sorted(n for n, _ in rnn.named_children()
                  if n.startswith("rnn")) == ["rnn1", "rnn2"]
    with pytest.raises(ValueError, match="aggregation_type"):
        HierarchicalCNN(F_IN, aggregation_type="mean")


def test_train_step_matches_jax():
    """One Adam step in train mode, as test_torch_train's 2d step: logits
    2e-4, loss 1e-4, gradients 1e-2 of each tensor's largest JAX gradient
    (tensors whose gradient is zero up to rounding, a bias ahead of a
    train-mode BatchNorm, held to 1e-6 of the model's largest), parameters
    after the step 1e-5 + 1e-2 lr but 2 lr for each element whose gradient
    is zero up to rounding (below 1e-6 of the model's largest: a channel
    the masked max-pool never selects), since Adam's first step moves it
    by +-lr whatever its size, and the running statistics after the step
    1e-5 relative."""
    lr = 1e-3
    params, stats = _variables(seed=11)
    feats, fl = _feats(5, 24, F_IN, seed=12)
    labels = (np.random.RandomState(13).rand(5, N_CLASSES) < 0.4).astype(
        np.float32)
    labels[:, 0] = 1.0

    model = JaxHier(**CFG, n_classes=N_CLASSES)
    loss_fn = jlosses.make_loss("lsep_naive")

    def loss_of(p):
        out, mut = model.apply({"params": p, "batch_stats": stats},
                               jnp.asarray(feats), jnp.asarray(fl),
                               mutable=["batch_stats"], train=True,
                               rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(loss_fn(out["class_logits"], jnp.asarray(labels),
                                average=False)), (out["class_logits"],
                                                  mut["batch_stats"])

    (jloss, (jlogits, jstats)), jgrads = jax.value_and_grad(
        loss_of, has_aux=True)(params)

    port = HierarchicalCNN(F_IN, **CFG, n_classes=N_CLASSES)
    port.load_state_dict(interop.from_jax_variables(params, stats))
    port.train()
    logits = port(torch.from_numpy(feats), torch.from_numpy(fl))
    loss = losses.lsep_loss(logits, torch.from_numpy(labels))
    opt = optimizers.make_optimizer("adam", port.parameters())
    opt.zero_grad()
    loss.backward()
    tgrads = interop.to_jax_variables(
        {k: v.grad for k, v in port.named_parameters()}
        | dict(port.named_buffers()))[0]
    optimizers.set_lr(opt, lr)
    opt.step()
    tparams, tstats = interop.to_jax_variables(port.state_dict())

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-4, rtol=0)
    assert float(loss.detach()) == pytest.approx(float(jloss), abs=1e-4)
    jg = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    top = max(np.abs(g).max() for g in jg.values())
    noise = {n for n, g in jg.items() if np.abs(g).max() < 1e-6 * top}
    for name, g in _leaves(tgrads):
        if name in noise:
            assert np.abs(g).max() < 1e-6 * top, name
            continue
        denom = np.abs(jg[name]).max()
        np.testing.assert_allclose(g / denom, jg[name] / denom, atol=1e-2,
                                   err_msg=name)
    tx = jopt.make_optimizer("adam", lambda s: lr, 0.0)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    jparams = dict(_leaves(jax.tree.map(lambda p, u: np.asarray(p + u),
                                        params, upd)))
    for name, p in _leaves(tparams):
        atol = np.where(np.abs(jg[name]) < 1e-6 * top, 2.01 * lr,
                        1e-5 + 1e-2 * lr)
        assert np.all(np.abs(p - jparams[name]) <= atol), name
    js = dict(_leaves(jax.tree.map(np.asarray, jstats)))
    for name, s in _leaves(tstats):
        np.testing.assert_allclose(s, js[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the warm start and the CLIs
# ---------------------------------------------------------------------------


def test_warm_start_loads_weights_and_statistics_only(tmp_path):
    params, stats = _variables(seed=14)
    path = str(tmp_path / "best_model.npz")
    interop.save_fold_npz(path, params, stats)
    model = HierarchicalCNN(F_IN, **CFG, n_classes=N_CLASSES)
    train_cfg = Config({"optimizer": "adam", "learning_rate": 1e-3,
                        "scheduler": "steplr_1_0.5", "weight_decay": 0.0})
    engine = engine_lib.Engine(model, frontend=None, train_config=train_cfg,
                               device="cpu", warm_start_path=path)
    engine.make_optimizer(10, 5)
    engine.warm_start(path)
    got_p, got_s = interop.to_jax_variables(engine.model.state_dict())
    for got, want in ((got_p, params), (got_s, stats)):
        want = dict(_leaves(want))
        for k, v in _leaves(got):
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert engine.global_step == 0 and not engine.optimizer.state


def _write_dataset(root, n=20):
    train_dir = os.path.join(root, "train")
    os.makedirs(train_dir)
    rng = np.random.RandomState(15)
    classes = [f"class_{c}" for c in range(3)]
    rows = []
    for i in range(n):
        m = int(rng.uniform(0.7, 1.4) * SR)
        tone = 0.3 * np.sin(2 * np.pi * (200 + 150 * (i % 3))
                            * np.arange(m) / SR)
        audio_io.write_wav(os.path.join(train_dir, f"clip{i:02d}.wav"),
                           tone + 0.01 * rng.randn(m), SR)
        rows.append((f"clip{i:02d}.wav", classes[i % 3]))
    with open(os.path.join(root, "train.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fname", "labels"])
        w.writerows(rows)
    with open(os.path.join(root, "classmap.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(classes)}, f)
    return classes


def _train_argv(root, label, features="mel_512_256_32", blocks="2"):
    return ["--train_df", os.path.join(root, "train.csv"),
            "--train_data_dir", os.path.join(root, "train"),
            "--classmap", os.path.join(root, "classmap.json"),
            "--device", "cpu", "--features", features,
            "--num_conv_blocks", blocks, "--conv_base_depth", "8",
            "--growth_rate", "1.5", "--start_deep_supervision_on", "0",
            "--aggregation_type", "max", "--optimizer", "adam",
            "--lr", "0.003", "--scheduler", "1cycle_0.0001_0.005",
            "--weight_decay", "0.0", "--p_mixup", "0.5", "--p_aug", "0.75",
            "--batch_size", "4", "--max_audio_length", "1",
            "--n_folds", "4", "--folds", "1", "--num_workers", "0",
            "--experiments_dir", os.path.join(root, "experiments"),
            "--log_interval", "1", "--label", label]


def test_train_finetune_predict_clis_end_to_end(tmp_path, monkeypatch):
    """The hierarchical train CLI (augmentation on, the plain versions of
    K1-K3), then the finetune CLI from its fold (asked for another
    architecture and features, it takes the pretrained experiment's, and
    its first step starts from the pretrained weights), then the predict
    CLI with --model_kind hierarchical_cnn on the finetuned fold, and the
    same ensemble fused through ``build_predictor``."""
    root = str(tmp_path)
    classes = _write_dataset(root)
    pre = train_hierarchical_cnn.main(
        _train_argv(root, "pre") + ["--epochs", "2"])
    best = os.path.join(pre.experiment_dir, "checkpoints", "fold_1",
                        "best_model.npz")
    pre_params, _ = interop.load_fold_npz(best)
    assert pre_params["block0"]["conv"]["kernel"].shape == (3, 32, 8)

    first = {}
    train_step = engine_lib.Engine.train_step

    def checked(self, *args, **kwargs):
        if not first:  # copies: the arrays share the parameters' memory
            first.update((k, v.copy()) for k, v in _leaves(
                interop.to_jax_variables(self.model.state_dict())[0]))
        return train_step(self, *args, **kwargs)

    monkeypatch.setattr(engine_lib.Engine, "train_step", checked)
    fine = finetune_hierarchical_cnn.main(
        _train_argv(root, "fine", features="stft_512_256", blocks="3")
        + ["--epochs", "1", "--pretrained_model", pre.experiment_dir,
           "--pretrained_fold", "1"])
    assert fine.config.data.features == "mel_512_256_32"
    assert int(fine.config.network.num_conv_blocks) == 2
    want = dict(_leaves(pre_params))
    assert first.keys() == want.keys()
    for k, v in first.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    log = open(os.path.join(fine.experiment_dir, "log")).read()
    assert "warm start from" in log and "nan" not in log.lower()
    tuned, _ = interop.load_fold_npz(os.path.join(
        fine.experiment_dir, "checkpoints", "fold_1", "final_model.npz"))
    assert not np.allclose(tuned["head"]["fc2"]["kernel"],
                           pre_params["head"]["fc2"]["kernel"])

    out = os.path.join(root, "preds.csv")
    with open(os.path.join(root, "test.csv"), "w") as f:
        f.write("fname\n" + "".join(f"clip{i:02d}.wav\n" for i in range(6)))
    predict_2d_cnn.main([
        "--experiment", fine.experiment_dir,
        "--test_df", os.path.join(root, "test.csv"),
        "--test_data_dir", os.path.join(root, "train"),
        "--classmap", os.path.join(root, "classmap.json"),
        "--output_df", out, "--device", "cpu", "--folds", "1",
        "--num_workers", "0", "--model_kind", "hierarchical_cnn"])
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["fname", *classes]
    probs = np.asarray([[float(v) for v in r[1:]] for r in rows[1:]])
    assert probs.shape == (6, 3) and np.isfinite(probs).all()
    assert probs.min() >= 0 and probs.max() <= 1

    from freesound_classification_tpu_torch.cli.common import SR as CLI_SR
    from freesound_classification_tpu_torch.data.dataset import (
        ClipDataset,
        read_manifest,
    )
    from freesound_classification_tpu_torch.cli.common import default_ladder
    from freesound_classification_tpu_torch.data.loader import make_loader

    _, files = read_manifest(os.path.join(root, "test.csv"),
                             os.path.join(root, "train"))
    loader = make_loader(ClipDataset(files, sr=CLI_SR), default_ladder(None),
                         batch_size=4, num_workers=0)
    fused = predict_2d_cnn.build_predictor(
        fine.experiment_dir, torch.device("cpu"), folds=[1],
        model_kind="hierarchical_cnn", fused_infer=True)
    assert all(b.resnet.fused_infer for b in fused.models[0].blocks)
    # a float32 model through the plain versions' bf16 rounding points
    np.testing.assert_allclose(fused.predict_loader(loader), probs,
                               atol=2e-2, rtol=0)
