"""The ``rnn`` aggregation of the port (``blocks.MaskedBiGRU`` in both CNN
families) against the JAX package's, on the CPU: the GRU's two routes at
lengths 1, T and in between, the within-length flip, the weight map and
flax's init, both models' logits, one train step, the stacked step under
``torch.func.vmap`` against single-fold engines, and the train and predict
CLIs with ``--aggregation_type rnn``, sequential and ``--fold_parallel``.

Inputs and weights are made with numpy from seeds (the weights in the JAX
package's layout, ``interop.random_jax_variables``) and handed to both
sides; float32 at a tiny width.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from freesound_classification_tpu.models.blocks import (
    MaskedBiGRU as JaxBiGRU,
)
from freesound_classification_tpu.models.classifiers import (
    HierarchicalCNN as JaxHier,
    TwoDimensionalCNN as JaxCNN,
)
from freesound_classification_tpu.ops import losses as jlosses
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import (
    predict_2d_cnn,
    train_2d_cnn,
    train_hierarchical_cnn,
)
from freesound_classification_tpu_torch.models import blocks
from freesound_classification_tpu_torch.models.classifiers import (
    HierarchicalCNN,
    TwoDimensionalCNN,
    build_classifier,
)
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops import losses
from freesound_classification_tpu_torch.ops.augment import (
    AugmentConfig,
    make_augmenter,
)
from freesound_classification_tpu_torch.training import multifold
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.training.multifold import (
    MultiFoldEngine,
)
from freesound_classification_tpu_torch.training.state import create_model
from freesound_classification_tpu_torch.utils.config import Config
from tests.test_torch_engine_rest import DESCRIPTOR, SR, _train_cfg
from tests.test_torch_hierarchical import _train_argv
from tests.test_torch_hierarchical import _write_dataset
from tests.test_torch_multifold import _wave_fold_batches, _worst

N_CLASSES = 4
F_IN = 6
CFG = dict(num_conv_blocks=3, start_deep_supervision_on=1,
           conv_base_depth=8, growth_rate=1.5)  # widths 8, 12, 18


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


def _gru_variables(c, hidden, seed):
    """flax's init of a JAX ``MaskedBiGRU`` with its LayerNorm moved off
    1/0, so every leaf carries information."""
    x = jnp.zeros((1, 4, c))
    params = JaxBiGRU(hidden).init(jax.random.PRNGKey(seed), x,
                                   jnp.array([4]))["params"]
    params = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(seed)
    params["ln"]["scale"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    params["ln"]["bias"] = (0.1 * rng.randn(c)).astype(np.float32)
    for cell in ("GRUCell_0", "GRUCell_1"):
        for dense in params[cell].values():
            if "bias" in dense:
                dense["bias"] = (0.1 * rng.randn(hidden)).astype(np.float32)
    return params


def _port_gru(params, c, hidden, route):
    gru = blocks.MaskedBiGRU(c, hidden)
    sd = {}
    interop._from_jax_by_name(sd, "", {"g": params}, {})
    gru.load_state_dict({k[2:]: v for k, v in sd.items()})
    gru.route = route
    return gru


LENGTHS = {"one": [1, 1, 1], "full": [12, 12, 12], "mixed": [12, 1, 7]}


@pytest.mark.parametrize("route", ["fused", "scan"])
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
def test_masked_bigru_matches_jax(route, lengths):
    """(B, 2H) final states at lengths of 1, T and in between, within
    1e-5, float32, on the fused (``torch._VF.gru``) and the step-by-step
    route; values past a row's length change nothing."""
    c, hidden, t = 5, 7, 12
    params = _gru_variables(c, hidden, seed=1)
    rng = np.random.RandomState(2)
    x = rng.randn(3, t, c).astype(np.float32)
    lens = np.array(LENGTHS[lengths], np.int32)
    want = np.asarray(jax.jit(JaxBiGRU(hidden).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(lens)))
    gru = _port_gru(params, c, hidden, route)
    got = gru(torch.from_numpy(x), torch.from_numpy(lens).long())
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=0)
    noisy = x.copy()
    noisy[np.arange(t)[None, :] >= lens[:, None]] = 9.0
    again = gru(torch.from_numpy(noisy), torch.from_numpy(lens).long())
    torch.testing.assert_close(again, got, rtol=0, atol=1e-6)


def test_routes_agree_forward_and_backward():
    """The step-by-step route against the fused one: outputs and every
    parameter's gradient within 1e-5 of the largest."""
    c, hidden = 5, 7
    params = _gru_variables(c, hidden, seed=3)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(4, 10, c).astype(np.float32))
    lens = torch.tensor([10, 3, 1, 8])
    grads = {}
    for route in ("fused", "scan"):
        gru = _port_gru(params, c, hidden, route)
        out = gru(x, lens)
        (out * torch.linspace(-1, 1, out.shape[1])).sum().backward()
        grads[route] = {n: p.grad.clone() for n, p in gru.named_parameters()}
        grads[route]["out"] = out.detach()
    names = list(grads["fused"])
    assert _worst(grads["scan"], grads["fused"], names) <= 1e-5


def test_flip_within_lengths_is_flax_flip_sequences():
    from flax.linen.recurrent import flip_sequences

    rng = np.random.RandomState(5)
    x = rng.randn(4, 9, 3).astype(np.float32)
    lens = np.array([9, 1, 4, 6])
    want = np.asarray(flip_sequences(jnp.asarray(x), jnp.asarray(lens), 1,
                                     False))
    got = blocks.flip_within_lengths(torch.from_numpy(x),
                                     torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_model(family, cfg=CFG):
    cls = JaxCNN if family == "2d" else JaxHier
    return cls(**cfg, aggregation_type="rnn", n_classes=N_CLASSES)


def _inputs(family, b=3, t=32, seed=6):
    rng = np.random.RandomState(seed)
    shape = (b, 32, t, 1) if family == "2d" else (b, t, F_IN)
    x = rng.randn(*shape).astype(np.float32)
    fl = rng.randint(2, t + 1, b).astype(np.int32)
    fl[0] = t
    return x, fl


def _variables(family, seed, cfg=CFG):
    kind = "2d_cnn" if family == "2d" else "hierarchical_cnn"
    return interop.random_jax_variables(
        **cfg, n_classes=N_CLASSES, seed=seed, model_kind=kind,
        input_dim=F_IN, aggregation_type="rnn")


def _port_model(family, params, stats, cfg=CFG):
    if family == "2d":
        model = TwoDimensionalCNN(**cfg, aggregation_type="rnn",
                                  n_classes=N_CLASSES)
    else:
        model = HierarchicalCNN(F_IN, **cfg, aggregation_type="rnn",
                                n_classes=N_CLASSES)
    model.load_state_dict(interop.from_jax_variables(params, stats))
    return model


@pytest.mark.parametrize("family", ["2d", "1d"])
def test_random_rnn_variables_have_the_flax_layout(family):
    x, fl = _inputs(family)
    init = jax.eval_shape(
        lambda: _jax_model(family).init(jax.random.PRNGKey(0), jnp.asarray(x),
                                        jnp.asarray(fl), train=False))

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(shapes(v, f"{prefix}{k}/"))
            else:
                out[f"{prefix}{k}"] = tuple(np.shape(v))
        return out

    params, stats = _variables(family, seed=0)
    assert shapes(params) == shapes(init["params"])
    assert shapes(stats) == shapes(init["batch_stats"])
    # the weight map round-trips, and the port's model takes every tensor
    sd = interop.from_jax_variables(params, stats)
    assert set(sd) == set(_port_model(family, params, stats).state_dict())
    back_p, back_s = interop.to_jax_variables(sd)
    assert dict(_leaves(back_p)).keys() == dict(_leaves(params)).keys()
    for name, v in _leaves(back_p):
        np.testing.assert_array_equal(v, dict(_leaves(params))[name])


@pytest.mark.parametrize("family", ["2d", "1d"])
def test_rnn_logits_match_jax(family):
    """Eval logits of both rnn models within 2e-4 (the ROADMAP's forward
    tolerance), ragged frame counts; both GRU routes."""
    params, stats = _variables(family, seed=7)
    x, fl = _inputs(family)
    want = np.asarray(jax.jit(
        lambda v, x, fl: _jax_model(family).apply(v, x, fl, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        jnp.asarray(fl))["class_logits"])
    model = _port_model(family, params, stats).eval()
    for route in ("fused", "scan"):
        for m in model.modules():
            if isinstance(m, blocks.MaskedBiGRU):
                m.route = route
        got = model(torch.from_numpy(x), torch.from_numpy(fl).long())
        np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-4,
                                   rtol=0, err_msg=route)


def test_fold_npz_round_trips_an_rnn_model(tmp_path):
    """A fold file of an rnn model loads back bit for bit, and the GRU
    weights it hands cuDNN are contiguous (the map's transposes are
    views; cuDNN's inference path refuses strided weights)."""
    params, stats = _variables("2d", seed=8)
    model = _port_model("2d", params, stats)
    for cell in (model.rnn1.GRUCell_0, model.rnn2.GRUCell_1):
        for dtype in (torch.float32, torch.bfloat16):
            assert all(t.is_contiguous() for t in cell.weights(dtype))
    path = str(tmp_path / "fold.npz")
    interop.save_fold_npz(path, *interop.to_jax_variables(model.state_dict()))
    other = TwoDimensionalCNN(**CFG, aggregation_type="rnn",
                              n_classes=N_CLASSES)
    other.load_state_dict(interop.from_jax_variables(
        *interop.load_fold_npz(path)))
    for name, t in model.state_dict().items():
        torch.testing.assert_close(other.state_dict()[name], t, rtol=0,
                                   atol=0)


def test_flax_like_init_of_the_gru():
    """``create_model`` draws the GRUs as flax does: LayerNorm 1/0, input
    kernels of variance 1/fan_in, each gate's recurrent kernel orthogonal,
    biases 0."""
    net = Config({**CFG, "aggregation_type": "rnn", "output_dropout": 0.0})
    model = create_model(net, N_CLASSES, torch.float32, 0,
                         torch.device("cpu"), model_kind="hierarchical_cnn",
                         input_dim=F_IN)
    gru = model.rnn2
    assert torch.equal(gru.ln.weight, torch.ones(18))
    assert torch.equal(gru.ln.bias, torch.zeros(18))
    for cell in (gru.GRUCell_0, gru.GRUCell_1):
        for gate in cell.weight_hh.split(128):
            torch.testing.assert_close(gate @ gate.T, torch.eye(128),
                                       atol=1e-5, rtol=0)
        assert abs(float(cell.weight_ih.detach().std()) * 18 ** 0.5 - 1) < 0.05
        assert not cell.bias_ih.any() and not cell.bias_hn.any()
    assert not torch.equal(gru.GRUCell_0.weight_hh, gru.GRUCell_1.weight_hh)


def test_unknown_aggregation_raises():
    net = Config({**CFG, "aggregation_type": "mean", "output_dropout": 0.0})
    with pytest.raises(ValueError, match="aggregation_type"):
        build_classifier("2d_cnn", net, N_CLASSES)


@pytest.mark.parametrize("family", ["2d", "1d"])
def test_rnn_train_step_matches_jax(family):
    """One train-mode step, dropout 0: loss 1e-4 and every gradient within
    1e-2 of its tensor's largest JAX gradient (the ROADMAP's tolerances;
    tensors whose JAX gradient is rounding noise, below 1e-6 of the
    model's largest, are held to that)."""
    params, stats = _variables(family, seed=9)
    x, fl = _inputs(family, b=5, t=24, seed=10)
    rng = np.random.RandomState(11)
    labels = (rng.rand(5, N_CLASSES) < 0.4).astype(np.float32)
    labels[:, 0] = 1.0
    loss_fn = jlosses.make_loss("lsep_naive")

    def loss_of(p):
        out, _ = _jax_model(family).apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(x),
            jnp.asarray(fl), mutable=["batch_stats"], train=True,
            rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(loss_fn(out["class_logits"], jnp.asarray(labels),
                                average=False))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(params)
    model = _port_model(family, params, stats).train()
    loss = losses.lsep_loss(model(torch.from_numpy(x),
                                  torch.from_numpy(fl).long()),
                            torch.from_numpy(labels))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), abs=1e-4)
    tgrads = interop.to_jax_variables(
        {k: v.grad for k, v in model.named_parameters()}
        | dict(model.named_buffers()))[0]
    jg = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    top = max(np.abs(g).max() for g in jg.values())
    assert any(name.startswith("rnn") for name in jg)
    for name, g in _leaves(tgrads):
        denom = np.abs(jg[name]).max()
        if denom < 1e-6 * top:
            assert np.abs(g).max() < 1e-6 * top, name
            continue
        np.testing.assert_allclose(g / denom, jg[name] / denom, atol=1e-2,
                                   err_msg=name)


def test_fold_stack_runs_the_scan_route_and_the_template_the_fused():
    model = TwoDimensionalCNN(**CFG, aggregation_type="rnn",
                              n_classes=N_CLASSES)
    stack = multifold.FoldStack(model, 2)
    routes = {m.route for m in stack._base[0].modules()
              if isinstance(m, blocks.MaskedBiGRU)}
    assert routes == {"scan"}
    assert {m.route for m in model.modules()
            if isinstance(m, blocks.MaskedBiGRU)} == {"fused"}


def test_stacked_rnn_step_matches_single_fold_engines():
    """Two folds, 2 epochs of 2 batches of 6 clips with ragged lengths,
    MixUp and the effects chain (no chunk shuffle, as for rnn models),
    momentum, float32, dropout 0: the stacked rnn engine (the GRU on its
    vmap route) against two single-fold port engines (the fused route)
    from the same weights with seeds ``seed + k``: per-fold epoch losses
    within 1e-5 relative, parameters within 1e-5 of each fold's largest,
    BatchNorm statistics within 1e-5 of their own largest."""
    torch.manual_seed(0)  # the template's default init
    cfg = _train_cfg("momentum", 1e-3, 1)
    augment = make_augmenter(AugmentConfig(p_mixup=0.5, p_aug=0.75))
    frontend = Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu")

    def engine(seed):
        model = TwoDimensionalCNN(
            num_conv_blocks=2, start_deep_supervision_on=0,
            conv_base_depth=8, growth_rate=2.0, aggregation_type="rnn",
            n_classes=N_CLASSES)
        return Engine(model, frontend, cfg, loss="lsep_naive",
                      augment=augment, seed=seed, device="cpu")

    template = engine(7)
    init = {n: t.clone() for n, t in template.model.state_dict().items()}
    stack = MultiFoldEngine(template, [0, 1])
    stack.make_optimizer(4, 2)
    singles = []
    for k in range(2):
        single = engine(7 + k)
        single.model.load_state_dict(init)
        single.make_optimizer(4, 2)
        singles.append(single)
    folds = _wave_fold_batches(2, 2, rows=6)
    for _ in range(2):
        got = stack.train_epoch(folds, 1.0, log_interval=100)
        want = [e.train_epoch(b, 1.0, log_interval=100)["loss"]
                for e, b in zip(singles, folds)]
        np.testing.assert_allclose(got["loss"], want, rtol=1e-5)
    names = stack.model.param_names
    assert any(".GRUCell_1." in n for n in names)
    for k, single in enumerate(singles):
        fold = stack.model.fold_state(k)
        want = single.model.state_dict()
        assert _worst(fold, want, names) <= 1e-5
        for name in stack.model.buffer_names:
            assert _worst(fold, want, [name]) <= 1e-5, name
    assert _worst(stack.model.fold_state(0), stack.model.fold_state(1),
                  names) > 1e-4


def _rnn_argv(root, label, *extra):
    """The hierarchical tests' train argv (2 blocks, base depth 8, batch
    4, 1 s clips, MixUp and the effects chain) with ``rnn`` aggregation,
    one epoch, and a hop of 1024 (44 frames a clip): the GRUs' steps."""
    return [a if a != "max" else "rnn" for a in _train_argv(
        root, label, features="mel_1024_1024_32")] + ["--epochs", "1",
                                                      *extra]


def test_rnn_train_and_predict_clis_sequential_and_fold_parallel(tmp_path):
    """``--aggregation_type rnn`` through the 2d train CLI (one fold), the
    same with ``--fold_parallel`` over two folds, the hierarchical train
    CLI with ``--fold_parallel``, and the predict CLI on each: the fold
    files hold the GRUs, and the predictions are probabilities."""
    root = str(tmp_path)
    _write_dataset(root)
    runs = [(train_2d_cnn, "2d_cnn", _rnn_argv(root, "seq")),
            (train_2d_cnn, "2d_cnn",
             _rnn_argv(root, "par", "--folds", "0", "1", "--fold_parallel")),
            (train_hierarchical_cnn, "hierarchical_cnn",
             _rnn_argv(root, "hier", "--folds", "0", "1",
                       "--fold_parallel"))]
    for cli, kind, argv in runs:
        experiment = cli.main(argv)
        fold = argv[len(argv) - argv[::-1].index("--folds")]
        params, _ = interop.load_fold_npz(os.path.join(
            experiment.experiment_dir, "checkpoints", f"fold_{fold}",
            "best_model.npz"))
        assert set(params["rnn0"]) == {"ln", "GRUCell_0", "GRUCell_1"}
        out = os.path.join(root, f"preds_{kind}_{fold}.csv")
        predict_2d_cnn.main([
            "--experiment", experiment.experiment_dir,
            "--test_df", os.path.join(root, "train.csv"),
            "--test_data_dir", os.path.join(root, "train"),
            "--classmap", os.path.join(root, "classmap.json"),
            "--output_df", out, "--device", "cpu", "--model_kind", kind,
            "--folds", fold])
        with open(out) as f:
            rows = [line.strip().split(",") for line in f][1:]
        probs = np.array([[float(v) for v in r[1:]] for r in rows])
        assert len(probs) == 20 and np.isfinite(probs).all()
        assert probs.min() >= 0 and probs.max() <= 1
