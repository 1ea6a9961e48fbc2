"""The port's resnet backbone family against the JAX package's, on the CPU:
``CNNBackbone`` in eval and train mode for both archs, the trunk's valid
frames, the weight map, the BasicBlock fold, K7's plain version against the
JAX Pallas kernel in interpret mode, the folded twin, ``fused_infer`` at
model level, K7's wrapper, and the train -> predict CLIs end to end
(K7's tile plans: ``tests/test_torch_conv_core.py``).

Inputs and weights are made with numpy from seeds and handed to both
sides (``interop.random_jax_variables``: BatchNorm statistics and PReLU
slopes away from their defaults); float32 products run at full precision.
"""

import csv
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from freesound_classification_tpu.models.backbone import (
    BasicBlock as JaxBasicBlock,
    CNNBackbone as JaxBackbone,
)
from freesound_classification_tpu.ops import losses as jlosses
from freesound_classification_tpu.ops import pallas_backbone as jbb
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import (
    predict_2d_cnn,
    train_backbone_cnn,
)
from freesound_classification_tpu_torch.data import audio_io
from freesound_classification_tpu_torch.models import backbone
from freesound_classification_tpu_torch.models.backbone import CNNBackbone
from freesound_classification_tpu_torch.models.classifiers import (
    build_classifier,
)
from freesound_classification_tpu_torch.ops import (
    backbone_infer,
    kernels,
    losses,
    resnet_infer,
)
from freesound_classification_tpu_torch.utils.config import Config

SR = 44100
N_CLASSES = 5
N_MELS = 32
ARCHS = ("resnet18", "resnet34")
FLIP_SHARE = 0.02  # the share of output elements one bf16 step may flip

torch.set_float32_matmul_precision("highest")


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


def _variables(arch, seed):
    return interop.random_jax_variables(
        n_classes=N_CLASSES, seed=seed, model_kind="backbone_cnn",
        backbone=arch)


def _port_model(arch, params, stats, fused_infer=False):
    model = CNNBackbone(arch, n_classes=N_CLASSES, fused_infer=fused_infer)
    model.load_state_dict(interop.from_jax_variables(params, stats))
    return model.eval()


def _spec(b, t, seed):
    rng = np.random.RandomState(seed)
    spec = rng.randn(b, N_MELS, t, 1).astype(np.float32)
    fl = rng.randint(1, t + 1, size=b).astype(np.int32)
    fl[0] = t
    return spec, fl


def _jax_logits(arch, params, stats, spec, fl):
    out = JaxBackbone(arch=arch, n_classes=N_CLASSES).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(spec),
        jnp.asarray(fl), train=False)
    return np.asarray(out["class_logits"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_random_variables_have_the_flax_layout(arch):
    spec, fl = _spec(2, 16, seed=0)
    init = JaxBackbone(arch=arch, n_classes=N_CLASSES).init(
        jax.random.PRNGKey(0), jnp.asarray(spec), jnp.asarray(fl))
    params, stats = _variables(arch, seed=0)
    for got, want in ((params, init["params"]), (stats, init["batch_stats"])):
        got, want = dict(_leaves(got)), dict(_leaves(want))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape, k


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("t", [37, 65, 5, 1])
def test_logits_match_jax(arch, t):
    """Eval logits at 2e-4. 65 frames leave 3 trunk frames (not 65 // 32);
    5 and 1 frames reach a 1-frame map in the first stages, which every
    stride-2 stage and the max-pool must carry (ceil(W / 2) frames out)."""
    params, stats = _variables(arch, seed=t)
    spec, fl = _spec(3, t, seed=t + 1)
    want = _jax_logits(arch, params, stats, spec, fl)
    got = _port_model(arch, params, stats)(torch.from_numpy(spec),
                                           torch.from_numpy(fl))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("frames,want", [(65, 3), (64, 2), (1, 1), (2, 1),
                                         (33, 2), (431, 14), (0, 1)])
def test_trunk_frames(frames, want):
    """(l + 1) // 2 five times, at least 1; 431 frames (10 s) -> 14, the
    width of the last stage's map."""
    got = backbone.trunk_frames(torch.tensor([frames]))
    assert int(got[0]) == want


def test_trunk_map_widths_are_ceil_halves():
    """Each stride-2 stage gives ceil(W / 2) frames: a 10 s clip's 431
    frames become 216, 108, 54, 27, 14."""
    model = CNNBackbone("resnet18", n_classes=N_CLASSES).eval()
    widths = []
    for name in ("conv1", "stage1_block0", "stage2_block0",
                 "stage3_block0"):
        getattr(model.trunk, name).register_forward_hook(
            lambda m, i, o: widths.append(o.shape[-1]))
    model(torch.zeros(1, 8, 431, 1), torch.tensor([431]))
    assert widths == [216, 54, 27, 14]


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_map_round_trips(arch):
    params, stats = _variables(arch, seed=10)
    assert interop.model_kind_of(params) == "backbone_cnn"
    back = interop.to_jax_variables(interop.from_jax_variables(params,
                                                               stats))
    for tree, want in zip(back, (params, stats)):
        got, ref = dict(_leaves(tree)), dict(_leaves(want))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_model_kinds_of_the_variables():
    net = dict(num_conv_blocks=2, start_deep_supervision_on=0,
               conv_base_depth=8, seed=1)
    assert interop.model_kind_of(
        interop.random_jax_variables(**net)[0]) == "2d_cnn"
    assert interop.model_kind_of(interop.random_jax_variables(
        **net, model_kind="hierarchical_cnn", input_dim=4)[0]) \
        == "hierarchical_cnn"


def test_build_classifier_reads_the_backbone():
    net = Config({"num_conv_blocks": 5, "start_deep_supervision_on": 2,
                  "conv_base_depth": 64, "growth_rate": 2.0,
                  "aggregation_type": "max", "output_dropout": 0.5,
                  "backbone": "resnet34"})
    model = build_classifier("backbone_cnn", net, N_CLASSES,
                             dtype=torch.bfloat16)
    assert model.arch == "resnet34" and model.dtype == torch.bfloat16
    assert len(model.trunk.block_names) == 16
    assert model.head.dropout == 0.5
    identity = [n for n in model.trunk.block_names
                if getattr(model.trunk, n).downsample is None]
    assert len(identity) == 13  # 3 + 3 + 5 + 2: the blocks K7 takes
    with pytest.raises(ValueError, match="unknown backbone"):
        CNNBackbone("resnet50")


def test_train_step_matches_jax():
    """One train-mode forward and backward of resnet18 (batch statistics,
    dropout 0): logits 2e-4, loss 1e-4, gradients 1e-2 of each tensor's
    largest JAX gradient (tensors whose gradient is zero up to rounding
    held to 1e-6 of the model's largest), running statistics after the
    step 1e-5 relative."""
    arch = "resnet18"
    params, stats = _variables(arch, seed=11)
    spec, fl = _spec(4, 40, seed=12)
    labels = (np.random.RandomState(13).rand(4, N_CLASSES) < 0.4).astype(
        np.float32)
    labels[:, 0] = 1.0

    model = JaxBackbone(arch=arch, n_classes=N_CLASSES)
    loss_fn = jlosses.make_loss("lsep_naive")

    def loss_of(p):
        out, mut = model.apply({"params": p, "batch_stats": stats},
                               jnp.asarray(spec), jnp.asarray(fl),
                               mutable=["batch_stats"], train=True,
                               rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(loss_fn(out["class_logits"], jnp.asarray(labels),
                                average=False)), (out["class_logits"],
                                                  mut["batch_stats"])

    (jloss, (jlogits, jstats)), jgrads = jax.value_and_grad(
        loss_of, has_aux=True)(params)

    port = CNNBackbone(arch, n_classes=N_CLASSES)
    port.load_state_dict(interop.from_jax_variables(params, stats))
    port.train()
    logits = port(torch.from_numpy(spec), torch.from_numpy(fl))
    loss = losses.lsep_loss(logits, torch.from_numpy(labels))
    loss.backward()
    tgrads = interop.to_jax_variables(
        {k: v.grad for k, v in port.named_parameters()}
        | dict(port.named_buffers()))[0]
    tstats = interop.to_jax_variables(port.state_dict())[1]

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-4, rtol=0)
    assert float(loss.detach()) == pytest.approx(float(jloss), abs=1e-4)
    jg = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    top = max(np.abs(g).max() for g in jg.values())
    noise = {n for n, g in jg.items() if np.abs(g).max() < 1e-6 * top}
    got = dict(_leaves(tgrads))
    assert got.keys() == jg.keys()
    for name, g in got.items():
        if name in noise:
            assert np.abs(g).max() < 1e-6 * top, name
            continue
        denom = np.abs(jg[name]).max()
        np.testing.assert_allclose(g / denom, jg[name] / denom, atol=1e-2,
                                   err_msg=name)
    js = dict(_leaves(jax.tree.map(np.asarray, jstats)))
    for name, s in _leaves(tstats):
        np.testing.assert_allclose(s, js[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the fold, K7's plain version and the folded twin
# ---------------------------------------------------------------------------


def _block(c, features, strides, seed):
    """One BasicBlock's JAX variables {"params", "batch_stats"} (random, in
    the JAX layout) and the port's block (eval) with the same weights."""
    rng = np.random.RandomState(seed)

    def conv(k, c_in, c_out):
        return {"kernel": (rng.randn(k, k, c_in, c_out)
                           * (k * k * c_in) ** -0.5).astype(np.float32)}

    def bn(n):
        return ({"scale": (1 + 0.1 * rng.randn(n)).astype(np.float32),
                 "bias": (0.1 * rng.randn(n)).astype(np.float32)},
                {"mean": (0.1 * rng.randn(n)).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, n).astype(np.float32)})

    p = {"conv1": conv(3, c, features), "conv2": conv(3, features, features)}
    s = {}
    p["bn1"], s["bn1"] = bn(features)
    p["bn2"], s["bn2"] = bn(features)
    if c != features or strides != 1:
        p["downsample"] = conv(1, c, features)
        p["downsample_bn"], s["downsample_bn"] = bn(features)
    block = backbone.BasicBlock(c, features, strides)
    sd = {}
    interop._from_jax_by_name(sd, "", p, s)
    block.load_state_dict(sd)
    return {"params": p, "batch_stats": s}, block.eval()


def _bf16_values(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("c,features,strides", [(8, 8, 1), (8, 16, 2),
                                                (8, 16, 1)])
def test_fold_matches_jax(c, features, strides):
    """The same float32 formula, scale / sqrt(var + eps): 1e-7."""
    variables, block = _block(c, features, strides, seed=1)
    want = jbb.fold_basic_params(variables)
    got = backbone_infer.fold_basic_params(block)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-7, rtol=1e-7, err_msg=k)


def _assert_bf16_close(got, want):
    """One bf16 step of the largest output, and at most 2% of the elements
    flipped: the plain version and the Pallas kernel compute the same bf16
    x bf16 products with float32 sums in another order and round h1 and y
    at the same points, so a sum that straddles a rounding boundary flips
    one step."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    step = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=step, rtol=0)
    assert (got != want).mean() <= FLIP_SHARE


@pytest.mark.parametrize("c,h,w,b", [(8, 6, 11, 2), (16, 5, 7, 2),
                                     (24, 3, 130, 2), (8, 1, 9, 1)])
def test_k7_plain_matches_jax_kernel(c, h, w, b):
    """The JAX tests' shapes (tests/test_pallas_backbone.py), and one row
    of one image, where both h1 halos are zero."""
    variables, block = _block(c, c, 1, seed=c + h)
    x = _bf16_values((b, h, w, c), seed=w)
    want = jbb.basic_block_infer_pallas(
        jnp.asarray(x), jbb.fold_basic_params(variables), interpret=True)
    wts = resnet_infer.fused_weights(block, backbone_infer.fold_basic_params,
                                     kernels.pack_basic_block)
    got = kernels.basic_block_fused_reference(_nchw(x), wts)
    _assert_bf16_close(_nhwc(got), want)


@pytest.mark.parametrize("c,features,strides,hw", [
    (8, 16, 2, (6, 10)),  # stride 2 with the projection
    (8, 16, 2, (5, 9)),   # odd sizes: ceil(W / 2) out
    (8, 16, 1, (5, 7)),   # a projection at stride 1
    (8, 8, 1, (6, 11)),   # identity
])
def test_folded_twin_matches_jax(c, features, strides, hw):
    """The folded twin in float32 against JAX ``basic_block_infer_xla``
    (2e-5), and the routed block against the unfused flax block with JAX's
    own tolerances: 2e-4 / 1e-3 for the folded twin, 0.06 / 0.05 for the
    identity block, which routes to K7 (its plain version here)."""
    variables, block = _block(c, features, strides, seed=5)
    x = np.random.RandomState(6).randn(2, *hw, c).astype(np.float32)
    fp = jbb.fold_basic_params(variables)
    want = np.asarray(jbb.basic_block_infer_xla(jnp.asarray(x), fp, strides))
    got = backbone_infer.basic_block_infer_folded(
        _nchw(x), backbone_infer.fold_basic_params(block), strides)
    np.testing.assert_allclose(_nhwc(got), want, atol=2e-5, rtol=1e-5)
    flax = np.asarray(JaxBasicBlock(features, strides).apply(
        variables, jnp.asarray(x), train=False))
    routed = backbone_infer.basic_block_infer(_nchw(x), block, strides)
    identity = c == features and strides == 1
    np.testing.assert_allclose(_nhwc(routed), flax,
                               atol=0.06 if identity else 2e-4,
                               rtol=0.05 if identity else 1e-3)


def test_routing_takes_k7_for_identity_blocks_only(monkeypatch):
    calls = []
    real = kernels.basic_block_fused
    monkeypatch.setattr(kernels, "basic_block_fused",
                        lambda x, w: calls.append(x.shape) or real(x, w))
    _, identity = _block(8, 8, 1, seed=7)
    _, projection = _block(8, 16, 1, seed=8)
    _, strided = _block(8, 16, 2, seed=9)
    x = torch.from_numpy(_bf16_values((1, 8, 4, 6), seed=10))
    backbone_infer.basic_block_infer(x, identity, 1)
    backbone_infer.basic_block_infer(x, projection, 1)
    backbone_infer.basic_block_infer(x, strided, 2)
    assert calls == [(1, 8, 4, 6)]


# ---------------------------------------------------------------------------
# fused_infer at model level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_infer_model_matches_jax(arch):
    """A float32 model with ``fused_infer``: the JAX model runs its folded
    float32 twin off the TPU, the port K7's plain version in the identity
    blocks, which rounds x, the folded weights, h1 and y to bf16 (2^-9
    relative each), and the folded twin elsewhere. Those roundings over up
    to 13 blocks of activations of order 1, through the head, stay within
    5e-2 abs + 5e-2 rel of the logits."""
    params, stats = _variables(arch, seed=20)
    spec, fl = _spec(3, 37, seed=21)
    want = np.asarray(JaxBackbone(arch=arch, n_classes=N_CLASSES,
                                  fused_infer=True).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(spec),
        jnp.asarray(fl), train=False)["class_logits"])
    got = _port_model(arch, params, stats, fused_infer=True)(
        torch.from_numpy(spec), torch.from_numpy(fl)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    # the rounding is there: the fused logits are not the float32 ones
    assert not np.allclose(got, want, atol=1e-6, rtol=0)


def test_train_mode_ignores_fused_infer():
    """In train mode a fused model is the unfused model: the same logits
    and running statistics, and no K7 launch."""
    params, stats = _variables("resnet18", seed=22)
    spec, fl = _spec(2, 20, seed=23)
    before = kernels.basic_block_fused.launches
    outs = []
    for fused in (False, True):
        model = _port_model("resnet18", params, stats, fused).train()
        outs.append((model(torch.from_numpy(spec), torch.from_numpy(fl)),
                     model.trunk.stage0_block1.bn2.running_var.clone()))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=0, rtol=0)
    torch.testing.assert_close(outs[1][1], outs[0][1], atol=0, rtol=0)
    assert kernels.basic_block_fused.launches == before


# ---------------------------------------------------------------------------
# K7's wrapper
# ---------------------------------------------------------------------------


def test_wrapper_takes_the_plain_version_on_cpu_only():
    _, block = _block(16, 16, 1, seed=24)
    wts = resnet_infer.fused_weights(block, backbone_infer.fold_basic_params,
                                     kernels.pack_basic_block)
    assert wts.w1.shape == (9, 16, 16) and wts.bias.shape == (2, 16)
    x = torch.from_numpy(_bf16_values((2, 16, 3, 5), seed=25))
    before = kernels.basic_block_fused.launches
    got = kernels.basic_block_fused(x, wts)
    assert kernels.basic_block_fused.launches == before
    torch.testing.assert_close(
        got, kernels.basic_block_fused_reference(x, wts), atol=0, rtol=0)
    assert got.dtype == torch.float32 and got.shape == x.shape
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.basic_block_fused(x.to("meta"), wts)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _write_dataset(root, n=16):
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


def test_train_then_predict_clis_end_to_end(tmp_path):
    """The backbone train CLI (augmentation on, the plain versions of
    K1-K3) writes ``network.backbone`` into config.json and its folds;
    the predict CLI with --model_kind backbone_cnn reads them; the same
    ensemble through ``build_predictor(..., fused_infer=True)`` (K7's
    plain version) agrees with it."""
    root = str(tmp_path)
    classes = _write_dataset(root)
    exp = train_backbone_cnn.main([
        "--train_df", os.path.join(root, "train.csv"),
        "--train_data_dir", os.path.join(root, "train"),
        "--classmap", os.path.join(root, "classmap.json"),
        "--device", "cpu", "--features", "mel_512_256_32",
        "--backbone", "resnet18", "--aggregation_type", "max",
        "--optimizer", "adam", "--lr", "0.003",
        "--scheduler", "1cycle_0.0001_0.005", "--weight_decay", "0.0",
        "--p_mixup", "0.5", "--p_aug", "0.75", "--output_dropout", "0.5",
        "--batch_size", "4", "--max_audio_length", "1", "--epochs", "2",
        "--n_folds", "4", "--folds", "1", "--num_workers", "0",
        "--log_interval", "1", "--label", "bb",
        "--experiments_dir", os.path.join(root, "experiments")])
    with open(os.path.join(exp.experiment_dir, "config.json")) as f:
        assert json.load(f)["network"]["backbone"] == "resnet18"
    fold_dir = os.path.join(exp.experiment_dir, "checkpoints", "fold_1")
    final, _ = interop.load_fold_npz(os.path.join(fold_dir,
                                                  "final_model.npz"))
    assert final["trunk"]["conv1"]["kernel"].shape == (7, 7, 3, 64)
    assert "bias" not in final["trunk"]["conv1"]
    log = open(os.path.join(exp.experiment_dir, "log")).read()
    assert "Epoch 1" in log

    with open(os.path.join(root, "test.csv"), "w") as f:
        f.write("fname\n" + "".join(f"clip{i:02d}.wav\n" for i in range(6)))
    out = os.path.join(root, "preds.csv")
    predict_2d_cnn.main([
        "--experiment", exp.experiment_dir,
        "--test_df", os.path.join(root, "test.csv"),
        "--test_data_dir", os.path.join(root, "train"),
        "--classmap", os.path.join(root, "classmap.json"),
        "--output_df", out, "--device", "cpu", "--folds", "1",
        "--num_workers", "0", "--model_kind", "backbone_cnn"])
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["fname", *classes]
    probs = np.asarray([[float(v) for v in r[1:]] for r in rows[1:]])
    assert probs.shape == (6, 3) and np.isfinite(probs).all()
    assert probs.min() >= 0 and probs.max() <= 1

    from freesound_classification_tpu_torch.cli.common import default_ladder
    from freesound_classification_tpu_torch.data.dataset import (
        ClipDataset,
        read_manifest,
    )
    from freesound_classification_tpu_torch.data.loader import make_loader

    _, files = read_manifest(os.path.join(root, "test.csv"),
                             os.path.join(root, "train"))
    loader = make_loader(ClipDataset(files, sr=SR), default_ladder(None),
                         batch_size=4, num_workers=0)
    fused = predict_2d_cnn.build_predictor(
        exp.experiment_dir, torch.device("cpu"), folds=[1],
        model_kind="backbone_cnn", fused_infer=True)
    assert fused.models[0].trunk.stage0_block0.fused_infer
    # a float32 model through K7's bf16 rounding points
    np.testing.assert_allclose(fused.predict_loader(loader), probs,
                               atol=2e-2, rtol=0)
    with pytest.raises(ValueError, match="holds a backbone_cnn model"):
        predict_2d_cnn.build_predictor(exp.experiment_dir,
                                       torch.device("cpu"), folds=[1])
