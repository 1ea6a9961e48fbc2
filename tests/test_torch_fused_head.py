"""The port's fused 2d head (K8) against the JAX package, on the CPU: the
fold, K8's plain version against the JAX Pallas head kernel in interpret
mode, the guard, ``fused_head`` at block and model level, the wrapper, and
``build_predictor(..., fused_head=True)``.

Weights are made with numpy from a seed in the JAX package's layout
(``interop.random_jax_variables``: BatchNorm statistics and PReLU slopes
away from their defaults) and handed to both packages.

Tolerance of a kernel comparison: both compute bn_in(x) in float32 rounded
to bf16, bf16 x bf16 products with float32 sums (in another order), the max
of four float32 conv outputs, the affine and PReLU in float32, and round
the output to bf16. Where two float32 sums straddle a bf16 rounding
boundary an output flips by one step: the outputs agree to one bf16 step
of the largest output (2^-7 of it), and at most 2% of them differ.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from freesound_classification_tpu.models.classifiers import (
    TwoDimensionalCNN as JaxCNN,
)
from freesound_classification_tpu.ops import pallas_head as jhead
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.models import blocks
from freesound_classification_tpu_torch.models.classifiers import (
    TwoDimensionalCNN,
)
from freesound_classification_tpu_torch.ops import (
    head_infer,
    kernels,
    resnet_infer,
)

N_CLASSES = 5
FLIP_SHARE = 0.02

torch.set_float32_matmul_precision("highest")


def _head(c_in, depth, seed):
    """A ConvBlock2d's JAX variables {"params", "batch_stats"} and the
    port's block (eval) with the same weights."""
    params, stats = interop.random_jax_variables(
        num_conv_blocks=1, start_deep_supervision_on=0,
        conv_base_depth=depth, growth_rate=1.0, n_classes=2, seed=seed)
    if c_in != 2:  # block0 of the 2d CNN has 2 input channels
        rng = np.random.RandomState(seed + 1)
        p, s = params["block0"], stats["block0"]
        p["conv"]["kernel"] = (rng.randn(3, 3, c_in, depth)
                               * (9 * c_in) ** -0.5).astype(np.float32)
        p["bn_in"] = {"scale": (1 + 0.1 * rng.randn(c_in)).astype(np.float32),
                      "bias": (0.1 * rng.randn(c_in)).astype(np.float32)}
        s["bn_in"] = {"mean": (0.1 * rng.randn(c_in)).astype(np.float32),
                      "var": rng.uniform(0.5, 1.5, c_in).astype(np.float32)}
    variables = {"params": params["block0"], "batch_stats": stats["block0"]}
    block = blocks.ConvBlock2d(c_in, depth, fused_head=True)
    block.load_state_dict({
        k[len("blocks.0."):]: v
        for k, v in interop.from_jax_variables(params, stats).items()
        if k.startswith("blocks.0.")})
    return variables, block.eval()


def _assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    step = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=step, rtol=0)
    assert (got != want).mean() <= FLIP_SHARE


def test_fold_matches_jax():
    """The same float32 formulas: 1e-7."""
    variables, block = _head(2, 16, seed=1)
    want = jhead.fold_head_params(variables)
    got = head_infer.fold_head_params(block)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-7, rtol=1e-7, err_msg=k)


@pytest.mark.parametrize("c_in,h,w,depth,dtype,t_in", [
    (2, 8, 11, 16, "float32", 0.0),    # odd W (block0's 431 frames)
    (2, 8, 12, 16, "float32", 0.0),    # even W
    (1, 6, 9, 32, "float32", 0.0),     # one channel
    (3, 7, 10, 16, "float32", 0.0),    # odd H: the pool drops the last row
    (4, 4, 40, 16, "float32", 0.0),    # the most input channels
    (2, 9, 13, 64, "float32", 0.0),    # block0's depth, odd H and W
    (2, 10, 21, 16, "bfloat16", 0.0),  # a bf16 model's input
    (2, 7, 11, 16, "float32", 8.0),    # raised t_in: bn_in(x)'s zero pad
    (2, 6, 9, 32, "bfloat16", -6.0),   # shows against padding x
])
def test_k8_plain_matches_jax_kernel(c_in, h, w, depth, dtype, t_in):
    """The port's head (fold, pack, K8's plain version) against the JAX
    function with its Pallas kernel interpreted. With t_in raised, the SAME
    zeros of bn_in(x) differ from bn_in of a zero-padded x by t_in."""
    variables, block = _head(c_in, depth, seed=c_in + h + w)
    if t_in:
        stats = variables["batch_stats"]["bn_in"]
        p = variables["params"]["bn_in"]
        p["bias"] = p["bias"] + np.float32(t_in)
        with torch.no_grad():
            block.bn_in.bias += t_in
    x = np.random.RandomState(w).randn(2, h, w, c_in).astype(np.float32)
    x = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jhead.conv_block_2d_head_infer(
        jnp.asarray(x.float().numpy()).astype(dtype), variables,
        interpret=True)
    got = head_infer.conv_block_2d_head_infer(x.permute(0, 3, 1, 2), block)
    assert got.dtype == x.dtype
    assert got.shape == (2, depth, h // 2, w // 2)
    _assert_bf16_close(got.float().permute(0, 2, 3, 1).numpy(),
                       np.asarray(want, np.float32))
    if t_in:  # padding x before bn_in would be another head
        wts = resnet_infer.fused_weights(block, head_infer.fold_head_params,
                                         kernels.pack_conv_head)
        xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2).float(),
                                     (1, 1, 1, 1))
        wrong = kernels.conv_head_fused_reference(xp, wts)[
            ..., :h // 2, :w // 2].float()
        assert (wrong - got.float()).abs().max() > 10 * 2.0 ** -7 * \
            np.abs(np.asarray(want, np.float32)).max()


def test_head_supported_guards():
    """JAX's guard less its VMEM clause: a 60 s clip's frames are in."""
    assert head_infer.head_supported((4, 2, 128, 431), 64)
    assert not head_infer.head_supported((4, 8, 128, 431), 64)   # C_in
    assert not head_infer.head_supported((4, 2, 1, 431), 64)     # H < 2
    assert not head_infer.head_supported((4, 2, 128, 1), 64)     # W < 2
    assert not head_infer.head_supported((4, 2, 128, 431), 24)   # depth
    assert not head_infer.head_supported((4, 2, 128, 431), 144)  # depth
    assert not head_infer.head_supported((2, 128, 431), 64)      # rank
    assert head_infer.head_supported((4, 2, 128, 2584 * 4), 64)
    # the published train recipe's depth 100 stays unfused, as in JAX
    assert not head_infer.head_supported((4, 2, 128, 431), 100)
    for shape, depth in (((4, 128, 431, 2), 64), ((4, 128, 431, 8), 64),
                         ((4, 1, 431, 2), 64), ((4, 128, 431, 2), 24)):
        b, h, w, c = shape
        assert (head_infer.head_supported((b, c, h, w), depth)
                == jhead.head_supported(shape, depth))


NET = dict(num_conv_blocks=3, start_deep_supervision_on=1,
           conv_base_depth=16, growth_rate=1.5)  # widths 16, 24, 36


def _models(seed):
    params, stats = interop.random_jax_variables(
        **NET, n_classes=N_CLASSES, seed=seed)
    sd = interop.from_jax_variables(params, stats)
    port = {}
    for fused in (False, True):
        m = TwoDimensionalCNN(**NET, n_classes=N_CLASSES, fused_head=fused)
        m.load_state_dict(sd)
        port[fused] = m.eval()
    return port, {"params": params, "batch_stats": stats}


def _inputs(seed, w=29):
    rng = np.random.RandomState(seed)
    spec = rng.randn(3, 16, w, 1).astype(np.float32)
    fl = np.array([w, 17, 5], np.int32)
    return spec, fl


def test_fused_head_model_matches_jax(monkeypatch):
    """A float32 model with ``fused_head``: block0's head runs K8's plain
    version, whose output is bf16 values (2^-9 relative), and the rest in
    float32. Against the JAX model (whose fused head runs only on a TPU,
    so it computes the unfused head here): 5e-2 abs + 5e-2 rel of the
    logits; unfused, the port matches to 2e-4. Only block0 takes K8."""
    port, variables = _models(seed=9)
    spec, fl = _inputs(seed=10)
    want = np.asarray(JaxCNN(**NET, n_classes=N_CLASSES,
                             fused_head=True).apply(
        variables, jnp.asarray(spec), jnp.asarray(fl),
        train=False)["class_logits"])
    calls = []
    real = kernels.conv_head_fused
    monkeypatch.setattr(kernels, "conv_head_fused",
                        lambda x, w: calls.append(x.shape) or real(x, w))
    got = port[True](torch.from_numpy(spec),
                     torch.from_numpy(fl)).detach().numpy()
    assert calls == [(3, 2, 16, 29)]
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    unfused = port[False](torch.from_numpy(spec),
                          torch.from_numpy(fl)).detach().numpy()
    np.testing.assert_allclose(unfused, want, atol=2e-4, rtol=2e-4)
    # the rounding is there: the fused logits are not the float32 ones
    assert not np.allclose(got, want, atol=1e-6, rtol=0)


def test_fused_head_block_matches_jax_interpret():
    """The port's fused ConvBlock2d (K8's plain version, then the resnet
    block) against the JAX head kernel interpreted, then the JAX resnet
    block on its output: the bf16 head's rounding carried through one
    float32 resnet block, 2e-2 abs + 2e-2 rel."""
    from freesound_classification_tpu.models import blocks as jblocks

    variables, block = _head(2, 16, seed=3)
    x = np.random.RandomState(4).randn(2, 10, 13, 2).astype(np.float32)
    head = jhead.conv_block_2d_head_infer(jnp.asarray(x), variables,
                                          interpret=True)
    resnet = {k: v["resnet"] for k, v in variables.items()}
    want = np.asarray(jblocks.ResnetBlock2d(16).apply(resnet, head,
                                                      train=False))
    got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               want, atol=2e-2, rtol=2e-2)


def test_train_mode_and_small_maps_take_the_unfused_head(monkeypatch):
    """Train mode, or a map of one frame, runs the unfused head: the same
    output as a block without ``fused_head``, and no K8 call."""
    calls = []
    real = kernels.conv_head_fused
    monkeypatch.setattr(kernels, "conv_head_fused",
                        lambda x, w: calls.append(x.shape) or real(x, w))
    _, block = _head(2, 16, seed=5)
    plain = blocks.ConvBlock2d(2, 16)
    plain.load_state_dict(block.state_dict())
    plain.eval()
    x = torch.from_numpy(np.random.RandomState(6).randn(
        2, 2, 8, 1).astype(np.float32))
    torch.testing.assert_close(block(x), plain(x), atol=0, rtol=0)
    x = torch.from_numpy(np.random.RandomState(7).randn(
        2, 2, 8, 6).astype(np.float32))
    block.train()
    plain.train()
    torch.testing.assert_close(block(x), plain(x), atol=0, rtol=0)
    assert calls == []


def test_wrapper_takes_the_plain_version_on_cpu_only():
    _, block = _head(2, 16, seed=8)
    wts = resnet_infer.fused_weights(block, head_infer.fold_head_params,
                                     kernels.pack_conv_head)
    assert wts.w.shape == (32, 16) and wts.w.dtype == torch.bfloat16
    x = torch.from_numpy(np.random.RandomState(9).randn(
        2, 2, 6, 7).astype(np.float32))
    before = kernels.conv_head_fused.launches
    got = kernels.conv_head_fused(x, wts)
    assert kernels.conv_head_fused.launches == before
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 3, 3)
    torch.testing.assert_close(
        got, kernels.conv_head_fused_reference(x, wts), atol=0, rtol=0)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.conv_head_fused(x.to("meta"), wts)


def test_build_predictor_takes_fused_head(tmp_path):
    """``build_predictor(..., fused_head=True)`` routes block0 of every
    fold through the head; its probabilities agree with the unfused
    ensemble's to the bf16 tolerance of the ensemble comparisons."""
    import json

    from freesound_classification_tpu_torch.cli import predict_2d_cnn

    exp = tmp_path / "experiment"
    for k in range(2):
        fold = exp / "checkpoints" / f"fold_{k}"
        fold.mkdir(parents=True)
        params, stats = interop.random_jax_variables(
            **NET, n_classes=N_CLASSES, seed=30 + k)
        interop.save_fold_npz(str(fold / "best_model.npz"), params, stats)
    (exp / "config.json").write_text(json.dumps({
        "network": dict(NET, aggregation_type="max", output_dropout=0.0),
        "data": {"features": "mel_512_256_32", "_n_folds": 2,
                 "_n_classes": N_CLASSES}, "train": {}, "label": "t"}))
    preds = {fused: predict_2d_cnn.build_predictor(
        str(exp), torch.device("cpu"), fused_head=fused)
        for fused in (False, True)}
    assert all(m.blocks[0].fused_head for m in preds[True].models)
    wave = torch.from_numpy(np.random.RandomState(11).randn(
        3, 8000).astype(np.float32) * 0.1)
    lengths = torch.tensor([8000, 6000, 3000])
    got, want = (preds[f].predict_batch(wave, lengths) for f in (True, False))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-2, rtol=0)


@pytest.mark.parametrize("c_in", [1, 2, 3, 4])
def test_packed_operand_is_the_conv_as_a_matrix_product(c_in):
    """``pack_conv_head``'s (K, depth) operand holds row tap CP + ci of the
    bf16 kernel (CP = C_in rounded up to even), zero for the padding
    channel and past 9 CP, K = 32 for C_in <= 2 and 48 else; the im2col
    product of bn_in(x) (K in that order) by it is the plain twin's conv,
    at float32 rounding (the same bf16 products, summed in another
    order)."""
    _, block = _head(c_in, 16, seed=40 + c_in)
    fp = head_infer.fold_head_params(block)
    wts = kernels.pack_conv_head(fp)
    cp = c_in + c_in % 2
    k_rows = 32 if c_in <= 2 else 48
    assert wts.w.shape == (k_rows, 16) and wts.w.dtype == torch.bfloat16
    assert not wts.w[9 * cp:].any()
    rows = wts.w[:9 * cp].reshape(9, cp, 16)
    assert not rows[:, c_in:].any()
    torch.testing.assert_close(
        rows[:, :c_in], fp["kern"].reshape(9, c_in, 16).to(torch.bfloat16),
        atol=0, rtol=0)
    x = torch.from_numpy(np.random.RandomState(c_in).randn(
        2, c_in, 6, 9).astype(np.float32))
    xa = (x * wts.s_in.view(1, -1, 1, 1) + wts.t_in.view(1, -1, 1, 1)) \
        .to(torch.bfloat16).float()
    xp = torch.nn.functional.pad(xa, (1, 1, 1, 1, 0, cp - c_in))
    taps = [xp[:, :, dh:dh + 6, dw:dw + 9] for dh in range(3)
            for dw in range(3)]
    a = torch.stack(taps, dim=1).permute(0, 3, 4, 1, 2).reshape(
        2, 6, 9, 9 * cp)
    a = torch.nn.functional.pad(a, (0, k_rows - 9 * cp))
    got = a @ wts.w.float()
    want = torch.nn.functional.conv2d(
        xa, kernels.head_conv_weight(wts), padding=1).permute(0, 2, 3, 1)
    # each sum of <= 36 exact products, rounded in two orders
    bound = 64 * 2.0 ** -24 * (a.abs() @ wts.w.float().abs())
    assert ((got - want).abs() <= bound).all()


@pytest.mark.parametrize("shape,depth", [
    ((128, 2, 128, 431), 64), ((2, 2, 6, 7), 16), ((3, 1, 17, 65), 48),
    ((1, 4, 2, 2), 128), ((2, 3, 40, 130), 32)])
def test_head_plan_covers_every_pooled_output_once(shape, depth):
    """K8's tiles (``kernels.head_plan``), walked as the kernel walks them
    (tile t: column tile t % tiles_w, row tile (t / tiles_w) % tiles_h,
    clip t / (tiles_w tiles_h); outputs past the map are not stored), cover
    every pooled output once, and a block's shared memory fits."""
    n_batch, c_in, height, width = shape
    h_out, w_out = height // 2, width // 2
    plan = kernels.head_plan(n_batch, c_in, h_out, w_out, depth)
    th, tw = plan.tile_h, plan.tile_w
    count = np.zeros((n_batch, plan.tiles_h * th, plan.tiles_w * tw), int)
    for t in range(plan.n_tiles):
        rest = t // plan.tiles_w
        b, i, j = rest // plan.tiles_h, rest % plan.tiles_h, t % plan.tiles_w
        count[b, i * th:(i + 1) * th, j * tw:(j + 1) * tw] += 1
    assert (count[:, :h_out, :w_out] == 1).all()
    assert plan.tiles_h * th - th < h_out and plan.tiles_w * tw - tw < w_out
    assert plan.smem <= kernels._MAX_SHARED_BYTES
