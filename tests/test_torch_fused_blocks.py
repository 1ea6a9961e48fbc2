"""The port's fused eval resnet blocks against the JAX package, on the CPU:
the BatchNorm fold, the plain versions of K6 (1d) and K4/K5 (2d) against the
JAX Pallas kernels in interpret mode and against the unfused flax blocks,
``fused_infer`` at model level, and the wrappers' routing and K6's launch
plans on the convolution core.

Block weights are made with numpy from a seed in the JAX package's layout
(``interop.random_jax_variables``: BatchNorm statistics and PReLU slopes
away from their defaults) and handed to both packages; inputs are bf16
values, so both sides round the same x.

Tolerance of a kernel comparison: the plain version and the Pallas kernel
compute the same bf16 x bf16 products with float32 sums, in another order,
and round h1, h2 and y to bf16 at the same points. Where two float32 sums
straddle a bf16 rounding boundary, one element of h1 or h2 flips by one
bf16 step, which moves the output by far less than a step; an output
element itself may flip by one step. So the outputs agree to one bf16 step
of the largest output (2^-7 of it), and at most 2% of the elements differ.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from freesound_classification_tpu.models import blocks as jblocks
from freesound_classification_tpu.models.classifiers import (
    HierarchicalCNN as JaxHier,
    TwoDimensionalCNN as JaxCNN,
)
from freesound_classification_tpu.ops import pallas_resnet as jres2d
from freesound_classification_tpu.ops import pallas_resnet1d as jres1d
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.models import blocks
from freesound_classification_tpu_torch.models.classifiers import (
    HierarchicalCNN,
    TwoDimensionalCNN,
)
from freesound_classification_tpu_torch.ops import kernels, resnet_infer

N_CLASSES = 5
FLIP_SHARE = 0.02  # the share of output elements one bf16 step may flip


def _block_variables(kind, c, seed):
    """One resnet block's JAX variables {"params", "batch_stats"} and the
    port's block (eval) with the same weights."""
    params, stats = interop.random_jax_variables(
        num_conv_blocks=1, start_deep_supervision_on=0, conv_base_depth=c,
        growth_rate=1.0, n_classes=2, seed=seed, model_kind=kind,
        input_dim=3)
    variables = {"params": params["block0"]["resnet"],
                 "batch_stats": stats["block0"]["resnet"]}
    pre = "blocks.0.resnet."
    sd = {k[len(pre):]: v
          for k, v in interop.from_jax_variables(params, stats).items()
          if k.startswith(pre)}
    block = (blocks.ResnetBlock1d(c) if kind == "hierarchical_cnn"
             else blocks.ResnetBlock2d(c))
    block.load_state_dict(sd)
    return variables, block.eval()


def _bf16_values(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def _assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    step = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=step, rtol=0)
    assert (got != want).mean() <= FLIP_SHARE


# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,c", [("hierarchical_cnn", 12),
                                    ("2d_cnn", 20)])
def test_fold_matches_jax(kind, c):
    """The same float32 formula, scale / sqrt(var + eps): 1e-7."""
    variables, block = _block_variables(kind, c, seed=1)
    if kind == "hierarchical_cnn":
        want = jres1d.fold_block_params_1d(variables)
        got = resnet_infer.fold_block_params_1d(block)
    else:
        want = jres2d.fold_block_params(variables)
        got = resnet_infer.fold_block_params(block)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-7, rtol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# the plain versions against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,t", [(8, 37), (12, 7), (20, 1)])
def test_k6_plain_matches_jax_kernel(c, t):
    variables, block = _block_variables("hierarchical_cnn", c, seed=c + t)
    x = _bf16_values((3, t, c), seed=t)
    want = jres1d.resnet_block_1d_infer_pallas(
        jnp.asarray(x), jres1d.fold_block_params_1d(variables),
        interpret=True)
    wts = resnet_infer.fused_weights(block,
                                     resnet_infer.fold_block_params_1d)
    got = kernels.resnet_block_1d_fused_reference(
        torch.from_numpy(x).transpose(1, 2), wts).transpose(1, 2)
    _assert_bf16_close(got.numpy(), want)


@pytest.mark.parametrize("c,h,w", [(8, 5, 9), (12, 3, 17), (20, 1, 1)])
def test_k5_plain_matches_jax_kernel(c, h, w):
    variables, block = _block_variables("2d_cnn", c, seed=c + h)
    x = _bf16_values((2, h, w, c), seed=w)
    want = jres2d.resnet_block_2d_infer_pallas_t(
        jnp.asarray(x), jres2d.fold_block_params(variables), interpret=True)
    wts = resnet_infer.fused_weights(block, resnet_infer.fold_block_params)
    got = kernels.resnet_block_2d_fused_reference(
        torch.from_numpy(x).permute(0, 3, 1, 2), wts).permute(0, 2, 3, 1)
    _assert_bf16_close(got.numpy(), want)


def _k4_jax(x, fp):
    """The v1 kernel as ``resnet_block_2d_infer(use_pallas_kernel="v1")``
    prepares and calls it (pallas_resnet.py:493-525), interpreted."""
    bsz, h, w, c = x.shape
    wp, hp = w + 2, h + 2
    xp = jnp.pad(jnp.asarray(x, jnp.bfloat16),
                 ((0, 0), (1, 1), (1, 1), (0, 0)))
    x_flat = xp.reshape(bsz, hp * wp, c)
    r_pad = -(-(hp * wp) // 16) * 16
    c_pad = -(-c // 128) * 128
    x_flat = jnp.pad(x_flat, ((0, 0), (0, r_pad - hp * wp), (0, c_pad - c)))
    idx = np.arange(r_pad)
    hh, ww = idx // wp, idx % wp
    mask = (((hh >= 1) & (hh <= h) & (ww >= 1) & (ww <= w)
             & (idx < hp * wp)).astype(np.float32))[:, None]

    def padw(m):
        return jnp.pad(m, ((0, c_pad - m.shape[0]), (0, c_pad - m.shape[1])))

    def padv(v):
        return jnp.pad(v, (0, c_pad - v.shape[0]))

    w2p = jnp.pad(fp["w2"], ((0, 0), (0, c_pad - c), (0, c_pad - c)))
    out = jres2d._fused_pallas(
        x_flat, jnp.asarray(mask), padw(fp["w1"]), w2p, padw(fp["w3"]),
        padv(fp["b1"]), padv(fp["b2"]), padv(fp["b3"]),
        padv(fp["a1"]), padv(fp["a2"]), padv(fp["a3"]),
        h=h, w=w, interpret=True)
    return out.reshape(bsz, h, wp, c_pad)[:, :, :w, :c]


@pytest.mark.parametrize("c,h,w", [(8, 4, 6), (12, 2, 9)])
def test_k4_plain_matches_jax_kernel(c, h, w):
    variables, block = _block_variables("2d_cnn", c, seed=40 + c)
    x = _bf16_values((2, h, w, c), seed=h)
    want = _k4_jax(x, jres2d.fold_block_params(variables))
    wts = resnet_infer.fused_weights(block, resnet_infer.fold_block_params)
    got = kernels.resnet_block_2d_fused_reference(
        torch.from_numpy(x).permute(0, 3, 1, 2), wts).permute(0, 2, 3, 1)
    _assert_bf16_close(got.numpy(), np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# against the unfused blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,c,shape", [
    ("hierarchical_cnn", 12, (3, 11)), ("hierarchical_cnn", 8, (2, 1)),
    ("2d_cnn", 12, (2, 5, 7)), ("2d_cnn", 20, (1, 1, 3))])
def test_plain_fused_matches_unfused_flax_block(kind, c, shape):
    """The JAX package's own tolerance for its kernels against the flax
    block (tests/test_pallas_resnet*.py): 0.06 abs + 0.05 rel."""
    variables, block = _block_variables(kind, c, seed=c)
    x = _bf16_values((*shape, c), seed=3)
    one_d = kind == "hierarchical_cnn"
    jblock = (jblocks.ResnetBlock1d(c) if one_d else jblocks.ResnetBlock2d(c))
    want = np.asarray(jblock.apply(variables, jnp.asarray(x), train=False))
    xt = torch.from_numpy(x)
    xt = xt.transpose(1, 2) if one_d else xt.permute(0, 3, 1, 2)
    if one_d:
        got = resnet_infer.resnet_block_1d_infer(xt, block).transpose(1, 2)
    else:
        got = resnet_infer.resnet_block_2d_infer(
            xt, block, use_kernel=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=0.06, rtol=0.05)
    # the folded twin computes in x's dtype, float32 here: JAX's 2e-4
    folded = (resnet_infer.resnet_block_1d_infer(xt, block, use_kernel=False)
              .transpose(1, 2) if one_d else
              resnet_infer.resnet_block_2d_infer(xt, block, use_kernel=False)
              .permute(0, 2, 3, 1))
    np.testing.assert_allclose(folded.numpy(), want, atol=2e-4, rtol=1e-3)


def test_v1_and_v2_route_to_the_same_kernel():
    _, block = _block_variables("2d_cnn", 12, seed=7)
    x = torch.from_numpy(_bf16_values((2, 12, 4, 5), seed=8))
    v2 = resnet_infer.resnet_block_2d_infer(x, block, use_kernel=True)
    v1 = resnet_infer.resnet_block_2d_infer(x, block, use_kernel="v1")
    torch.testing.assert_close(v1, v2, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# fused_infer at model level
# ---------------------------------------------------------------------------

NET = dict(num_conv_blocks=3, start_deep_supervision_on=1,
           conv_base_depth=8, growth_rate=1.5)  # widths 8, 12, 18


def _models(kind, seed):
    params, stats = interop.random_jax_variables(
        **NET, n_classes=N_CLASSES, seed=seed, model_kind=kind, input_dim=16)
    sd = interop.from_jax_variables(params, stats)
    port = {}
    for fused in (False, True):
        if kind == "hierarchical_cnn":
            m = HierarchicalCNN(16, **NET, n_classes=N_CLASSES,
                                fused_infer=fused)
        else:
            m = TwoDimensionalCNN(**NET, n_classes=N_CLASSES,
                                  fused_infer=fused)
        m.load_state_dict(sd)
        port[fused] = m.eval()
    jax_cls = JaxHier if kind == "hierarchical_cnn" else JaxCNN
    jmodel = jax_cls(**NET, n_classes=N_CLASSES, fused_infer=True)
    return port, jmodel, {"params": params, "batch_stats": stats}


def _model_inputs(kind, seed):
    rng = np.random.RandomState(seed)
    shape = (3, 29, 16) if kind == "hierarchical_cnn" else (3, 16, 29, 1)
    x = rng.randn(*shape).astype(np.float32)
    fl = np.array([29, 17, 5], np.int32)
    return x, fl


@pytest.mark.parametrize("kind", ["hierarchical_cnn", "2d_cnn"])
def test_fused_infer_model_matches_jax(kind):
    """A float32 model with ``fused_infer``: the JAX model runs its folded
    float32 twin off the TPU, the port the kernel's plain version, which
    rounds x, the folded weights, h1, h2 and y to bf16 (2^-9 relative
    each). Five such roundings per block over three blocks of activations
    of order 1, through the head, stay within 5e-2 abs + 5e-2 rel of the
    logits; unfused, the port matches JAX to 2e-4."""
    port, jmodel, variables = _models(kind, seed=9)
    x, fl = _model_inputs(kind, seed=10)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                   jnp.asarray(fl), train=False)
                      ["class_logits"])
    got = port[True](torch.from_numpy(x), torch.from_numpy(fl))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-2,
                               rtol=5e-2)
    unfused = port[False](torch.from_numpy(x), torch.from_numpy(fl))
    np.testing.assert_allclose(unfused.detach().numpy(), want, atol=2e-4,
                               rtol=2e-4)
    # the rounding is there: the fused logits are not the float32 ones
    assert not np.allclose(got.detach().numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["hierarchical_cnn", "2d_cnn"])
def test_train_mode_ignores_fused_infer(kind):
    """In train mode a fused model is the unfused model: the same logits
    (batch statistics) and the same running statistics after the call."""
    port, _, _ = _models(kind, seed=11)
    x, fl = _model_inputs(kind, seed=12)
    outs = []
    before = kernels.resnet_block_1d_fused.launches
    for fused in (False, True):
        model = port[fused].train()
        outs.append((model(torch.from_numpy(x), torch.from_numpy(fl)),
                     model.blocks[1].resnet.bn2.running_var.clone()))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=0, rtol=0)
    torch.testing.assert_close(outs[1][1], outs[0][1], atol=0, rtol=0)
    assert kernels.resnet_block_1d_fused.launches == before


def test_fused_weights_follow_changed_parameters():
    """The cached kernel weights of a block are rebuilt once its
    parameters or statistics change (a warm start, a train step)."""
    _, block = _block_variables("hierarchical_cnn", 8, seed=13)
    fold = resnet_infer.fold_block_params_1d
    first = resnet_infer.fused_weights(block, fold)
    assert resnet_infer.fused_weights(block, fold) is first
    with torch.no_grad():
        block.bn1.running_var.mul_(2.0)
    second = resnet_infer.fused_weights(block, fold)
    assert second is not first
    assert not torch.equal(second.w1, first.w1)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def test_wrappers_take_the_plain_version_on_cpu_only():
    _, block = _block_variables("hierarchical_cnn", 12, seed=14)
    wts = resnet_infer.fused_weights(block,
                                     resnet_infer.fold_block_params_1d)
    x = torch.from_numpy(_bf16_values((2, 12, 9), seed=15))
    before = kernels.resnet_block_1d_fused.launches
    got = kernels.resnet_block_1d_fused(x, wts)
    assert kernels.resnet_block_1d_fused.launches == before
    torch.testing.assert_close(
        got, kernels.resnet_block_1d_fused_reference(x, wts), atol=0, rtol=0)
    assert got.dtype == torch.float32 and got.shape == x.shape
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.resnet_block_1d_fused(x.to("meta"), wts)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.resnet_block_2d_fused(
            torch.empty(1, 12, 2, 2, device="meta"), wts)


def _written_once(plan, m_total, n_write):
    """A ``conv_kernel`` launch's row tiles cover the positions once each
    (rows past them are masked) and its column tiles cover the columns once
    each."""
    assert plan.grid_m * plan.bm >= m_total > (plan.grid_m - 1) * plan.bm
    assert plan.grid_n * plan.bn >= n_write > (plan.grid_n - 1) * plan.bn
    assert plan.smem <= kernels._MAX_SHARED_BYTES


@pytest.mark.parametrize("c", [64, 96, 144, 216, 324, 486])
@pytest.mark.parametrize("hw", [(1, 1), (1, 6), (2, 6), (4, 13),
                                (64, 215), (128, 431)])
def test_tiles_cover_every_tap_and_fit_shared_memory(c, hw):
    """K6's launches on the convolution core
    (``kernels.resnet_block_1d_plan``) over the hierarchical path's 128
    clips of hw[1] frames: every output row and column of each launch is
    written once and its tiles fit a Hopper block's shared memory. Two
    launches (h1, then K4/K5's tail with the three 1d taps) where the
    tail's grid fills the 132 SMs; else three (h1, h2, y), each of whose
    grids fills the card wherever the smallest tile allows. Which frames a
    tap reads, across clip boundaries, is checked on the card
    (``chip_smoke.py``: shifted frames and x padded instead of h1 must fail
    by far)."""
    cp = -(-c // 16) * 16
    m_total = 128 * hw[1]
    plan = kernels.resnet_block_1d_plan(m_total, c, cp)
    tail = kernels.tail_plan(m_total, cp)
    if tail.grid_m >= kernels.H100_SMS:
        first, second = plan
        assert first == kernels.conv_plan(m_total, cp, cp) and second == tail
        _written_once(first, m_total, cp)
        # the tail: one CTA per row tile, h2 over [0, cp) and y over [0, C)
        # in its column loops, h2 of every row and channel beside the ring
        assert tail.grid_n == 1
        _written_once(tail._replace(bn=max(tail.bn, c)), m_total, c)
        assert tail.smem >= (kernels._ring_bytes(tail.bm, tail.bn)
                             + tail.bm * cp * 2)
        return
    assert len(plan) == 3
    for launch, n_write in zip(plan, (cp, cp, c)):
        _written_once(launch, m_total, n_write)
        assert (launch.bm, launch.bn) in kernels._SMALL_MAP_TILES
        most = -(-m_total // 32) * -(-n_write // 64)  # the 32 x 64 tile's
        assert launch.grid_m * launch.grid_n >= min(kernels.H100_SMS, most)
