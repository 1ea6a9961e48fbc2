"""The 2d blocks' convolution core (``csrc/conv_blocks.cu``) as far as the CPU
can check it: the tile plans the wrappers pass to the kernels
(``kernels.conv_plan``, ``kernels.tail_plan``: tile sizes, grid and shared
memory) at K7's stage shapes and K4/K5's block shapes; and the two
launches' plain decomposition against the blocks' plain twins, bit for bit.

Each plan case checks that the grid's tiles write every output position
and column once, that a staged weight chunk serves at least 128 positions
where the map allows it, and that the ring and the tiles fit a Hopper
block's shared memory. Which rows a tap reads, across clip boundaries and
the padding, is checked on the card (``chip_smoke.py``: shifted frames and
a plain version that pads the wrong tensor must fail by far).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.models import backbone, blocks
from freesound_classification_tpu_torch.ops import (
    backbone_infer,
    kernels,
    resnet_infer,
)

K7_HW = [(1, 1), (1, 3), (2, 2), (4, 14), (8, 27), (16, 54), (32, 108),
         (128, 431)]
K45_HW = [(1, 1), (1, 6), (2, 6), (4, 13), (64, 215), (128, 431)]


def _batch(height, width):
    """Three clips for small maps, two for the large ones."""
    return 3 if height * width <= 8 * 27 else 2


def _covered_once(starts, size, n):
    """Tiles of ``size`` from ``starts`` cover [0, n) once each."""
    count = np.zeros(max(n, max(starts) + size), int)
    for s in starts:
        count[s:s + size] += 1
    return (count[:n] == 1).all()


def _check_launch(plan, m_total, n_write):
    """Every output (row, column) of a ``conv_kernel`` launch is written
    once: the grid's row tiles cover the positions once each (rows past
    them are masked) and its column tiles cover the columns once each."""
    assert plan.grid_m * plan.bm >= m_total > (plan.grid_m - 1) * plan.bm
    assert _covered_once([i * plan.bm for i in range(plan.grid_m)], plan.bm,
                         m_total)
    assert _covered_once([j * plan.bn for j in range(plan.grid_n)], plan.bn,
                         n_write)
    assert plan.smem <= kernels._MAX_SHARED_BYTES


@pytest.mark.parametrize("c", [24, 64, 128, 256, 512])
@pytest.mark.parametrize("hw", K7_HW)
def test_k7_plans_write_every_output_once_and_fit_shared_memory(c, hw):
    """K7's two launches (conv1 into the h1 scratch of cp columns, conv2
    through the epilogue into the C columns of y) share one plan."""
    height, width = hw
    n_batch = _batch(height, width)
    cp = -(-c // 16) * 16
    m_total = n_batch * height * width
    plan = kernels.conv_plan(m_total, cp, cp)
    assert plan.bm >= 128  # a staged weight chunk serves 128 rows or more
    _check_launch(plan, m_total, cp)
    _check_launch(kernels.conv_plan(m_total, c, cp), m_total, c)
    assert kernels.conv_plan(m_total, c, cp) == plan
    assert plan.bn in (64, 128) and (plan.bn == 64) == (cp <= 64)


@pytest.mark.parametrize("c", [64, 96, 144, 216, 324, 486])
@pytest.mark.parametrize("hw", K45_HW)
def test_k45_plans_write_every_output_once_and_fit_shared_memory(c, hw):
    """K4/K5's h1 launch (1x1, positions read in place) and its tail (3x3
    on h1 into h2 in shared memory over every column chunk, then h2 w3 to
    the C columns of y), one CTA per row tile."""
    height, width = hw
    n_batch = _batch(height, width)
    cp = -(-c // 16) * 16
    m_total = n_batch * height * width
    first = kernels.conv_plan(m_total, cp, cp)
    assert first.bm >= 128
    _check_launch(first, m_total, cp)
    tail = kernels.tail_plan(m_total, cp)
    assert tail.grid_n == 1 and tail.bm in (64, 128, 256)
    _check_launch(tail._replace(bn=max(tail.bn, c)), m_total, c)
    # the tail's column loops: h2 over [0, cp), y over [0, C)
    assert _covered_once(list(range(0, cp, tail.bn)), tail.bn, cp)
    assert _covered_once(list(range(0, c, tail.bn)), tail.bn, c)
    # h2 (every row of the tile, every channel) sits beside the ring
    assert tail.smem >= (kernels._ring_bytes(tail.bm, tail.bn)
                         + tail.bm * cp * 2)


# ---------------------------------------------------------------------------
# the two launches' plain decomposition
# ---------------------------------------------------------------------------


def _scratch(h, cp):
    """(B, C, H, W) float32 h1 -> the kernels' bf16 scratch (B, H, W, cp),
    zero past C, and back: what the second launch reads."""
    rows = F.pad(h.permute(0, 2, 3, 1).to(torch.bfloat16),
                 (0, cp - h.shape[1]))
    return rows[..., :h.shape[1]].permute(0, 3, 1, 2).float()


def _random_x(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float()


@pytest.mark.parametrize("c,hw", [(16, (5, 7)), (24, (3, 11))])
def test_k7_two_launches_equal_the_plain_twin(c, hw):
    """conv1 + b1 + relu stored as bf16 h1 in the scratch layout, then
    conv2 + b2 + x + relu: bit for bit ``basic_block_fused_reference``."""
    params, stats = interop.random_jax_variables(
        n_classes=2, seed=c, model_kind="backbone_cnn", backbone="resnet18")
    block = backbone.BasicBlock(64, 64)
    pre = "trunk.stage0_block1."
    block.load_state_dict({
        k[len(pre):]: v
        for k, v in interop.from_jax_variables(params, stats).items()
        if k.startswith(pre)})
    fp = backbone_infer.fold_basic_params(block.eval())
    fp = {k: v[..., :c, :c] if v.dim() == 4 else v[:c]
          for k, v in fp.items()}
    wts = kernels.pack_basic_block(fp)
    cp = wts.bias.shape[1]
    x = _random_x((2, c, *hw), seed=c + 1)

    def conv(h, w):
        return kernels._conv3x3(h, w, c)

    b1, b2 = (wts.bias[i, :c].view(1, c, 1, 1) for i in (0, 1))
    h1 = _scratch(F.relu(conv(x, wts.w1) + b1), cp)
    y = F.relu(conv(h1, wts.w2) + b2 + x).to(torch.bfloat16)
    torch.testing.assert_close(
        y, kernels.basic_block_fused_reference(x, wts).to(torch.bfloat16),
        atol=0, rtol=0)


@pytest.mark.parametrize("c,hw", [(12, (4, 6)), (20, (2, 9))])
def test_k45_two_launches_equal_the_plain_twin(c, hw):
    """h1 = prelu(x w1 + b1) stored as bf16 in the scratch layout, then
    the tail's h2 and y: bit for bit ``resnet_block_2d_fused_reference``."""
    params, stats = interop.random_jax_variables(
        num_conv_blocks=1, start_deep_supervision_on=0, conv_base_depth=c,
        growth_rate=1.0, n_classes=2, seed=c, input_dim=3)
    block = blocks.ResnetBlock2d(c)
    pre = "blocks.0.resnet."
    block.load_state_dict({
        k[len(pre):]: v
        for k, v in interop.from_jax_variables(params, stats).items()
        if k.startswith(pre)})
    wts = resnet_infer.fused_weights(block.eval(),
                                     resnet_infer.fold_block_params)
    cp = wts.w1.shape[0]
    x = _random_x((2, c, *hw), seed=c + 2)

    def vec(v):
        return v[:c].view(1, c, 1, 1)

    def mat(w):
        return w[..., :c, :c].float()

    h1 = _scratch(F.prelu(kernels.conv1x1(x, mat(wts.w1)) + vec(wts.bias[0]),
                          wts.slope[0, :c]), cp)
    k2 = mat(wts.w2).reshape(3, 3, c, c).permute(3, 2, 0, 1)
    h2 = F.prelu(F.conv2d(h1, k2, padding=1) + vec(wts.bias[1]),
                 wts.slope[1, :c]).to(torch.bfloat16).float()
    y = F.prelu(kernels.conv1x1(h2, mat(wts.w3)) + vec(wts.bias[2]) + x,
                wts.slope[2, :c]).to(torch.bfloat16)
    torch.testing.assert_close(
        y, kernels.resnet_block_2d_fused_reference(x, wts).to(torch.bfloat16),
        atol=0, rtol=0)


@pytest.mark.parametrize("c,length,n_launches", [(12, 4300, 2),
                                                 (20, 9, 3)])
def test_k6_launches_equal_the_plain_twin(c, length, n_launches):
    """K6's launches as ``resnet_block_1d_plan`` plans them: over a long map
    two (h1 = prelu(x w1 + b1) stored as bf16 in the scratch layout, then
    the tail's h2 in shared memory and y), over a small one three (h1, then
    h2 = prelu(conv3(h1) + b2) stored as bf16 in a second scratch, then y):
    bit for bit ``resnet_block_1d_fused_reference``."""
    params, stats = interop.random_jax_variables(
        num_conv_blocks=1, start_deep_supervision_on=0, conv_base_depth=c,
        growth_rate=1.0, n_classes=2, seed=c, model_kind="hierarchical_cnn",
        input_dim=3)
    block = blocks.ResnetBlock1d(c)
    pre = "blocks.0.resnet."
    block.load_state_dict({
        k[len(pre):]: v
        for k, v in interop.from_jax_variables(params, stats).items()
        if k.startswith(pre)})
    wts = resnet_infer.fused_weights(block.eval(),
                                     resnet_infer.fold_block_params_1d)
    cp = wts.w1.shape[0]
    assert len(kernels.resnet_block_1d_plan(2 * length, c, cp)) == n_launches
    x = _random_x((2, c, length), seed=c + 3)

    def vec(v):
        return v[:c].view(1, c, 1)

    def mat(w):
        return w[..., :c, :c].float()

    def scratch(h):
        return _scratch(h.unsqueeze(2), cp).squeeze(2)

    h1 = scratch(F.prelu(kernels.conv1x1(x, mat(wts.w1)) + vec(wts.bias[0]),
                         wts.slope[0, :c]))
    h2 = F.prelu(F.conv1d(h1, mat(wts.w2).permute(2, 1, 0), padding=1)
                 + vec(wts.bias[1]), wts.slope[1, :c])
    h2 = scratch(h2) if n_launches == 3 else h2.to(torch.bfloat16).float()
    y = F.prelu(kernels.conv1x1(h2, mat(wts.w3)) + vec(wts.bias[2]) + x,
                wts.slope[2, :c]).to(torch.bfloat16)
    torch.testing.assert_close(
        y, kernels.resnet_block_1d_fused_reference(x, wts).to(torch.bfloat16),
        atol=0, rtol=0)


def test_channel_rows_read_in_place_or_padded():
    """The model's channels_last map at C % 8 == 0 is read in place; a map
    of another layout or width becomes a zero-padded (B, H, W, cp) copy."""
    x = torch.randn(2, 64, 3, 5).bfloat16().to(
        memory_format=torch.channels_last)
    rows, strides, readable = kernels._channel_rows(x, 64)
    assert rows.data_ptr() == x.data_ptr() and readable == 64
    assert strides == (64 * 15, 64 * 5, 64)
    y = torch.randn(2, 486, 3, 5).to(memory_format=torch.channels_last)
    rows, strides, readable = kernels._channel_rows(y, 496)
    assert rows.shape == (2, 3, 5, 496) and readable == 496
    assert strides == (496 * 15, 496 * 5, 496)
    torch.testing.assert_close(rows[..., :486].float(),
                               y.permute(0, 2, 3, 1).bfloat16().float())
    assert not rows[..., 486:].any()
    rows, _, readable = kernels._channel_rows(x.contiguous(), 64)
    assert rows.shape == (2, 3, 5, 64) and readable == 64
