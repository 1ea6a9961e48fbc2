"""Building blocks of the 2d and the 1d CNN, NCHW and (B, C, T), in eval and
train mode.

Counterparts of ``freesound_classification_tpu/models/blocks.py``. The JAX
package is channels-last; inside the port's models tensors are NCHW (an NHWC
input permuted to NCHW is already in PyTorch's channels_last memory format,
which cuDNN keeps through the convolutions) and (B, C, T) for ``nn.Conv1d``.
``fused_infer=True`` runs eval-mode resnet blocks through the folded, fused
kernels (``ops/resnet_infer.py``: K6 in 1d, K4/K5 in 2d), and
``fused_head=True`` the 2d block0 head through K8 (``ops/head_infer.py``);
training, init and the checkpoint layout are the same either way. Parameters stay float32 and are
cast to the activations' dtype at use, as flax does for a ``dtype=bfloat16``
module. BatchNorm follows flax's: batch statistics in float32 when training,
and running statistics updated with the biased batch variance.

``phase_conv_pool_2d``/``_1d`` of the JAX package are XLA rewrites of conv3 +
max-pool that give the same result, so the port runs the convolution and
the max-pool.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from freesound_classification_tpu_torch.ops import head_infer, resnet_infer
from freesound_classification_tpu_torch.parallel import mesh as mesh_lib

NEG_INF = -1e30
BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in float64 where it is float64 (flax promotes
    statistics and outputs to at least float32)."""
    return x if x.dtype == torch.float64 else x.float()


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(C,) -> broadcastable over dim 1 of ``x``, in ``x``'s dtype."""
    return v.to(x.dtype).view(1, -1, *([1] * (x.dim() - 2)))


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with eps 1e-5: flax's ``nn.BatchNorm(momentum=
    0.9)`` as the JAX blocks use it.

    Eval: the affine of the running statistics, folded in float32 and
    applied in the input's dtype. Train: the batch mean and variance over
    every dim but 1, in float32 for a float32 or narrower input and in
    float64 for a float64 one (flax promotes to at least float32), with
    flax's fast variance ``max(E[x^2] - E[x]^2, 0)``; the output is
    computed in that dtype and cast back. The running statistics move by 0.1 towards the batch's,
    with the *biased* variance as flax does; ``F.batch_norm`` would use the
    unbiased one (n/(n-1) times larger, 20/19 for the head's 20 rows).

    With ``group``, a process group (the data-parallel ``Engine`` sets it),
    the train-mode statistics are the global batch's, as JAX's jit over a
    sharded batch takes them: each rank sums x and x^2 per channel and
    counts its elements in the statistics' dtype, the three go through one
    all-reduce that gradients flow through, and the running statistics, the
    same on every rank, move by the global mean and variance.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            scale = self.weight * torch.rsqrt(self.running_var + BN_EPS)
            shift = self.bias - self.running_mean * scale
            return x * _per_channel(scale, x) + _per_channel(shift, x)
        xf = at_least_float32(x)
        dims = [d for d in range(x.dim()) if d != 1]
        if self.group is None:
            mean = xf.mean(dim=dims)
            mean2 = (xf * xf).mean(dim=dims)
        else:
            # (3, C): the sums of x and x^2 and the element count, a row
            # each, so the backward takes no per-slice copies
            c = x.shape[1]
            total = mesh_lib.all_reduce_sum(torch.stack([
                xf.sum(dim=dims), (xf * xf).sum(dim=dims),
                xf.new_full((c,), xf.numel() // c)]), self.group)
            mean, mean2, _ = total / total[2:].detach()
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(
                mean.detach(), alpha=1.0 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(
                var.detach(), alpha=1.0 - BN_MOMENTUM)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - _per_channel(mean, xf)) * _per_channel(mul, xf)
        return (y + _per_channel(self.bias, xf)).to(x.dtype)


class PReLU(nn.Module):
    """Per-channel PReLU over dim 1, init 0.25."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` whose float32 parameters run in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 parameters run in the input's dtype; with
    ``bias=False`` (the backbone's convolutions) there is no bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """``nn.Linear`` whose float32 parameters run in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class _ResnetBlock(nn.Module):
    """1x1 -> 3 (pad 1) -> 1x1 conv residual block, BN+PReLU after each."""

    conv = Conv2d

    def __init__(self, depth: int, fused_infer: bool = False):
        super().__init__()
        self.fused_infer = fused_infer
        self.conv1 = self.conv(depth, depth, 1)
        self.bn1 = BatchNorm(depth)
        self.prelu1 = PReLU(depth)
        self.conv2 = self.conv(depth, depth, 3, padding=1)
        self.bn2 = BatchNorm(depth)
        self.prelu2 = PReLU(depth)
        self.conv3 = self.conv(depth, depth, 1)
        self.bn3 = BatchNorm(depth)
        self.prelu3 = PReLU(depth)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.prelu1(self.bn1(self.conv1(x)))
        h = self.prelu2(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return self.prelu3(h + x)


class ResnetBlock1d(_ResnetBlock):
    """The block over (B, C, T) (JAX ``blocks.ResnetBlock1d``). With
    ``fused_infer``, eval-mode forwards run K6."""

    conv = Conv1d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_infer and not self.training:
            return resnet_infer.resnet_block_1d_infer(x, self)
        return super().forward(x)


class ResnetBlock2d(_ResnetBlock):
    """The block over NCHW (JAX ``blocks.ResnetBlock2d``). With
    ``fused_infer``, eval-mode forwards run K4/K5, as the JAX block routes
    to its transposed-layout kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_infer and not self.training:
            return resnet_infer.resnet_block_2d_infer(x, self, use_kernel=True)
        return super().forward(x)


class ConvBlock1d(nn.Module):
    """BN -> conv3 (pad 1) -> max-pool 2 -> BN -> PReLU -> ResnetBlock1d
    (JAX ``blocks.ConvBlock1d``). Halves T; a time axis of size 1 pools with
    window 1, where ``max_pool1d`` with window 2 would raise. With
    ``fused_infer``, eval-mode forwards keep the map's channels contiguous
    for K6."""

    def __init__(self, in_channels: int, depth: int,
                 fused_infer: bool = False):
        super().__init__()
        self.bn_in = BatchNorm(in_channels)
        self.conv = Conv1d(in_channels, depth, 3, padding=1)
        self.bn_out = BatchNorm(depth)
        self.prelu = PReLU(depth)
        self.resnet = ResnetBlock1d(depth, fused_infer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.resnet.fused_infer and not self.training:
            h = self._head_channels_contiguous(self.bn_in(x))
        else:
            h = self.conv(self.bn_in(x))
            if x.shape[2] >= 2:
                h = F.max_pool1d(h, 2)
        h = self.prelu(self.bn_out(h))
        return self.resnet(h)

    def _head_channels_contiguous(self, x: torch.Tensor) -> torch.Tensor:
        """conv and pool over (B, C, 1, T) in channels_last memory: the map
        K6 is handed keeps its channels contiguous (the JAX package's
        (B, T, C)), which K6 reads in place, where ``conv1d`` would make its
        input contiguous and return a time-major map that K6 copies."""
        x4 = x.unsqueeze(2).contiguous(memory_format=torch.channels_last)
        h = F.conv2d(x4, self.conv.weight.to(x.dtype).unsqueeze(2),
                     self.conv.bias.to(x.dtype), padding=(0, 1))
        if x.shape[2] >= 2:
            h = F.max_pool2d(h, (1, 2))
        return h.squeeze(2)


class ConvBlock2d(nn.Module):
    """BN -> conv3x3 -> max-pool 2x2 -> BN -> PReLU -> ResnetBlock2d
    (JAX ``blocks.ConvBlock2d``). Halves H and W; an axis of size 1 pools
    with window 1, where ``max_pool2d`` with window 2 would raise.

    With ``fused_head``, an eval-mode forward over a map of at least 2 x 2
    that ``head_infer.head_supported`` accepts (block0's 2-channel input)
    runs the head, BN -> conv -> pool -> BN -> PReLU, through K8, whose
    output is bf16 values in x's dtype (the model's); then the resnet
    block."""

    def __init__(self, in_channels: int, depth: int,
                 fused_infer: bool = False, fused_head: bool = False):
        super().__init__()
        self.fused_head = fused_head
        self.bn_in = BatchNorm(in_channels)
        self.conv = Conv2d(in_channels, depth, 3, padding=1)
        self.bn_out = BatchNorm(depth)
        self.prelu = PReLU(depth)
        self.resnet = ResnetBlock2d(depth, fused_infer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.fused_head and not self.training
                and head_infer.head_supported(x.shape,
                                              self.conv.out_channels)):
            return self.resnet(
                head_infer.conv_block_2d_head_infer(x, self))
        window = (2 if x.shape[2] >= 2 else 1, 2 if x.shape[3] >= 2 else 1)
        h = self.conv(self.bn_in(x))
        if window != (1, 1):
            h = F.max_pool2d(h, window)
        h = self.prelu(self.bn_out(h))
        return self.resnet(h)


def time_mask(lengths: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B,) valid frame counts -> (B, n_frames) bool mask."""
    t = torch.arange(n_frames, device=lengths.device)
    return t[None, :] < lengths[:, None]


def loss_terms(parts, group=None) -> list:
    """A self-supervised model's ``loss_parts``, each (masked sum, valid
    count), as its loss terms: each sum over its count (at least 1), the
    counts summed over ``group``'s ranks where one is given, which makes
    each term JAX's frame-masked mean over the global batch."""
    nums, counts = zip(*parts)
    counts = torch.stack(counts)
    if group is not None:
        counts = mesh_lib.all_reduce_sum_(counts.detach().clone(), group)
    return [num / count.clamp(min=1.0) for num, count in zip(nums, counts)]


def mask_time(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero the padded time frames (dim 2) of a (B, C, T) map, so bucket
    padding stays the zero of the convolutions' own padding however deep
    the receptive field."""
    return h * time_mask(lengths, h.shape[2])[:, None, :].to(h.dtype)


def masked_max_pool_time(h: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Global max over the valid frames of a (B, C, T) map -> (B, C)."""
    mask = time_mask(lengths, h.shape[2])[:, None, :]
    return torch.where(mask, h, NEG_INF).amax(dim=2)


def mask_time_2d(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero the padded time frames (dim 3) of an NCHW feature map, so bucket
    padding stays the same constant however deep the receptive field."""
    return h * time_mask(lengths, h.shape[3])[:, None, None, :].to(h.dtype)


def masked_max_pool_2d(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Global max over (H, W) of an NCHW map with W (time) masked -> (B, C)."""
    mask = time_mask(lengths, h.shape[3])[:, None, None, :]
    return torch.where(mask, h, NEG_INF).amax(dim=(2, 3))


def masked_mean_time(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean over the valid frames of a (B, C, T) map -> (B, C) (JAX
    ``blocks.masked_mean_time``, there over (B, T, C)); a row of no valid
    frame gives 0."""
    mask = time_mask(lengths, h.shape[2])[:, None, :].to(h.dtype)
    return (h * mask).sum(dim=2) / mask.sum(dim=2).clamp(min=1.0)


class ConvLockedDropout(nn.Module):
    """Per-channel dropout of a (B, C, T) map, one mask entry per row and
    channel shared across time (JAX ``blocks.ConvLockedDropout``, there
    over (B, T, C); reference ``networks/classifiers.py:21-34``). In train
    mode a channel of a row is kept with probability 1 - ``dropout_rate``
    and zeroed otherwise; kept values are not rescaled, as in JAX. The
    mask draws from ``generator`` (PyTorch's default one where None);
    ``keep``, a (B, C, 1) mask, replaces the draw."""

    def __init__(self, dropout_rate: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.generator = generator

    def forward(self, x: torch.Tensor,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        if not self.training or not self.dropout_rate:
            return x
        if keep is None:
            keep = torch.bernoulli(
                torch.full((x.shape[0], x.shape[1], 1),
                           1.0 - self.dropout_rate, device=x.device),
                generator=self.generator)
        return x * keep.to(x.dtype)


class MLPHead(nn.Module):
    """BN -> Linear -> BN -> PReLU -> Dropout -> Linear(n_classes) (JAX
    ``blocks.MLPHead``). Dropout zeroes with probability ``dropout`` and
    scales the kept values by 1/(1 - dropout) in train mode, as flax's."""

    def __init__(self, width: int, n_classes: int, dropout: float = 0.0):
        super().__init__()
        self.bn1 = BatchNorm(width)
        self.fc1 = Linear(width, width)
        self.bn2 = BatchNorm(width)
        self.prelu = PReLU(width)
        self.dropout = dropout
        self.fc2 = Linear(width, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.prelu(self.bn2(self.fc1(self.bn1(x))))
        h = F.dropout(h, self.dropout, training=self.training)
        return self.fc2(h)


LN_EPS = 1e-6  # flax's nn.LayerNorm default


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last dim: eps 1e-6, statistics and
    output in float32 (float64 for a float64 input), cast back to the
    input's dtype; ``affine=False`` is
    flax's ``use_scale=False, use_bias=False``."""

    def __init__(self, width: int, affine: bool = True):
        super().__init__()
        self.width = width
        if affine:
            self.weight = nn.Parameter(torch.ones(width))
            self.bias = nn.Parameter(torch.zeros(width))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = at_least_float32(x)
        return F.layer_norm(xf, (self.width,), self.weight, self.bias,
                            LN_EPS).to(x.dtype)


def _uniform_like_torch_rnn(cell: nn.Module) -> None:
    """torch's RNN default: every parameter U(-1/sqrt(H), 1/sqrt(H)), until
    ``init_like_flax`` or a checkpoint replaces it."""
    bound = cell.hidden ** -0.5
    with torch.no_grad():
        for p in cell.parameters():
            p.uniform_(-bound, bound)


class GRUCell(nn.Module):
    """The parameters of flax's ``nn.GRUCell``: input projections with
    biases (``weight_ih`` (3H, C), ``bias_ih``) and recurrent ones with
    only the candidate's bias (``weight_hh`` (3H, H), ``bias_hn`` (H,)),
    gates stacked r, z, n as in torch's GRU. So the cell is flax's
    function exactly; torch's ``bias_hh`` is ``[0, 0, bias_hn]``."""

    def __init__(self, input_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden, input_dim))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden))
        self.bias_hn = nn.Parameter(torch.zeros(hidden))
        _uniform_like_torch_rnn(self)

    def bias_hh(self) -> torch.Tensor:
        return torch.cat([self.bias_hn.new_zeros(2 * self.hidden),
                          self.bias_hn])

    def weights(self, dtype: torch.dtype) -> list:
        """[w_ih, w_hh, b_ih, b_hh] in ``dtype``, torch's GRU layout,
        contiguous as cuDNN's weight buffer needs them (a state_dict may
        hold transposed views)."""
        return [t.to(dtype).contiguous() for t in (
            self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh())]


def gru_sequence(x: torch.Tensor, cell: GRUCell) -> torch.Tensor:
    """A forward GRU from a zero state over (B, T, C) -> outputs (B, T, H),
    as one ``torch._VF.gru`` call (cuDNN on the card) with the cell's
    float32 weights cast to x's dtype. cuDNN keeps what its backward needs
    only in train mode, so the call trains wherever gradients are on; its
    inference mode takes only a contiguous input."""
    x = x.contiguous()
    h0 = x.new_zeros(1, x.shape[0], cell.hidden)
    out, _ = torch._VF.gru(x, h0, cell.weights(x.dtype), True, 1, 0.0,
                           torch.is_grad_enabled(), False, True)
    return out


def flip_within_lengths(x: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row of (B, T, ...) within its own length, the padding
    kept at the end (flax's ``flip_sequences``): position t takes
    ``(lengths - 1 - t) mod T``. One gather, no host sync."""
    t = x.shape[1]
    idx = (torch.arange(t - 1, -1, -1, device=x.device)[None, :]
           + lengths[:, None]) % t
    return torch.gather(
        x, 1, idx.view(*idx.shape, *([1] * (x.dim() - 2))).expand_as(x))


def at_lengths(out: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(..., B, T, H) outputs -> (..., B, H) at each row's last valid step."""
    idx = (lengths - 1).view(-1, 1, 1).expand(-1, 1, out.shape[-1])
    idx = idx.expand(*out.shape[:-3], *idx.shape)
    return torch.gather(out, -2, idx).squeeze(-2)


def _gru_scan(gi: torch.Tensor, w_hh: torch.Tensor,
              b_hh: torch.Tensor) -> torch.Tensor:
    """D GRUs at once, step by step: gi (D, B, T, 3H) input projections
    (with their biases), w_hh (D, 3H, H), b_hh (D, 3H) -> outputs
    (D, B, T, H) from zero states. Matrix products and elementwise ops
    only, so ``torch.func.vmap`` batches it."""
    d, b, t, h3 = gi.shape
    hid = h3 // 3
    h = gi.new_zeros(d, b, hid)
    w_t = w_hh.transpose(1, 2)
    outs = []
    for step in range(t):
        gh = torch.baddbmm(b_hh[:, None, :], h, w_t)
        g = gi[:, :, step]
        r, z = torch.sigmoid(g[..., :2 * hid] + gh[..., :2 * hid]).chunk(
            2, dim=-1)
        n = torch.tanh(g[..., 2 * hid:] + r * gh[..., 2 * hid:])
        h = n + z * (h - n)
        outs.append(h)
    return torch.stack(outs, dim=2)


class LSTMCell(nn.Module):
    """The parameters of flax's ``nn.OptimizedLSTMCell``: input projections
    without bias (``weight_ih`` (4H, C)) and recurrent ones with
    (``weight_hh`` (4H, H), ``bias_hh``), gates stacked i, f, g, o as in
    torch's LSTM, whose ``bias_ih`` is then 0."""

    def __init__(self, input_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, input_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))
        _uniform_like_torch_rnn(self)

    def weights(self, dtype: torch.dtype) -> list:
        """[w_ih, w_hh, b_ih, b_hh] in ``dtype``, torch's LSTM layout,
        contiguous as ``GRUCell.weights``'."""
        return [t.to(dtype).contiguous() for t in (
            self.weight_ih, self.weight_hh, torch.zeros_like(self.bias_hh),
            self.bias_hh)]


def lstm_sequence(x: torch.Tensor, cells) -> torch.Tensor:
    """A stack of forward LSTMs from zero states over (B, T, C) -> the
    last layer's outputs (B, T, H), as one ``torch._VF.lstm`` call (cuDNN
    on the card), weights cast to x's dtype as in ``gru_sequence``."""
    x = x.contiguous()
    h0 = x.new_zeros(len(cells), x.shape[0], cells[0].hidden)
    weights = [w for cell in cells for w in cell.weights(x.dtype)]
    out, _, _ = torch._VF.lstm(x, (h0, h0), weights, True, len(cells), 0.0,
                               torch.is_grad_enabled(), False, True)
    return out


class MaskedBiGRU(nn.Module):
    """LayerNorm -> a forward and a backward GRU over (B, T, C) with
    per-row valid lengths -> (B, 2H), both directions' final states (JAX
    ``blocks.MaskedBiGRU``, flax ``nn.RNN`` with ``seq_lengths``).

    The forward state is the forward GRU's output at ``lengths - 1``; the
    backward one runs its weights forward over each row reversed within
    its own length (``flip_within_lengths``) and takes the same position,
    so bucket padding reaches neither state.

    ``route`` "fused" runs each direction as one ``torch._VF.gru`` call
    (cuDNN on the card), which ``torch.func.vmap`` cannot batch; "scan"
    runs both directions together as one matrix product for every frame's
    input projections and a per-step recurrence of matrix products and
    elementwise ops, which it can (``training/multifold.FoldStack`` selects
    it). Both compute the same function."""

    def __init__(self, input_dim: int, hidden: int = 128):
        super().__init__()
        self.route = "fused"
        self.ln = LayerNorm(input_dim)
        self.GRUCell_0 = GRUCell(input_dim, hidden)  # forward (flax names)
        self.GRUCell_1 = GRUCell(input_dim, hidden)  # backward

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        x = self.ln(x)
        x_b = flip_within_lengths(x, lengths)
        if self.route == "fused":
            outs = torch.stack([gru_sequence(x, self.GRUCell_0),
                                gru_sequence(x_b, self.GRUCell_1)])
        elif self.route == "scan":
            outs = self._scan(torch.stack([x, x_b]))
        else:
            raise ValueError(f"unknown GRU route {self.route!r}")
        last = at_lengths(outs, lengths)  # (2, B, H)
        return torch.cat([last[0], last[1]], dim=-1)

    def _scan(self, xs: torch.Tensor) -> torch.Tensor:
        cells = (self.GRUCell_0, self.GRUCell_1)
        w_ih, w_hh, b_ih, b_hh = (torch.stack(ts) for ts in zip(
            *(c.weights(xs.dtype) for c in cells)))
        d, b, t, c = xs.shape
        gi = torch.baddbmm(b_ih[:, None, :], xs.reshape(d, b * t, c),
                           w_ih.transpose(1, 2))
        return _gru_scan(gi.view(d, b, t, -1), w_hh, b_hh)


def block_depths(num_conv_blocks: int, conv_base_depth: int,
                 growth_rate: float) -> Sequence[int]:
    """Per-stage channel widths: int(growth_rate**k * conv_base_depth)."""
    return [int(growth_rate**k * conv_base_depth)
            for k in range(num_conv_blocks)]


def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize ``model`` in place as flax initializes the JAX model:
    conv and dense kernels LeCun-normal (normal truncated at 2 std, scaled
    to variance 1/fan_in), biases 0, BatchNorm scale 1 / bias 0 / mean 0 /
    var 1, LayerNorm scale 1 / bias 0, PReLU 0.25, and the GRU and LSTM
    cells as flax's. The draws come from ``generator``."""
    # std of a unit normal truncated to [-2, 2], which flax divides out
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                w = module.weight
                fan_in = w[0].numel()
                std = fan_in ** -0.5 / trunc_std
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
            elif isinstance(module, PReLU):
                module.weight.fill_(0.25)
            elif isinstance(module, LayerNorm) and module.weight is not None:
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, (GRUCell, LSTMCell)):
                # flax's cells: LeCun-normal input kernels, orthogonal
                # recurrent kernels (each gate's own), zero biases
                w = module.weight_ih
                std = w.shape[1] ** -0.5 / trunc_std
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                for gate in module.weight_hh.split(module.hidden):
                    nn.init.orthogonal_(gate, generator=generator)
                for name, p in module.named_parameters():
                    if name.startswith("bias"):
                        p.zero_()
