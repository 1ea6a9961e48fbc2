"""K2, ``kernels.resample_linear`` (``csrc/resample.cu``): the effects
chain's playback-rate change, a two-tap lerp at ``i * factor`` a row,
zero where that position is at or past the row's valid length.

Work these inputs need: each row's source samples up to the last tap an
output loads (1 + the floor of its largest loading position), read once;
the whole (B, L) output written once; the factors and lengths; 6
operations an output that loads taps."""

import torch

TARGET = ("freesound_classification_tpu_torch.ops.kernels",
          "resample_linear")
DEVICE_NAMES = ("resample_kernel",)
PEAK_OPS = 67e12


def capture(args, kwargs, out):
    wave, factor = args[:2]
    lengths = args[2] if len(args) > 2 else kwargs.get("lengths")
    return {"shape": tuple(wave.shape), "factor": factor, "lengths": lengths}


def work(call):
    rows, length = call["shape"]
    factor = call["factor"].float()
    pos = torch.arange(length, dtype=torch.float32,
                       device=factor.device)[None] * factor[:, None]
    limit = (call["lengths"].float()[:, None] if call["lengths"] is not None
             else torch.full_like(factor[:, None], float(length)))
    loads = pos < limit
    last = torch.where(loads, pos, -1.0).amax(dim=1)
    read = torch.clamp(torch.floor(last).long() + 2, 0, length)
    extra = factor.numel() + (0 if call["lengths"] is None
                              else call["lengths"].numel())
    n_bytes = 4 * (int(read.sum()) + rows * length + extra)
    return 6 * int(loads.sum()), n_bytes
