"""The 2d CNN's trunk: each block's 3x3 convolution before its pool, then
its 1x1, 3x3 and 1x1 residual convolutions after it."""

from port_bench.flops import conv
from port_bench.reference.model import kind


def trunk(cfg: dict, batch: int, h: int, w: int) -> int:
    total, c_in = 0, 2
    for d in kind(cfg).depths(cfg):
        total += conv(batch, h, w, d, c_in, 3)
        h, w = (h // 2 if h >= 2 else h), (w // 2 if w >= 2 else w)
        total += conv(batch, h, w, d, d, 1) * 2 + conv(batch, h, w, d, d, 3)
        c_in = d
    return total
