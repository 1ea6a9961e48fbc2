"""The ResNet trunk: the 7x7 stem, each BasicBlock's two 3x3 convolutions
and, where the block changes width or stride, its 1x1 downsample."""

from port_bench.flops import conv, out
from port_bench.reference.model import kind


def trunk(cfg: dict, batch: int, h: int, w: int) -> int:
    stem = cfg["widths"][0]
    h, w = out(h, 7, 2, 3), out(w, 7, 2, 3)
    total = conv(batch, h, w, stem, 3, 7)
    h, w = out(h, 3, 2, 1), out(w, 3, 2, 1)
    for _, c_in, c, stride in kind(cfg).blocks(cfg):
        h, w = out(h, 3, stride, 1), out(w, 3, stride, 1)
        total += conv(batch, h, w, c, c_in, 3) + conv(batch, h, w, c, c, 3)
        if c_in != c or stride != 1:
            total += conv(batch, h, w, c, c_in, 1)
    return total
