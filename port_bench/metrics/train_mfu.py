"""The train steps' model FLOPs (``port_bench.flops``: convolutions and
matrix products of forward and backward, at the batch shapes the loader
handed over) per second of the measured window, which runs untraced
before the profiled one, as a share of the H100's 989 TFLOP/s dense bf16,
in %."""

from port_bench.harness import PEAK_BF16


def read(r):
    if r.kind != "train" or not r.cuda or not r.window.flops:
        return None
    return 100.0 * r.window.flops / (r.window.seconds * PEAK_BF16)
