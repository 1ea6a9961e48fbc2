"""The eval forwards' model FLOPs of every fold (``port_bench.flops``, at
the batch shapes the loader handed over) per second of the measured window, which runs untraced
before the profiled one, as a share of the H100's 989 TFLOP/s dense bf16,
in %."""

from port_bench.harness import PEAK_BF16


def read(r):
    if r.kind != "infer" or not r.cuda or not r.window.flops:
        return None
    return 100.0 * r.window.flops / (r.window.seconds * PEAK_BF16)
