"""The hand-written kernels of the train step (``port_bench/kernels``: K1,
K2, K3) against their roofline: the sum over the window's calls of each
call's bound (the larger of its bytes over 3.35 TB/s and its operations
over the peak) over the sum of their device times, in %."""


def read(r):
    if r.kind != "train" or not r.cuda:
        return None
    device = sum(r.kernel_device_s.values())
    bound = sum(r.kernel_bound_s.values())
    return None if not device or not bound else 100.0 * bound / device
