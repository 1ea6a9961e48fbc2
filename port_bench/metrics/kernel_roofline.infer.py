"""The hand-written kernels of inference (K1) against their roofline: the
summed bound of the window's calls over their summed device time, in %."""


def read(r):
    if r.kind != "infer" or not r.cuda:
        return None
    device = sum(r.kernel_device_s.values())
    bound = sum(r.kernel_bound_s.values())
    return None if not device or not bound else 100.0 * bound / device
