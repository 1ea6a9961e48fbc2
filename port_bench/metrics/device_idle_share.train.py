"""The share of the measured train window in which no device activity
ran, in %. The device's busy time (the union of the kernels', copies' and
sets' intervals) is read from the profiled window after it, per clip, and
scaled to the measured window's clips: the device's time is the same
traced or not, while the profiler slows the host."""


def read(r):
    if r.kind != "train" or not r.cuda or not r.trace.busy_s or not r.clips:
        return None
    busy = r.trace.busy_s * r.window.clips / r.clips
    return 100.0 * (1.0 - busy / r.window.seconds)
