"""The host's mean wait inside the loader's ``next()`` per train step (the
benchmark's ``Feed`` around the port's ``DataLoader``), over the measured
window, in ms."""


def read(r):
    if r.kind != "train" or not r.window.waits:
        return None
    return 1e3 * sum(r.window.waits) / len(r.window.waits)
