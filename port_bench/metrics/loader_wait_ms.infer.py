"""The host's mean wait inside the loader's ``next()`` per inference batch
of ``predict_loader``, over the measured window, in ms."""


def read(r):
    if r.kind != "infer" or not r.window.waits:
        return None
    return 1e3 * sum(r.window.waits) / len(r.window.waits)
