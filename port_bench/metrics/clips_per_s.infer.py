"""Clips predicted in the measured window's whole ``predict_loader``
passes over its host seconds (the window runs untraced before the
profiled one), in clips/s."""


def read(r):
    if r.kind != "infer" or not r.window.clips:
        return None
    return r.window.clips / r.window.seconds
