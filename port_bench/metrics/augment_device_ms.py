"""Device ms per train step of what the engine launched inside its
``augment`` range (the effects chain with K2 and K3, MixUp, the shuffle)."""


def read(r):
    if r.kind != "train" or not r.cuda or not r.batches:
        return None
    sec = r.trace.by_range.get("augment")
    return None if not sec else 1e3 * sec / r.batches
