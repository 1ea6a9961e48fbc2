"""Device ms per train step of what the engine launched inside its
``forward`` and ``backward`` ranges (the model, the loss and their
gradients)."""


def read(r):
    if r.kind != "train" or not r.cuda or not r.batches:
        return None
    sec = r.trace.by_range.get("forward", 0.0) + r.trace.by_range.get(
        "backward", 0.0)
    return None if not sec else 1e3 * sec / r.batches
