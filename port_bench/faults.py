"""Faults planted in the port underneath a run, for the check that
``correct`` comes out false (``tests/test_pb_faults.py``) and for the
fault readings of ``control.py``:

- ``unchanged``: a train step that leaves the state as it was (no
  optimizer update);
- ``half``: half of the batch left out, the mean taken over the rest (the
  train loss, or the inference rows: the second half's rows given the
  first half's mean);
- ``altered``: an answer altered where it is produced (the first row of
  every inference batch).

A cell on one card has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import importlib

from port_bench.harness import PORT

TRAIN = ("unchanged", "half_train")
INFER = ("half_infer", "altered")


@contextlib.contextmanager
def _patched(module: str, owner: str, attr: str, make):
    mod = importlib.import_module(f"{PORT}.{module}")
    target = getattr(mod, owner) if owner else mod
    original = getattr(target, attr)
    setattr(target, attr, make(original))
    try:
        yield
    finally:
        setattr(target, attr, original)


def _half_loss(make_loss):
    def make(name):
        fn = make_loss(name)

        def loss(logits, labels, average=True):
            per = fn(logits, labels, average=False)
            h = max(per.shape[0] // 2, 1)
            per = per.clone()
            per[h:] = per[:h].mean()
            return per.mean() if average else per
        return loss
    return make


def _half_rows(predict_batch):
    def fn(self, wave, lengths):
        probs = predict_batch(self, wave, lengths).clone()
        h = max(probs.shape[0] // 2, 1)
        probs[h:] = probs[:h].mean(dim=0)
        return probs
    return fn


def _altered(predict_batch):
    def fn(self, wave, lengths):
        probs = predict_batch(self, wave, lengths).clone()
        probs[0] = 1.0 - probs[0]
        return probs
    return fn


def planted(name: str):
    """A context in which the port runs with fault ``name``."""
    if name == "unchanged":
        return _patched("training.engine", "Engine", "_update_due",
                        lambda orig: lambda self: False)
    if name == "half_train":
        return _patched("training.engine", "", "make_loss", _half_loss)
    if name == "half_infer":
        return _patched("training.ensemble", "EnsemblePredictor",
                        "predict_batch", _half_rows)
    if name == "altered":
        return _patched("training.ensemble", "EnsemblePredictor",
                        "predict_batch", _altered)
    raise ValueError(f"unknown fault {name!r}")
