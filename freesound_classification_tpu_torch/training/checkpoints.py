"""Fold checkpoints (JAX ``training/checkpoints.py``).

The JAX package keeps orbax train states. The port saves a model's weights
and BatchNorm statistics in the JAX package's variable layout
(``interop.to_jax_variables``) as the flat ``.npz`` that the predict CLI and
``scripts/export_fold_weights.py`` already share, for either classifier
family: ``best_model.npz``, ``final_model.npz`` and ``model_on_epoch_N.npz``.
``load_model`` serves reloading a fold's best model and the finetune CLI's
warm start from another experiment. ``prune_epoch_checkpoints`` keeps the
newest periodic ``model_on_epoch_N.npz`` files of a fold.

A fold's resume point is one file, ``last_model.pt`` (the port's own
format, not read by the JAX package): the engine's whole train state and
its progress metadata in one ``torch.save`` dict, so both become visible in
one rename. JAX's bundle (``save_resume_bundle``) swaps a directory for the
same guarantee because orbax writes directories.

Every file is written durably (``interop.write_durably``: fsynced, renamed
into place, the directory fsynced), so a reader never sees half a file and
a kill leaves the previous file or the new one.

Saves are asynchronous, as JAX's: one strict-FIFO writer thread, started at
the first save, does each save's conversion, serialisation, fsync and
rename, so that the train loop goes on with the next epoch meanwhile. On
the caller's thread a save only takes its snapshot (``snapshot``): every
tensor copied into host memory of its own, a clone on the CPU and a
synchronous copy from the card, so the next optimizer step cannot reach
what is written, and the writer issues no CUDA work. Because the queue is
strictly ordered, what ``write_after_saves`` enqueues (the engines'
retention pruning) runs after every save enqueued before it is on disk, and
a resume bundle is never on disk before the best model of its epoch.
``wait_for_saves`` drains the queue and re-raises the first writer error;
every load calls it first (``load_model``, ``load_bundle`` and
``interop.load_fold_npz``), the engines call it at the end of a fit and
after a one-off ``Engine.save_model``, the train CLIs before they return,
and the interpreter at its exit. ``ASYNC_SAVES`` False (or
``async_save=False``) makes saves synchronous: the queue is drained, then
the file written on the caller's thread. The bytes are the same either way.
"""

from __future__ import annotations

import atexit
import collections
import copy
import os
import queue
import re
import threading
import time
from typing import Callable, Optional

import torch
from torch import nn

from freesound_classification_tpu_torch import interop

# the default of every save's ``async_save``
ASYNC_SAVES = True

# each save's times, the newest 64: ``{"path", "loop_ms", "write_ms"}``,
# ``loop_ms`` the caller's (the snapshot and the enqueue; a synchronous
# save's whole), ``write_ms`` the write's on whichever thread did it (None
# until it is done)
save_times: collections.deque = collections.deque(maxlen=64)

_QUEUE: Optional[queue.Queue] = None
_ERRORS: list = []
_START = threading.Lock()


def _worker_loop(q: queue.Queue) -> None:
    while True:
        fn = q.get()
        try:
            fn()
        except BaseException as e:  # surfaced by wait_for_saves()
            _ERRORS.append(e)
        finally:
            q.task_done()


def _submit(fn: Callable[[], None]) -> None:
    global _QUEUE
    with _START:
        if _QUEUE is None:
            _QUEUE = queue.Queue()
            threading.Thread(target=_worker_loop, args=(_QUEUE,),
                             daemon=True, name="ckpt-writer").start()
            atexit.register(wait_for_saves)
    _QUEUE.put(fn)


def wait_for_saves() -> None:
    """Drain the writer's queue; re-raise the first writer error."""
    if _QUEUE is not None:
        _QUEUE.join()
    if _ERRORS:
        raise _ERRORS.pop(0)


def write_after_saves(fn: Callable[[], None]) -> None:
    """Run ``fn`` on the writer after every save enqueued so far is on
    disk (strict FIFO): the engines' retention pruning."""
    _submit(fn)


def snapshot(obj):
    """``obj`` (dicts, lists and tuples of tensors and plain values) with
    each tensor copied into host memory of its own (a tensor that appears
    twice, copied once): a clone on the CPU, a synchronous copy from the
    card. Dicts keep their type and attributes (a ``state_dict``'s
    ``_metadata``), so what is written is what ``obj`` would write."""
    copies: dict = {}

    def own(x):
        if torch.is_tensor(x):
            if id(x) not in copies:
                t = x.detach()
                copies[id(x)] = (t.clone() if t.device.type == "cpu"
                                 else t.to("cpu"))
            return copies[id(x)]
        if isinstance(x, dict):
            out = copy.copy(x)
            for k, v in x.items():
                out[k] = own(v)
            return out
        if type(x) in (list, tuple):
            return type(x)(own(v) for v in x)
        return copy.deepcopy(x)

    return own(obj)


def _save(path: str, write: Callable[[], None], t0: float,
          async_save: Optional[bool]) -> None:
    """Enqueue ``write`` (or run it on this thread once the queue is
    drained) and record its times; ``t0`` is when the save began."""
    record = {"path": path, "loop_ms": None, "write_ms": None}
    save_times.append(record)

    def run() -> None:
        start = time.perf_counter()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write()
        record["write_ms"] = 1e3 * (time.perf_counter() - start)

    if ASYNC_SAVES if async_save is None else async_save:
        _submit(run)
    else:
        wait_for_saves()
        run()
    record["loop_ms"] = 1e3 * (time.perf_counter() - t0)


def save_model(path: str, model: nn.Module,
               async_save: Optional[bool] = None) -> None:
    """Write ``model``'s variables to ``path`` durably, on the writer
    (``async_save``, by default ``ASYNC_SAVES``) from a snapshot taken
    now."""
    t0 = time.perf_counter()
    path = os.path.abspath(path)
    state = snapshot(model.state_dict())
    _save(path, lambda: interop.save_fold_npz(
        path, *interop.to_jax_variables(state)), t0, async_save)


def load_model(path: str, model: nn.Module) -> None:
    """Load a ``save_model`` file into ``model`` in place, once every
    enqueued save is written."""
    sd = interop.from_jax_variables(*interop.load_fold_npz(path))
    model.load_state_dict(sd)


def save_bundle(path: str, bundle: dict,
                async_save: Optional[bool] = None) -> None:
    """Write a resume bundle (tensors, numbers, strings, lists and dicts of
    them) to ``path`` durably, in one atomic step, on the writer
    (``async_save``, by default ``ASYNC_SAVES``) from a snapshot taken
    now."""
    t0 = time.perf_counter()
    path = os.path.abspath(path)
    state = snapshot(bundle)
    _save(path, lambda: interop.write_durably(
        path, lambda f: torch.save(state, f)), t0, async_save)


def load_bundle(path: str) -> Optional[dict]:
    """The bundle at ``path`` with its tensors on the CPU, or None where
    there is none, once every enqueued save is written. Only the types
    ``save_bundle`` writes are unpickled."""
    wait_for_saves()
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


_EPOCH_FILE = re.compile(r"^model_on_epoch_(\d+)\.npz$")


def prune_epoch_checkpoints(fold_dir: str, keep: int) -> None:
    """Keep only the newest ``keep`` periodic ``model_on_epoch_N.npz``
    files in ``fold_dir``; best and final models are never touched, and
    ``keep <= 0`` keeps all (the reference's behaviour). The engines run
    it through ``write_after_saves``."""
    if keep <= 0:
        return
    found = sorted((int(m.group(1)), name) for name in os.listdir(fold_dir)
                   if (m := _EPOCH_FILE.match(name)))
    for _, name in found[:-keep]:
        os.remove(os.path.join(fold_dir, name))
