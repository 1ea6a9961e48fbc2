"""Bucketed batch loader with background decode (JAX ``data/loader.py``).

``BucketBatchSampler`` forms batches of same-bucket clips, each padded to its
bucket's length. Decode runs in a thread pool ahead of the device. In train
mode the batch plan is reshuffled every epoch from epoch-keyed seeds, short
batches are dropped, and long clips take a random crop keyed on
(seed, epoch, index).

Data parallel (JAX ``process_index``/``process_count``): every rank builds
the same global batch plan from the same seed and decodes only its own
contiguous slice of each batch (``_local_rows``: a tail that does not divide
is padded by repeating its last index). Each batch says how many of its rows
are real (``n_real``) and how many the global batch has (``n_global``), so
the engine can mask the padded ones.
"""

from __future__ import annotations

import math
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np

from freesound_classification_tpu_torch.data.bucketing import (
    BucketBatchSampler,
    bucket_of,
    pad_to_length,
)
from freesound_classification_tpu_torch.data.dataset import ClipDataset
from freesound_classification_tpu_torch.parallel import mesh as mesh_lib

_PREFETCH = 2  # decoded batches waiting ahead of the device


class DataLoader:
    """Iterable of batch dicts with bucket-static shapes:
    {"signal": (B, L_bucket) f32, "lengths": (B,) i32,
     "labels": (B, C) f32, "index": (B,) i64}; on rank ``process_index``
    of ``process_count`` > 1 the rows are that rank's slice of the global
    batch, and "n_real" and "n_global" (ints) count the real rows of the
    slice and of the global batch.
    """

    def __init__(self, dataset: ClipDataset, sampler: BucketBatchSampler,
                 train: bool = False, num_workers: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.sampler = sampler
        self.train = train
        self.num_workers = num_workers
        self.process_index = process_index
        self.process_count = process_count
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.sampler)

    def _local_rows(self, indices: List[int]) -> List[int]:
        """This rank's slice of a global batch's rows (JAX, copied)."""
        if self.process_count <= 1:
            return list(indices)
        indices = list(indices)
        rem = (-len(indices)) % self.process_count
        indices = indices + [indices[-1]] * rem
        per = len(indices) // self.process_count
        return indices[self.process_index * per:
                       (self.process_index + 1) * per]

    def _make_batch(self, indices: List[int], epoch: int) -> dict:
        b = bucket_of(self.sampler.lengths[indices], self.sampler.ladder)
        length = int(self.sampler.ladder[int(b.max())])
        n_global = len(indices)
        indices = self._local_rows(indices)
        signal = np.zeros((len(indices), length), dtype=np.float32)
        lengths = np.zeros(len(indices), dtype=np.int32)
        labels = np.zeros((len(indices), self.dataset.n_classes),
                          dtype=np.float32)
        for row, idx in enumerate(indices):
            audio = self.dataset.decode(idx, train=self.train, epoch=epoch)
            signal[row] = pad_to_length(audio, length)
            lengths[row] = min(audio.size, length)
            labels[row] = self.dataset.label(idx)
        batch = {"signal": signal, "lengths": lengths, "labels": labels,
                 "index": np.asarray(indices, dtype=np.int64)}
        if self.process_count > 1:
            batch["n_real"] = mesh_lib.rank_rows(
                n_global, self.process_index, self.process_count)[1]
            batch["n_global"] = n_global
        return batch

    def __iter__(self) -> Iterator[dict]:
        if self.train:
            # a fresh plan every epoch; the advanced counter keys the crops,
            # as in the JAX loader
            if self.sampler.shuffle:
                self.sampler.set_epoch(self._epoch)
            self._epoch += 1
        epoch = self._epoch
        batches = list(self.sampler)
        if self.num_workers <= 0:
            for indices in batches:
                yield self._make_batch(indices, epoch)
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                futures = [pool.submit(self._make_batch, idxs, epoch)
                           for idxs in batches]
                for fut in futures:
                    if stop.is_set():
                        fut.cancel()
                        continue
                    try:
                        out_q.put(fut.result())
                    except Exception as e:  # surfaced to the consumer
                        out_q.put(e)
                        return
            out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def make_loader(dataset: ClipDataset, ladder,
                batch_size: Optional[int] = None,
                max_batch_elems: Optional[int] = None,
                train: bool = False, shuffle: Optional[bool] = None,
                seed: int = 42, drop_last: Optional[bool] = None,
                size_multiple: int = 1,
                num_workers: int = 0,
                mesh: Optional[mesh_lib.Mesh] = None) -> DataLoader:
    """Give exactly one of ``batch_size`` and ``max_batch_elems``. A train
    loader shuffles per epoch and drops short batches; an inference loader
    yields every clip once, in bucket order. ``shuffle`` and ``drop_last``
    default to ``train``; crop TTA takes a train loader (a fresh crop every
    pass) with both off. On a rank of ``mesh`` the loader yields the rank's
    slices, and batch sizes are trimmed to a multiple of
    ``lcm(size_multiple, world size)`` where they can be (JAX
    ``make_loader``)."""
    rank, world = (mesh.rank, mesh.world_size) if mesh is not None else (0, 1)
    if world > 1:
        size_multiple = math.lcm(max(size_multiple, 1), world)
    sampler = BucketBatchSampler(
        dataset.lengths, ladder, batch_size=batch_size,
        max_batch_elems=max_batch_elems,
        shuffle=train if shuffle is None else shuffle, seed=seed,
        drop_last=train if drop_last is None else drop_last,
        size_multiple=size_multiple)
    return DataLoader(dataset, sampler, train=train, num_workers=num_workers,
                      process_index=rank, process_count=world)
