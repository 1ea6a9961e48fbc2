"""Length-bucketed batching with a static shape ladder (JAX
``data/bucketing.py``, the port's own copy).

Clips are binned into a small ladder of lengths, batches are formed within a
bucket, and each batch is padded to its bucket's length with a validity
length vector. Masked pooling in the models makes the padding inert.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


def make_bucket_ladder(max_length: int, min_length: int = 16384,
                       growth: float = 2.0) -> List[int]:
    """Geometric ladder of waveform lengths covering [1, max_length],
    rounded up to multiples of 1024."""
    ladder = []
    length = min_length
    while length < max_length:
        ladder.append(int(length))
        length = int(length * growth)
    ladder.append(int(max_length))
    return sorted(set((x + 1023) // 1024 * 1024 for x in ladder))


def bucket_of(lengths: np.ndarray, ladder: Sequence[int]) -> np.ndarray:
    """Index of the smallest ladder entry >= each length."""
    ladder = np.asarray(ladder)
    idx = np.searchsorted(ladder, np.asarray(lengths), side="left")
    return np.minimum(idx, len(ladder) - 1)


class BucketBatchSampler:
    """Batches of same-bucket clips: a fixed ``batch_size`` per batch, or
    ``max_batch_elems`` packing (total padded samples per batch at most
    that). Batch sizes are trimmed to a multiple of ``size_multiple`` where
    the bucket holds enough clips. With ``shuffle`` the plan is rebuilt per
    epoch from ``seed + epoch``."""

    def __init__(
        self,
        lengths: Sequence[int],
        ladder: Sequence[int],
        batch_size: Optional[int] = None,
        max_batch_elems: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 42,
        drop_last: bool = False,
        size_multiple: int = 1,
    ):
        if (batch_size is None) == (max_batch_elems is None):
            raise ValueError(
                "specify exactly one of batch_size/max_batch_elems")
        self.lengths = np.asarray(lengths)
        self.ladder = list(ladder)
        self.batch_size = batch_size
        self.max_batch_elems = max_batch_elems
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.size_multiple = max(int(size_multiple), 1)
        self._epoch = 0
        self._batches = self._create_batches()

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self._batches = self._create_batches()

    def _create_batches(self) -> List[List[int]]:
        rng = np.random.RandomState(self.seed + self._epoch)
        buckets = bucket_of(self.lengths, self.ladder)
        batches: List[List[int]] = []
        for b in range(len(self.ladder)):
            ids = np.flatnonzero(buckets == b)
            if ids.size == 0:
                continue
            if self.shuffle:
                rng.shuffle(ids)
            if self.batch_size is not None:
                size = self.batch_size
            else:
                size = max(int(self.max_batch_elems // self.ladder[b]), 1)
            size = max((size // self.size_multiple) * self.size_multiple,
                       min(self.size_multiple, len(ids)))
            for k in range(0, len(ids), size):
                chunk = ids[k: k + size].tolist()
                if self.drop_last and len(chunk) < size:
                    continue
                batches.append(chunk)
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def __iter__(self) -> Iterator[List[int]]:
        return iter(self._batches)

    def __len__(self) -> int:
        return len(self._batches)


def pad_to_length(audio: np.ndarray, length: int) -> np.ndarray:
    """Zero-pad (or trim) a waveform to exactly ``length`` samples."""
    if audio.size >= length:
        return audio[:length]
    out = np.zeros(length, dtype=np.float32)
    out[: audio.size] = audio
    return out
