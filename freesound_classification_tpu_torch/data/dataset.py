"""Clip dataset and CSV manifests (JAX ``data/dataset.py``).

The host keeps what decides shapes: decode, labels binarized through the
class map, and the train-time random crop of clips longer than
``max_audio_length``. Everything that changes values but not shapes runs on
the device (``ops/augment.py``).
"""

from __future__ import annotations

import csv
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from freesound_classification_tpu_torch.data import audio_io
from freesound_classification_tpu_torch.data.folds import (
    binarize_label_strings,
)


def load_classmap(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def class_names_from_classmap(classmap: dict) -> list:
    """Class names sorted by their index."""
    rev = {v: k for k, v in classmap.items()}
    return [rev[i] for i in sorted(classmap.values())]


def read_csv_columns(csv_path: str, columns: Sequence[str]) -> List[list]:
    """The named columns of a CSV file, each as a list of strings."""
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        missing = [c for c in columns if c not in (reader.fieldnames or [])]
        if missing:
            raise ValueError(f"{csv_path}: no column(s) {missing}")
        rows = list(reader)
    return [[row[c] for row in rows] for c in columns]


def read_manifest(csv_path: str,
                  data_dir: str) -> Tuple[List[str], List[str]]:
    """(fnames, paths) from a FSDKaggle2019-style CSV with a ``fname``
    column."""
    (fnames,) = read_csv_columns(csv_path, ["fname"])
    return fnames, [os.path.join(data_dir, name) for name in fnames]


class ClipDataset:
    """Map-style dataset over audio files, decoded at ``sr``, with optional
    comma-separated label strings binarized through ``classmap`` and an
    optional train-time random crop to ``max_audio_length`` seconds."""

    def __init__(
        self,
        audio_files: Sequence[str],
        raw_labels: Optional[Sequence[str]] = None,
        classmap: Optional[dict] = None,
        max_audio_length: Optional[float] = None,
        sr: int = 44100,
        seed: int = 42,
    ):
        self.audio_files = list(audio_files)
        self.sr = sr
        self.max_audio_length = max_audio_length
        self.seed = seed
        if raw_labels is not None:
            if classmap is None:
                raise ValueError("labels need a classmap")
            self.labels = binarize_label_strings(
                [str(v) for v in raw_labels], classmap)
        else:
            self.labels = None
        self.n_classes = len(classmap) if classmap else 0
        self._lengths: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.audio_files)

    @property
    def lengths(self) -> np.ndarray:
        """Per-clip sample counts at ``sr`` (capped by the crop), from the
        WAV headers only."""
        if self._lengths is None:
            lens = np.empty(len(self), dtype=np.int64)
            for i, path in enumerate(self.audio_files):
                n, file_sr = audio_io.wav_length(path)
                if file_sr != self.sr:
                    n = int(round(n * self.sr / file_sr))
                lens[i] = n
            if self.max_audio_length is not None:
                lens = np.minimum(lens, int(self.max_audio_length * self.sr))
            self._lengths = np.maximum(lens, 1)
        return self._lengths

    def decode(self, index: int, train: bool = False,
               epoch: int = 0) -> np.ndarray:
        """Clip ``index`` as float32 mono at ``sr`` (at least one sample).
        Long clips are cropped: at a random offset when training, drawn from
        a RandomState keyed on (seed, epoch, index) so the loader's threads
        share no generator, else from the start."""
        audio, file_sr = audio_io.read_wav(self.audio_files[index])
        if file_sr != self.sr:
            audio = audio_io.resample(audio, file_sr, self.sr)
        if self.max_audio_length is not None:
            max_len = int(self.max_audio_length * self.sr)
            if audio.size > max_len:
                start = 0
                if train:
                    rng = np.random.RandomState(
                        (self.seed * 1_000_003 + epoch * 9_973 + index)
                        % (2**32))
                    start = rng.randint(0, audio.size - max_len)
                audio = audio[start: start + max_len]
        if audio.size == 0:
            audio = np.zeros(1, dtype=np.float32)
        return audio

    def label(self, index: int) -> np.ndarray:
        if self.labels is None:
            return np.zeros(self.n_classes, dtype=np.float32)
        return self.labels[index]
