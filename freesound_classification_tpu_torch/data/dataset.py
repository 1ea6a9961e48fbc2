"""Clip dataset and CSV manifests (JAX ``data/dataset.py``, inference part).

The JAX module binarizes labels through ``data/folds.py``, which imports
sklearn, so the port keeps its own copy of what prediction needs: the class
map, the test manifest read with the ``csv`` module, and decode through the
reused numpy-only ``data/audio_io.py``. Labels and the train-time random crop
arrive with the train path (ROADMAP slice 2).
"""

from __future__ import annotations

import csv
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from freesound_classification_tpu.data import audio_io


def load_classmap(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def class_names_from_classmap(classmap: dict) -> list:
    """Class names sorted by their index."""
    rev = {v: k for k, v in classmap.items()}
    return [rev[i] for i in sorted(classmap.values())]


def read_manifest(csv_path: str,
                  data_dir: str) -> Tuple[List[str], List[str]]:
    """(fnames, paths) from a FSDKaggle2019-style CSV with a ``fname``
    column."""
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None or "fname" not in reader.fieldnames:
            raise ValueError(f"{csv_path}: no 'fname' column")
        fnames = [row["fname"] for row in reader]
    return fnames, [os.path.join(data_dir, name) for name in fnames]


class ClipDataset:
    """Map-style dataset over audio files, decoded at ``sr``."""

    def __init__(self, audio_files: Sequence[str], sr: int = 44100):
        self.audio_files = list(audio_files)
        self.sr = sr
        self._lengths: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.audio_files)

    @property
    def lengths(self) -> np.ndarray:
        """Per-clip sample counts at ``sr``, from the WAV headers only."""
        if self._lengths is None:
            lens = np.empty(len(self), dtype=np.int64)
            for i, path in enumerate(self.audio_files):
                n, file_sr = audio_io.wav_length(path)
                if file_sr != self.sr:
                    n = int(round(n * self.sr / file_sr))
                lens[i] = n
            self._lengths = np.maximum(lens, 1)
        return self._lengths

    def decode(self, index: int) -> np.ndarray:
        """Clip ``index`` as float32 mono at ``sr`` (at least one sample)."""
        audio, file_sr = audio_io.read_wav(self.audio_files[index])
        if file_sr != self.sr:
            audio = audio_io.resample(audio, file_sr, self.sr)
        if audio.size == 0:
            audio = np.zeros(1, dtype=np.float32)
        return audio
