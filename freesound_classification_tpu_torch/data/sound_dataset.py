"""The reference's map-style dataset (``datasets/sound_dataset.py:14-59``;
JAX ``data/sound_dataset.py``).

It feeds the reference-compatible transform API (``data/transforms.py``),
so code written against the reference's ``SoundDataset`` runs unchanged,
MixUp's partner draw (``random_clean_sample``, from the stdlib ``random``)
included. The port's own train path uses ``data/dataset.ClipDataset`` and
augments on the card.
"""

from __future__ import annotations

import random

import numpy as np


class SoundDataset:
    def __init__(self, audio_files, labels=None, transform=None,
                 is_noisy=None, clean_transform=None):
        self.transform = transform
        self.clean_transform = clean_transform
        self.audio_files = audio_files
        self.labels = labels
        self.is_noisy = (
            is_noisy if is_noisy is not None
            else np.zeros(len(self.audio_files))
        )

    def _raw_sample(self, index):
        sample = dict(
            filename=self.audio_files[index],
            is_noisy=self.is_noisy[index],
        )
        if self.labels is not None:
            sample["raw_labels"] = self.labels[index]
        return sample

    def __getitem__(self, index):
        sample = self._raw_sample(index)
        if self.transform is not None:
            sample = self.transform(dataset=self, **sample)
        return sample

    def random_clean_sample(self):
        sample = self._raw_sample(random.randint(0, len(self) - 1))
        if self.clean_transform is not None:
            sample = self.clean_transform(dataset=self, **sample)
        return sample

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __len__(self):
        return len(self.audio_files)
