"""The reference's host transform API (``ops/transforms.py:20-377``; JAX
``data/transforms.py``).

``Compose`` (with ``switch_off_augmentations``), ``Identity``, ``OneOf``,
``LoadAudio``, ``MapLabels``, ``MixUp``, ``AudioAugmentation``,
``FlipAudio``, ``ShuffleAudio``, ``CutOut``, ``SampleSegment``,
``SampleLongAudio``, ``STFT``, ``AudioFeatures``, ``DropFields`` and
``RenameFields``, with the reference's constructors, so code written
against the reference runs unchanged over ``data.sound_dataset
.SoundDataset``. Each transform draws from the global ``np.random`` in the
JAX package's order, so one seed gives both packages the same samples.

``AudioAugmentation`` runs the port's effects chain on the card (K3 and
K2), one clip a call. Transforms run in the process that reads the
dataset: in a ``torch.utils.data.DataLoader`` with workers, the card needs
``multiprocessing_context="spawn"``, since a worker forked from a parent
that has used CUDA cannot use it. ``device="cpu"`` runs the chain's plain
versions on the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from freesound_classification_tpu_torch.data import audio_io, host_ops
from freesound_classification_tpu_torch.ops.dsp import parse_features
from freesound_classification_tpu_torch.utils.device import resolve_device

SAMPLE_RATE = 44100


class Augmentation:
    """Marker base class: ``Compose.switch_off_augmentations`` sets ``p`` to
    0 on every subclass (reference ``transforms.py:20-22, 362-365``)."""


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def switch_off_augmentations(self):
        for t in self.transforms:
            if isinstance(t, Augmentation):
                t.p = 0.0

    def __call__(self, dataset=None, **inputs):
        for t in self.transforms:
            inputs = t(dataset=dataset, **inputs)
        return inputs


class Identity:
    def __call__(self, dataset=None, **inputs):
        return inputs


class OneOf:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, dataset=None, **inputs):
        t = self.transforms[np.random.randint(len(self.transforms))]
        return t(dataset=dataset, **inputs)


class LoadAudio:
    def __call__(self, dataset=None, **inputs):
        audio, sr = audio_io.read_audio(inputs["filename"])
        out = dict(inputs)
        out["audio"] = audio
        out["sr"] = sr
        return out


class MapLabels:
    def __init__(self, class_map, drop_raw=True):
        self.class_map = class_map

    def __call__(self, dataset=None, **inputs):
        labels = np.zeros(len(self.class_map), dtype=np.float32)
        for c in inputs["raw_labels"]:
            labels[self.class_map[c]] = 1.0
        out = dict(inputs)
        out["labels"] = labels
        out.pop("raw_labels")
        return out


class MixUp(Augmentation):
    def __init__(self, p):
        self.p = p

    def __call__(self, dataset=None, **inputs):
        out = dict(inputs)
        if np.random.uniform() < self.p:
            partner = dataset.random_clean_sample()
            audio, labels = host_ops.mix_audio_and_labels(
                inputs["audio"], partner["audio"],
                inputs["labels"], partner["labels"])
            out["audio"] = audio
            out["labels"] = labels
        return out


class AudioAugmentation(Augmentation):
    """The sox chain of the reference (``transforms.py:84-108``) as the
    port's effects chain, on ``device``: the card by default, and the
    constructor raises where there is none."""

    def __init__(self, p, device: Optional[torch.device | str] = None):
        self.p = p
        self.device = resolve_device("cuda" if device is None else device)

    def __call__(self, dataset=None, **inputs):
        out = dict(inputs)
        if np.random.uniform() < self.p:
            out["audio"] = host_ops.apply_effects_chain(
                inputs["audio"], sr=inputs.get("sr", SAMPLE_RATE),
                device=self.device)
        return out


class FlipAudio(Augmentation):
    def __init__(self, p):
        self.p = p

    def __call__(self, dataset=None, **inputs):
        out = dict(inputs)
        if np.random.uniform() < self.p:
            out["audio"] = np.flipud(inputs["audio"])
        return out


class ShuffleAudio(Augmentation):
    def __init__(self, chunk_length=0.5, p=0.5):
        self.chunk_length = chunk_length
        self.p = p

    def __call__(self, dataset=None, **inputs):
        out = dict(inputs)
        if np.random.uniform() < self.p:
            out["audio"] = host_ops.shuffle_audio(
                out["audio"], self.chunk_length, sr=out["sr"])
        return out


class CutOut(Augmentation):
    def __init__(self, area=0.25, p=0.5):
        self.area = area
        self.p = p

    def __call__(self, dataset=None, **inputs):
        out = dict(inputs)
        if np.random.uniform() < self.p:
            out["audio"] = host_ops.cutout(out["audio"], self.area)
        return out


class SampleSegment(Augmentation):
    def __init__(self, ratio=(0.3, 0.9), p=1.0):
        self.min, self.max = ratio
        self.p = p

    def __call__(self, dataset=None, **inputs):
        out = dict(inputs)
        if np.random.uniform() < self.p:
            size = inputs["audio"].size
            target = int(np.random.uniform(self.min, self.max) * size)
            start = np.random.randint(max(size - target - 1, 1))
            out["audio"] = inputs["audio"][start: start + target]
        return out


class SampleLongAudio:
    def __init__(self, max_length):
        self.max_length = max_length

    def __call__(self, dataset=None, **inputs):
        out = dict(inputs)
        if (inputs["audio"].size / inputs["sr"]) > self.max_length:
            max_length = self.max_length * inputs["sr"]
            start = np.random.randint(0, inputs["audio"].size - max_length)
            out["audio"] = inputs["audio"][start: start + max_length]
        return out


class STFT:
    eps = 1e-4

    def __init__(self, n_fft, hop_size):
        self.n_fft = n_fft
        self.hop_size = hop_size

    def __call__(self, dataset=None, **inputs):
        s = host_ops.compute_stft(
            inputs["audio"], window_size=self.n_fft, hop_size=self.hop_size,
            eps=self.eps)
        out = dict(inputs)
        out["stft"] = np.transpose(s)
        return out


class AudioFeatures:
    """The feature descriptor (reference ``transforms.py:150-233``): parses
    "mel_*", "stft_*" or "raw", exposes ``n_features`` and
    ``padding_value``, and passes the waveform on as ``signal``; the
    features are computed on the device (``models/frontend.py``)."""

    eps = 1e-4

    def __init__(self, descriptor, verbose=False):
        self.descriptor = parse_features(descriptor)
        self.feature_type = self.descriptor.kind
        self.n_features = self.descriptor.n_features
        self.padding_value = self.descriptor.padding_value
        if verbose:
            print(f"Using {self.feature_type} features "
                  f"({self.n_features} dims)")

    def __call__(self, dataset=None, **inputs):
        out = dict(inputs)
        out["signal"] = np.expand_dims(inputs["audio"], -1)
        return out


class DropFields:
    def __init__(self, fields):
        self.to_drop = fields

    def __call__(self, dataset=None, **inputs):
        return {k: v for k, v in inputs.items() if k not in self.to_drop}


class RenameFields:
    def __init__(self, mapping):
        self.mapping = mapping

    def __call__(self, dataset=None, **inputs):
        out = dict(inputs)
        for old, new in self.mapping.items():
            out[new] = out.pop(old)
        return out
