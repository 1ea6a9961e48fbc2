"""The reference's host audio ops, in numpy (JAX ``data/host_ops.py``).

The port's train path augments on the card (``ops/augment.py``). These ops
serve the reference-compatible transform API (``data/transforms.py``): they
take one clip as a numpy array and follow the reference (``ops/audio.py``)
exactly, the MixUp window's ``=+`` quirk included. The random ones draw
from the ``rng`` passed in, or from the global ``np.random`` when none is,
in the JAX package's order, so one ``RandomState`` gives both packages the
same arrays and leaves the same stream behind.

``apply_effects_chain`` runs the port's effects chain (reverb, pitch by the
phase vocoder (K3), overdrive, speed by the resample kernel (K2)) on one
clip, on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from freesound_classification_tpu_torch.ops import augment
from freesound_classification_tpu_torch.utils.device import resolve_device


def compute_stft(audio: np.ndarray, window_size: int, hop_size: int,
                 log: bool = True, eps: float = 1e-4) -> np.ndarray:
    """|STFT| of ``scipy.signal.stft``, then ``log(s + eps)`` (reference
    ``ops/audio.py:10-19``; JAX ``dsp.compute_stft_host``). The reference
    passes its ``hop_size`` as scipy's ``noverlap``, so the hop is
    ``window_size - hop_size``; kept as it is."""
    import scipy.signal

    _, _, s = scipy.signal.stft(audio, nperseg=window_size,
                                noverlap=hop_size)
    s = np.abs(s)
    if log:
        s = np.log(s + eps)
    return s


def trim_audio(audio: np.ndarray, top_db: float = 60.0,
               frame_length: int = 2048, hop_length: int = 512) -> np.ndarray:
    """Trim leading and trailing silence (reference ``ops/audio.py:22-24``,
    ``librosa.effects.trim(top_db=60)``): frames whose RMS is more than
    ``top_db`` below the clip's loudest are cut from both ends."""
    if audio.size == 0:
        return audio
    n_frames = max(1 + (audio.size - frame_length) // hop_length, 1)
    rms = np.empty(n_frames)
    for i in range(n_frames):
        seg = audio[i * hop_length: i * hop_length + frame_length]
        rms[i] = np.sqrt(np.mean(seg**2) + 1e-20)
    db = 20.0 * np.log10(rms + 1e-20)
    idx = np.flatnonzero(db > (db.max() - top_db))
    if idx.size == 0:
        return audio[:0]
    start = idx[0] * hop_length
    end = min(idx[-1] * hop_length + frame_length, audio.size)
    return audio[start:end]


def mix_audio_and_labels(first_audio, second_audio, first_labels,
                         second_labels, rng=None, quirk_replace: bool = True):
    """MixUp-OR (reference ``ops/audio.py:32-52``): the labels' clipped
    sum; the shorter clip goes into a random window of the longer, which is
    scaled by a ~ U(0.4, 0.6). ``quirk_replace`` replaces the window by
    ``shorter * (1 - a)`` (the reference's ``=+``), else adds it. Equal
    lengths give the plain average."""
    rng = rng or np.random
    new_labels = np.clip(first_labels + second_labels, 0, 1)
    a = rng.uniform(0.4, 0.6)

    shorter, longer = first_audio, second_audio
    if shorter.size == longer.size:
        return (shorter + longer) / 2, new_labels
    if first_audio.size > second_audio.size:
        shorter, longer = longer, shorter

    start = rng.randint(0, longer.size - shorter.size)
    end = start + shorter.size
    out = longer * a
    if quirk_replace:
        out[start:end] = shorter * (1 - a)
    else:
        out[start:end] += shorter * (1 - a)
    return out, new_labels


def gen_even_slices_sizes(size: int, n: int) -> np.ndarray:
    """sklearn ``gen_even_slices``' chunk sizes: the first ``size % n``
    chunks one longer."""
    base, rem = divmod(size, n)
    return np.array([base + (i < rem) for i in range(n)])


def shuffle_audio(audio: np.ndarray, chunk_length: float = 0.5,
                  sr: int = 44100, rng=None) -> np.ndarray:
    """Permute ~``chunk_length`` s chunks (reference
    ``ops/audio.py:55-67``)."""
    rng = rng or np.random
    n_chunks = int((audio.size / sr) / chunk_length)
    if n_chunks in (0, 1):
        return audio
    sizes = gen_even_slices_sizes(audio.size, n_chunks)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    order = rng.permutation(n_chunks)
    return np.concatenate(
        [audio[starts[i]: starts[i] + sizes[i]] for i in order])


def cutout(audio: np.ndarray, area: float = 0.25, rng=None) -> np.ndarray:
    """Zero a window of ``area`` x the size from a random start (reference
    ``ops/audio.py:70-79``; the window may clip at the clip's end)."""
    rng = rng or np.random
    width = int(audio.size * area)
    start = rng.randint(0, audio.size)
    audio = audio.copy()
    audio[start: start + width] = 0
    return audio


def effects_buffer(n: int) -> int:
    """The chain's buffer for an ``n``-sample clip (JAX
    ``host_ops.apply_effects_chain``): the next power of two of 1.25 n, at
    least 4096, so a slowdown's longer output fits. It is not cosmetic:
    the phase vocoder's ``n_fft`` reads the buffer's length."""
    return 1 << max(math.ceil(math.log2(max(n * 1.25, 4096))), 12)


def effects_chain_with(audio: np.ndarray, reverberance, room, cents, gain,
                       speed, sr: int = 44100,
                       device: torch.device | str = "cuda") -> np.ndarray:
    """The port's effects chain (``augment.apply_effects``) on one clip with
    the given parameters (numbers, or (1,) tensors on ``device``),
    zero-padded to ``effects_buffer``: the valid region of the result,
    float32, which the speed change makes shorter or longer than the
    clip."""
    device = resolve_device(device)
    n = int(audio.size)
    wave = torch.zeros(1, effects_buffer(n), device=device)
    wave[0, :n] = torch.as_tensor(np.asarray(audio, np.float32),
                                  device=device)
    lengths = torch.tensor([n], dtype=torch.int32, device=device)
    draws = augment.EffectsDraws(
        torch.arange(1, device=device),
        *(torch.as_tensor(v, dtype=torch.float32, device=device).reshape(1)
          for v in (reverberance, room, cents, gain, speed)))
    out, new_len = augment.apply_effects(wave, lengths, draws, sr=sr)
    return out[0, : int(new_len[0])].cpu().numpy()


def apply_effects_chain(audio: np.ndarray, sr: int = 44100, rng=None,
                        device: Optional[torch.device | str] = None
                        ) -> np.ndarray:
    """The effects chain on one clip, on ``device`` (the card by default;
    it raises where there is none). As in JAX, one seed in [0, 2^31 - 1)
    is drawn from ``rng`` (or the global ``np.random``), so the numpy
    stream moves as JAX's does; it seeds a ``torch.Generator`` on the
    device, whose ``augment.draw_effects`` draws the parameters. The two
    packages' draws from one seed differ (jax.random against torch)."""
    device = resolve_device("cuda" if device is None else device)
    rng = rng or np.random
    seed = int(rng.randint(0, 2**31 - 1))
    gen = torch.Generator(device=device).manual_seed(seed)
    d = augment.draw_effects(gen, 1, 1.0)
    return effects_chain_with(audio, d.reverberance, d.room, d.cents,
                              d.gain, d.speed, sr=sr, device=device)
