"""The general traffic generator: clip lengths, clip audio and labels from a
traffic file's parameters.

The audio of a mix is a corpus of 16-bit 44.1 kHz WAVs drawn once from the
mix's ``corpus_seed`` and written to a fixed directory inside the checkout
(``build/port_bench/corpus/<key>``, git-ignored), so only the first run of a
checkout writes it. A run's ``--seed`` then draws everything else: which
file is which dataset row, the labels, the loader's shuffles and crops, the
weights and every random draw of the program. So every seed has the same
set of lengths in another order, and a run writes nothing to disk.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from port_bench.spec import ROOT

SR = 44100


def clip_seconds(lengths: dict, n: int, seed: int) -> np.ndarray:
    """``n`` clip durations in seconds: lognormal(``mu``, ``sigma``) clipped
    to [``min_s``, ``max_s``]."""
    if lengths["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {lengths['dist']!r}")
    rng = np.random.default_rng([seed, 1])
    secs = rng.lognormal(lengths["mu"], lengths["sigma"], size=n)
    return np.clip(secs, lengths["min_s"], lengths["max_s"])


def clip_audio(index: int, n: int, seed: int, sr: int = SR) -> np.ndarray:
    """Clip-like int16 audio: two or three tones under slow amplitude
    envelopes, a decaying click train and a little noise."""
    import scipy.signal

    rng = np.random.default_rng([seed, 2, index])
    t = np.arange(n, dtype=np.float32) / np.float32(sr)
    x = np.zeros(n, dtype=np.float32)
    for _ in range(int(rng.integers(2, 4))):
        f, fm = np.exp(rng.uniform(np.log(80.0), np.log(8000.0))), \
            rng.uniform(0.2, 4.0)
        env = 0.5 + 0.5 * np.sin(np.float32(2 * np.pi * fm) * t
                                 + np.float32(rng.uniform(0, 6.28)))
        x += np.float32(rng.uniform(0.03, 0.2)) * env * np.sin(
            np.float32(2 * np.pi * f) * t + np.float32(rng.uniform(0, 6.28)))
    period = int(rng.integers(sr // 8, sr))
    clicks = np.zeros(n, dtype=np.float32)
    clicks[::period] = np.float32(rng.uniform(0.2, 0.6))
    x += scipy.signal.lfilter([1.0], [1.0, -np.exp(-1.0 / 300.0)],
                              clicks).astype(np.float32)
    x += np.float32(rng.uniform(0.002, 0.02)) * rng.standard_normal(
        n, dtype=np.float32)
    return np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)


def write_wav(path: str, pcm: np.ndarray, sr: int = SR) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def corpus_key(lengths: dict, n: int, seed: int) -> str:
    blob = json.dumps({"lengths": lengths, "n": n, "seed": seed, "sr": SR,
                       "version": 1}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def corpus(lengths: dict, n: int, seed: int, root: Path = ROOT,
           threads: int = 8) -> tuple:
    """(paths, sample counts) of the mix's ``n`` WAVs, written once under
    the checkout's ``build/port_bench/corpus/`` (into a temporary name,
    renamed into place when whole)."""
    samples = (clip_seconds(lengths, n, seed) * SR).astype(np.int64)
    samples = np.maximum(samples, 1)
    base = root / "build" / "port_bench" / "corpus"
    final = base / corpus_key(lengths, n, seed)
    paths = [str(final / f"{i:05d}.wav") for i in range(n)]
    if not final.is_dir():
        tmp = base / f"{final.name}.part"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)

        def one(i: int) -> None:
            write_wav(str(tmp / f"{i:05d}.wav"),
                      clip_audio(i, int(samples[i]), seed))

        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(one, range(n)))
        os.replace(tmp, final)
    return paths, samples


def label_strings(n: int, n_classes: int, per_clip: list,
                  rng: np.random.Generator) -> list:
    """Comma-joined class names ``c00``... of 1 to ``len(per_clip)``
    distinct classes a clip, the count drawn with probabilities
    ``per_clip``."""
    counts = rng.choice(np.arange(1, len(per_clip) + 1), size=n, p=per_clip)
    return [",".join(f"c{c:02d}" for c in sorted(
        rng.choice(n_classes, size=k, replace=False))) for k in counts]


def classmap(n_classes: int) -> dict:
    return {f"c{c:02d}": c for c in range(n_classes)}
