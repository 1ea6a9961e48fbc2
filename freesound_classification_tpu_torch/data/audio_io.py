"""WAV file I/O with the standard library and scipy (JAX ``data/audio_io.py``,
the port's own copy of its Python path).

Conventions of ``librosa.load(sr=None, mono=True)``: integer PCM scaled by
2**(bits-1), several channels averaged to mono, float32 out. The JAX package's
optional C++ decoder is not part of the port.
"""

from __future__ import annotations

import math
import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """WAV file -> (float32 mono waveform in [-1, 1], sample rate)."""
    import scipy.io.wavfile as wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    elif data.dtype in (np.float32, np.float64):
        audio = data.astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV dtype {data.dtype} in {path}")
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    return np.ascontiguousarray(audio, dtype=np.float32), int(sr)


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """The reference's ``read_audio`` (``librosa.load(sr=None)``), on WAV
    files: ``read_wav``."""
    return read_wav(path)


def wav_length(path: str) -> Tuple[int, int]:
    """(n_frames, sample_rate) from the WAV header only."""
    with wave.open(path, "rb") as w:
        return w.getnframes(), w.getframerate()


def write_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """Float [-1, 1] mono audio -> 16-bit PCM WAV."""
    audio = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    pcm = (audio * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def resample(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy), for inputs not at ``target_sr``."""
    if sr == target_sr:
        return audio
    import scipy.signal

    g = math.gcd(sr, target_sr)
    return scipy.signal.resample_poly(
        audio, target_sr // g, sr // g).astype(np.float32)
