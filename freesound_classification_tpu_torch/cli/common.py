"""Shared CLI plumbing of the port (JAX ``cli/common.py``, predict part)."""

from __future__ import annotations

from typing import Optional

import torch

from freesound_classification_tpu.data import bucketing

SR = 44100


def default_ladder(max_audio_length: Optional[float], sr: int = SR):
    """Bucket ladder covering up to max_audio_length (or ~30 s full clips)."""
    max_len = int((max_audio_length or 30) * sr)
    return bucketing.make_bucket_ladder(max_len, min_length=sr // 2)


def resolve_device(name: str) -> torch.device:
    """``--device`` -> torch.device. "cuda" without a usable GPU raises: a
    run asked for the card never carries on on the CPU."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda: no CUDA device is available "
                f"(torch {torch.__version__}, built for CUDA "
                f"{torch.version.cuda})")
        return torch.device("cuda")
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r} (expected 'cuda' or 'cpu')")
