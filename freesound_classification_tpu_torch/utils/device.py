"""The port's device rule: its entry points and constructors run on the card
unless the caller asks for the CPU, and a run asked for the card never
carries on on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """``device`` ("cuda", "cuda:<n>", "cpu" or a torch.device) ->
    torch.device. A CUDA device raises when no card is usable; any other
    kind raises ValueError."""
    try:
        resolved = torch.device(device)
    except RuntimeError as err:
        raise ValueError(f"unknown device {device!r} (expected 'cuda' or "
                         "'cpu')") from err
    if resolved.type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r} (expected 'cuda' or "
                         "'cpu')")
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r}: no CUDA device is available (torch "
            f"{torch.__version__}, built for CUDA {torch.version.cuda}); "
            "pass device='cpu' to run on the CPU")
    return resolved
