"""The reference's fold-ensemble prediction: each clip read from its WAV,
zero-padded to its bucket's length, the log-mel features, every fold's
model in eval mode, and the mean of the folds' sigmoids."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import frontend
from port_bench.reference.model import FP32, Net, Quant


def calibrate(cfg: dict, states: list, wavs: list, length: int,
              device) -> list:
    """Each fold's BatchNorm running statistics set to the batch statistics
    of ``wavs`` cut or padded to ``length`` samples: eval-mode activations
    of about unit scale, as a trained model has them."""
    wave = torch.zeros(len(wavs), length, device=device)
    n = torch.zeros(len(wavs), dtype=torch.int64, device=device)
    for r, clip in enumerate(wavs):
        k = min(clip.size, length)
        wave[r, :k] = torch.from_numpy(clip[:k]).to(device)
        n[r] = k
    spec, frames = frontend.log_mel(wave, n, cfg["features"], cfg["sr"])
    out = []
    for state in states:
        p = {k: v.clone() for k, v in state.items()}
        Net(cfg, p, train=False, calibrate=True)(spec, frames)
        out.append(p)
    return out


@torch.no_grad()
def predict(cfg: dict, states: list, wavs: list, ladder: list, device,
            q: Quant = FP32, block: int = 16) -> np.ndarray:
    """(n, C) fold-averaged probabilities of the clips ``wavs``, each at its
    bucket's length, in blocks of ``block`` clips of one length."""
    lengths = [frontend.bucket_length(w.size, ladder) for w in wavs]
    out = np.zeros((len(wavs), cfg["n_classes"]), dtype=np.float64)
    for length in sorted(set(lengths)):
        rows = [i for i, l in enumerate(lengths) if l == length]
        for s in range(0, len(rows), block):
            part = rows[s: s + block]
            wave = torch.zeros(len(part), length, device=device)
            n = torch.zeros(len(part), dtype=torch.int64, device=device)
            for r, i in enumerate(part):
                k = min(wavs[i].size, length)
                wave[r, :k] = torch.from_numpy(wavs[i][:k]).to(device)
                n[r] = k
            spec, frames = frontend.log_mel(wave, n, cfg["features"],
                                            cfg["sr"])
            probs = torch.stack([torch.sigmoid(Net(cfg, p, train=False, q=q)(
                spec, frames)) for p in states]).mean(dim=0)
            out[part] = probs.double().cpu().numpy()
    return out
