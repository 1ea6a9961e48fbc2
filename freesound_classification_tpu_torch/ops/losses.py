"""Multi-label classification losses (JAX ``ops/losses.py``).

All take logits (B, C) and binary targets (B, C); ``average=False`` returns
the per-sample vector.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pairwise_rank_terms(logits: torch.Tensor, targets: torch.Tensor):
    """differences[b, i, j] = s_j - s_i; mask[b, i, j] = 1 where
    y_j < y_i (i a positive, j a negative)."""
    differences = logits[:, None, :] - logits[:, :, None]
    where_lower = (targets[:, None, :] < targets[:, :, None]).to(logits.dtype)
    return differences, where_lower


def lsep_loss(logits: torch.Tensor, targets: torch.Tensor,
              average: bool = True) -> torch.Tensor:
    """Naive LSEP: log(1 + sum exp(s_neg - s_pos))."""
    differences, where_lower = _pairwise_rank_terms(logits, targets)
    lsep = torch.log1p((torch.exp(differences) * where_lower).sum(dim=(1, 2)))
    return lsep.mean() if average else lsep


def lsep_loss_stable(logits: torch.Tensor, targets: torch.Tensor,
                     average: bool = True) -> torch.Tensor:
    """LSEP shifted by the max over all pairwise differences (>= 0)."""
    n = logits.shape[0]
    differences, where_lower = _pairwise_rank_terms(logits, targets)
    differences = differences.reshape(n, -1)
    where_lower = where_lower.reshape(n, -1)
    max_difference = differences.amax(dim=1, keepdim=True)
    exps = torch.exp(differences - max_difference) * where_lower
    max_difference = max_difference[:, 0]
    lsep = max_difference + torch.log(
        torch.exp(-max_difference) + exps.sum(dim=-1))
    return lsep.mean() if average else lsep


def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         raw: bool = True,
                         average: bool = True) -> torch.Tensor:
    """Element-wise BCE, mean over classes per sample; ``raw`` inputs are
    logits, through the stable softplus form."""
    if raw:
        per_elem = (targets * F.softplus(-logits)
                    + (1.0 - targets) * F.softplus(logits))
    else:
        probs = logits.clamp(1e-12, 1.0 - 1e-12)
        per_elem = -(targets * torch.log(probs)
                     + (1 - targets) * torch.log(1 - probs))
    per_sample = per_elem.mean(dim=tuple(range(1, per_elem.dim())))
    return per_sample.mean() if average else per_sample


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               focus: float = 2.0, raw: bool = True,
               average: bool = True) -> torch.Tensor:
    """Focal loss, mean over classes per sample."""
    probs = torch.sigmoid(logits) if raw else logits
    prob_true = probs * targets + (1.0 - probs) * (1.0 - targets)
    prob_true = prob_true.clamp(1e-7, 1.0 - 1e-7)
    per_elem = -((1.0 - prob_true) ** focus) * torch.log(prob_true)
    per_sample = per_elem.mean(dim=tuple(range(1, per_elem.dim())))
    return per_sample.mean() if average else per_sample


LOSSES = {
    "lsep": lsep_loss_stable,
    "lsep_naive": lsep_loss,
    "bce": binary_cross_entropy,
    "focal": focal_loss,
}


def make_loss(name: str):
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(
            f"unknown loss {name!r}; options: {sorted(LOSSES)}") from None
