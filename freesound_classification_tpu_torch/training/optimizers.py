"""Optimizers of the recipe (JAX ``training/optimizers.py``), as torch's own.

- "adam": ``torch.optim.Adam(amsgrad=True)``, weight decay coupled as L2 on
  the gradient before the moments (not AdamW);
- "momentum": ``torch.optim.SGD(momentum=0.9, nesterov=True)``, the same
  coupled weight decay.

The JAX package wrote its transforms to match these torch optimizers step
for step, so here they are the reference's own. The learning rate is set on
every step from the schedule (``set_lr``).
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """An optimizer with lr 0; the engine sets the schedule's lr before
    every step."""
    params = list(params)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay, amsgrad=True)
    if name == "momentum":
        return torch.optim.SGD(params, lr=0.0, momentum=0.9, nesterov=True,
                               weight_decay=weight_decay)
    raise ValueError(
        f"unknown optimizer {name!r}; options: ['adam', 'momentum']")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
