"""LR schedules from descriptor strings (JAX ``ops/schedules.py``).

Each descriptor becomes a ``step -> lr`` function of the optimizer step
(0 for the first batch), evaluated in float32 as the JAX package does:

- ``steplr_<step_size>_<gamma>``: base * gamma**(epoch // step_size)
- ``1cycle_<min_lr>_<max_lr>``: linear warm-up min -> max over the first 30%
  of the steps, then linear anneal max -> min/1e3
- ``cyclic_<base>_<max>_<stepsize>[_<mode>[_<gamma>]]``: Smith's cyclical
  LR, triangular / triangular2 / exp_range
"""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
_f32 = np.float32


def onecycle_schedule(min_lr: float, max_lr: float,
                      max_steps: int) -> Schedule:
    mid = max(int(round(max_steps * 0.3)), 1)
    tail = max(max_steps - mid, 1)
    final_lr = min_lr / 1e3

    def schedule(step: int) -> float:
        step = _f32(step)
        if step < mid:
            return float(_f32(min_lr) + _f32(max_lr - min_lr)
                         * (step / _f32(mid)))
        r = (step - _f32(mid)) / _f32(tail)
        return float(_f32(max_lr) + _f32(final_lr - max_lr) * r)

    return schedule


def steplr_schedule(base_lr: float, step_size: int, gamma: float,
                    steps_per_epoch: int) -> Schedule:
    steps_per_epoch = max(steps_per_epoch, 1)

    def schedule(step: int) -> float:
        k = _f32((int(step) // steps_per_epoch) // step_size)
        return float(_f32(base_lr) * np.power(_f32(gamma), k))

    return schedule


def cyclic_schedule(base_lr: float, max_lr: float, step_size: int,
                    mode: str = "triangular",
                    gamma: float = 1.0) -> Schedule:
    if mode not in ("triangular", "triangular2", "exp_range"):
        raise ValueError(f"unknown cyclic mode {mode!r}")
    step_size_f = _f32(max(step_size, 1))

    def schedule(step: int) -> float:
        step = _f32(step)
        cycle = np.floor(_f32(1.0) + step / (_f32(2.0) * step_size_f))
        x = np.abs(step / step_size_f - _f32(2.0) * cycle + _f32(1.0))
        height = _f32(max_lr - base_lr) * np.maximum(_f32(0.0),
                                                     _f32(1.0) - x)
        if mode == "triangular":
            scale = _f32(1.0)
        elif mode == "triangular2":
            scale = _f32(1.0) / (_f32(2.0) ** (cycle - _f32(1.0)))
        else:
            scale = _f32(gamma) ** step
        return float(_f32(base_lr) + height * scale)

    return schedule


def make_schedule(descriptor: str, base_lr: float, max_steps: int,
                  steps_per_epoch: int) -> Schedule:
    """Descriptor -> ``step -> lr``. "steplr_*" scales ``base_lr`` (the --lr
    flag); "1cycle_*" and "cyclic_*" carry their own rates."""
    name, *args = descriptor.split("_")
    if name == "steplr":
        return steplr_schedule(base_lr, int(args[0]), float(args[1]),
                               steps_per_epoch)
    if name == "1cycle":
        return onecycle_schedule(float(args[0]), float(args[1]), max_steps)
    if name == "cyclic":
        mode = args[3] if len(args) > 3 else "triangular"
        gamma = float(args[4]) if len(args) > 4 else 1.0
        return cyclic_schedule(float(args[0]), float(args[1]), int(args[2]),
                               mode, gamma)
    raise ValueError(f"unknown scheduler descriptor: {descriptor!r}")
