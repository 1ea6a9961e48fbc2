"""The reference's first training steps: the batches the loader handed over
(each row checked against the WAV it claims to be), the augmentation from
the seeded draws, the log-mel features, the model in train mode, the mean
LSEP over the batch, the gradients, and Adam (amsgrad, coupled weight
decay) at the 1cycle schedule's rates."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import augment, frontend
from port_bench.reference.model import FP32, Net, Quant, loss_fn


def check_rows(batch: dict, wavs: list, labels: np.ndarray,
               max_samples: int) -> str:
    """'' when every row of ``batch`` is its clip: a window of at most
    ``max_samples`` of the WAV (its start where the clip is longer),
    zeros after it, its length and its labels; else what is wrong."""
    for r, idx in enumerate(batch["index"].tolist()):
        clip = wavs[idx]
        n = min(clip.size, max_samples)
        row = batch["signal"][r]
        if int(batch["lengths"][r]) != n or np.any(row[n:] != 0.0):
            return f"row {r} (clip {idx}): length or padding wrong"
        if not np.array_equal(batch["labels"][r], labels[idx]):
            return f"row {r} (clip {idx}): labels wrong"
        if clip.size <= max_samples:
            ok = np.array_equal(row[:n], clip)
        else:
            starts = np.flatnonzero(clip[: clip.size - n + 1] == row[0])
            ok = any(np.array_equal(clip[s: s + n], row[:n]) for s in starts)
        if not ok:
            return f"row {r} (clip {idx}): samples are not the clip's"
    return ""


def onecycle(step: int, min_lr: float, max_lr: float, max_steps: int
             ) -> float:
    """Linear warm-up from ``min_lr`` to ``max_lr`` over the first 30 % of
    the steps, then down towards ``min_lr / 1000``."""
    mid = max(int(round(max_steps * 0.3)), 1)
    if step < mid:
        return min_lr + (max_lr - min_lr) * step / mid
    return max_lr + (min_lr / 1e3 - max_lr) * (step - mid) / max(
        max_steps - mid, 1)


def follow(cfg: dict, batches: list, state: dict, aug_scale: float,
           engine_seed: int, dropout_masks: list, steps_per_epoch: int,
           device, q: Quant = FP32) -> dict:
    """The reference's run of ``batches`` from ``state``: each step's loss
    and its rows' losses, each leaf's first gradient norm, and each leaf's
    change after the last step, as norms (float64 numpy), with the names
    of the leaves."""
    p = {k: v.detach().clone().to(device) for k, v in state.items()}
    names = [k for k, v in p.items()
             if not k.endswith(("running_mean", "running_var"))]
    for k in names:
        p[k].requires_grad_(True)
    start = {k: p[k].detach().clone() for k in names}
    _, min_lr, max_lr = cfg["scheduler"].split("_")
    opt = torch.optim.Adam([p[k] for k in names], lr=0.0, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=cfg["weight_decay"],
                           amsgrad=True, foreach=False)
    gen = torch.Generator(device=device).manual_seed(engine_seed)
    aug = {k: cfg[k] for k in ("p_mixup", "p_aug", "p_shuffle")}
    loss_of = loss_fn(cfg["loss"])
    pool, losses, row_losses, first_grad = {}, [], [], None
    for step, batch in enumerate(batches):
        wave = torch.as_tensor(batch["signal"], device=device)
        lengths = torch.as_tensor(batch["lengths"], device=device)
        labels = torch.as_tensor(batch["labels"], device=device)
        clean = (wave, lengths, labels)
        if aug_scale > 0.0:
            partner = pool.get(tuple(wave.shape), clean)
            wave, lengths, labels = augment.augment(
                wave, lengths, labels, gen, aug, aug_scale, partner)
            pool[tuple(clean[0].shape)] = clean
        spec, frames = frontend.log_mel(wave, lengths, cfg["features"],
                                        cfg["sr"])
        logits = Net(cfg, p, train=True, q=q,
                     dropout_mask=dropout_masks[step])(spec, frames)
        rows = loss_of(logits, labels)
        loss = rows.mean()
        row_losses.append(rows.detach().double().cpu().numpy())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if first_grad is None:
            first_grad = [float(p[k].grad.double().norm()) for k in names]
        lr = onecycle(step, float(min_lr), float(max_lr),
                      steps_per_epoch * cfg["epochs"])
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        losses.append(loss.item())
    change = [float((p[k].detach() - start[k]).double().norm())
              for k in names]
    return {"names": names, "losses": np.array(losses),
            "row_losses": row_losses, "grad": np.array(first_grad),
            "change": np.array(change)}
