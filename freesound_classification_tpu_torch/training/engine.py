"""The training engine of the classifiers (JAX ``training/engine.py``).

One train step (``Engine.train_step``), as the JAX package's jitted step:
augment the batch on the device (the effects chain runs K2 and K3), then
the log-mel frontend (K1), the forward in train mode, the loss over the
batch's rows, the backward, the optimizer step at the schedule's learning
rate, and the batch's lwlrap. The step runs eagerly; augmentation and the
frontend take no gradient.

Around it, as the JAX engine: the epoch switch-off of augmentation
(``switch_off_augmentations_on``; scale 0 skips the augmenter), the MixUp
partner pool (the previous clean batch of the same bucket shape), full-set
validation lwlrap, ``fit_validate`` saving ``best_model.npz`` per fold and
``model_on_epoch_{epoch}.npz`` every ``_save_every`` epochs (the newest
``_keep_checkpoints`` kept; 0 keeps all), the warm start of the finetune CLI
(``warm_start_path``: every fold's fit starts from that ``best_model.npz``'s
weights and BatchNorm statistics, with a fresh optimizer and step count),
and with ``profile_dir`` a ``torch.profiler`` trace of epoch 1 (the first
after the warm-up epoch 0) into that directory. While it traces, each
step's stages are named ranges in the trace (``augment``, ``frontend``,
``forward``, ``backward``, ``optimizer``); untraced steps open none.

Not ported yet, and refused with the ROADMAP item named: gradient
accumulation, resume bundles, tensorboard summaries, fold-parallel and
multi-device training.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops import metrics as metrics_lib
from freesound_classification_tpu_torch.ops.losses import make_loss
from freesound_classification_tpu_torch.ops.schedules import make_schedule
from freesound_classification_tpu_torch.training import checkpoints
from freesound_classification_tpu_torch.training.optimizers import (
    make_optimizer,
    set_lr,
)
from freesound_classification_tpu_torch.utils.device import resolve_device
from freesound_classification_tpu_torch.utils.profiling import (
    StepTimer,
    annotate,
    maybe_trace,
)


def _no_range(name: str) -> contextlib.nullcontext:
    del name
    return contextlib.nullcontext()


class Engine:
    """Trains and evaluates one model on one device.

    ``train_config`` has optimizer, learning_rate, scheduler, weight_decay,
    accumulation_steps and switch_off_augmentations_on (an experiment's
    ``config.train``). ``augment`` is ``ops.augment.make_augmenter``'s
    function or None. ``seed`` seeds the generator of every random draw of
    the augmenter; dropout draws from PyTorch's default generator.
    ``warm_start_path``, a fold ``.npz`` of the same architecture, seeds
    the model at the start of every ``fit_validate``. ``profile_dir``, where
    set, receives a trace of each fit's epoch 1. ``device`` is the card
    unless the caller passes "cpu"; without a card it raises.
    """

    def __init__(self, model: nn.Module, frontend: Frontend, train_config,
                 loss: str = "lsep_naive",
                 augment: Optional[Callable] = None,
                 checkpoint_dir: Optional[str] = None, seed: int = 42,
                 device: torch.device | str = "cuda",
                 warm_start_path: Optional[str] = None,
                 profile_dir: Optional[str] = None):
        accum = int(getattr(train_config, "accumulation_steps", 1))
        if accum > 1:
            raise NotImplementedError(
                f"accumulation_steps={accum}: gradient accumulation is not "
                "ported yet (ROADMAP M2.2)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.frontend = frontend
        self.train_config = train_config
        self.loss_fn = make_loss(loss)
        self.augment = augment
        self.checkpoint_dir = checkpoint_dir
        self.warm_start_path = warm_start_path
        self.profile_dir = profile_dir
        self._stage = _no_range  # ``annotate`` while an epoch is traced
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.schedule = None
        self.global_step = 0
        self._mixup_pool: dict = {}
        self.epoch_stats: list = []  # train_epoch's dicts of the last fit

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def make_optimizer(self, max_steps: int, steps_per_epoch: int) -> None:
        cfg = self.train_config
        self.schedule = make_schedule(cfg.scheduler, cfg.learning_rate,
                                      max_steps, steps_per_epoch)
        self.optimizer = make_optimizer(cfg.optimizer,
                                        self.model.parameters(),
                                        cfg.weight_decay)

    def to_device(self, batch: dict) -> tuple:
        return tuple(torch.as_tensor(batch[k], device=self.device)
                     for k in ("signal", "lengths", "labels"))

    def train_step(self, wave: torch.Tensor, lengths: torch.Tensor,
                   labels: torch.Tensor, aug_scale: float = 1.0,
                   partner: Optional[tuple] = None) -> dict:
        """One optimizer step on a device batch; returns 0-d tensors
        ``loss`` and ``metric`` and the (B,) ``per_sample`` losses."""
        self.model.train()
        with torch.no_grad():
            if self.augment is not None and aug_scale > 0.0:
                with self._stage("augment"):
                    wave, lengths, labels = self.augment(
                        wave, lengths, labels, self.generator, aug_scale,
                        partner=partner)
            with self._stage("frontend"):
                inputs, frame_lengths = self.frontend(wave, lengths)
        with self._stage("forward"):
            logits = self.model(inputs, frame_lengths)
            per_sample = self.loss_fn(logits, labels, average=False)
            loss = per_sample.mean()
        with self._stage("backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with self._stage("optimizer"):
            set_lr(self.optimizer, self.schedule(self.global_step))
            self.optimizer.step()
        self.global_step += 1
        with torch.no_grad():
            metric = metrics_lib.lwlrap_torch(labels,
                                              torch.sigmoid(logits.detach()))
        return {"loss": loss.detach(), "metric": metric,
                "per_sample": per_sample.detach()}

    @torch.inference_mode()
    def eval_step(self, wave: torch.Tensor, lengths: torch.Tensor,
                  labels: torch.Tensor) -> tuple:
        """(mean loss, (B, C) probabilities) in eval mode."""
        self.model.eval()
        inputs, frame_lengths = self.frontend(wave, lengths)
        logits = self.model(inputs, frame_lengths)
        return self.loss_fn(logits, labels), torch.sigmoid(logits)

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------

    def train_epoch(self, loader, aug_scale: float = 1.0,
                    log_interval: int = 25) -> dict:
        losses, batch_metrics = [], []
        n_clips = 0
        timer = StepTimer()
        timer.start()
        for batch_idx, batch in enumerate(loader):
            wave, lengths, labels = self.to_device(batch)
            # MixUp partners: the previous clean batch of the same bucket
            # shape (the current one on a bucket's first step), so over an
            # epoch partners span the whole dataset
            pool_key = tuple(wave.shape)
            clean = (wave, lengths, labels)
            partner = self._mixup_pool.get(pool_key, clean)
            out = self.train_step(wave, lengths, labels, aug_scale, partner)
            if self.augment is not None:
                self._mixup_pool[pool_key] = clean
            n_clips += wave.shape[0]
            losses.append(out["loss"])
            batch_metrics.append(out["metric"])
            if batch_idx % log_interval == 0:
                print(f"step {self.global_step}: loss "
                      f"{float(out['loss']):.4f} metric "
                      f"{float(out['metric']):.4f}")
        losses = torch.stack(losses).float().cpu().numpy()
        batch_metrics = torch.stack(batch_metrics).float().cpu().numpy()
        # the epoch as one timed span, closed after the losses' readback
        dt = timer.stop(n_clips)
        return {"loss": float(losses.mean()),
                "metric": float(np.nanmean(batch_metrics)),
                "losses": losses, "clips_per_sec": timer.clips_per_sec,
                "steps": len(losses), "seconds": dt}

    def predict(self, loader) -> np.ndarray:
        """Probabilities over a loader, rows in dataset order."""
        probs, index = [], []
        for batch in loader:
            _, p = self.eval_step(*self.to_device(batch))
            probs.append(p.float().cpu().numpy())
            index.append(batch["index"])
        probs = np.concatenate(probs)
        out = np.zeros_like(probs)
        out[np.concatenate(index)] = probs
        return out

    def evaluate(self, loader, verbose: bool = False) -> float:
        """Full-set lwlrap (numpy) and the clip-weighted mean loss."""
        all_probs, all_labels = [], []
        total_loss, total_n = 0.0, 0
        for batch in loader:
            loss, probs = self.eval_step(*self.to_device(batch))
            n = len(batch["index"])
            total_loss += float(loss) * n
            total_n += n
            all_probs.append(probs.float().cpu().numpy())
            all_labels.append(batch["labels"])
        score = metrics_lib.lwlrap(np.concatenate(all_labels),
                                   np.concatenate(all_probs))
        if verbose:
            print(f"Validation loss: {total_loss / max(total_n, 1):.4f}")
            print(f"Validation metric: {score:.4f}")
        return score

    def fit_validate(self, train_loader, valid_loader, epochs: int,
                     fold: int, log_interval: int = 25) -> list:
        """Train ``epochs`` epochs, validating after each; save
        ``model_on_epoch_{epoch}.npz`` when ``epoch % _save_every == 0``
        (then prune to the newest ``_keep_checkpoints``) and
        ``best_model.npz`` whenever validation lwlrap improves. Epoch 1 runs
        under ``maybe_trace(profile_dir)``. Returns the per-epoch scores."""
        steps_per_epoch = len(train_loader)
        if steps_per_epoch == 0:
            raise ValueError(
                "train loader is empty: with drop_last batching every "
                "bucket had fewer clips than one batch; lower batch_size "
                "or use more data")
        self.global_step = 0
        # never carry MixUp partners across folds
        self._mixup_pool = {}
        self.make_optimizer(steps_per_epoch * epochs, steps_per_epoch)
        if self.warm_start_path:
            print(f"warm start from {self.warm_start_path}")
            self.warm_start(self.warm_start_path)
        cfg = self.train_config
        switch_off = int(getattr(cfg, "switch_off_augmentations_on", 10**9))
        save_every = int(getattr(cfg, "_save_every", 10**9))
        keep = int(getattr(cfg, "_keep_checkpoints", 0))
        scores, best = [], -np.inf
        self.epoch_stats = []
        for epoch in range(epochs):
            traced = self.profile_dir if epoch == 1 else None
            self._stage = annotate if traced else _no_range
            try:
                with maybe_trace(traced):
                    stats = self.train_epoch(
                        train_loader, 0.0 if epoch >= switch_off else 1.0,
                        log_interval)
            finally:
                self._stage = _no_range
            self.epoch_stats.append(stats)
            print(f"Epoch {epoch}: loss {stats['loss']:.4f} metric "
                  f"{stats['metric']:.4f} ({stats['clips_per_sec']:.1f} "
                  "clips/s)")
            score = self.evaluate(valid_loader, verbose=True)
            scores.append(score)
            if self.checkpoint_dir is not None:
                if epoch % save_every == 0:
                    self.save_model(fold, f"model_on_epoch_{epoch}")
                    checkpoints.prune_epoch_checkpoints(
                        os.path.join(self.checkpoint_dir, f"fold_{fold}"),
                        keep)
                if score > best:
                    self.save_model(fold, "best_model")
            best = max(best, score)
        return scores

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def model_path(self, fold: int, name: str) -> str:
        return os.path.join(self.checkpoint_dir, f"fold_{fold}",
                            f"{name}.npz")

    def save_model(self, fold: int, name: str) -> None:
        checkpoints.save_model(self.model_path(fold, name), self.model)

    def load_model(self, fold: int, name: str) -> None:
        checkpoints.load_model(self.model_path(fold, name), self.model)

    def warm_start(self, path: str) -> None:
        """Load the weights and BatchNorm statistics of another
        experiment's fold ``.npz`` (JAX ``Engine.warm_start``); the
        optimizer state and the step count stay as they are."""
        checkpoints.load_model(path, self.model)
