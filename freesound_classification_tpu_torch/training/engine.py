"""The training engine of the classifiers (JAX ``training/engine.py``).

One train step (``Engine.train_step``), as the JAX package's jitted step:
augment the batch on the device (the effects chain runs K2 and K3), then
the log-mel frontend (K1), the forward in train mode, the loss over the
batch's rows, the backward, and the batch's lwlrap. The step runs eagerly;
augmentation and the frontend take no gradient.

Gradient accumulation is ``optax.MultiSteps``'s (``accumulation_steps`` k):
each micro-batch's gradients join a running mean (Welford, as optax), and
every k-th micro-batch the optimizer updates with that mean and the mean
restarts. The optimizer's own state (Adam's step count) advances once an
update, and its c-th update takes the learning rate ``schedule(c * k)``,
JAX's stretched schedule; BatchNorm statistics move on every micro-batch.
A partial mean carries over epoch ends, and every fit starts a fresh one.

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

Resume: with a checkpoint dir, every epoch ends by writing the fold's
``last_model.pt`` bundle (``checkpoints.save_bundle``): the model's and the
optimizer's state, the accumulated gradients and micro-step, the update
count and ``global_step``, the augmenter's generator and the device's
default generator (dropout's), and the progress ``{epoch, best_score,
scores, global_step}``. ``fit_validate(resume=True)`` continues from it at
the next epoch, with the loader's epoch counter set so that its shuffles
and crops line up with an uninterrupted run; the MixUp pool starts empty,
as in JAX, and a fold with no bundle starts fresh.

Summaries: ``summary_writer_factory(fold, split)`` gives each fit a train
and a valid writer (or None), written as JAX writes them: train ``loss``,
``metric`` and ``lr`` every ``log_interval`` batches, the first batch's
spectrogram grid (``signal``), the ``losses`` histogram of the logged
batches' per-sample losses at each epoch's end, valid ``loss`` and
``metric`` after each validation.
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


def _default_rng_state(device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        return torch.cuda.get_rng_state(device)
    return torch.get_rng_state()


def _set_default_rng_state(device: torch.device, state: torch.Tensor) -> None:
    if device.type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


def spectrogram_grid(inputs: torch.Tensor) -> np.ndarray:
    """The frontend's (B, H, W, 1) or (B, T, F) features as one (1, B*H, W)
    image, each clip scaled to [0, 1] (JAX ``Engine._add_image_summary``)."""
    imgs = inputs.detach().float().cpu().numpy()
    if imgs.ndim == 4:
        imgs = imgs[..., 0]
    else:
        imgs = np.swapaxes(imgs, 1, 2)
    lo = imgs.min(axis=(1, 2), keepdims=True)
    hi = imgs.max(axis=(1, 2), keepdims=True)
    imgs = (imgs - lo) / np.maximum(hi - lo, 1e-6)
    return np.concatenate(list(imgs), axis=0)[None]


class Engine:
    """Trains and evaluates one model on one device.

    ``train_config`` has optimizer, learning_rate, scheduler, weight_decay,
    accumulation_steps and switch_off_augmentations_on (an experiment's
    ``config.train``). ``augment`` is ``ops.augment.make_augmenter``'s
    function or None. ``seed`` seeds the generator of every random draw of
    the augmenter; dropout draws from PyTorch's default generator.
    ``warm_start_path``, a fold ``.npz`` of the same architecture, seeds
    the model at the start of every ``fit_validate``. ``profile_dir``, where
    set, receives a trace of each fit's epoch 1. ``summary_writer_factory``
    (fold, split) -> a tensorboard-like writer or None. ``device`` is the
    card unless the caller passes "cpu"; without a card it raises.
    """

    def __init__(self, model: nn.Module, frontend: Frontend, train_config,
                 loss: str = "lsep_naive",
                 augment: Optional[Callable] = None,
                 checkpoint_dir: Optional[str] = None, seed: int = 42,
                 device: torch.device | str = "cuda",
                 warm_start_path: Optional[str] = None,
                 profile_dir: Optional[str] = None,
                 summary_writer_factory: Optional[Callable] = None):
        self.accumulation_steps = max(
            int(getattr(train_config, "accumulation_steps", 1)), 1)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.frontend = frontend
        self.train_config = train_config
        self.loss_fn = make_loss(loss)
        self.augment = augment
        self.checkpoint_dir = checkpoint_dir
        self.warm_start_path = warm_start_path
        self.profile_dir = profile_dir
        self._writer_factory = summary_writer_factory
        self.train_writer = None
        self.valid_writer = None
        self._stage = _no_range  # ``annotate`` while an epoch is traced
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.schedule = None
        self.global_step = 0  # micro-batches of this fit
        self.updates = 0  # optimizer updates of this fit
        self.micro_step = 0  # micro-batches in the running mean
        self._accumulated: Optional[list] = None
        self._mixup_pool: dict = {}
        self.epoch_stats: list = []  # train_epoch's dicts of the last fit

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def make_optimizer(self, max_steps: int, steps_per_epoch: int) -> None:
        """A fresh optimizer, schedule and gradient mean."""
        cfg = self.train_config
        self.schedule = make_schedule(cfg.scheduler, cfg.learning_rate,
                                      max_steps, steps_per_epoch)
        self.optimizer = make_optimizer(cfg.optimizer,
                                        self.model.parameters(),
                                        cfg.weight_decay)
        self.updates = 0
        self.micro_step = 0
        self._accumulated = None

    def to_device(self, batch: dict) -> tuple:
        return tuple(torch.as_tensor(batch[k], device=self.device)
                     for k in ("signal", "lengths", "labels"))

    def _update_due(self) -> bool:
        """Fold this micro-batch's gradients into the running mean; on the
        k-th, hand the mean to the parameters' ``grad`` and say so. A
        parameter without a gradient counts as a zero one, as in optax."""
        k = self.accumulation_steps
        if k == 1:
            return True
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        if self._accumulated is None:
            self._accumulated = [torch.zeros_like(p) for p in params]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        delta = torch._foreach_sub(grads, self._accumulated)
        torch._foreach_div_(delta, self.micro_step + 1)
        torch._foreach_add_(self._accumulated, delta)
        self.micro_step += 1
        if self.micro_step < k:
            return False
        for p, mean in zip(params, self._accumulated):
            p.grad = mean
        self.micro_step = 0
        return True

    def train_step(self, wave: torch.Tensor, lengths: torch.Tensor,
                   labels: torch.Tensor, aug_scale: float = 1.0,
                   partner: Optional[tuple] = None) -> dict:
        """One micro-batch: forward, backward, and the optimizer step where
        an update is due; returns 0-d tensors ``loss`` and ``metric`` and
        the (B,) ``per_sample`` losses."""
        self.model.train()
        if self.augment is not None and aug_scale > 0.0:
            with torch.no_grad(), self._stage("augment"):
                wave, lengths, labels = self.augment(
                    wave, lengths, labels, self.generator, aug_scale,
                    partner=partner)
        logits, per_sample, loss = self._learn(
            wave, lengths, labels, lambda per_sample: (per_sample.mean(),) * 2)
        with torch.no_grad():
            metric = metrics_lib.lwlrap_torch(labels, torch.sigmoid(logits))
        return {"loss": loss, "metric": metric, "per_sample": per_sample}

    def _learn(self, wave: torch.Tensor, lengths: torch.Tensor,
               labels: torch.Tensor, reduce: Callable) -> tuple:
        """The step after augmentation, shared with the fold-parallel step
        (``training/multifold.py``): the frontend, the forward and the loss,
        the backward, the gradient mean and the optimizer step where an
        update is due. ``reduce(per_sample)`` gives (the loss to
        differentiate, the loss to report). Returns the detached logits,
        per-sample losses and reported loss."""
        with torch.no_grad(), self._stage("frontend"):
            inputs, frame_lengths = self.frontend(wave, lengths)
        with self._stage("forward"):
            logits = self.model(inputs, frame_lengths)
            per_sample = self.loss_fn(logits, labels, average=False)
            loss, reported = reduce(per_sample)
        with self._stage("backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with self._stage("optimizer"):
            if self._update_due():
                set_lr(self.optimizer, self.schedule(
                    self.updates * self.accumulation_steps))
                self.optimizer.step()
                self.updates += 1
                if self._accumulated is not None:
                    torch._foreach_zero_(self._accumulated)
        self.global_step += 1
        return logits.detach(), per_sample.detach(), reported.detach()

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
        losses, batch_metrics, logged_losses = [], [], []
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
            # only the logged batches wait for the card
            if batch_idx % log_interval == 0:
                loss, metric = float(out["loss"]), float(out["metric"])
                print(f"step {self.global_step}: loss {loss:.4f} metric "
                      f"{metric:.4f}")
                logged_losses.append(out["per_sample"].float().cpu().numpy())
                self._write_train_scalars(loss, metric)
            if batch_idx == 0 and self.train_writer is not None:
                with torch.no_grad():
                    inputs, _ = self.frontend(wave[:8], lengths[:8])
                self.train_writer.add_image(
                    "signal", spectrogram_grid(inputs), self.global_step)
        losses = torch.stack(losses).float().cpu().numpy()
        batch_metrics = torch.stack(batch_metrics).float().cpu().numpy()
        # the epoch as one timed span, closed after the losses' readback
        dt = timer.stop(n_clips)
        if logged_losses and self.train_writer is not None:
            values = np.concatenate(logged_losses)
            # a histogram of non-finite values cannot be binned: JAX's
            # engine writes none then either
            if np.isfinite(values).all():
                self.train_writer.add_histogram("losses", values,
                                                global_step=self.global_step)
        return {"loss": float(losses.mean()),
                "metric": float(np.nanmean(batch_metrics)),
                "losses": losses, "clips_per_sec": timer.clips_per_sec,
                "steps": len(losses), "seconds": dt}

    def _write_train_scalars(self, loss: float, metric: float) -> None:
        if self.train_writer is None:
            return
        step = self.global_step
        self.train_writer.add_scalar("loss", loss, step)
        self.train_writer.add_scalar("metric", metric, step)
        self.train_writer.add_scalar("lr", float(self.schedule(step - 1)),
                                     step)

    def predict(self, loader, n_tta: int = 1) -> np.ndarray:
        """Probabilities over a loader, rows in dataset order, averaged over
        ``n_tta`` passes (JAX ``Engine.predict``). The eval step is
        deterministic, so ``n_tta > 1`` needs a stochastic loader (train
        mode with a crop, ``max_audio_length``): a deterministic one raises,
        as does a shuffled one. Perturbation TTA is
        ``EnsemblePredictor.predict_loader(tta_fn=...)``."""
        if n_tta > 1:
            train = getattr(loader, "train", None)
            crop = getattr(getattr(loader, "dataset", None),
                           "max_audio_length", None)
            if train is not None and not (train and crop):
                raise ValueError(
                    f"predict(n_tta={n_tta}) on a deterministic loader "
                    "would average identical passes. Build the loader with "
                    "train=True and a dataset max_audio_length (stochastic "
                    "crop TTA), or use n_tta=1. Perturbation-based TTA "
                    "lives in EnsemblePredictor.predict_loader(tta_fn=...)")
            if getattr(getattr(loader, "sampler", None), "shuffle", False):
                raise ValueError(
                    f"predict(n_tta={n_tta}) on a SHUFFLED loader: build "
                    "the TTA loader with shuffle=False")
        passes = []
        for _ in range(n_tta):
            probs, index = [], []
            for batch in loader:
                _, p = self.eval_step(*self.to_device(batch))
                probs.append(p.float().cpu().numpy())
                index.append(batch["index"])
            probs = np.concatenate(probs)
            out = np.zeros_like(probs)
            out[np.concatenate(index)] = probs
            passes.append(out)
        return np.mean(passes, axis=0)

    def evaluate(self, loader, verbose: bool = False,
                 write_summary: bool = False) -> float:
        """Full-set lwlrap (numpy) and the clip-weighted mean loss; with
        ``write_summary`` both go to the valid writer."""
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
        mean_loss = total_loss / max(total_n, 1)
        if write_summary and self.valid_writer is not None:
            self.valid_writer.add_scalar("loss", mean_loss, self.global_step)
            self.valid_writer.add_scalar("metric", score, self.global_step)
        if verbose:
            print(f"Validation loss: {mean_loss:.4f}")
            print(f"Validation metric: {score:.4f}")
        return score

    def fit_validate(self, train_loader, valid_loader, epochs: int,
                     fold: int, log_interval: int = 25,
                     resume: bool = False) -> list:
        """Train ``epochs`` epochs, validating after each; save
        ``model_on_epoch_{epoch}.npz`` when ``epoch % _save_every == 0``
        (then prune to the newest ``_keep_checkpoints``), ``best_model.npz``
        whenever validation lwlrap improves and the ``last_model.pt``
        resume bundle. With ``resume`` a fold's bundle, where there is one,
        is loaded and training goes on from the epoch after it. Epoch 1 runs
        under ``maybe_trace(profile_dir)``. Returns the per-epoch scores,
        the bundle's included."""
        steps_per_epoch = len(train_loader)
        if steps_per_epoch == 0:
            raise ValueError(
                "train loader is empty: with drop_last batching every "
                "bucket had fewer clips than one batch; lower batch_size "
                "or use more data")
        if self._writer_factory is not None:
            self.train_writer = self._writer_factory(fold, "train")
            self.valid_writer = self._writer_factory(fold, "valid")
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
        scores, best, start_epoch = [], -np.inf, 0
        if resume and self.checkpoint_dir is not None:
            bundle = checkpoints.load_bundle(self.bundle_path(fold))
            if bundle is not None:
                meta = self.load_train_state(bundle)
                start_epoch = meta["epoch"] + 1
                best = meta["best_score"]
                scores = list(meta["scores"])
                # the loader's epoch-keyed shuffles and crops then follow
                # the uninterrupted run's
                if hasattr(train_loader, "_epoch"):
                    train_loader._epoch = start_epoch
                print(f"resuming fold {fold} from epoch {start_epoch} "
                      f"(best {best:.4f})")
        self.epoch_stats = []
        for epoch in range(start_epoch, epochs):
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
            score = self.evaluate(valid_loader, verbose=True,
                                  write_summary=True)
            scores.append(score)
            if self.checkpoint_dir is not None:
                if epoch % save_every == 0:
                    self.save_model(fold, f"model_on_epoch_{epoch}")
                    checkpoints.prune_epoch_checkpoints(
                        os.path.join(self.checkpoint_dir, f"fold_{fold}"),
                        keep)
                if score > best:
                    self.save_model(fold, "best_model")
                checkpoints.save_bundle(self.bundle_path(fold), dict(
                    self.train_state(),
                    meta={"epoch": epoch,
                          "best_score": float(max(best, score)),
                          "scores": [float(s) for s in scores],
                          "global_step": self.global_step}))
            best = max(best, score)
        for writer in (self.train_writer, self.valid_writer):
            if writer is not None:
                writer.close()
        return scores

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def model_path(self, fold: int, name: str) -> str:
        return os.path.join(self.checkpoint_dir, f"fold_{fold}",
                            f"{name}.npz")

    def bundle_path(self, fold: int) -> str:
        return os.path.join(self.checkpoint_dir, f"fold_{fold}",
                            "last_model.pt")

    def save_model(self, fold: int, name: str) -> None:
        checkpoints.save_model(self.model_path(fold, name), self.model)

    def load_model(self, fold: int, name: str) -> None:
        checkpoints.load_model(self.model_path(fold, name), self.model)

    def train_state(self) -> dict:
        """Everything a resumed fit needs to go on as if uninterrupted."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "accumulated": self._accumulated,
                "micro_step": self.micro_step,
                "updates": self.updates,
                "global_step": self.global_step,
                "augment_rng": self.generator.get_state(),
                "dropout_rng": _default_rng_state(self.device)}

    def load_train_state(self, bundle: dict) -> dict:
        """Load a ``train_state`` bundle; returns its progress meta."""
        self.model.load_state_dict(bundle["model"])
        self.optimizer.load_state_dict(bundle["optimizer"])
        acc = bundle["accumulated"]
        self._accumulated = (None if acc is None
                             else [t.to(self.device) for t in acc])
        self.micro_step = int(bundle["micro_step"])
        self.updates = int(bundle["updates"])
        self.global_step = int(bundle["global_step"])
        self.generator.set_state(bundle["augment_rng"])
        _set_default_rng_state(self.device, bundle["dropout_rng"])
        return bundle["meta"]

    def warm_start(self, path: str) -> None:
        """Load the weights and BatchNorm statistics of another
        experiment's fold ``.npz`` (JAX ``Engine.warm_start``); the
        optimizer state and the step count stay as they are."""
        checkpoints.load_model(path, self.model)
