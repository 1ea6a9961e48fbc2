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
after the warm-up epoch 0) into that directory. While spans are on
(``utils/profiling.span``: in any profiler window, that trace's too), each
step's stages are spans (``augment``, ``frontend``, ``forward``,
``backward``, ``optimizer``) and its host-to-device copy one (``h2d``);
with spans off they open nothing.

Saves go through ``checkpoints``' writer thread: each epoch's periodic
model, best model and bundle are enqueued in that order, snapshots taken
on the loop, and the pruning after them (``write_after_saves``); a fit
returns once they are written.

Resume: with a checkpoint dir, every epoch ends by writing the fold's
``last_model.pt`` bundle (``checkpoints.save_bundle``): the model's and the
optimizer's state, the accumulated gradients and micro-step, the update
count and ``global_step``, the augmenter's generator and the device's
default generator (dropout's), and the progress ``{epoch, best_score,
scores, global_step}``. ``fit_validate(resume=True)`` continues from it at
the next epoch, with the loader's epoch counter set so that its shuffles
and crops line up with an uninterrupted run; the MixUp pool starts empty,
as in JAX, and a fold with no bundle starts fresh.

Self-supervised models (``self_supervised=True``: APC, CPC; JAX's
``self_supervised`` mode) return their ``loss_parts``; the step's loss is
the sum of their terms (``blocks.loss_terms``), there are no
probabilities and no lwlrap, and the validation score is ``-mean_loss``,
which picks ``best_model.npz`` as lwlrap does for a classifier. Such a
step reports no batch metric, and an epoch's ``metric`` is NaN by
definition (JAX takes the ``nanmean`` of all-NaN batch metrics, which
warns; the port states it instead).

Summaries: ``summary_writer_factory(fold, split)`` gives each fit a train
and a valid writer (or None), written as JAX writes them: train ``loss``,
``metric`` and ``lr`` every ``log_interval`` batches, the first batch's
spectrogram grid (``signal``), the ``losses`` histogram of the logged
batches' per-sample losses at each epoch's end, valid ``loss`` and
``metric`` after each validation.

Data parallel (``mesh``, a ``parallel.mesh.Mesh`` with a process group;
JAX's engine over a 1-D mesh): each rank steps on its slice of every global
batch (the loader's ``n_real`` of its rows are real, ``n_global`` the
global batch's), and the arithmetic is JAX's over the global batch.

- Every rank starts from rank 0's weights (a broadcast after init, after
  ``warm_start`` and after a resume); the optimizer states then stay the
  same on every rank.
- Train-mode BatchNorm takes the global batch's statistics (each layer's
  ``group``), padded rows included as in JAX.
- The loss differentiated on a rank is its masked per-sample sum over the
  global real-row count; the gradients, with the rank's share of the
  reported loss, are summed over the ranks in one buffer before the
  gradient mean of accumulation, so an update sees JAX's global gradient.
  A self-supervised model's terms are its ``loss_parts`` sums over the
  counts summed over the ranks, with the padded rows' frame counts zeroed
  (JAX ``engine.py:146-152``).
- The batch lwlrap, validation and predictions gather the ranks' rows and
  drop the padded ones: every rank sees the single-process numbers and
  makes the same best-model decision.
- Rank 0 alone writes files, through the checkpoint writer
  (``checkpoints``: the snapshot on the loop, the write on the writer's
  thread), and no rank waits for them. Rank 0 alone reads them too, once
  its writer has drained: a model file or a resume bundle reaches the
  others by broadcast, so no rank needs to see rank 0's disk.
- Each rank draws its augmentation from its own generator, seeded
  ``mesh.rank_seed(seed)`` (JAX's key is global), and MixUp partners come
  from the rank's own rows; the effects chain runs on the rank's share of
  the global batch's ``round(p * B)`` rows.
- The resume bundle holds every rank's generator states and the world
  size. A resume at that world size takes each rank's back; at another
  one (the bundle's other state is the same on every rank) rank r draws
  from ``mesh.resume_seed(seed, r, global_step)``, augmenter and dropout
  alike: JAX's resume, whose key is global, goes on at any mesh size.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from freesound_classification_tpu_torch.models.blocks import (
    BatchNorm,
    loss_terms,
)
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops import metrics as metrics_lib
from freesound_classification_tpu_torch.ops.losses import make_loss
from freesound_classification_tpu_torch.ops.schedules import make_schedule
from freesound_classification_tpu_torch.parallel import mesh as mesh_lib
from freesound_classification_tpu_torch.training import checkpoints
from freesound_classification_tpu_torch.training.optimizers import (
    make_optimizer,
    set_lr,
)
from freesound_classification_tpu_torch.utils.device import resolve_device
from freesound_classification_tpu_torch.utils.profiling import (
    StepTimer,
    maybe_trace,
    span,
)


def _no_range(name: str) -> contextlib.nullcontext:
    """A stage that opens nothing whatever the switch."""
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
    ``self_supervised`` trains a model that returns ``loss_parts``.
    ``mesh``, a ``parallel.mesh.Mesh`` with a process group, makes this
    engine one rank of a data-parallel job (the module docstring); its
    device is ``device``.
    """

    def __init__(self, model: nn.Module, frontend: Frontend, train_config,
                 loss: str = "lsep_naive",
                 augment: Optional[Callable] = None,
                 checkpoint_dir: Optional[str] = None, seed: int = 42,
                 device: torch.device | str = "cuda",
                 warm_start_path: Optional[str] = None,
                 profile_dir: Optional[str] = None,
                 summary_writer_factory: Optional[Callable] = None,
                 self_supervised: bool = False,
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.self_supervised = self_supervised
        self.mesh = mesh if mesh is not None and mesh.distributed else None
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
        self._stage = span  # the step's five stages
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.mesh.rank_seed(seed) if self.mesh else seed)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.schedule = None
        self.global_step = 0  # micro-batches of this fit
        self.updates = 0  # optimizer updates of this fit
        self.micro_step = 0  # micro-batches in the running mean
        self._accumulated: Optional[list] = None
        self._mixup_pool: dict = {}
        self.epoch_stats: list = []  # train_epoch's dicts of the last fit
        self._replicate()

    def _replicate(self) -> None:
        """Rank 0's weights and statistics on every rank, whose BatchNorm
        layers take the global batch's statistics."""
        if self.mesh:
            mesh_lib.broadcast_module(self.model, self.mesh.group)
            for module in self.model.modules():
                if isinstance(module, BatchNorm):
                    module.group = self.mesh.group

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
        with span("h2d"):
            return tuple(torch.as_tensor(batch[k], device=self.device)
                         for k in ("signal", "lengths", "labels"))

    @staticmethod
    def batch_rows(batch: dict) -> tuple:
        """(real rows of this rank's slice, real rows of the global batch);
        both the batch's size where the loader gives neither."""
        n = len(batch["index"])
        return batch.get("n_real", n), batch.get("n_global", n)

    def _gather_rows(self, n_global: int, *columns: torch.Tensor) -> list:
        """The global batch's real rows of each (B_local, k) column block,
        gathered from every rank in one float64 buffer (exact for float32
        values and int64 indices below 2^53)."""
        widths = [c.shape[1] for c in columns]
        flat = torch.cat([c.to(torch.float64) for c in columns], dim=1)
        rows = mesh_lib.all_gather_rows(flat, self.mesh.group)[:n_global]
        return list(torch.split(rows, widths, dim=1))

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
                   partner: Optional[tuple] = None,
                   rows: Optional[tuple] = None) -> dict:
        """One micro-batch: forward, backward, and the optimizer step where
        an update is due; returns 0-d tensors ``loss`` and ``metric`` and
        the (B,) ``per_sample`` losses (a self-supervised step: its loss,
        and None for the other two). On a rank of a mesh, ``rows`` is the
        batch's ``batch_rows``, and the loss, the metric and the per-sample
        losses are the global batch's real rows'."""
        self.model.train()
        shard = ((self.mesh.rank, self.mesh.world_size) if self.mesh
                 else None)
        if self.augment is not None and aug_scale > 0.0:
            with torch.no_grad(), self._stage("augment"):
                wave, lengths, labels = self.augment(
                    wave, lengths, labels, self.generator, aug_scale,
                    partner=partner, shard=shard)
        if self.mesh is None:
            logits, per_sample, loss = self._learn(
                wave, lengths, labels,
                lambda per_sample: (per_sample.mean(),) * 2)
        else:
            n_real, n_global = rows
            row_mask = torch.arange(wave.shape[0],
                                    device=self.device) < n_real

            def reduce(per_sample):
                if self.self_supervised:
                    return per_sample, per_sample
                share = ((per_sample * row_mask).sum()
                         / max(n_global, 1))
                return share, share

            logits, per_sample, loss = self._learn(
                wave, lengths, labels, reduce, row_mask=row_mask)
        if self.self_supervised:
            return {"loss": loss, "metric": None, "per_sample": None}
        with torch.no_grad():
            probs = torch.sigmoid(logits)
            if self.mesh is not None:
                probs, labels, per_sample = self._gather_rows(
                    n_global, probs, labels, per_sample[:, None])
                per_sample = per_sample[:, 0]
            metric = metrics_lib.lwlrap_torch(labels, probs)
        return {"loss": loss, "metric": metric, "per_sample": per_sample}

    def _learn(self, wave: torch.Tensor, lengths: torch.Tensor,
               labels: torch.Tensor, reduce: Callable,
               row_mask: Optional[torch.Tensor] = None) -> tuple:
        """The step after augmentation, shared with the fold-parallel step
        (``training/multifold.py``): the frontend, the forward and the loss,
        the backward, the gradient mean and the optimizer step where an
        update is due. ``reduce(per_sample)`` gives (the loss to
        differentiate, the loss to report); a self-supervised model's
        "per-sample" loss is the sum of its loss terms. On a mesh
        ``row_mask`` marks the real rows, and the gradients and the
        reported loss are summed over the ranks. Returns the detached
        logits (None for a self-supervised model), per-sample losses and
        reported loss."""
        with torch.no_grad(), self._stage("frontend"):
            inputs, frame_lengths = self.frontend(wave, lengths)
        with self._stage("forward"):
            logits, per_sample = self._forward_loss(inputs, frame_lengths,
                                                    labels, row_mask)
            loss, reported = reduce(per_sample)
        with self._stage("backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if self.mesh is not None:
                reported, = mesh_lib.all_reduce_gradients(
                    [p for g in self.optimizer.param_groups
                     for p in g["params"]], self.mesh.group, [reported])
        with self._stage("optimizer"):
            if self._update_due():
                set_lr(self.optimizer, self.schedule(
                    self.updates * self.accumulation_steps))
                self.optimizer.step()
                self.updates += 1
                if self._accumulated is not None:
                    torch._foreach_zero_(self._accumulated)
        self.global_step += 1
        return (None if logits is None else logits.detach(),
                per_sample.detach(), reported.detach())

    def _forward_loss(self, inputs: torch.Tensor,
                      frame_lengths: torch.Tensor,
                      labels: torch.Tensor,
                      row_mask: Optional[torch.Tensor] = None) -> tuple:
        """(logits, per-sample losses) of a classifier; (None, the sum of
        the loss terms) of a self-supervised model. On a mesh, a
        self-supervised model's padded rows (``row_mask`` False) have no
        frames, and its "loss" is this rank's share of the global terms:
        each sum over the counts summed over the ranks."""
        if self.self_supervised and row_mask is not None:
            frame_lengths = torch.where(row_mask, frame_lengths,
                                        torch.zeros_like(frame_lengths))
        out = self.model(inputs, frame_lengths)
        if not self.self_supervised:
            return out, self.loss_fn(out, labels, average=False)
        return None, sum(loss_terms(out["loss_parts"],
                                    self.mesh.group if self.mesh else None))

    @torch.inference_mode()
    def eval_batch(self, batch: dict) -> tuple:
        """A loader's batch in eval mode: (mean loss, (n, C) probabilities,
        (n, C) labels, the n dataset indices, n), over this process's n
        rows, or on a mesh over the global batch's n real rows gathered
        from every rank in rank order; a self-supervised model's: (its
        loss, None, None, None, n)."""
        self.model.eval()
        wave, lengths, labels = self.to_device(batch)
        n_real, n_global = self.batch_rows(batch)
        row_mask = (torch.arange(wave.shape[0], device=self.device) < n_real
                    if self.mesh else None)
        inputs, frame_lengths = self.frontend(wave, lengths)
        logits, per_sample = self._forward_loss(inputs, frame_lengths,
                                                labels, row_mask)
        if logits is None:
            if self.mesh:
                per_sample = mesh_lib.all_reduce_sum_(per_sample.clone(),
                                                      self.mesh.group)
            return per_sample, None, None, None, n_global
        if self.mesh is None:
            return (per_sample.mean(), torch.sigmoid(logits),
                    batch["labels"], batch["index"], n_global)
        index = torch.as_tensor(batch["index"], device=self.device)
        probs, labels, per_sample, index = self._gather_rows(
            n_global, torch.sigmoid(logits), labels, per_sample[:, None],
            index[:, None])
        return (per_sample.mean(), probs, labels.float().cpu().numpy(),
                index[:, 0].long().cpu().numpy(), n_global)

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
            rows = self.batch_rows(batch)
            out = self.train_step(wave, lengths, labels, aug_scale, partner,
                                  rows=rows)
            if self.augment is not None:
                self._mixup_pool[pool_key] = clean
            n_clips += rows[1] if self.mesh else wave.shape[0]
            losses.append(out["loss"])
            if out["metric"] is not None:
                batch_metrics.append(out["metric"])
            # only the logged batches wait for the card
            if batch_idx % log_interval == 0:
                loss = float(out["loss"])
                metric = (float("nan") if out["metric"] is None
                          else float(out["metric"]))
                print(f"step {self.global_step}: loss {loss:.4f} metric "
                      f"{metric:.4f}")
                if out["per_sample"] is not None:
                    logged_losses.append(
                        out["per_sample"].float().cpu().numpy())
                self._write_train_scalars(loss, metric)
            if batch_idx == 0 and self.train_writer is not None:
                with torch.no_grad():
                    inputs, _ = self.frontend(wave[:8], lengths[:8])
                self.train_writer.add_image(
                    "signal", spectrogram_grid(inputs), self.global_step)
        losses = torch.stack(losses).float().cpu().numpy()
        # a self-supervised epoch has no batch metric: its metric is NaN
        metric = (float(np.nanmean(torch.stack(batch_metrics).float().cpu()
                                   .numpy())) if batch_metrics
                  else float("nan"))
        # the epoch as one timed span, closed after the losses' readback
        dt = timer.stop(n_clips)
        if logged_losses and self.train_writer is not None:
            values = np.concatenate(logged_losses)
            # a histogram of non-finite values cannot be binned: JAX's
            # engine writes none then either
            if np.isfinite(values).all():
                self.train_writer.add_histogram("losses", values,
                                                global_step=self.global_step)
        return {"loss": float(losses.mean()), "metric": metric,
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
                _, p, _, idx, _ = self.eval_batch(batch)
                probs.append(p.float().cpu().numpy())
                index.append(idx)
            probs = np.concatenate(probs)
            out = np.zeros_like(probs)
            out[np.concatenate(index)] = probs
            passes.append(out)
        return np.mean(passes, axis=0)

    def evaluate(self, loader, verbose: bool = False,
                 write_summary: bool = False) -> float:
        """Full-set lwlrap (numpy; ``-mean_loss`` for a self-supervised
        model) and the clip-weighted mean loss; with ``write_summary`` both
        go to the valid writer."""
        all_probs, all_labels = [], []
        total_loss, total_n = 0.0, 0
        for batch in loader:
            loss, probs, labels, _, n = self.eval_batch(batch)
            total_loss += float(loss) * n
            total_n += n
            if probs is not None:
                all_probs.append(probs.float().cpu().numpy())
                all_labels.append(labels)
        mean_loss = total_loss / max(total_n, 1)
        score = (-mean_loss if self.self_supervised else metrics_lib.lwlrap(
            np.concatenate(all_labels), np.concatenate(all_probs)))
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
            bundle = (checkpoints.load_bundle(self.bundle_path(fold))
                      if self._writes else None)
            if self.mesh:
                bundle = self.mesh.broadcast_tensors(bundle)
            if bundle is not None:
                meta = self.load_train_state(bundle)
                self._replicate()
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
            with maybe_trace(traced):
                stats = self.train_epoch(
                    train_loader, 0.0 if epoch >= switch_off else 1.0,
                    log_interval)
            self.epoch_stats.append(stats)
            print(f"Epoch {epoch}: loss {stats['loss']:.4f} metric "
                  f"{stats['metric']:.4f} ({stats['clips_per_sec']:.1f} "
                  "clips/s)")
            score = self.evaluate(valid_loader, verbose=True,
                                  write_summary=True)
            scores.append(score)
            if self.checkpoint_dir is not None:
                # every rank takes part in gathering the generator states;
                # rank 0 alone enqueues the writes, and no rank waits
                state = self.train_state()
            if self.checkpoint_dir is not None and self._writes:
                if epoch % save_every == 0:
                    checkpoints.save_model(self.model_path(
                        fold, f"model_on_epoch_{epoch}"), self.model)
                    checkpoints.write_after_saves(functools.partial(
                        checkpoints.prune_epoch_checkpoints,
                        os.path.join(self.checkpoint_dir, f"fold_{fold}"),
                        keep))
                if score > best:
                    checkpoints.save_model(self.model_path(fold, "best_model"),
                                           self.model)
                checkpoints.save_bundle(self.bundle_path(fold), dict(
                    state,
                    meta={"epoch": epoch,
                          "best_score": float(max(best, score)),
                          "scores": [float(s) for s in scores],
                          "global_step": self.global_step}))
            best = max(best, score)
        for writer in (self.train_writer, self.valid_writer):
            if writer is not None:
                writer.close()
        checkpoints.wait_for_saves()
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

    @property
    def _writes(self) -> bool:
        """Rank 0 (or the single process) writes the files, and reads
        them."""
        return self.mesh is None or self.mesh.is_writer

    def save_model(self, fold: int, name: str) -> None:
        """Rank 0 writes ``fold``'s ``{name}.npz`` and returns once it is
        on disk (a one-off save, as the final model's, has no epoch to
        overlap); the other ranks do not wait."""
        if self._writes:
            checkpoints.save_model(self.model_path(fold, name), self.model)
            checkpoints.wait_for_saves()

    def load_model(self, fold: int, name: str) -> None:
        self._load_weights(self.model_path(fold, name))

    def _load_weights(self, path: str) -> None:
        """Rank 0 reads the ``.npz`` at ``path`` (once its writer has
        drained: ``checkpoints.load_model``); on a mesh the other ranks
        take its weights by broadcast and read no file (rank 0's files
        need not be theirs to see)."""
        if self._writes:
            checkpoints.load_model(path, self.model)
        self._replicate()

    def train_state(self) -> dict:
        """Everything a resumed fit needs to go on as if uninterrupted. On
        a mesh (every rank calls it) the generator states are every rank's,
        in rank order, beside ``world_size``."""
        rngs = (self.generator.get_state(), _default_rng_state(self.device))
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "accumulated": self._accumulated,
                 "micro_step": self.micro_step,
                 "updates": self.updates,
                 "global_step": self.global_step,
                 "augment_rng": rngs[0],
                 "dropout_rng": rngs[1]}
        if self.mesh:
            ranks = self.mesh.all_gather_object(rngs)
            state.update(augment_rng=[r[0] for r in ranks],
                         dropout_rng=[r[1] for r in ranks],
                         world_size=self.mesh.world_size)
        return state

    def load_train_state(self, bundle: dict) -> dict:
        """Load a ``train_state`` bundle; returns its progress meta. At the
        world size that wrote it each rank takes back its own generator
        states; at another one rank r reseeds its augmenter and dropout
        from ``mesh.resume_seed(seed, r, global_step)``."""
        self.model.load_state_dict(bundle["model"])
        self.optimizer.load_state_dict(bundle["optimizer"])
        acc = bundle["accumulated"]
        self._accumulated = (None if acc is None
                             else [t.to(self.device) for t in acc])
        self.micro_step = int(bundle["micro_step"])
        self.updates = int(bundle["updates"])
        self.global_step = int(bundle["global_step"])
        rank, world = ((self.mesh.rank, self.mesh.world_size) if self.mesh
                       else (0, 1))
        if bundle.get("world_size", 1) != world:
            self.reseed(mesh_lib.resume_seed(self.seed, rank,
                                             global_step=self.global_step))
            return bundle["meta"]
        augment_rng, dropout_rng = bundle["augment_rng"], bundle["dropout_rng"]
        if "world_size" in bundle:
            augment_rng, dropout_rng = augment_rng[rank], dropout_rng[rank]
        self.generator.set_state(augment_rng)
        _set_default_rng_state(self.device, dropout_rng)
        return bundle["meta"]

    def reseed(self, seed: int) -> None:
        """Seed the augmenter's generator and the device's default one
        (dropout's) with ``seed``."""
        self.generator.manual_seed(seed)
        _set_default_rng_state(self.device, torch.Generator(
            device=self.device).manual_seed(seed).get_state())

    def warm_start(self, path: str) -> None:
        """Load the weights and BatchNorm statistics of another
        experiment's fold ``.npz`` (JAX ``Engine.warm_start``); the
        optimizer state and the step count stay as they are."""
        self._load_weights(path)
