"""Fold-parallel training on one card: K folds trained together, one train
step over the K folds' stacked batch (JAX ``training/multifold.py``, its
one-device layout; the fold-sharded and fold x data layouts need more than
one card and wait for ROADMAP M5.1).

The JAX package stacks the K fold train states and ``vmap``s its step over
them. Here ``FoldStack`` holds the K folds' parameters and BatchNorm
statistics stacked along a leading fold axis (``torch.func.
stack_module_state``) and runs one model's forward on each fold's slice
under ``torch.func.vmap`` (``functional_call``; a batched convolution
weight is a grouped convolution with K groups). One backward over the
stacked leaves and one optimizer over them do the K folds' updates: Adam
(amsgrad) and SGD with coupled weight decay are elementwise, and so is the
engine's gradient mean, so each fold's slice of the optimizer state is its
own optimizer's. The loss is the sum of the folds' masked means, so each
fold's gradient is its own mean's.

A stacked step (``MultiFoldEngine.train_step``):

- augments each fold's rows apart, with that fold's own generator (seed
  ``seed + k``) and that fold's slice of the previous clean stacked batch as
  its MixUp partner pool: partners never cross folds, where another fold's
  train clips may be this fold's validation clips;
- runs the frontend (K1) once on the K x B rows, which is row-wise and so
  exact; K1 launches once per stacked step, not K times;
- then forward, loss, backward and optimizer through ``Engine._learn``,
  with cuDNN held to deterministic algorithms: for the grouped
  convolutions it otherwise picks a weight-gradient algorithm whose sums
  vary from run to run (on an NVIDIA H100, two stacked runs parted by
  2e-3 relative after 3 steps, and a resumed run could not repeat a
  straight one), where the single-fold convolutions' picks repeat.

Batches: each global step takes one batch of each fold's loader and
``stack_batches`` pads them to a common (rows, length): time with zeros
(the lengths keep featurization exact), rows by repeating the last row,
whose copies enter BatchNorm's batch statistics (as in JAX: the statistics
stay non-degenerate) and are masked out of the loss and the batch lwlrap.

Correctness parity with the sequential path:
- per-fold batches are PADDED to the largest fold batch (repeating the last
  row, mesh-padding style) and masked out of loss/metric — no clip is ever
  trimmed away;
- the lock-step epoch runs to the LONGEST fold loader, cycling shorter
  loaders. This is a DELIBERATE DIVERGENCE from the sequential path, not an
  equivalence: with unbalanced folds, a shorter fold sees extra re-drawn
  batches each epoch (up to len_longest - len_shortest, drawn from a fresh
  reshuffle), so its per-epoch sample distribution differs slightly and its
  optimizer takes more steps per epoch than sequentially. With near-equal
  fold sizes (the k-fold norm) the difference is a few batches per epoch;
  artifacts (checkpoints, metrics files) have the same schema and
  semantics, but per-fold training trajectories are NOT bit-identical to
  the sequential path;
- the folds start from the weights the sequential path gives them (the
  template's model, which ``cli/common.build_engine`` makes alike for every
  fold), or with a ``warm_start_path`` from that file: JAX's ``fit`` draws
  fresh weights and drops the warm start;
- resume (one stacked bundle, ``checkpoints/multifold_resume.pt``),
  periodic ``_save_every`` checkpoints, per-fold tensorboard writers and
  the files of each fold (``fold_k/{best_model,model_on_epoch_N}.npz``)
  match ``Engine.fit_validate``. The bundle keeps each fold loader's own
  epoch counter: a cycled loader advances it more than once an epoch,
  which JAX's resume (every counter set to the start epoch) loses.
"""

from __future__ import annotations

import contextlib
import copy
import os
from typing import List, Sequence

import numpy as np
import torch
from torch import nn

from freesound_classification_tpu_torch.ops import metrics as metrics_lib
from freesound_classification_tpu_torch.training import checkpoints
from freesound_classification_tpu_torch.training.engine import (
    Engine,
    _no_range,
)
from freesound_classification_tpu_torch.utils.profiling import (
    StepTimer,
    annotate,
    maybe_trace,
)

BUNDLE = "multifold_resume.pt"


def stack_batches(batches: Sequence[dict]) -> tuple:
    """Pad K per-fold batches to a common (largest batch, longest length)
    and stack each key to (K, B, ...) (JAX ``_stack_batches``): the signal
    is zero-padded in time, short batches repeat their last row. Each
    key is written once into its stacked array. Returns (stacked numpy
    dict, ``n_real`` (K,) int32, each fold's real rows)."""
    max_len = max(b["signal"].shape[1] for b in batches)
    max_bs = max(b["signal"].shape[0] for b in batches)
    n_real = np.array([b["signal"].shape[0] for b in batches], np.int32)
    out = {}
    for key in batches[0]:
        first = np.asarray(batches[0][key])
        tail = (max_len,) if key == "signal" else first.shape[1:]
        stacked = np.empty((len(batches), max_bs, *tail), first.dtype)
        for k, batch in enumerate(batches):
            x = np.asarray(batch[key])
            if key == "signal":
                stacked[k, :len(x), :x.shape[1]] = x
                stacked[k, :len(x), x.shape[1]:] = 0.0
            else:
                stacked[k, :len(x)] = x
            stacked[k, len(x):] = stacked[k, len(x) - 1]
        out[key] = stacked
    return out, n_real


def cycle_to(loader, n_steps: int):
    """Yield exactly ``n_steps`` batches, iterating ``loader`` again as
    often as needed (each pass a fresh epoch of its shuffles); an empty
    loader raises."""
    done = 0
    while done < n_steps:
        got = False
        for batch in loader:
            got = True
            yield batch
            done += 1
            if done >= n_steps:
                return
        if not got:
            raise ValueError("empty fold loader in fold-parallel training")


def _key(name: str) -> str:
    """A state_dict name as an attribute name of ``FoldStack``."""
    return name.replace(".", "__")


class FoldStack(nn.Module):
    """K copies of ``model`` as stacked parameters and buffers (leading fold
    axis), whose forward runs ``model``'s on each fold's slice of the
    inputs under ``torch.func.vmap``. The inputs and the logits are the
    folds' rows one after another, (K * B, ...). Dropout draws differ per
    fold (``randomness="different"``). BatchNorm's in-place update of the
    running statistics writes each fold's slice of the stacked buffers."""

    def __init__(self, model: nn.Module, n_folds: int):
        super().__init__()
        self.n_folds = n_folds
        params, buffers = torch.func.stack_module_state([model] * n_folds)
        self.param_names, self.buffer_names = list(params), list(buffers)
        for name, value in params.items():
            self.register_parameter(_key(name), nn.Parameter(value.detach()))
        for name, value in buffers.items():
            self.register_buffer(_key(name), value)
        # the model as a function of the tensors handed to it; a list keeps
        # it out of this module's parameters
        self._base = [copy.deepcopy(model).to("meta")]

    def train(self, mode: bool = True) -> "FoldStack":
        super().train(mode)
        self._base[0].train(mode)
        return self

    def stacked(self) -> tuple:
        """({name: (K, ...) parameter}, {name: (K, ...) buffer})."""
        return ({n: getattr(self, _key(n)) for n in self.param_names},
                {n: getattr(self, _key(n)) for n in self.buffer_names})

    def fold_state(self, k: int) -> dict:
        """Fold ``k``'s state_dict, views of the stacked tensors."""
        params, buffers = self.stacked()
        return {n: t[k].detach() for n, t in {**params, **buffers}.items()}

    @torch.no_grad()
    def load_fold(self, k: int, state_dict: dict) -> None:
        """Copy a state_dict of the model into fold ``k``'s slice."""
        params, buffers = self.stacked()
        for name, t in {**params, **buffers}.items():
            t[k].copy_(state_dict[name])

    def forward(self, inputs: torch.Tensor,
                frame_lengths: torch.Tensor) -> torch.Tensor:
        base = self._base[0]

        def one_fold(params, buffers, x, n):
            return torch.func.functional_call(base, (params, buffers), (x, n))

        params, buffers = self.stacked()
        logits = torch.func.vmap(one_fold, randomness="different")(
            params, buffers, inputs.unflatten(0, (self.n_folds, -1)),
            frame_lengths.unflatten(0, (self.n_folds, -1)))
        return logits.flatten(0, 1)


@contextlib.contextmanager
def _deterministic_cudnn(on: bool):
    """cuDNN held to deterministic algorithms within the block, if ``on``."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on or before
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


class MultiFoldEngine(Engine):
    """Trains the folds ``fold_ids`` together as one stacked model on the
    template's device. The template (``cli/common.build_engine``'s engine
    of one fold) gives the model, its initial weights, the frontend, the
    augmenter, the loss, the train config, the checkpoint, profile and
    summary settings; after the fit it is each fold's evaluator, with that
    fold's weights loaded into its model. ``deterministic`` (the default)
    runs each stacked step with cuDNN's deterministic algorithms."""

    def __init__(self, template: Engine, fold_ids: Sequence[int],
                 deterministic: bool = True):
        self.template = template
        self.fold_ids = list(fold_ids)
        self.deterministic = deterministic
        seed = template.generator.initial_seed()
        super().__init__(
            FoldStack(template.model, len(self.fold_ids)), template.frontend,
            template.train_config, augment=template.augment,
            checkpoint_dir=template.checkpoint_dir, seed=seed,
            device=template.device,
            warm_start_path=template.warm_start_path,
            profile_dir=template.profile_dir,
            summary_writer_factory=template._writer_factory)
        self.loss_fn = template.loss_fn
        self.generators = [
            torch.Generator(device=self.device).manual_seed(seed + k)
            for k in range(len(self.fold_ids))]
        self.fold_writers: list = []  # (train, valid) per fold, in a fit

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def train_step(self, wave: torch.Tensor, lengths: torch.Tensor,
                   labels: torch.Tensor, n_real: torch.Tensor,
                   aug_scale: float = 1.0,
                   partner: tuple | None = None) -> dict:
        """One stacked micro-batch of (K, B, ...) tensors whose first
        ``n_real[k]`` rows of fold k are real; returns (K,) ``loss`` and
        ``metric`` over each fold's real rows and the (K, B)
        ``per_sample`` losses."""
        self.model.train()
        if self.augment is not None and aug_scale > 0.0:
            with torch.no_grad(), self._stage("augment"):
                folds = [self.augment(
                    wave[k], lengths[k], labels[k], gen, aug_scale,
                    partner=(None if partner is None
                             else tuple(t[k] for t in partner)))
                    for k, gen in enumerate(self.generators)]
                wave, lengths, labels = (torch.stack(t) for t in zip(*folds))
        n_folds, rows = wave.shape[:2]
        mask = (torch.arange(rows, device=wave.device)[None, :]
                < n_real[:, None]).float()
        count = mask.sum(dim=1).clamp(min=1.0)

        def reduce(per_sample):
            per_fold = (per_sample.view(n_folds, rows) * mask).sum(1) / count
            return per_fold.sum(), per_fold

        with _deterministic_cudnn(self.deterministic):
            logits, per_sample, loss = self._learn(
                wave.flatten(0, 1), lengths.flatten(0, 1),
                labels.flatten(0, 1), reduce)
        with torch.no_grad():
            probs = torch.sigmoid(logits).view(n_folds, rows, -1)
            metric = torch.func.vmap(metrics_lib.lwlrap_torch)(
                labels, probs, mask)
        return {"loss": loss, "metric": metric,
                "per_sample": per_sample.view(n_folds, rows)}

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------

    def train_epoch(self, loaders: List, aug_scale: float = 1.0,
                    log_interval: int = 25) -> dict:
        """One lock-step pass to the longest fold loader, shorter ones
        cycled (see the module docstring). Returns the epoch's per-fold
        (K,) ``loss``, ``metric`` and real ``clips``, and its ``steps``,
        ``seconds`` and ``clips_per_sec`` (every fold's real clips)."""
        n_steps = max(len(loader) for loader in loaders)
        losses, batch_metrics = [], []
        clips = np.zeros(len(loaders), np.int64)
        timer = StepTimer()
        timer.start()
        for batch_idx, batches in enumerate(
                zip(*(cycle_to(loader, n_steps) for loader in loaders))):
            stacked, n_real = stack_batches(batches)
            wave, lengths, labels = self.to_device(stacked)
            # MixUp partners: the previous clean stacked batch of the same
            # shape, each fold's own slice of it
            pool_key = tuple(wave.shape)
            clean = (wave, lengths, labels)
            partner = self._mixup_pool.get(pool_key, clean)
            out = self.train_step(
                wave, lengths, labels,
                torch.as_tensor(n_real, device=self.device), aug_scale,
                partner)
            if self.augment is not None:
                self._mixup_pool[pool_key] = clean
            clips += n_real
            losses.append(out["loss"])
            batch_metrics.append(out["metric"])
            if batch_idx % log_interval == 0:
                loss = out["loss"].float().cpu().numpy()
                metric = out["metric"].float().cpu().numpy()
                print(f"step {self.global_step}: loss {np.round(loss, 4)} "
                      f"metric {np.round(metric, 4)}")
                for k, (writer, _) in enumerate(self.fold_writers):
                    if writer is not None:
                        writer.add_scalar("loss", float(loss[k]),
                                          self.global_step)
                        writer.add_scalar("metric", float(metric[k]),
                                          self.global_step)
        losses = torch.stack(losses).float().cpu().numpy()
        batch_metrics = torch.stack(batch_metrics).float().cpu().numpy()
        dt = timer.stop(int(clips.sum()))
        return {"loss": losses.mean(axis=0),
                "metric": np.nanmean(batch_metrics, axis=0),
                "clips": clips, "clips_per_sec": timer.clips_per_sec,
                "steps": len(losses), "seconds": dt}

    def to_template(self, k: int) -> Engine:
        """The template engine holding fold ``k``'s current weights."""
        self.template.model.load_state_dict(self.model.fold_state(k))
        return self.template

    def fit(self, train_loaders: List, valid_loaders: List, epochs: int,
            log_interval: int = 25, resume: bool = False) -> list:
        """Train every fold ``epochs`` epochs, validating each fold after
        each epoch through the template's ``evaluate``; save a fold's
        ``best_model.npz`` when its score improves, every fold's
        ``model_on_epoch_{epoch}.npz`` when ``epoch % _save_every == 0``
        (pruned to the newest ``_keep_checkpoints``) and the stacked resume
        bundle. With ``resume`` the bundle, where there is one, is loaded
        and training goes on from the epoch after it. Epoch 1 runs under
        ``maybe_trace(profile_dir)``. Returns each fold's best score;
        ``epoch_stats`` holds the epochs' ``train_epoch`` dicts."""
        if min(len(loader) for loader in train_loaders) == 0:
            raise ValueError(
                "a fold's train loader is empty: with drop_last batching "
                "every bucket had fewer clips than one batch; lower "
                "batch_size or use more data")
        steps_per_epoch = max(len(loader) for loader in train_loaders)
        factory = self._writer_factory
        self.fold_writers = [
            (factory(f, "train"), factory(f, "valid")) if factory else
            (None, None) for f in self.fold_ids]
        self.global_step = 0
        self._mixup_pool = {}
        self.make_optimizer(steps_per_epoch * epochs, steps_per_epoch)
        if self.warm_start_path:
            print(f"warm start of every fold from {self.warm_start_path}")
            self.template.warm_start(self.warm_start_path)
            for k in range(len(self.fold_ids)):
                self.model.load_fold(k, self.template.model.state_dict())
        cfg = self.train_config
        switch_off = int(getattr(cfg, "switch_off_augmentations_on", 10**9))
        save_every = int(getattr(cfg, "_save_every", 10**9))
        keep = int(getattr(cfg, "_keep_checkpoints", 0))
        best, start_epoch = [-np.inf] * len(self.fold_ids), 0
        meta = (self.load_stacked_bundle(train_loaders)
                if resume and self.checkpoint_dir is not None else None)
        if meta is not None:
            start_epoch = meta["epoch"] + 1
            best = list(meta["best"])
            print(f"resuming folds {self.fold_ids} from epoch "
                  f"{start_epoch} (best {np.round(best, 4)})")
        self.epoch_stats = []
        for epoch in range(start_epoch, epochs):
            traced = self.profile_dir if epoch == 1 else None
            self._stage = annotate if traced else _no_range
            try:
                with maybe_trace(traced):
                    stats = self.train_epoch(
                        train_loaders, 0.0 if epoch >= switch_off else 1.0,
                        log_interval)
            finally:
                self._stage = _no_range
            self.epoch_stats.append(stats)
            print(f"Epoch {epoch}: loss {np.round(stats['loss'], 4)} metric "
                  f"{np.round(stats['metric'], 4)} "
                  f"({stats['clips_per_sec']:.1f} clips/s)")
            for k, fold in enumerate(self.fold_ids):
                score = self.validate_fold(k, valid_loaders[k])
                if self.checkpoint_dir is None:
                    best[k] = max(best[k], score)
                    continue
                if epoch % save_every == 0:
                    self.template.save_model(fold, f"model_on_epoch_{epoch}")
                    checkpoints.prune_epoch_checkpoints(
                        os.path.join(self.checkpoint_dir, f"fold_{fold}"),
                        keep)
                if score > best[k]:
                    self.template.save_model(fold, "best_model")
                best[k] = max(best[k], score)
            if self.checkpoint_dir is not None:
                self.save_stacked_bundle(epoch, best, train_loaders)
        for writers in self.fold_writers:
            for writer in writers:
                if writer is not None:
                    writer.close()
        return best

    def validate_fold(self, k: int, valid_loader) -> float:
        """Fold ``k``'s validation lwlrap by the template's ``evaluate`` on
        its current weights, written to its valid writer."""
        template = self.to_template(k)
        template.global_step = self.global_step
        template.valid_writer = self.fold_writers[k][1]
        print(f"fold {self.fold_ids[k]}:")
        try:
            return template.evaluate(valid_loader, verbose=True,
                                     write_summary=True)
        finally:
            template.valid_writer = None

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def stacked_bundle_path(self) -> str:
        return os.path.join(self.checkpoint_dir, BUNDLE)

    def save_stacked_bundle(self, epoch: int, best: Sequence[float],
                            loaders: List) -> None:
        """Write the stacked resume bundle: ``train_state``, each fold
        loader's epoch counter and the progress ``{epoch, best,
        global_step}``, in one atomic step."""
        checkpoints.save_bundle(self.stacked_bundle_path(), dict(
            self.train_state(),
            loader_epochs=[int(getattr(loader, "_epoch", 0))
                           for loader in loaders],
            meta={"epoch": int(epoch), "best": [float(b) for b in best],
                  "global_step": self.global_step}))

    def load_stacked_bundle(self, loaders: List) -> dict | None:
        """Load the stacked bundle, where there is one, and set each fold
        loader's epoch counter from it; returns its progress meta."""
        bundle = checkpoints.load_bundle(self.stacked_bundle_path())
        if bundle is None:
            return None
        for loader, epoch in zip(loaders, bundle["loader_epochs"]):
            loader._epoch = epoch
        return self.load_train_state(bundle)

    def save_fold_models(self, name: str) -> None:
        """Every fold's current weights as ``fold_k/{name}.npz``."""
        for k, fold in enumerate(self.fold_ids):
            self.to_template(k).save_model(fold, name)

    def train_state(self) -> dict:
        """``Engine.train_state`` and each fold's augmenter generator."""
        return dict(super().train_state(),
                    fold_augment_rngs=[g.get_state()
                                       for g in self.generators])

    def load_train_state(self, bundle: dict) -> dict:
        for gen, state in zip(self.generators, bundle["fold_augment_rngs"]):
            gen.set_state(state)
        return super().load_train_state(bundle)
