"""Fold-parallel training: K folds trained together, one train step over
the K folds' stacked batch (JAX ``training/multifold.py``), on one card or
over several ranks in JAX's fold layouts.

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
- every save goes through ``checkpoints``' writer thread (each fold's
  files, then the bundle, in that order; a snapshot on the loop), and a
  fit returns once they are written;
- resume (one stacked bundle, ``checkpoints/multifold_resume.pt``),
  periodic ``_save_every`` checkpoints, per-fold tensorboard writers and
  the files of each fold (``fold_k/{best_model,model_on_epoch_N}.npz``)
  match ``Engine.fit_validate``. The bundle keeps each fold loader's own
  epoch counter: a cycled loader advances it more than once an epoch,
  which JAX's resume (every counter set to the start epoch) loses.

Over several ranks (``FoldMesh``, under ``torchrun``): ``fold_layout``
picks JAX's ``make_fold_dp_mesh(K, layout="auto")`` layout for K folds on
n ranks: f fold groups of d ranks, f the largest divisor of K at most n,
where f x d == n, else the fold-local layout (one group of all n ranks
holding every fold, f 1 and d n). Rank r trains the K / f folds of its
group, a slice of ``--folds``, with this engine, the same stacked states
on each of the group's d ranks. What makes a rank's folds train as in
the one-process stack of all K:

- fold k's augmenter generator starts from ``seed + k``, k its position
  in the whole fold list (``+ RANK_SEED_STRIDE * j`` at place j of a
  group of d > 1: place 0 keeps it);
- an epoch runs to the longest loader of all K folds (gathered once a
  fit), and so does the 1cycle schedule's ``steps_per_epoch``;
- each step pads to the (rows, length) of all K folds' batches, gathered
  in one small all-gather (padded rows enter BatchNorm's statistics, so a
  rank-local pad would change the results), the rows rounded up to a
  multiple of d (JAX's ``row_multiple``);
- the job writes one stacked bundle, ``multifold_resume.pt``, as the
  one process stacking all K folds writes it (JAX's one bundle of all
  folds, ``multifold.py:500-509``): each fold group's place 0 sends its
  folds' slices of the stacked model, optimizer state and gradient mean
  to world rank 0, tensor by tensor, and rank 0 writes the file in one
  atomic rename, so no kill leaves folds at two epochs; rank 0 enqueues
  it once the other ranks have drained their checkpoint writers, so the
  bundle never lands ahead of an epoch's fold files. Beside them: the
  layout, each fold's best score, loader epoch and every place's
  augmenter generator, and every rank's dropout generator. ``resume``
  takes it under any layout (JAX re-shards its bundle, ``_shard_states``):
  world rank 0 reads it and every rank takes its folds' slices by
  broadcast. Under the layout that wrote it every place takes back its
  generators; under another, fold k at place j draws from
  ``mesh.resume_seed(seed, k, j, global_step)`` and rank r's dropout from
  ``resume_seed(seed, r, global_step)``;
- rank 0 prints each epoch's line over all K folds, each fold counted
  once. The checkpoint directory is one the ranks share.

A group of d > 1 ranks (JAX's ``P("fold", "data")``, or ``P(None,
"data")`` fold-local, inside its ``shard_map`` over "fold") is the data
parallel of ``training/engine.py`` over the group, per fold: every place
builds the same padded stacked batch from the folds' own unsharded loaders
and takes its contiguous 1/d of every fold's rows (``FoldLayout.rows``);
BatchNorm's statistics go through the group's all-reduce inside the vmap
(``mesh.all_reduce_sum``'s vmap rule: one collective a layer for all of
the rank's folds); each fold's loss is its masked sum over the rank's rows
over the fold's real rows in the whole batch, and the stacked gradients
with the (K,) reported loss are summed over the group in one buffer
(``Engine._learn``); the batch lwlrap gathers the group's rows. Each
place's chain takes its share of the fold's ``round(p B)`` rows
(``augment.effects_count``), and MixUp partners come from the rank's own
rows (JAX's are the fold's whole batch). The template engine, on the fold
group, validates and predicts data parallel over it; the group's place 0
writes the fold files and the summaries, and sends its folds' part of
the bundle.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import glob
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from freesound_classification_tpu_torch.models.blocks import (
    BatchNorm,
    MaskedBiGRU,
)
from freesound_classification_tpu_torch.ops import metrics as metrics_lib
from freesound_classification_tpu_torch.parallel import mesh as mesh_lib
from freesound_classification_tpu_torch.training import checkpoints
from freesound_classification_tpu_torch.training.engine import (
    Engine,
    _default_rng_state,
    _set_default_rng_state,
)
from freesound_classification_tpu_torch.utils.profiling import (
    StepTimer,
    maybe_trace,
)

BUNDLE = "multifold_resume.pt"


# ---------------------------------------------------------------------------
# layouts over ranks
# ---------------------------------------------------------------------------


def fold_axis_size(n_folds: int, n_ranks: int) -> int:
    """The largest divisor of ``n_folds`` at most ``n_ranks`` (JAX
    ``_fold_axis_size``)."""
    for f in range(min(n_ranks, n_folds), 0, -1):
        if n_folds % f == 0:
            return f
    return 1


@dataclass(frozen=True)
class FoldLayout:
    """K folds on n ranks as JAX's ``make_fold_dp_mesh`` lays them out:
    ``kind`` "fold_dp" is an (f, d) = ("fold", "data") mesh, rank r in
    fold group r // d at place r % d, the group owning the folds at
    positions [g K / f, (g + 1) K / f) of the fold list; "fold_local" is
    the 1-D ("data",) mesh of all n ranks, every one holding all K folds
    (f 1, d n)."""
    n_folds: int
    n_ranks: int
    f: int
    d: int
    kind: str

    @property
    def axis_names(self) -> tuple:
        return ("fold", "data") if self.kind == "fold_dp" else ("data",)

    @property
    def shape(self) -> tuple:
        return (self.f, self.d) if self.kind == "fold_dp" else (self.n_ranks,)

    def describe(self) -> str:
        ranks = f"{self.n_ranks} rank{'s' if self.n_ranks > 1 else ''}"
        if self.kind == "fold_local":
            return f"fold-local (all {self.n_folds} folds on each of {ranks})"
        return f"{self.f} x {self.d} (fold x data) on {ranks}"

    def positions(self, rank: int) -> range:
        """The positions in the fold list of the folds ``rank`` owns."""
        per = self.n_folds // self.f
        start = (rank // self.d if self.kind == "fold_dp" else 0) * per
        return range(start, start + per)

    def place(self, rank: int) -> int:
        """``rank``'s place in its fold group: its index on "data"."""
        return rank % self.d

    def rows(self, rank: int, n_rows: int) -> slice:
        """The rows ``rank`` takes of each of its folds in a stacked batch
        of ``n_rows`` (a multiple of d): its contiguous 1/d, where JAX's
        ``P("fold", "data")`` (``P(None, "data")`` fold-local) puts them."""
        per = n_rows // self.d
        start = self.place(rank) * per
        return slice(start, start + per)

    def group_ranks(self) -> list:
        """Each fold group's ranks, in group order."""
        return [list(range(g * self.d, (g + 1) * self.d))
                for g in range(self.f)]


def fold_layout(n_folds: int, n_ranks: int) -> FoldLayout:
    """JAX's ``make_fold_dp_mesh(n_folds, layout="auto")`` over ``n_ranks``
    devices: f = ``fold_axis_size``, d = n // f, the (fold, data) mesh
    where f x d == n, else the fold-local layout."""
    f = fold_axis_size(n_folds, n_ranks)
    d = max(1, n_ranks // f)
    if f * d < n_ranks:
        return FoldLayout(n_folds, n_ranks, 1, n_ranks, "fold_local")
    return FoldLayout(n_folds, n_ranks, f, d, "fold_dp")


def layout_record(layout: FoldLayout, folds: Sequence[int]) -> str:
    """What a stacked bundle records of the layout that wrote it."""
    return f"{layout.describe()}, folds {list(folds)}"


@dataclass(frozen=True)
class FoldMesh:
    """A rank's place in a fold-parallel job: the ``layout`` of the run's
    ``folds`` over ``world``'s ranks, and ``group``, the rank's fold group
    of d ranks (``MultiFoldEngine`` runs the group's collectives inside the
    step where d > 1)."""
    layout: FoldLayout
    folds: tuple
    world: mesh_lib.Mesh
    group: mesh_lib.Mesh

    @property
    def positions(self) -> range:
        return self.layout.positions(self.world.rank)

    @property
    def own_folds(self) -> list:
        """The folds this rank trains, in ``folds`` order."""
        return [self.folds[i] for i in self.positions]

    @property
    def data_group(self) -> Optional[mesh_lib.Mesh]:
        """The fold group where its rows go over d > 1 ranks, else None
        (whole folds on each rank: no collective inside the step)."""
        return self.group if self.layout.d > 1 else None


def make_fold_mesh(world: mesh_lib.Mesh, folds: Sequence[int]) -> FoldMesh:
    """The rank's ``FoldMesh`` for ``folds`` over ``world`` (a distributed
    ``parallel.mesh.Mesh``; every rank calls this): JAX's layout, and the
    f fold groups of d ranks."""
    layout = fold_layout(len(folds), world.world_size)
    group = mesh_lib.sub_mesh(world, layout.group_ranks())
    return FoldMesh(layout, tuple(folds), world, group)


def bundle_layout(bundle: dict, folds: Sequence[int]) -> str:
    """The layout a stacked bundle records; a bundle from before layouts
    were recorded is the one-process stack of ``folds``."""
    return bundle.get("layout") or layout_record(fold_layout(len(folds), 1),
                                                 folds)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def stack_batches(batches: Sequence[dict],
                  shape: Optional[tuple] = None,
                  row_multiple: int = 1) -> tuple:
    """Pad K per-fold batches to a common (largest batch, longest length),
    or to ``shape`` = (rows, length) where it is larger, the rows rounded
    up to a multiple of ``row_multiple`` (a fold group's d ranks), and
    stack each key to (K, B, ...) (JAX ``_stack_batches``): the signal is
    zero-padded in time, short batches repeat their last row. Each key is
    written once into its stacked array. Returns (stacked numpy dict,
    ``n_real`` (K,) int32, each fold's real rows)."""
    rows, length = shape if shape is not None else (0, 0)
    max_len = max([length] + [b["signal"].shape[1] for b in batches])
    max_bs = max([rows] + [b["signal"].shape[0] for b in batches])
    max_bs += (-max_bs) % row_multiple
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
    inputs under ``torch.func.vmap``. An ``rnn`` model's GRUs run there on
    ``MaskedBiGRU``'s "scan" route (the "fused" one, ``torch._VF.gru``,
    has no batching rule and raises under vmap), the same function. The inputs and the logits are the
    folds' rows one after another, (K * B, ...). Dropout draws differ per
    fold (``randomness="different"``). BatchNorm's in-place update of the
    running statistics writes each fold's slice of the stacked buffers; on
    a fold group (``set_group``) its statistics are the group's rows'."""

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
        # it out of this module's parameters. Its GRUs take their step-by-
        # step route: vmap has no batching rule for the fused GRU's op. A
        # BatchNorm's process group is not copied: the engine sets the
        # stack's (``set_group``)
        base = copy.deepcopy(model, {
            id(m.group): None for m in model.modules()
            if isinstance(m, BatchNorm) and m.group is not None}).to("meta")
        for module in base.modules():
            if isinstance(module, MaskedBiGRU):
                module.route = "scan"
        self._base = [base]

    def set_group(self, group) -> None:
        """Train-mode BatchNorm takes its statistics over ``group``'s ranks
        (a process group; None: this rank's rows)."""
        for module in self._base[0].modules():
            if isinstance(module, BatchNorm):
                module.group = group

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
    runs each stacked step with cuDNN's deterministic algorithms. On a
    ``fold_mesh`` the engine is a rank of a fold-parallel job and
    ``fold_ids`` are the rank's own folds (the module docstring); where
    the rank's fold group has d > 1 ranks, ``self.mesh`` is that group and
    the template must be an engine on it (``cli/common.build_engine(...,
    mesh=fold_mesh.group)``), which validates and writes for the group."""

    def __init__(self, template: Engine, fold_ids: Sequence[int],
                 deterministic: bool = True,
                 fold_mesh: Optional[FoldMesh] = None):
        self.template = template
        self.fold_ids = list(fold_ids)
        self.deterministic = deterministic
        self.fold_mesh = fold_mesh
        positions, group = range(len(self.fold_ids)), None
        if fold_mesh is not None:
            if self.fold_ids != fold_mesh.own_folds:
                raise ValueError(f"folds {self.fold_ids} on a rank that owns "
                                 f"{fold_mesh.own_folds}")
            positions, group = fold_mesh.positions, fold_mesh.data_group
            if group is not None and template.mesh != group:
                raise ValueError(
                    f"a fold group of {group.world_size} ranks needs a "
                    "template engine on that group (mesh=fold_mesh.group): "
                    "it validates, predicts and writes for the group")
        seed = template.generator.initial_seed()
        if group is not None:  # the template's is its rank's seed
            seed -= mesh_lib.RANK_SEED_STRIDE * group.rank
        super().__init__(
            FoldStack(template.model, len(self.fold_ids)), template.frontend,
            template.train_config, augment=template.augment,
            checkpoint_dir=template.checkpoint_dir, seed=seed,
            device=template.device,
            warm_start_path=template.warm_start_path,
            profile_dir=template.profile_dir,
            summary_writer_factory=template._writer_factory, mesh=group)
        self.loss_fn = template.loss_fn
        self.positions = positions  # of the rank's folds in the job's list
        # fold k of the whole fold list draws from seed + k, at place j of
        # a fold group from seed + k + RANK_SEED_STRIDE * j
        self.generators = [
            torch.Generator(device=self.device).manual_seed(
                self.mesh.rank_seed(seed + k) if self.mesh else seed + k)
            for k in positions]
        self.fold_writers: list = []  # (train, valid) per fold, in a fit

    def _replicate(self) -> None:
        """``Engine._replicate``, and the stack's BatchNorms (in the model
        it runs under vmap) take their statistics over the fold group."""
        super()._replicate()
        self.model.set_group(self.mesh.group if self.mesh else None)

    @property
    def _shard(self) -> Optional[tuple]:
        """(place, d) on a fold group of d > 1 ranks, else None."""
        return (self.mesh.rank, self.mesh.world_size) if self.mesh else None

    # ------------------------------------------------------------------
    # the job's ranks
    # ------------------------------------------------------------------

    def all_ranks(self, obj) -> list:
        """Every rank's ``obj``, in rank order (``[obj]`` alone)."""
        if self.fold_mesh is None:
            return [obj]
        return self.fold_mesh.world.all_gather_object(obj)

    def epoch_steps(self, loaders: List) -> int:
        """The steps of an epoch: the longest loader of all the job's
        folds. Every rank raises where any fold's loader is empty."""
        lengths = sum(self.all_ranks([len(loader) for loader in loaders]),
                      [])
        if min(lengths) == 0:
            raise ValueError(
                "a fold's train loader is empty: with drop_last batching "
                "every bucket had fewer clips than one batch; lower "
                "batch_size or use more data")
        return max(lengths)

    def step_shape(self, batches: Sequence[dict]) -> Optional[tuple]:
        """The (rows, length) every rank pads this step's batches to, the
        largest of all the job's folds', in one all-gather of each rank's
        pairs (``stack_batches`` rounds the rows up to a multiple of d);
        None alone (``stack_batches`` takes the local largest)."""
        if self.fold_mesh is None:
            return None
        world = self.fold_mesh.world
        local = torch.tensor([b["signal"].shape[:2] for b in batches],
                             dtype=torch.int64, device=world.device)
        rows, length = mesh_lib.all_gather_rows(
            local, world.group).amax(dim=0).tolist()
        return rows, length

    def stack_step(self, batches: Sequence[dict]) -> tuple:
        """``stack_batches`` of the rank's folds' ``batches`` to the job's
        ``step_shape``, the rows a multiple of d; on a fold group of d > 1
        ranks, this place's rows of every fold (``FoldLayout.rows``).
        Returns (stacked numpy dict, each fold's real rows in the whole
        stacked batch)."""
        if self.mesh is None:
            return stack_batches(batches, self.step_shape(batches))
        stacked, n_real = stack_batches(batches, self.step_shape(batches),
                                        row_multiple=self.mesh.world_size)
        rows = self.fold_mesh.layout.rows(self.fold_mesh.world.rank,
                                          stacked["signal"].shape[1])
        return {k: v[:, rows] for k, v in stacked.items()}, n_real

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
        ``per_sample`` losses. On a fold group of d ranks the tensors are
        this place's B rows of a stacked batch of d B, whose first
        ``n_real[k]`` rows of fold k are real; the loss and the metric are
        the whole batch's."""
        self.model.train()
        if self.augment is not None and aug_scale > 0.0:
            with torch.no_grad(), self._stage("augment"):
                folds = [self.augment(
                    wave[k], lengths[k], labels[k], gen, aug_scale,
                    partner=(None if partner is None
                             else tuple(t[k] for t in partner)),
                    shard=self._shard)
                    for k, gen in enumerate(self.generators)]
                wave, lengths, labels = (torch.stack(t) for t in zip(*folds))
        n_folds, rows = wave.shape[:2]
        first = self.mesh.rank * rows if self.mesh else 0
        mask = ((first + torch.arange(rows, device=wave.device))[None, :]
                < n_real[:, None]).float()
        count = n_real.to(mask.dtype).clamp(min=1.0)

        def reduce(per_sample):
            per_fold = (per_sample.view(n_folds, rows) * mask).sum(1) / count
            return per_fold.sum(), per_fold

        with _deterministic_cudnn(self.deterministic):
            logits, per_sample, loss = self._learn(
                wave.flatten(0, 1), lengths.flatten(0, 1),
                labels.flatten(0, 1), reduce)
        with torch.no_grad():
            probs = torch.sigmoid(logits).view(n_folds, rows, -1)
            if self.mesh is not None:  # the whole stacked batch's rows
                total = rows * self.mesh.world_size
                probs, labels = (
                    t.view(total, n_folds, -1).transpose(0, 1).float()
                    for t in self._gather_rows(
                        total, *(b.transpose(0, 1).flatten(1)
                                 for b in (probs, labels))))
                mask = (torch.arange(total, device=wave.device)[None, :]
                        < n_real[:, None]).float()
            metric = torch.func.vmap(metrics_lib.lwlrap_torch)(
                labels, probs, mask)
        return {"loss": loss, "metric": metric,
                "per_sample": per_sample.view(n_folds, rows)}

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------

    def train_epoch(self, loaders: List, aug_scale: float = 1.0,
                    log_interval: int = 25,
                    n_steps: Optional[int] = None) -> dict:
        """One lock-step pass of ``n_steps`` (by default ``epoch_steps``:
        to the longest fold loader), shorter loaders cycled (see the module
        docstring). Returns the epoch's per-fold (K,) ``loss``, ``metric``
        and real ``clips``, and its ``steps``, ``seconds`` and
        ``clips_per_sec`` (every fold's real clips)."""
        if n_steps is None:
            n_steps = self.epoch_steps(loaders)
        losses, batch_metrics = [], []
        clips = np.zeros(len(loaders), np.int64)
        timer = StepTimer()
        timer.start()
        for batch_idx, batches in enumerate(
                zip(*(cycle_to(loader, n_steps) for loader in loaders))):
            stacked, n_real = self.stack_step(batches)
            wave, lengths, labels = self.to_device(stacked)
            # MixUp partners: the previous clean stacked batch of the same
            # shape (the job's: every rank pads to it), each fold's own
            # slice of it (this place's rows of it on a fold group)
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
        ``epoch_stats`` holds the epochs' ``train_epoch`` dicts. On a fold
        mesh every rank calls this with its own folds' loaders."""
        steps_per_epoch = self.epoch_steps(train_loaders)
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
            with maybe_trace(traced):
                stats = self.train_epoch(
                    train_loaders, 0.0 if epoch >= switch_off else 1.0,
                    log_interval, n_steps=steps_per_epoch)
            self.epoch_stats.append(stats)
            scores = []
            for k, fold in enumerate(self.fold_ids):
                # the template holds fold k's weights from here to its saves
                score = self.validate_fold(k, valid_loaders[k])
                scores.append(score)
                if self.checkpoint_dir is None:
                    best[k] = max(best[k], score)
                    continue
                if epoch % save_every == 0:
                    self.enqueue_fold_model(fold, f"model_on_epoch_{epoch}")
                    if self._writes:
                        checkpoints.write_after_saves(functools.partial(
                            checkpoints.prune_epoch_checkpoints,
                            os.path.join(self.checkpoint_dir,
                                         f"fold_{fold}"), keep))
                if score > best[k]:
                    self.enqueue_fold_model(fold, "best_model")
                best[k] = max(best[k], score)
            self.print_epoch(epoch, stats, scores)
            if self.checkpoint_dir is not None:
                self.save_stacked_bundle(epoch, best, train_loaders)
        for writers in self.fold_writers:
            for writer in writers:
                if writer is not None:
                    writer.close()
        checkpoints.wait_for_saves()
        return best

    def enqueue_fold_model(self, fold: int, name: str) -> None:
        """The template's weights (fold ``fold``'s, loaded by
        ``to_template``) as ``fold_{fold}/{name}.npz``, on the writer from
        a snapshot taken now, where this rank writes."""
        if self._writes:
            checkpoints.save_model(self.template.model_path(fold, name),
                                   self.template.model)

    def print_epoch(self, epoch: int, stats: dict, scores: list) -> None:
        """The epoch's line over every fold of the job (JAX's ``epoch N:
        loss [...] val [...]``): the train loss and batch lwlrap, the
        validation lwlrap, and the clips/s of all fold groups together,
        each group's numbers from its place 0."""
        rows = self.all_ranks((self.mesh.rank if self.mesh else 0,
                               stats["loss"].tolist(),
                               stats["metric"].tolist(), list(scores),
                               float(stats["clips_per_sec"])))
        rows = [r[1:] for r in rows if r[0] == 0]
        loss, metric, val = (np.array(sum((r[i] for r in rows), []))
                             for i in range(3))
        print(f"Epoch {epoch}: loss {np.round(loss, 4)} metric "
              f"{np.round(metric, 4)} val {np.round(val, 4)} "
              f"({sum(r[3] for r in rows):.1f} clips/s)")

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

    @property
    def job_folds(self) -> list:
        """Every fold of the job, in ``--folds`` order."""
        return list(self.fold_mesh.folds if self.fold_mesh is not None
                    else self.fold_ids)

    @property
    def layout_record(self) -> str:
        """The layout this engine's bundles record."""
        layout = (self.fold_mesh.layout if self.fold_mesh is not None
                  else fold_layout(len(self.fold_ids), 1))
        return layout_record(layout, self.job_folds)

    @property
    def world(self) -> Optional[mesh_lib.Mesh]:
        """The job's ranks (None alone)."""
        return self.fold_mesh.world if self.fold_mesh is not None else None

    def stacked_bundle_path(self) -> str:
        return os.path.join(self.checkpoint_dir, BUNDLE)

    def fold_tensors(self) -> dict:
        """This rank's stacked tensors with a fold axis first, by name:
        the model's state (``model/<name>``), the optimizer's state of each
        parameter i (``optimizer/<i>/<name>``: all but Adam's shared step)
        and the gradient mean (``accumulated/<i>``)."""
        out = {f"model/{n}": t for n, t in self.model.state_dict().items()}
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        for i, p in enumerate(params):
            for name, t in self.optimizer.state.get(p, {}).items():
                if torch.is_tensor(t) and t.dim() > 0:
                    out[f"optimizer/{i}/{name}"] = t
        for i, t in enumerate(self._accumulated or []):
            out[f"accumulated/{i}"] = t
        return out

    def gather_fold_tensors(self) -> Optional[dict]:
        """On world rank 0 (or alone) ``fold_tensors`` of every fold of
        the job, in ``--folds`` order, on the device that carries the
        world's messages (``Mesh.wire``); None on the other ranks. Each
        fold group's place 0 but rank 0's own sends its slices to rank 0,
        tensor by tensor (a fold of the bench's 2d model is 34 MB of
        weights, and Adam's state three times that)."""
        local = self.fold_tensors()
        world = self.world
        if world is None:
            return local
        layout, rank = self.fold_mesh.layout, world.rank
        owners = [g[0] for g in layout.group_ranks()]
        if rank != 0:
            if rank in owners:
                for t in local.values():
                    dist.send(t.detach().to(world.wire).contiguous(),
                              dst=dist.get_global_rank(world.group, 0),
                              group=world.group)
            return None
        full = {}
        for name, t in local.items():
            full[name] = torch.empty((layout.n_folds, *t.shape[1:]),
                                     dtype=t.dtype, device=world.wire)
            full[name][:len(t)].copy_(t.detach())
        for owner in owners[1:]:
            held = layout.positions(owner)
            for out in full.values():
                dist.recv(out[held.start:held.stop],
                          src=dist.get_global_rank(world.group, owner),
                          group=world.group)
        return full

    def save_stacked_bundle(self, epoch: int, best: Sequence[float],
                            loaders: List) -> None:
        """Write the job's stacked bundle (the module docstring) in one
        atomic step: every fold's model and optimizer state, gradient mean,
        best score, loader epoch counter and every place's augmenter
        generator, every rank's dropout generator, the layout and the
        progress ``{epoch, best, global_step}``. Every rank takes part;
        world rank 0 enqueues the write, once the other ranks have drained
        their writers after the gather (which their writes overlap), so
        that the bundle never lands ahead of a fold file of its epoch
        (rank 0's own are ahead of it in its queue)."""
        place = self.mesh.rank if self.mesh else 0
        ranks = self.all_ranks({
            "positions": list(self.positions), "place": place,
            "rngs": [g.get_state() for g in self.generators],
            "dropout": _default_rng_state(self.device),
            "best": [float(b) for b in best],
            "epochs": [int(getattr(loader, "_epoch", 0))
                       for loader in loaders]})
        tensors = self.gather_fold_tensors()
        if self.world is not None:
            if self.world.rank != 0:
                checkpoints.wait_for_saves()
            self.all_ranks(None)  # every rank's fold files are on disk
        if tensors is None:
            return
        n, d = len(self.job_folds), max(r["place"] for r in ranks) + 1
        rngs = [[None] * d for _ in range(n)]
        fold_best, loader_epochs = [None] * n, [None] * n
        for r in ranks:
            for k, state, b, e in zip(r["positions"], r["rngs"], r["best"],
                                      r["epochs"]):
                rngs[k][r["place"]] = state
                fold_best[k], loader_epochs[k] = b, e
        optimizer = self.optimizer.state_dict()
        optimizer["state"] = {
            i: {name: tensors.get(f"optimizer/{i}/{name}", t)
                for name, t in state.items()}
            for i, state in optimizer["state"].items()}
        checkpoints.save_bundle(self.stacked_bundle_path(), {
            "model": {n: tensors[f"model/{n}"]
                      for n in self.model.state_dict()},
            "optimizer": optimizer,
            "accumulated": (None if self._accumulated is None else
                            [tensors[f"accumulated/{i}"]
                             for i in range(len(self._accumulated))]),
            "micro_step": self.micro_step, "updates": self.updates,
            "global_step": self.global_step,
            "folds": self.job_folds, "layout": self.layout_record,
            "fold_augment_rngs": rngs,
            "dropout_rng": [r["dropout"] for r in ranks],
            "loader_epochs": loader_epochs,
            "meta": {"epoch": int(epoch), "best": fold_best,
                     "global_step": self.global_step}})

    def read_stacked_bundle(self) -> Optional[dict]:
        """The job's stacked bundle on every rank (None where there is
        none): world rank 0 reads it and the others take it by
        ``Mesh.broadcast_tensors``. A checkpoint directory with only the
        per-group bundles of earlier versions of the port is refused on
        every rank, naming them."""
        bundle, refused = None, None
        if self.world is None or self.world.rank == 0:
            path = self.stacked_bundle_path()
            old = sorted(os.path.basename(p) for p in glob.glob(
                os.path.join(self.checkpoint_dir,
                             "multifold_resume_folds_*.pt")))
            if old and not os.path.isfile(path):
                refused = (
                    f"{self.checkpoint_dir} holds only per-group stacked "
                    f"bundles ({', '.join(old)}), which this version of "
                    f"the port does not read (it resumes from one {BUNDLE} "
                    "of the whole job): start the run afresh, without "
                    "--resume")
            else:
                bundle = checkpoints.load_bundle(path)
        if self.world is not None:
            refused = self.world.broadcast_object(refused)
            bundle = self.world.broadcast_tensors(bundle)
        if refused:
            raise ValueError(refused)
        return bundle

    def load_stacked_bundle(self, loaders: List) -> dict | None:
        """Load the job's stacked bundle, where there is one, into this
        rank's folds under any layout (``load_train_state``) and set each
        fold loader's epoch counter from it; returns its progress meta."""
        bundle = self.read_stacked_bundle()
        if bundle is None:
            return None
        meta = self.load_train_state(bundle)
        for loader, k in zip(loaders, self.positions):
            loader._epoch = bundle["loader_epochs"][k]
        return dict(meta, best=[meta["best"][k] for k in self.positions])

    def save_fold_models(self, name: str) -> None:
        """Every fold's current weights as ``fold_k/{name}.npz``, on disk
        when this returns."""
        for k, fold in enumerate(self.fold_ids):
            self.to_template(k)
            self.enqueue_fold_model(fold, name)
        checkpoints.wait_for_saves()

    def load_train_state(self, bundle: dict) -> dict:
        """Load this rank's folds' slices of a stacked bundle of the job
        (every fold, in ``--folds`` order); returns its progress meta.
        Under the layout that wrote it every place takes back its
        generators; under another fold k at place j reseeds from
        ``mesh.resume_seed(seed, k, j, global_step)``, and rank r's dropout
        from ``resume_seed(seed, r, global_step)``."""
        folds = bundle.get("folds", self.job_folds)
        if list(folds) != self.job_folds:
            raise ValueError(f"the stacked bundle holds folds {list(folds)} "
                             f"and this run trains {self.job_folds}")
        own = slice(self.positions.start, self.positions.stop)

        def mine(t):
            return t[own].clone()

        self.model.load_state_dict({n: mine(t)
                                    for n, t in bundle["model"].items()})
        optimizer = dict(bundle["optimizer"])
        optimizer["state"] = {
            i: {name: mine(t) if torch.is_tensor(t) and t.dim() > 0 else t
                for name, t in state.items()}
            for i, state in optimizer["state"].items()}
        self.optimizer.load_state_dict(optimizer)
        acc = bundle["accumulated"]
        self._accumulated = (None if acc is None
                             else [mine(t).to(self.device) for t in acc])
        self.micro_step = int(bundle["micro_step"])
        self.updates = int(bundle["updates"])
        self.global_step = int(bundle["global_step"])
        place = self.mesh.rank if self.mesh else 0
        rank = self.world.rank if self.world is not None else 0
        if bundle_layout(bundle, self.job_folds) == self.layout_record:
            # each fold's states, one a place; a bundle without ``folds``
            # is an earlier version's of one process: a state a fold
            rngs = bundle["fold_augment_rngs"]
            if "folds" not in bundle:
                rngs = [[state] for state in rngs]
            for gen, k in zip(self.generators, self.positions):
                gen.set_state(rngs[k][place])
            dropout = bundle["dropout_rng"]
            _set_default_rng_state(self.device, dropout[rank]
                                   if isinstance(dropout, list) else dropout)
        else:
            step = self.global_step
            for gen, k in zip(self.generators, self.positions):
                gen.manual_seed(mesh_lib.resume_seed(self.seed, k, place,
                                                     global_step=step))
            self.reseed(mesh_lib.resume_seed(self.seed, rank,
                                             global_step=step))
        return bundle["meta"]
