"""Data parallel across ranks (JAX ``parallel/mesh.py``).

The JAX package shards one fold's global batch over a 1-D device mesh,
replicates the train state, and lets XLA insert the collectives. The port
runs one process per card under ``torchrun`` (one rank each) and makes the
same arithmetic explicit:

- the loader splits each global batch into contiguous per-rank slices,
  padding a tail that does not divide by repeating its last row
  (``rank_rows``; ``data/loader.py``), and each batch says how many of its
  rows are real (``n_real``) and how many the global batch has
  (``n_global``);
- every rank starts from rank 0's weights (``broadcast_module``);
- train-mode BatchNorm takes its statistics over the global batch, padded
  rows included as in JAX's global batch: the per-channel sums go through
  ``all_reduce_sum``, an all-reduce that gradients flow through;
- the engine divides each rank's masked loss sum by the global real-row
  count and sums the gradients over the ranks (``all_reduce_gradients``),
  which gives the gradient of JAX's loss over the global batch;
- metrics and predictions gather the ranks' rows (``all_gather_rows``) and
  drop the padded ones.

A run resumed at another width than the one that wrote its bundle cannot
take back the writer's per-rank random streams: it draws new ones, each
seeded ``resume_seed(seed, *ids, global_step)`` (``ids`` a rank, or a fold
and a place), which no fresh run draws and every resume of one bundle at
one width draws alike. Bundles pass between ranks tensor by tensor
(``Mesh.broadcast_tensors``), never pickled whole.

``make_mesh`` reads ``torchrun``'s ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``. Without them no process group is made and the caller takes
the single-process path. Under ``torchrun`` a group is made even for one
rank, so that run goes through the real collectives: NCCL on the card
(rank r on ``cuda:{LOCAL_RANK}``), gloo on the CPU. Every function here
takes any process group, so a caller may also build a ``Mesh`` over a group
of its own (``sub_mesh``: the fold groups of ``training/multifold.py``).
"""

from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass
from typing import Iterator, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from freesound_classification_tpu_torch.utils.device import resolve_device

# a rank's random streams (the augmenter's generator, dropout's default
# one) start from seed + RANK_SEED_STRIDE * rank: rank 0 keeps the seed
RANK_SEED_STRIDE = 1_000_003
# a collective that waits longer than this ends the job instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def resume_seed(seed: int, *ids: int, global_step: int) -> int:
    """The seed of random stream ``ids`` (a rank; a fold and a place) of a
    run resumed from a bundle of step ``global_step`` at another width or
    layout than the one that wrote it. A 64-bit draw of
    ``numpy.random.SeedSequence([seed, *ids, global_step])``: the same for
    every resume of one bundle, and none of the small seeds ``seed + k +
    RANK_SEED_STRIDE * j`` of a fresh run but by a 2^-64 chance."""
    state = np.random.SeedSequence([seed, *ids, global_step])
    return int(state.generate_state(1, np.uint64)[0])


@dataclass(frozen=True)
class _TensorSlot:
    """A tensor's place in an object that ``broadcast_tensors`` sends."""
    shape: tuple
    dtype: torch.dtype


def _take_tensors(obj, out: list):
    """``obj`` with each tensor of one or more dimensions replaced by a
    ``_TensorSlot``, the tensors appended to ``out`` in order."""
    if isinstance(obj, torch.Tensor) and obj.dim() > 0:
        out.append(obj)
        return _TensorSlot(tuple(obj.shape), obj.dtype)
    if isinstance(obj, dict):
        return {k: _take_tensors(v, out) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_take_tensors(v, out) for v in obj)
    return obj


def _slots(obj) -> Iterator[_TensorSlot]:
    """The ``_TensorSlot``s of a ``_take_tensors`` skeleton, in order."""
    if isinstance(obj, _TensorSlot):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _slots(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _slots(v)


def _put_tensors(obj, tensors: Iterator[torch.Tensor]):
    """``_take_tensors`` undone: each slot replaced by the next tensor."""
    if isinstance(obj, _TensorSlot):
        return next(tensors)
    if isinstance(obj, dict):
        return {k: _put_tensors(v, tensors) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_put_tensors(v, tensors) for v in obj)
    return obj


@dataclass(frozen=True)
class Mesh:
    """A rank's place in a data-parallel job: ``group`` None is the single
    process of today's path."""
    rank: int = 0
    world_size: int = 1
    group: Optional[dist.ProcessGroup] = None
    device: torch.device = torch.device("cpu")

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes files."""
        return self.rank == 0

    def rank_seed(self, seed: int) -> int:
        return seed + RANK_SEED_STRIDE * self.rank

    def barrier(self) -> None:
        """Every rank's host waits here for the others (a no-op alone).
        Under NCCL an all-reduce only queues on the card's stream, so the
        host waits for its result."""
        if self.group is not None:
            all_reduce_sum_(torch.zeros(1, device=self.device),
                            self.group).item()

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank (picklable objects)."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=dist.get_global_rank(
            self.group, 0), group=self.group)
        return box[0]

    @property
    def wire(self) -> torch.device:
        """Where the group's messages take their tensors: the card under
        NCCL, the host under gloo (whose send and receive read host
        memory)."""
        if self.group is not None and dist.get_backend(self.group) == "nccl":
            return self.device
        return torch.device("cpu")

    def broadcast_tensors(self, obj):
        """Rank 0's ``obj`` (dicts, lists and tuples of tensors and
        picklable values) on every rank: its skeleton by
        ``broadcast_object``, then each tensor of one or more dimensions by
        a broadcast of its own, so that a bundle of hundreds of MB is never
        pickled whole. The tensors arrive on the CPU."""
        if self.group is None:
            return obj
        tensors: list = []
        skeleton = self.broadcast_object(
            _take_tensors(obj, tensors) if self.rank == 0 else None)
        if self.rank != 0:
            tensors = list(_slots(skeleton))
        src = dist.get_global_rank(self.group, 0)
        got = []
        for t in tensors:
            buf = (t.to(self.wire).contiguous() if self.rank == 0 else
                   torch.empty(t.shape, dtype=t.dtype, device=self.wire))
            dist.broadcast(buf, src=src, group=self.group)
            got.append(t if self.rank == 0 else buf.cpu())
        return _put_tensors(skeleton, iter(got))

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj``, in rank order."""
        if self.group is None:
            return [obj]
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    @contextlib.contextmanager
    def quiet(self) -> Iterator[None]:
        """Ranks above 0 print nothing inside the block."""
        if self.rank == 0:
            yield
            return
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            yield

    def close(self) -> None:
        """Destroy the default process group ``make_mesh`` made."""
        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(mesh_devices: Optional[int] = None,
              device: torch.device | str = "cuda",
              env: Optional[Mapping[str, str]] = None) -> Mesh:
    """The rank's ``Mesh`` from ``torchrun``'s environment.

    ``mesh_devices`` None means the job's world size (1 without
    ``torchrun``); any other value must equal ``WORLD_SIZE``. On the card
    rank r takes ``cuda:{LOCAL_RANK}`` and raises where that card is not
    there: no rank falls back to the CPU or to another rank's card."""
    env = os.environ if env is None else env
    if "WORLD_SIZE" not in env:
        if mesh_devices not in (None, 1):
            raise ValueError(
                f"--mesh_devices {mesh_devices} needs one process per rank: "
                f"launch with `torchrun --nproc_per_node {mesh_devices} -m "
                "<cli module> ... --mesh_devices "
                f"{mesh_devices}` (one rank per card)")
        return Mesh(device=resolve_device(device))
    world = int(env["WORLD_SIZE"])
    rank = int(env["RANK"])
    local = int(env.get("LOCAL_RANK", rank))
    if mesh_devices is not None and mesh_devices != world:
        raise ValueError(
            f"--mesh_devices {mesh_devices} but torchrun started {world} "
            f"ranks: pass --nproc_per_node {mesh_devices} (the mesh is one "
            "rank per process)")
    resolved = resolve_device(device)
    if resolved.type == "cuda":
        n_cards = torch.cuda.device_count()
        if local >= n_cards:
            raise RuntimeError(
                f"rank {rank}: LOCAL_RANK {local} has no card of its own "
                f"({n_cards} visible); start at most {n_cards} ranks a node")
        resolved = torch.device("cuda", local)
        torch.cuda.set_device(resolved)
    dist.init_process_group(
        "nccl" if resolved.type == "cuda" else "gloo", init_method="env://",
        rank=rank, world_size=world, timeout=TIMEOUT)
    return Mesh(rank, world, dist.group.WORLD, resolved)


def sub_mesh(mesh: Mesh, groups: Sequence[Sequence[int]]) -> Mesh:
    """The rank's ``Mesh`` within ``groups``, a partition of ``mesh``'s
    ranks into process groups of the world's backend (NCCL on the card,
    gloo on the CPU). Every rank makes every group, in one order, as
    ``dist.new_group`` asks, and keeps its own. Alone (no process group),
    ``mesh`` itself."""
    if mesh.group is None:
        return mesh
    mine = None
    for ranks in groups:
        ranks = list(ranks)
        group = dist.new_group(ranks, timeout=TIMEOUT)
        if mesh.rank in ranks:
            mine = Mesh(ranks.index(mesh.rank), len(ranks), group,
                        mesh.device)
    if mine is None:
        raise ValueError(f"rank {mesh.rank} is in none of the groups "
                         f"{[list(g) for g in groups]}")
    return mine


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------


def rank_rows(n: int, rank: int, world: int) -> tuple:
    """(first row, real rows) of rank ``rank``'s slice of a global batch of
    ``n`` rows: the batch is padded to a multiple of ``world`` by repeating
    its last row and each rank takes ``ceil(n / world)`` contiguous rows,
    so the padded ones are at the end of the last slices."""
    per = -(-n // world)
    start = rank * per
    return start, max(0, min(per, n - start))


def pad_batch_to_multiple(batch: dict, multiple: int) -> tuple:
    """Pad the leading axis to a multiple of ``multiple`` by repeating the
    last row; returns (padded batch, original size) (JAX, copied)."""
    n = len(next(iter(batch.values())))
    pad = (-n) % multiple
    if pad == 0:
        return batch, n
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        reps = np.repeat(v[-1:], pad, axis=0)
        out[k] = np.concatenate([v, reps], axis=0)
    return out, n


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s slice of a host batch dict of arrays, as the loader
    gives it: the rows of ``rank_rows``, with ``n_real`` and
    ``n_global``."""
    padded, n = pad_batch_to_multiple(batch, world)
    per = len(next(iter(padded.values()))) // world
    out = {k: np.asarray(v)[rank * per:(rank + 1) * per]
           for k, v in padded.items()}
    out["n_real"] = rank_rows(n, rank, world)[1]
    out["n_global"] = n
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_reduce_sum_(x: torch.Tensor, group: dist.ProcessGroup
                    ) -> torch.Tensor:
    """Sum ``x`` over the ranks in place (no gradient)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over the ranks. Backward: the sum over the ranks of
    the gradient, since every rank's loss reads the same sum. Under
    ``torch.func.vmap`` (the stacked folds of ``training/multifold.py``)
    the rule moves the batch dim to 0 and sums the whole batched tensor in
    one all-reduce, forward and backward: one collective for all of a
    rank's folds."""

    @staticmethod
    def forward(x: torch.Tensor, group) -> torch.Tensor:
        return all_reduce_sum_(x.clone(), group)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return all_reduce_sum_(grad.contiguous().clone(), ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x: torch.Tensor, group):
        del info
        return _AllReduceSum.apply(x.movedim(in_dims[0], 0), group), 0


def all_reduce_sum(x: torch.Tensor, group: dist.ProcessGroup
                   ) -> torch.Tensor:
    """The sum of ``x`` over the ranks, with gradients (statistics that a
    loss reads, as BatchNorm's); under ``torch.func.vmap`` too."""
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group: dist.ProcessGroup
                    ) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each) concatenated on dim 0 in rank
    order: the padded global batch."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def broadcast_module(module: nn.Module, group: dist.ProcessGroup) -> None:
    """Rank 0's parameters and buffers on every rank, in place."""
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)


def _memory_order(t: torch.Tensor) -> torch.Tensor:
    """A dense tensor's elements as a 1-D view, in memory order (a
    channels_last weight's gradient is dense but not contiguous)."""
    dense = t.is_contiguous() or (
        t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last))
    if not dense:
        raise ValueError(f"a gradient of shape {tuple(t.shape)} and strides "
                         f"{t.stride()} is not dense")
    return t.as_strided((t.numel(),), (1,))


def all_reduce_gradients(params: Sequence[torch.Tensor],
                         group: dist.ProcessGroup,
                         extra: Sequence[torch.Tensor] = ()) -> list:
    """Sum the parameters' gradients over the ranks in one flat buffer,
    with the tensors ``extra`` (the rank's share of the reported loss: 0-d,
    or one entry a fold of a stacked step) appended; returns the summed
    ``extra``, each in its shape. A parameter without a gradient has none
    on every rank (the same graph), and is left out. The buffer is one
    concatenation of the gradients in memory order, copied back with one
    foreach copy."""
    grads = [_memory_order(p.grad) for p in params if p.grad is not None]
    dtype = grads[0].dtype if grads else torch.float32
    if any(g.dtype != dtype for g in grads):
        raise TypeError("all_reduce_gradients: gradients of one dtype only")
    flat = torch.cat(grads + [e.detach().reshape(-1).to(dtype)
                              for e in extra])
    all_reduce_sum_(flat, group)
    parts = flat.split([g.numel() for g in grads] + [e.numel() for e in extra])
    if grads:
        torch._foreach_copy_(grads, list(parts[:len(grads)]))
    return [p.view(e.shape).to(e.dtype)
            for p, e in zip(parts[len(grads):], extra)]
