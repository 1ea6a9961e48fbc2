"""Ranks of ``tests/test_torch_fold_mesh.py`` and
``tests/test_torch_fold_data_mesh.py``: each process is one rank of a gloo
group on the CPU, trains its fold group's folds with the port's
``MultiFoldEngine`` on a ``FoldMesh`` (or runs a stacked BatchNorm over
the ranks), and imports only the port.

Usage: python tests/_fold_mesh_worker.py CASE RANK WORLD INIT_FILE INPUTS
    OUT_DIR

``INPUTS`` is a ``torch.save`` dict the parent wrote, with the run's fold
list under ``folds``; the rank writes what ``CASES[CASE](fold_mesh,
inputs)`` returns to ``OUT_DIR/rank{RANK}.pt``. The case functions also
run in the parent with ``fold_mesh=None``: the one process that stacks
every fold, which the ranks are held against.
"""

import datetime
import os
import sys
import types

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch.distributed as dist  # noqa: E402

from freesound_classification_tpu_torch.models.blocks import (  # noqa: E402
    BatchNorm,
)
from freesound_classification_tpu_torch.models.classifiers import (  # noqa
    TwoDimensionalCNN,
)
from freesound_classification_tpu_torch.models.frontend import (  # noqa
    Frontend,
)
from freesound_classification_tpu_torch.ops import (  # noqa: E402
    augment as augment_lib,
)
from freesound_classification_tpu_torch.ops.augment import (  # noqa: E402
    AugmentConfig,
    make_augmenter,
)
from freesound_classification_tpu_torch.parallel import (  # noqa: E402
    mesh as mesh_lib,
)
from freesound_classification_tpu_torch.training.engine import (  # noqa
    Engine,
)
from freesound_classification_tpu_torch.training import (  # noqa: E402
    checkpoints,
    multifold,
)
from freesound_classification_tpu_torch.training.multifold import (  # noqa
    MultiFoldEngine,
    fold_layout,
    make_fold_mesh,
)

CFG = dict(num_conv_blocks=2, start_deep_supervision_on=0,
           conv_base_depth=8, growth_rate=2.0)
SR = 44100
DESCRIPTOR = "mel_512_256_32"


def unflatten(feats, frames):
    """The engines' frontend over flattened (B, 32 * T) log-mel rows."""
    return feats.reshape(feats.shape[0], 32, -1)[..., None], frames


def _stack(fold_mesh, inp, frontend, augment, seed, checkpoint_dir=None):
    """The template (``inp["state"]``'s weights; on the rank's fold group
    where it has d > 1 ranks) and the stacked engine over the rank's folds,
    or over all of them alone; with the positions of those folds in the
    run's fold list."""
    model = TwoDimensionalCNN(**CFG, aggregation_type="max",
                              n_classes=inp["n_classes"])
    model.load_state_dict(inp["state"])
    template = Engine(model, frontend, types.SimpleNamespace(**inp["cfg"]),
                      loss="lsep_naive", augment=augment,
                      checkpoint_dir=checkpoint_dir, seed=seed,
                      device="cpu", mesh=(None if fold_mesh is None
                                          else fold_mesh.data_group))
    folds = list(inp["folds"])
    own = fold_mesh.own_folds if fold_mesh is not None else folds
    stack = MultiFoldEngine(template, own, fold_mesh=fold_mesh)
    return stack, [folds.index(f) for f in own]


def _epochs(stack, loaders):
    """Two epochs of ``stack`` over ``loaders``: each of its folds' epoch
    losses, final state and momentum buffers, and the run's step and
    update counts."""
    n_steps = stack.epoch_steps(loaders)
    stack.make_optimizer(2 * n_steps, n_steps)
    losses = [stack.train_epoch(loaders, 1.0, log_interval=100)["loss"]
              for _ in range(2)]
    names = stack.model.param_names
    params = list(stack.model.stacked()[0].values())
    folds = {}
    for k, fold in enumerate(stack.fold_ids):
        folds[fold] = {
            "loss": [float(epoch[k]) for epoch in losses],
            "state": {n: t.clone()
                      for n, t in stack.model.fold_state(k).items()},
            "momentum": {n: stack.optimizer.state[p]["momentum_buffer"][k]
                         .clone() for n, p in zip(names, params)}}
    return {"folds": folds, "steps": n_steps, "updates": stack.updates,
            "global_step": stack.global_step}


def _recipe_augment():
    return make_augmenter(AugmentConfig(p_mixup=0.5, p_aug=0.75,
                                        p_shuffle=0.5))


def case_epochs(fold_mesh, inp):
    """Two epochs of the recipe's augmentation (MixUp, the effects chain,
    chunk shuffle) over each fold's list of batches (``_epochs``)."""
    stack, positions = _stack(
        fold_mesh, inp, Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu"),
        _recipe_augment(), seed=7)
    return _epochs(stack, [inp["batches"][p] for p in positions])


def emulated_epochs(inp, rank: int, world: int):
    """``case_epochs`` in one process that stacks rank ``rank``'s folds
    alone, told what the job gives them: their places in the fold list
    (the generators' seeds), the job's step count and each step's (rows,
    length) over every fold's batch of the step."""
    layout = fold_layout(len(inp["folds"]), world)
    positions = list(layout.positions(rank))
    sub = dict(inp, folds=[inp["folds"][p] for p in positions])
    stack, _ = _stack(None, sub, Frontend(DESCRIPTOR, "2d", sr=SR,
                                          device="cpu"),
                      _recipe_augment(), seed=7)
    stack.generators = [torch.Generator().manual_seed(7 + p)
                        for p in positions]
    everyone = inp["batches"]
    n_steps = max(len(batches) for batches in everyone)
    shapes = [tuple(max(b[i % len(b)]["signal"].shape[j] for b in everyone)
                    for j in (0, 1)) for i in range(n_steps)]
    calls = []

    def job_shape(batches):
        calls.append(1)
        return shapes[(len(calls) - 1) % n_steps]

    stack.step_shape = job_shape
    stack.epoch_steps = lambda loaders: n_steps
    return _epochs(stack, [everyone[p] for p in positions])


def case_jax_steps(fold_mesh, inp):
    """Steps without augmentation from the stacked JAX fold states
    ``inp["stacked"]`` over each step's per-fold batches, padded to the
    job's (rows, length): each owned fold's per-step loss and batch
    lwlrap, and its final state."""
    stack, positions = _stack(fold_mesh, inp, unflatten, None, seed=0)
    stack.make_optimizer(2 * len(inp["steps"]), len(inp["steps"]))
    for k, p in enumerate(positions):
        stack.model.load_fold(k, {n: t[p] for n, t in inp["stacked"].items()})
    losses, metrics = [], []
    for step in inp["steps"]:
        batch, n_real = stack.stack_step([step[p] for p in positions])
        out = stack.train_step(*stack.to_device(batch),
                               torch.from_numpy(n_real), aug_scale=0.0)
        losses.append(out["loss"].detach().clone())
        metrics.append(out["metric"].clone())
    return {fold: {"loss": [float(x[k]) for x in losses],
                   "metric": [float(x[k]) for x in metrics],
                   "state": {n: t.clone() for n, t in
                             stack.model.fold_state(k).items()}}
            for k, fold in enumerate(stack.fold_ids)}


def case_effects(fold_mesh, inp):
    """One stacked step of the chain alone (``p_aug`` ``inp["p"]``) over
    each step's per-fold batches: the chain's row count of each owned
    fold on this rank, per step (``augment.draw_effects``' rows)."""
    counts = []
    draw = augment_lib.draw_effects

    def counting(gen, b, p, shard=None):
        draws = draw(gen, b, p, shard)
        counts.append(len(draws.rows))
        return draws

    augment_lib.draw_effects = counting
    stack, positions = _stack(
        fold_mesh, inp, Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu"),
        make_augmenter(AugmentConfig(p_aug=inp["p"])), seed=7)
    stack.make_optimizer(len(inp["steps"]), len(inp["steps"]))
    out = []
    for step in inp["steps"]:
        counts.clear()
        batch, n_real = stack.stack_step([step[p] for p in positions])
        stack.train_step(*stack.to_device(batch), torch.from_numpy(n_real))
        out.append({"rows": batch["signal"].shape[1],
                    "counts": dict(zip(stack.fold_ids, counts))})
    return out


def case_vmap_bn(fold_mesh, inp):
    """A ``BatchNorm`` of ``inp["channels"]`` stacked over the folds
    (``torch.func.stack_module_state``) and run under ``torch.func.vmap``
    on this rank's contiguous half of each fold's rows of ``inp["x"]``,
    its statistics over the world's ranks: the forward, the gradients of
    ``(y * inp["g"]).sum()`` as to the rank's rows and as to the stacked
    weight and bias, and the stacked running statistics."""
    del fold_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    per = inp["x"].shape[1] // world
    rows = slice(rank * per, (rank + 1) * per)
    x = inp["x"][:, rows].clone().requires_grad_(True)
    bn = BatchNorm(inp["channels"])
    params, buffers = torch.func.stack_module_state(
        [bn] * inp["x"].shape[0])
    params = {n: t.detach().copy_(inp[n]).requires_grad_(True)
              for n, t in params.items()}
    bn.group = dist.group.WORLD
    bn.to("meta")

    def one_fold(p, b, xs):
        return torch.func.functional_call(bn, (p, b), (xs,))

    y = torch.func.vmap(one_fold)(params, buffers, x)
    (y * inp["g"][:, rows]).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad,
            **{f"{n}_grad": t.grad for n, t in params.items()},
            **{n: t for n, t in buffers.items()}}


class Batches(list):
    """A fold's fixed batches as its train loader, with the epoch counter
    that the stacked bundle keeps."""
    _epoch = 0


# the exit code of a rank killed at a kill point of ``_fit``
KILLED = 9


def _kill_at_bundle_rename(n: int) -> None:
    """World rank 0 dies as by SIGKILL at its ``n``-th rename of the
    stacked bundle: after the gather, with the new bundle whole in its
    temporary file."""
    real, renames = os.replace, []

    def replace(src, dst, *args, **kwargs):
        if os.path.basename(dst) == multifold.BUNDLE:
            renames.append(dst)
            if len(renames) == n:
                os._exit(KILLED)
        return real(src, dst, *args, **kwargs)

    os.replace = replace


def _fit(fold_mesh, inp, root, stop=None, kill=None, resume=False):
    """``MultiFoldEngine.fit`` of ``inp["epochs"]`` epochs over each fold's
    ``inp["batches"]`` (and ``inp["valid"]``, one batch a fold), from
    ``inp["stacked"]``'s fold states where given, with the checkpoints
    under ``root``; the model's inputs are waves through the frontend with
    ``inp["waves"]``, else flattened spectrograms, and with
    ``inp["augment"]`` the chain and chunk shuffle run (MixUp off: its
    partner pool restarts on resume, as in JAX). ``stop`` ends the run
    before that epoch as a crash would; ``kill`` makes world rank 0 die as
    by SIGKILL at its second bundle's rename ("rename", on its checkpoint
    writer) or before epoch 1 once epoch 0's saves are on disk ("epoch");
    ``resume`` goes on from ``root``'s bundle. Returns each
    owned fold's final state and best score, the step count and the
    augmenter generators' seeds (None for a stopped run)."""
    frontend = (Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu")
                if inp.get("waves") else unflatten)
    augment = (make_augmenter(AugmentConfig(p_aug=0.75, p_shuffle=0.5))
               if inp.get("augment") else None)
    stack, positions = _stack(fold_mesh, inp, frontend, augment, seed=7,
                              checkpoint_dir=os.path.join(root,
                                                          "checkpoints"))
    for k, p in enumerate(positions):
        if "stacked" in inp:
            stack.model.load_fold(
                k, {n: t[p] for n, t in inp["stacked"].items()})
    group = fold_mesh.data_group if fold_mesh is not None else None
    valid = [[inp["valid"][p] if group is None else mesh_lib.shard_batch(
        inp["valid"][p], group.rank, group.world_size)] for p in positions]
    world_rank = dist.get_rank() if fold_mesh is not None else 0
    if kill == "rename" and world_rank == 0:
        _kill_at_bundle_rename(2)
    end = 1 if kill == "epoch" else stop
    if end is not None:
        train_epoch, started = stack.train_epoch, []

        def stopping(*args, **kwargs):
            if len(started) == end:
                if kill is None:
                    raise KeyboardInterrupt(f"stopped before epoch {end}")
                if world_rank == 0:
                    checkpoints.wait_for_saves()
                    os._exit(KILLED)
            started.append(1)
            return train_epoch(*args, **kwargs)

        stack.train_epoch = stopping
    try:
        best = stack.fit([Batches(inp["batches"][p]) for p in positions],
                         valid, epochs=inp["epochs"], log_interval=100,
                         resume=resume)
    except KeyboardInterrupt:
        return None
    return {"folds": {fold: {"state": {n: t.clone() for n, t in
                                       stack.model.fold_state(k).items()},
                             "best": best[k]}
                      for k, fold in enumerate(stack.fold_ids)},
            "global_step": stack.global_step,
            "seeds": [g.initial_seed() for g in stack.generators]}


def case_fit(fold_mesh, inp):
    """``_fit`` of each of ``inp["runs"]`` (its keyword arguments) in
    turn; on a rank the results so far are written after each run, so
    that a run killed after them leaves them."""
    results = []
    for run in inp["runs"]:
        results.append(_fit(fold_mesh, inp, **run))
        if fold_mesh is not None:
            torch.save(results, os.path.join(
                inp["out_dir"], f"rank{dist.get_rank()}.pt"))
    return results


CASES = {"epochs": case_epochs, "jax_steps": case_jax_steps,
         "effects": case_effects, "vmap_bn": case_vmap_bn, "fit": case_fit}


def main() -> None:
    case, rank, world, init_file, inputs, out_dir = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    mesh = mesh_lib.Mesh(rank, world, dist.group.WORLD, torch.device("cpu"))
    try:
        inp = torch.load(inputs, weights_only=False)
        out = CASES[case](make_fold_mesh(mesh, inp["folds"])
                          if "folds" in inp else None, inp)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
