"""Ranks of ``tests/test_torch_data_parallel.py``: each process is one rank
of a gloo group on the CPU and imports only the port.

Usage: python tests/_dp_worker.py CASE RANK WORLD INIT_FILE INPUTS OUT_DIR

``INPUTS`` is a ``torch.save`` dict the parent wrote; the rank writes what
``CASES[CASE](mesh, inputs)`` returns to ``OUT_DIR/rank{RANK}.pt``. The case
functions also run in the parent with ``mesh=None``, as the single process
the ranks are held against.
"""

import datetime
import os
import sys
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch.distributed as dist  # noqa: E402

from freesound_classification_tpu_torch.cli import common  # noqa: E402
from freesound_classification_tpu_torch.data.dataset import (  # noqa: E402
    ClipDataset,
)
from freesound_classification_tpu_torch.data.loader import (  # noqa: E402
    make_loader,
)
from freesound_classification_tpu_torch.models.apc import APCModel  # noqa
from freesound_classification_tpu_torch.models.blocks import (  # noqa: E402
    BatchNorm,
    init_like_flax,
)
from freesound_classification_tpu_torch.models.classifiers import (  # noqa
    TwoDimensionalCNN,
)
from freesound_classification_tpu_torch.models.cpc import CPCModel  # noqa
from freesound_classification_tpu_torch.models.frontend import (  # noqa
    Frontend,
)
from freesound_classification_tpu_torch.ops.augment import (  # noqa: E402
    AugmentConfig,
    make_augmenter,
)
from freesound_classification_tpu_torch.parallel import (  # noqa: E402
    mesh as mesh_lib,
)
from freesound_classification_tpu_torch.training import (  # noqa: E402
    checkpoints,
)
from freesound_classification_tpu_torch.training.engine import (  # noqa
    Engine,
)
from freesound_classification_tpu_torch.training.state import (  # noqa
    create_model,
)

CFG = dict(num_conv_blocks=2, start_deep_supervision_on=0,
           conv_base_depth=8, growth_rate=2.0)
SR = 44100
DESCRIPTOR = "mel_512_256_32"


def unflatten(feats, frames):
    """The engines' frontend over flattened (B, 32 * T) log-mel rows."""
    return feats.reshape(feats.shape[0], 32, -1)[..., None], frames


def _rows(mesh, batch):
    """The rank's slice of a global host batch (the whole batch alone)."""
    if mesh is None:
        return dict(batch)
    return mesh_lib.shard_batch(batch, mesh.rank, mesh.world_size)


def _local(mesh, x: torch.Tensor) -> torch.Tensor:
    if mesh is None:
        return x
    start, _ = mesh_lib.rank_rows(len(x), mesh.rank, mesh.world_size)
    return x[start:start + len(x) // mesh.world_size]


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------


def case_batchnorm(mesh, inp):
    """One train-mode BatchNorm forward and backward on the rank's rows of
    ``x`` (an even split), with the loss sum(y * w)."""
    x, w = inp["x"], inp["w"]
    bn = BatchNorm(x.shape[1])
    if x.dtype == torch.float64:
        bn = bn.double()
    with torch.no_grad():
        bn.weight.copy_(inp["weight"])
        bn.bias.copy_(inp["bias"])
    bn.group = mesh.group if mesh else None
    xl = _local(mesh, x).clone().requires_grad_()
    y = bn.train()(xl)
    (y * _local(mesh, w)).sum().backward()
    return {"y": y.detach(), "grad": xl.grad, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "mean": bn.running_mean,
            "var": bn.running_var}


def case_steps(mesh, inp):
    """``epochs`` epochs of the 2d CNN's engine over the global feature
    batches (augmentation off), from the given weights."""
    dtype = inp["dtype"]
    model = TwoDimensionalCNN(**CFG, aggregation_type="max",
                              n_classes=inp["n_classes"], dtype=dtype)
    if dtype == torch.float64:
        model = model.double()
    model.load_state_dict(inp["state"])
    engine = Engine(model, unflatten, types.SimpleNamespace(**inp["cfg"]),
                    loss="lsep_naive", device="cpu", mesh=mesh)
    loader = [_rows(mesh, b) for b in inp["batches"]]
    engine.make_optimizer(len(loader) * inp["epochs"], len(loader))
    stats = [engine.train_epoch(loader, 1.0, log_interval=100)
             for _ in range(inp["epochs"])]
    return {"state": model.state_dict(),
            "losses": [s["losses"] for s in stats],
            "metrics": [s["metric"] for s in stats],
            "updates": engine.updates, "micro_step": engine.micro_step}


def case_ssl(mesh, inp):
    """Two momentum steps of APC or CPC over the global batch of log-mel
    frames, then its validation score (-loss) on the same batch."""
    kind, feats, frames = inp["kind"], inp["feats"], inp["frames"]
    if kind == "apc":
        model = APCModel(feats.shape[-1], rnn_size=8, rnn_layers=2)
    else:
        model = CPCModel(feats.shape[-1], n_encoder_layers=2,
                         conv_base_depth=4, context_size=8)
    init_like_flax(model, torch.Generator().manual_seed(0))
    engine = Engine(model, lambda f, n: (f, n),
                    types.SimpleNamespace(**inp["cfg"]), device="cpu",
                    self_supervised=True, mesh=mesh)
    batch = {"signal": feats.numpy(), "lengths": frames.numpy(),
             "labels": np.zeros((len(feats), 1), np.float32),
             "index": np.arange(len(feats))}
    loader = [_rows(mesh, batch)]
    engine.make_optimizer(2, 1)
    losses = [engine.train_epoch(loader, 1.0, log_interval=100)["loss"]
              for _ in range(2)]
    return {"losses": losses, "score": engine.evaluate(loader),
            "state": model.state_dict()}


def _clip_loader(mesh, inp, train=False, batch_size=3, **kw):
    classmap = {f"c{k}": k for k in range(inp["n_classes"])}
    ds = ClipDataset(inp["files"], raw_labels=inp["labels"],
                     classmap=classmap, max_audio_length=kw.pop("crop", None),
                     sr=SR, seed=3)
    return make_loader(ds, common.default_ladder(1 if train else None),
                       batch_size=batch_size, train=train, mesh=mesh, **kw)


def case_eval(mesh, inp):
    """``predict`` and ``evaluate`` of a 2d CNN over WAV clips."""
    net = types.SimpleNamespace(**CFG, aggregation_type="max",
                                output_dropout=0.0)
    model = create_model(net, inp["n_classes"], torch.float32, 5, "cpu")
    engine = Engine(model, Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu"),
                    types.SimpleNamespace(), device="cpu", mesh=mesh)
    loader = _clip_loader(mesh, inp)
    return {"probs": engine.predict(loader), "score": engine.evaluate(loader)}


def _resume_engine(mesh, inp, root):
    """The recipe's augmentation less MixUp (whose pool restarts on
    resume, as in JAX), head dropout, accumulation 2, 3 steps an epoch."""
    net = types.SimpleNamespace(**CFG, aggregation_type="max",
                                output_dropout=0.5)
    torch.manual_seed(mesh.rank_seed(7) if mesh else 7)
    engine = Engine(
        create_model(net, inp["n_classes"], torch.float32, 7, "cpu"),
        Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu"),
        types.SimpleNamespace(**inp["cfg"]),
        augment=make_augmenter(AugmentConfig(p_aug=0.5, p_shuffle=0.5)),
        checkpoint_dir=os.path.join(root, "checkpoints"), seed=7,
        device="cpu", mesh=mesh)
    return (engine, _clip_loader(mesh, inp, train=True, batch_size=4,
                                 crop=1, seed=5),
            _clip_loader(mesh, dict(inp, files=inp["files"][:6],
                                    labels=inp["labels"][:6])))


def case_resume(mesh, inp):
    """2 epochs straight, then 1 epoch, a kill, and a resumed run in
    another directory."""
    root = inp["root"]
    straight, train, valid = _resume_engine(mesh, inp,
                                            os.path.join(root, "a"))
    want_scores = straight.fit_validate(train, valid, epochs=2, fold=0)
    first, train, valid = _resume_engine(mesh, inp, os.path.join(root, "b"))
    train_epoch = first.train_epoch
    calls = []

    def stop_after_one(*a, **k):
        if calls:
            raise KeyboardInterrupt("killed after epoch 0")
        calls.append(1)
        return train_epoch(*a, **k)

    first.train_epoch = stop_after_one
    try:
        first.fit_validate(train, valid, epochs=2, fold=0)
    except KeyboardInterrupt:
        pass
    resumed, train, valid = _resume_engine(mesh, inp,
                                           os.path.join(root, "b"))
    scores = resumed.fit_validate(train, valid, epochs=2, fold=0,
                                  resume=True)
    return {"want_scores": want_scores, "scores": scores,
            "want": straight.model.state_dict(),
            "got": resumed.model.state_dict(),
            "first": first.model.state_dict(),
            "steps": (straight.global_step, resumed.global_step)}


def case_mixup(mesh, inp):
    """Two epochs of a MixUp-only augmenter (p 1) through the engine over
    batches whose labels are one-hot in the dataset row: returns each
    step's rows and their labels after MixUp."""
    seen = []
    augment = make_augmenter(AugmentConfig(p_mixup=1.0))

    def recording(wave, lengths, labels, gen, scale=1.0, partner=None,
                  shard=None):
        out = augment(wave, lengths, labels, gen, scale, partner=partner,
                      shard=shard)
        seen.append(out[2].clone())
        return out

    net = types.SimpleNamespace(**CFG, aggregation_type="max",
                                output_dropout=0.0)
    n = inp["n_classes"]
    engine = Engine(create_model(net, n, torch.float32, 5, "cpu"), unflatten,
                    types.SimpleNamespace(**inp["cfg"]), augment=recording,
                    device="cpu", mesh=mesh)
    loader = [_rows(mesh, b) for b in inp["batches"]]
    engine.make_optimizer(2 * len(loader), len(loader))
    for _ in range(2):
        engine.train_epoch(loader, 1.0, log_interval=100)
    return {"index": [b["index"] for b in loader] * 2, "labels": seen}


def case_rank0_files(mesh, inp):
    """Rank 0 writes every model file a second late, and the other ranks'
    checkpoint directory is one they never see written (a disk of their
    own): 2 epochs, the predictions of ``best_model`` loaded by every
    rank, then a resumed third epoch from rank 0's bundle."""
    save_model = checkpoints.save_model

    def late(path, model):
        time.sleep(1.0)
        save_model(path, model)

    checkpoints.save_model = late
    root = os.path.join(inp["root"], "rank0" if mesh.rank == 0
                        else f"unseen{mesh.rank}")
    engine, train, valid = _resume_engine(mesh, inp, root)
    scores = engine.fit_validate(train, valid, epochs=2, fold=0)
    engine.load_model(0, "best_model")
    out = {"scores": scores, "best": engine.model.state_dict(),
           "probs": engine.predict(valid)}
    resumed, train, valid = _resume_engine(mesh, inp, root)
    out["resumed_scores"] = resumed.fit_validate(train, valid, epochs=3,
                                                 fold=0, resume=True)
    out["resumed_steps"] = resumed.global_step
    return out


def case_warm_start(mesh, inp):
    """A fresh 2d CNN warm-started from ``inp["path"]`` on rank 0 and from
    a path that does not exist on the other ranks (a disk of their
    own)."""
    net = types.SimpleNamespace(**CFG, aggregation_type="max",
                                output_dropout=0.0)
    engine = Engine(create_model(net, inp["n_classes"], torch.float32, 11,
                                 "cpu"), unflatten, types.SimpleNamespace(),
                    device="cpu", mesh=mesh)
    engine.warm_start(inp["path"] if mesh.rank == 0
                      else inp["path"] + ".unseen")
    return engine.model.state_dict()


CASES = {"batchnorm": case_batchnorm, "steps": case_steps, "ssl": case_ssl,
         "eval": case_eval, "resume": case_resume, "mixup": case_mixup,
         "rank0_files": case_rank0_files, "warm_start": case_warm_start}


def main() -> None:
    case, rank, world, init_file, inputs, out_dir = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    mesh = mesh_lib.Mesh(rank, world, dist.group.WORLD, torch.device("cpu"))
    try:
        out = CASES[case](mesh, torch.load(inputs, weights_only=False))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
