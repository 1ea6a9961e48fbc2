"""Weight bridge between the JAX package's variables and the port's
state_dict, both ways.

The JAX package keeps a model as two nested dicts of arrays, ``params`` and
``batch_stats``, keyed as flax names them (``block0/conv/kernel``,
``block0/resnet/bn1/scale``, ``head/fc1/kernel``, ...). The two CNN
families, ``TwoDimensionalCNN`` and ``HierarchicalCNN``, use the same names,
so one map serves both: ``from_jax_variables`` turns them into the port's
state_dict, conv kernels HWIO -> OIHW (2d) or (k, in, out) -> (out, in, k)
(1d), dense kernels transposed, BatchNorm scale/bias/mean/var to
weight/bias/running_mean/running_var. The backbone (``CNNBackbone``, whose
variables have ``trunk``) keeps the JAX names as its module names
(``input_norm``, ``trunk/conv1``, ``trunk/stage{s}_block{b}/downsample_bn``,
``head/fc1``, ...; its convolutions have no bias), so its map is the same
per-leaf conversion by name. So are the GRUs of the CNNs' ``rnn``
aggregation (``rnn{k}/ln``, ``rnn{k}/GRUCell_0`` forward and
``GRUCell_1`` backward) and the models without a CNN tower: APC
(``OptimizedLSTMCell_{l}``, ``output_norm``, ``prediction_{s}``), CPC
(``input_bn``, ``enc{k}/conv``, ``prelu{k}``, ``output_bn``,
``GRUCell_0``, ``coupling_{s}``) and the adversarial test's
``DomainDiscriminator`` (``bn0``, ``conv0``, ``res0``, ..., ``head``).
A flax ``GRUCell`` {ir, iz, in, hr, hz, hn} becomes the port's
``blocks.GRUCell`` (torch's gate order r, z, n; flax has no hidden-side
bias but the candidate's, ``bias_hn``), an ``OptimizedLSTMCell`` {ii, if,
ig, io, hi, hf, hg, ho} a ``blocks.LSTMCell`` (gates i, f, g, o, biases on
the hidden side only) and a LayerNorm's scale/bias its weight/bias.

``to_jax_variables`` is the reverse map; ``model_kind_of`` tells the family
from the variables. ``stack_jax_fold_states`` and ``unstack_jax_fold_states``
do the same for K folds stacked along a leading axis (JAX's fold-parallel
states, the port's ``training/multifold.FoldStack``).

A fold is stored as a flat ``.npz`` of those arrays keyed by ``/``-joined
paths (``params/block0/conv/kernel``, ...): ``scripts/export_fold_weights.py``
writes it from a JAX checkpoint, the port's train CLI from a trained model
(``to_jax_variables`` then ``save_fold_npz``), and the predict CLI reads it
with ``load_fold_npz``.
"""

from __future__ import annotations

import os
import re
import socket
from typing import BinaryIO, Callable, Mapping, Tuple

import numpy as np
import torch

from freesound_classification_tpu_torch.models.backbone import (
    RESNET_STAGES,
    TRUNK_WIDTH,
)
from freesound_classification_tpu_torch.models.blocks import block_depths
from freesound_classification_tpu_torch.models.classifiers import RNN_SIZE

_COLLECTIONS = ("params", "batch_stats")
# the random backbone's conditioning (random_jax_variables)
RESIDUAL_SCALE = 0.2
CLASSIFIER_SCALE = 0.3


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _map_bn(sd: dict, key: str, p: Mapping, s: Mapping) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    sd[f"{key}.running_mean"] = _t(s["mean"])
    sd[f"{key}.running_var"] = _t(s["var"])


def _map_conv(sd: dict, key: str, p: Mapping) -> None:
    # flax (kh, kw, in, out) -> torch (out, in, kh, kw); flax (k, in, out)
    # -> torch (out, in, k)
    kernel = np.asarray(p["kernel"])
    order = (3, 2, 0, 1) if kernel.ndim == 4 else (2, 1, 0)
    sd[f"{key}.weight"] = _t(np.transpose(kernel, order))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _map_linear(sd: dict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{key}.bias"] = _t(p["bias"])


def _map_prelu(sd: dict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(p["alpha"])


def _map_layer_norm(sd: dict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _gates(p: Mapping, names: str, side: str, leaf: str) -> np.ndarray:
    """The ``side`` ("i" or "h") denses of a flax cell's gates ``names``
    stacked on dim 0 as torch does: kernels transposed, or biases."""
    if leaf == "kernel":
        return np.concatenate([np.asarray(p[side + g]["kernel"]).T
                               for g in names])
    return np.concatenate([np.asarray(p[side + g]["bias"]) for g in names])


def _map_gru(sd: dict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight_ih"] = _t(_gates(p, "rzn", "i", "kernel"))
    sd[f"{key}.weight_hh"] = _t(_gates(p, "rzn", "h", "kernel"))
    sd[f"{key}.bias_ih"] = _t(_gates(p, "rzn", "i", "bias"))
    sd[f"{key}.bias_hn"] = _t(p["hn"]["bias"])


def _map_lstm(sd: dict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight_ih"] = _t(_gates(p, "ifgo", "i", "kernel"))
    sd[f"{key}.weight_hh"] = _t(_gates(p, "ifgo", "h", "kernel"))
    sd[f"{key}.bias_hh"] = _t(_gates(p, "ifgo", "h", "bias"))


def model_kind_of(params: Mapping) -> str:
    """The family of JAX variables: "backbone_cnn" (a ``trunk``), "apc"
    (LSTM cells), "cpc" (an encoder ``enc0``), "adversarial" (the domain
    discriminator's ``res0``), "2d_cnn" (a 4-d block0 conv kernel) or
    "hierarchical_cnn"."""
    for name, kind in (("trunk", "backbone_cnn"),
                       ("OptimizedLSTMCell_0", "apc"), ("enc0", "cpc"),
                       ("res0", "adversarial")):
        if name in params:
            return kind
    if np.ndim(params["block0"]["conv"]["kernel"]) == 4:
        return "2d_cnn"
    return "hierarchical_cnn"


def _from_jax_by_name(sd: dict, prefix: str, params: Mapping,
                      stats: Mapping) -> None:
    """Every leaf module of ``params`` under its own name: a dict with a
    kernel is a conv (rank 3-4) or a dense layer (rank 2), one with an
    ``hn`` a GRU cell, one with an ``hi`` an LSTM cell, one with a scale a
    BatchNorm (statistics from ``stats``) or, without statistics, a
    LayerNorm, one with an alpha a PReLU."""
    for name, p in params.items():
        key = f"{prefix}{name}"
        if "hn" in p:
            _map_gru(sd, key, p)
        elif "hi" in p:
            _map_lstm(sd, key, p)
        elif "kernel" in p:
            if np.ndim(p["kernel"]) == 2:
                _map_linear(sd, key, p)
            else:
                _map_conv(sd, key, p)
        elif "scale" in p:
            if name in stats:
                _map_bn(sd, key, p, stats[name])
            else:
                _map_layer_norm(sd, key, p)
        elif "alpha" in p:
            _map_prelu(sd, key, p)
        else:
            _from_jax_by_name(sd, f"{key}.", p, stats.get(name, {}))


def from_jax_variables(params: Mapping,
                       batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """JAX variables of any family ``model_kind_of`` tells -> the port's
    state_dict of the same family."""
    sd: dict[str, torch.Tensor] = {}
    if model_kind_of(params) not in ("2d_cnn", "hierarchical_cnn"):
        _from_jax_by_name(sd, "", params, batch_stats)
        return sd
    _from_jax_by_name(sd, "", {name: p for name, p in params.items()
                               if name.startswith("rnn")}, {})
    k = 0
    while f"block{k}" in params:
        p, s = params[f"block{k}"], batch_stats[f"block{k}"]
        pre = f"blocks.{k}"
        _map_bn(sd, f"{pre}.bn_in", p["bn_in"], s["bn_in"])
        _map_conv(sd, f"{pre}.conv", p["conv"])
        _map_bn(sd, f"{pre}.bn_out", p["bn_out"], s["bn_out"])
        _map_prelu(sd, f"{pre}.prelu", p["prelu"])
        r, rs = p["resnet"], s["resnet"]
        for i in (1, 2, 3):
            _map_conv(sd, f"{pre}.resnet.conv{i}", r[f"conv{i}"])
            _map_bn(sd, f"{pre}.resnet.bn{i}", r[f"bn{i}"], rs[f"bn{i}"])
            _map_prelu(sd, f"{pre}.resnet.prelu{i}", r[f"prelu{i}"])
        k += 1
    h, hs = params["head"], batch_stats["head"]
    _map_bn(sd, "head.bn1", h["bn1"], hs["bn1"])
    _map_linear(sd, "head.fc1", h["fc1"])
    _map_bn(sd, "head.bn2", h["bn2"], hs["bn2"])
    _map_prelu(sd, "head.prelu", h["prelu"])
    _map_linear(sd, "head.fc2", h["fc2"])
    return sd


def to_jax_variables(
        state_dict: Mapping[str, torch.Tensor]) -> Tuple[dict, dict]:
    """The port's state_dict of any family -> JAX (params, batch_stats) as
    nested dicts of float32 numpy arrays: the inverse of
    ``from_jax_variables``."""
    def a(key: str) -> np.ndarray:
        return state_dict[key].detach().to("cpu", torch.float32).numpy()

    def bn(key: str):
        return ({"scale": a(f"{key}.weight"), "bias": a(f"{key}.bias")},
                {"mean": a(f"{key}.running_mean"),
                 "var": a(f"{key}.running_var")})

    def conv(key: str) -> dict:
        w = a(f"{key}.weight")
        order = (2, 3, 1, 0) if w.ndim == 4 else (2, 1, 0)
        out = {"kernel": np.ascontiguousarray(np.transpose(w, order))}
        if f"{key}.bias" in state_dict:
            out["bias"] = a(f"{key}.bias")
        return out

    def linear(key: str) -> dict:
        return {"kernel": np.ascontiguousarray(a(f"{key}.weight").T),
                "bias": a(f"{key}.bias")}

    def prelu(key: str) -> dict:
        return {"alpha": a(f"{key}.weight")}

    def cell(key: str, names: str) -> dict:
        """A GRU (names "rzn") or LSTM ("ifgo") cell's gate denses."""
        w_ih = np.split(a(f"{key}.weight_ih"), len(names))
        w_hh = np.split(a(f"{key}.weight_hh"), len(names))
        out = {}
        for g, wi, wh in zip(names, w_ih, w_hh):
            out["i" + g] = {"kernel": np.ascontiguousarray(wi.T)}
            out["h" + g] = {"kernel": np.ascontiguousarray(wh.T)}
        if names == "rzn":
            for g, b in zip(names, np.split(a(f"{key}.bias_ih"), 3)):
                out["i" + g]["bias"] = b
            out["hn"]["bias"] = a(f"{key}.bias_hn")
        else:
            for g, b in zip(names, np.split(a(f"{key}.bias_hh"), 4)):
                out["h" + g]["bias"] = b
        return out

    def by_name(keys) -> None:
        """Every module of ``keys`` under its own (JAX) name."""
        for key in sorted({k.rsplit(".", 1)[0] for k in keys}):
            *path, leaf = key.split(".")
            p_node = _subtree(params, path)
            if f"{key}.running_mean" in state_dict:
                p_node[leaf], _subtree(stats, path)[leaf] = bn(key)
            elif f"{key}.bias_hn" in state_dict:
                p_node[leaf] = cell(key, "rzn")
            elif f"{key}.weight_ih" in state_dict:
                p_node[leaf] = cell(key, "ifgo")
            elif state_dict[f"{key}.weight"].dim() >= 3:
                p_node[leaf] = conv(key)
            elif state_dict[f"{key}.weight"].dim() == 2:
                p_node[leaf] = linear(key)
            elif f"{key}.bias" in state_dict:
                p_node[leaf] = {"scale": a(f"{key}.weight"),
                                "bias": a(f"{key}.bias")}
            else:
                p_node[leaf] = prelu(key)

    params: dict = {}
    stats: dict = {}
    if "blocks.0.conv.weight" not in state_dict:
        by_name(state_dict)
        return params, stats
    by_name([k for k in state_dict if k.startswith("rnn")])
    k = 0
    while f"blocks.{k}.conv.weight" in state_dict:
        pre = f"blocks.{k}"
        p: dict = {"conv": conv(f"{pre}.conv"), "prelu": prelu(f"{pre}.prelu")}
        s: dict = {}
        p["bn_in"], s["bn_in"] = bn(f"{pre}.bn_in")
        p["bn_out"], s["bn_out"] = bn(f"{pre}.bn_out")
        r: dict = {}
        rs: dict = {}
        for i in (1, 2, 3):
            r[f"conv{i}"] = conv(f"{pre}.resnet.conv{i}")
            r[f"bn{i}"], rs[f"bn{i}"] = bn(f"{pre}.resnet.bn{i}")
            r[f"prelu{i}"] = prelu(f"{pre}.resnet.prelu{i}")
        p["resnet"], s["resnet"] = r, rs
        params[f"block{k}"], stats[f"block{k}"] = p, s
        k += 1
    head: dict = {"fc1": linear("head.fc1"), "prelu": prelu("head.prelu"),
                  "fc2": linear("head.fc2")}
    head_stats: dict = {}
    head["bn1"], head_stats["bn1"] = bn("head.bn1")
    head["bn2"], head_stats["bn2"] = bn("head.bn2")
    params["head"], stats["head"] = head, head_stats
    return params, stats


def _fold_slice(tree: Mapping, k: int) -> dict:
    return {name: (_fold_slice(value, k) if isinstance(value, Mapping)
                   else np.asarray(value)[k])
            for name, value in tree.items()}


def _stack_trees(trees: list) -> dict:
    return {name: (_stack_trees([t[name] for t in trees])
                   if isinstance(value, Mapping)
                   else np.stack([t[name] for t in trees]))
            for name, value in trees[0].items()}


def stack_jax_fold_states(params: Mapping, batch_stats: Mapping
                          ) -> dict[str, torch.Tensor]:
    """JAX's stacked fold variables (``MultiFoldEngine.states.params`` and
    ``.batch_stats`` as numpy arrays, a leading fold axis on every leaf) ->
    the port's stacked state_dict {name: (K, ...) tensor}, each fold's
    slice ``from_jax_variables`` of that fold's variables."""
    flat: dict = {}
    _flatten(params, "", flat)
    n_folds = len(next(iter(flat.values())))
    folds = [from_jax_variables(_fold_slice(params, k),
                                _fold_slice(batch_stats, k))
             for k in range(n_folds)]
    return {name: torch.stack([sd[name] for sd in folds])
            for name in folds[0]}


def unstack_jax_fold_states(
        state: Mapping[str, torch.Tensor]) -> Tuple[dict, dict]:
    """The inverse of ``stack_jax_fold_states``: the port's stacked
    state_dict -> JAX's stacked (params, batch_stats), numpy arrays with a
    leading fold axis."""
    n_folds = len(next(iter(state.values())))
    folds = [to_jax_variables({name: t[k] for name, t in state.items()})
             for k in range(n_folds)]
    return (_stack_trees([p for p, _ in folds]),
            _stack_trees([s for _, s in folds]))


def _subtree(tree: dict, path) -> dict:
    for name in path:
        tree = tree.setdefault(name, {})
    return tree


def _flatten(tree: Mapping, prefix: str, out: dict) -> None:
    for name, value in tree.items():
        if isinstance(value, Mapping):
            _flatten(value, f"{prefix}{name}/", out)
        else:
            out[f"{prefix}{name}"] = np.asarray(value)


def _fsync_dir(directory: str) -> None:
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


_TEMPORARY_TAG = ".tmp-"
# what follows the tag: ``<host>-<pid>``, or the bare ``<pid>`` of older
# names, then an optional suffix (``.<stem>.o``); the host is matched
# greedily, so a host name may hold ``-`` and ``.``
_TEMPORARY_OWNER = re.compile(r"(?:(?P<host>.+)-)?(?P<pid>\d+)(?:\..*)?")


def temporary_name(name: str) -> str:
    """``<name>.tmp-<host>-<pid>``: the temporary this process writes for
    ``name``."""
    return f"{name}{_TEMPORARY_TAG}{socket.gethostname()}-{os.getpid()}"


def _process_is_gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except (PermissionError, OverflowError):  # another user's, or no pid
        return False
    return False


def clear_dead_temporaries(directory: str, prefix: str) -> list:
    """Remove the files in ``directory`` whose names start with ``prefix``
    and hold a ``temporary_name`` tag of a writer that died before its
    rename: a tag of this host (or a bare ``.tmp-<pid>``, counted as this
    host's) whose pid is not this process's and names no live process.
    A live writer's temporary, this process's own and another host's stay.
    Returns the names removed."""
    host, me = socket.gethostname(), os.getpid()
    removed = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return removed
    for name in names:
        if not name.startswith(prefix) or _TEMPORARY_TAG not in name:
            continue
        owner = _TEMPORARY_OWNER.fullmatch(name.rsplit(_TEMPORARY_TAG, 1)[1])
        if owner is None or owner["host"] not in (None, host):
            continue
        pid = int(owner["pid"])
        if pid <= 0 or pid == me or not _process_is_gone(pid):
            continue
        try:
            os.unlink(os.path.join(directory, name))
        except FileNotFoundError:  # another process cleared it first
            continue
        removed.append(name)
    return removed


def write_durably(path: str, write: Callable[[BinaryIO], None]) -> None:
    """``write(f)`` into a temporary file beside ``path``
    (``temporary_name``), fsynced, then renamed over ``path`` (one atomic
    step) and the directory fsynced, so that a kill at any point leaves the
    previous file or the new one, whole, at ``path``.

    First the temporaries of ``path`` that dead writers of this host left
    are removed (``clear_dead_temporaries``), as JAX's next save of a path
    clears its stale swaps. A ``write`` or ``fsync`` that raises removes
    this call's temporary and leaves ``path`` as it was."""
    directory, name = os.path.split(os.path.abspath(path))
    clear_dead_temporaries(directory, name + _TEMPORARY_TAG)
    tmp = os.path.join(directory, temporary_name(name))
    with open(tmp, "wb") as f:
        try:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        except BaseException:
            os.unlink(tmp)
            raise
    os.replace(tmp, path)
    _fsync_dir(directory)


def save_fold_npz(path: str, params: Mapping, batch_stats: Mapping) -> None:
    """Write one fold's variables as a flat ``.npz`` at ``path``, durably
    (``write_durably``)."""
    flat: dict = {}
    _flatten({"params": params, "batch_stats": batch_stats}, "", flat)
    write_durably(path, lambda f: np.savez(f, **flat))


def load_fold_npz(path: str) -> Tuple[dict, dict]:
    """Read a ``save_fold_npz`` file back into (params, batch_stats), once
    every save enqueued on the checkpoint writer is written."""
    from freesound_classification_tpu_torch.training import checkpoints

    checkpoints.wait_for_saves()
    trees: dict = {c: {} for c in _COLLECTIONS}
    with np.load(path) as data:
        for key in data.files:
            collection, *names = key.split("/")
            if collection not in trees or not names:
                raise ValueError(f"{path}: unexpected array {key!r}")
            node = trees[collection]
            for name in names[:-1]:
                node = node.setdefault(name, {})
            node[names[-1]] = data[key]
    return trees["params"], trees["batch_stats"]


def random_jax_variables(
    num_conv_blocks: int = 5,
    start_deep_supervision_on: int = 2,
    conv_base_depth: int = 64,
    growth_rate: float = 2.0,
    n_classes: int = 80,
    seed: int = 0,
    model_kind: str = "2d_cnn",
    input_dim: int | None = None,
    backbone: str = "resnet18",
    aggregation_type: str = "max",
) -> Tuple[dict, dict]:
    """Random ``TwoDimensionalCNN`` (``model_kind`` "2d_cnn"),
    ``HierarchicalCNN`` ("hierarchical_cnn", over ``input_dim`` features
    per frame) or ``CNNBackbone`` ("backbone_cnn", the ``backbone`` arch;
    the tower's widths do not apply) variables in the JAX package's layout,
    from a numpy seed: (params, batch_stats) as nested dicts of float32
    arrays. With ``aggregation_type="rnn"`` the CNNs carry an ``rnn{k}``
    GRU pair (hidden ``RNN_SIZE``) after each deep-supervised block.

    Kernels are LeCun-normal like flax's default init. Biases, BatchNorm
    statistics and PReLU slopes get small random offsets from flax's
    constants, so every tensor the bridge maps carries information.

    The backbone's residual branches end in a BatchNorm of scale ~0.2 (as a
    trained resnet's, or a zero-initialized residual scale, keep them
    small), and its classifier kernel is 0.3 of LeCun's scale. With
    flax's constants every block about doubles its input's variance, so a
    random resnet34's logits reach the hundreds, the sigmoids saturate, and
    bf16 rounding noise decides the probabilities near 0.5; so conditioned,
    its logits spread by about 1.
    """
    rng = np.random.RandomState(seed)

    def normal(shape, std):
        return (std * rng.randn(*shape)).astype(np.float32)

    if model_kind == "2d_cnn":
        spatial, c_first = 2, 2  # spectrogram + frequency encoding
    elif model_kind == "hierarchical_cnn":
        if input_dim is None:
            raise ValueError("hierarchical_cnn needs input_dim")
        spatial, c_first = 1, int(input_dim)
    elif model_kind == "backbone_cnn":
        spatial = 2
    else:
        raise ValueError(f"no random variables for {model_kind!r}")

    def conv(k, c_in, c_out, bias=True):
        out = {"kernel": normal((k,) * spatial + (c_in, c_out),
                                (k ** spatial * c_in) ** -0.5)}
        if bias:
            out["bias"] = normal((c_out,), 0.1)
        return out

    def dense(c_in, c_out):
        return {"kernel": normal((c_in, c_out), c_in ** -0.5),
                "bias": normal((c_out,), 0.1)}

    def bn(c):
        p = {"scale": 1.0 + normal((c,), 0.1), "bias": normal((c,), 0.1)}
        s = {"mean": normal((c,), 0.1),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        return p, s

    def prelu(c):
        return {"alpha": 0.25 + normal((c,), 0.05)}

    def head(width):
        h: dict = {"fc1": dense(width, width), "prelu": prelu(width),
                   "fc2": dense(width, n_classes)}
        hs: dict = {}
        h["bn1"], hs["bn1"] = bn(width)
        h["bn2"], hs["bn2"] = bn(width)
        return h, hs

    params: dict = {}
    stats: dict = {}
    if model_kind == "backbone_cnn":
        params["input_norm"], stats["input_norm"] = bn(3)
        trunk: dict = {"conv1": conv(7, 3, 64, bias=False)}
        trunk_stats: dict = {}
        trunk["bn1"], trunk_stats["bn1"] = bn(64)
        c_in = 64
        for stage, n_blocks in enumerate(RESNET_STAGES[backbone]):
            features = 64 * 2**stage
            for b in range(n_blocks):
                strides = 2 if stage > 0 and b == 0 else 1
                p = {"conv1": conv(3, c_in, features, bias=False),
                     "conv2": conv(3, features, features, bias=False)}
                s: dict = {}
                p["bn1"], s["bn1"] = bn(features)
                p["bn2"], s["bn2"] = bn(features)
                p["bn2"]["scale"] *= np.float32(RESIDUAL_SCALE)
                if c_in != features or strides != 1:
                    p["downsample"] = conv(1, c_in, features, bias=False)
                    p["downsample_bn"], s["downsample_bn"] = bn(features)
                name = f"stage{stage}_block{b}"
                trunk[name], trunk_stats[name] = p, s
                c_in = features
        params["trunk"], stats["trunk"] = trunk, trunk_stats
        params["head"], stats["head"] = head(TRUNK_WIDTH)
        params["head"]["fc2"]["kernel"] *= np.float32(CLASSIFIER_SCALE)
        return params, stats

    depths = block_depths(num_conv_blocks, conv_base_depth, growth_rate)
    for k, (c_in, d) in enumerate(zip([c_first, *depths], depths)):
        p: dict = {"conv": conv(3, c_in, d), "prelu": prelu(d)}
        s: dict = {}
        p["bn_in"], s["bn_in"] = bn(c_in)
        p["bn_out"], s["bn_out"] = bn(d)
        r: dict = {}
        rs: dict = {}
        for i, size in ((1, 1), (2, 3), (3, 1)):
            r[f"conv{i}"] = conv(size, d, d)
            r[f"bn{i}"], rs[f"bn{i}"] = bn(d)
            r[f"prelu{i}"] = prelu(d)
        p["resnet"], s["resnet"] = r, rs
        params[f"block{k}"], stats[f"block{k}"] = p, s
    supervised = depths[start_deep_supervision_on:]
    if aggregation_type == "max":
        params["head"], stats["head"] = head(sum(supervised))
        return params, stats

    def gru(c_in):
        out = {}
        for g in "rzn":
            out["i" + g] = dense(c_in, RNN_SIZE)
            out["h" + g] = {"kernel": normal((RNN_SIZE, RNN_SIZE),
                                             RNN_SIZE ** -0.5)}
        out["hn"]["bias"] = normal((RNN_SIZE,), 0.1)
        return out

    for k, d in enumerate(supervised, start=start_deep_supervision_on):
        params[f"rnn{k}"] = {
            "ln": {"scale": 1.0 + normal((d,), 0.1),
                   "bias": normal((d,), 0.1)},
            "GRUCell_0": gru(d), "GRUCell_1": gru(d)}
    params["head"], stats["head"] = head(2 * RNN_SIZE * len(supervised))
    return params, stats
