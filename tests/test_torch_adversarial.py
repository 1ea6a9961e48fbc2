"""The port's adversarial test against the JAX package's, on the CPU: the
domain discriminator's outputs through ``interop`` in eval and train mode,
the numpy AUC and split against sklearn's, and the CLI end to end and its
refusal without a card.

Inputs are made with numpy from seeds; weights are flax's init of the JAX
model (moved off its constants); float32.
"""

import csv
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from freesound_classification_tpu.models.adversarial import (
    DomainDiscriminator as JaxDiscriminator,
)
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.cli import adversarial_test, common
from freesound_classification_tpu_torch.data import audio_io
from freesound_classification_tpu_torch.models.adversarial import (
    DomainDiscriminator,
)
from tests.test_torch_ssl import _leaves, _moved

F_IN = 6


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes, many small ops: one intra-op thread, torch's and the
    BLAS/OpenMP pools', is fastest, and keeps the suite's parallel
    workers from oversubscribing the cores."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


def _variables(seed=0):
    x = jnp.zeros((2, 40, F_IN))
    init = JaxDiscriminator().init(jax.random.PRNGKey(seed), x,
                                   jnp.array([40, 30]), train=False)
    rng = np.random.RandomState(seed)
    params = _moved(init["params"], rng)
    stats = _moved(init["batch_stats"], rng)
    for _, node in _bn_nodes(stats):
        node["var"] = np.abs(node["var"]) + 0.5
    return params, stats


def _bn_nodes(tree, prefix=""):
    for name, node in tree.items():
        if "var" in node:
            yield prefix + name, node
        else:
            yield from _bn_nodes(node, f"{prefix}{name}/")


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_jax(train):
    """Clip scores and the per-frame probabilities within 1e-5 (the
    sigmoid's outputs; 1e-4 before it), ragged lengths down to a clip
    whose last conv leaves one frame."""
    params, stats = _variables()
    assert interop.model_kind_of(params) == "adversarial"
    rng = np.random.RandomState(1)
    x = rng.randn(3, 40, F_IN).astype(np.float32)
    fl = np.array([40, 13, 9], np.int32)
    variables = {"params": params, "batch_stats": stats}
    want = jax.jit(lambda v, x, fl: JaxDiscriminator().apply(
        v, x, fl, train=train, mutable=["batch_stats"] if train else False))(
        variables, jnp.asarray(x), jnp.asarray(fl))
    if train:
        want = want[0]
    model = DomainDiscriminator(F_IN)
    model.load_state_dict(interop.from_jax_variables(params, stats))
    got = model.train(train)(torch.from_numpy(x), torch.from_numpy(fl).long())
    for key in ("domain_prob", "frame_probs"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), atol=1e-5,
                                   rtol=0, err_msg=key)
    back_p, back_s = interop.to_jax_variables(model.state_dict())
    assert dict(_leaves(back_p)).keys() == dict(_leaves(params)).keys()
    assert dict(_leaves(back_s)).keys() == dict(_leaves(stats)).keys()


def test_roc_auc_and_split_equal_sklearn():
    """The rank AUC (ties at their mean rank) equals sklearn's
    ``roc_auc_score`` to the last bits of its trapezoid sums (1e-12), and
    ``holdout_rows`` gives ``train_test_split(..., shuffle=True,
    random_state=42)``'s rows exactly."""
    from sklearn.metrics import roc_auc_score
    from sklearn.model_selection import train_test_split

    rng = np.random.RandomState(2)
    for n in (5, 40, 333):
        y = (rng.rand(n) < 0.4).astype(np.float64)
        y[:2] = (0, 1)
        for scores in (rng.rand(n), np.round(rng.rand(n), 1),
                       np.full(n, 0.5)):
            assert adversarial_test.roc_auc(y, scores) == pytest.approx(
                roc_auc_score(y, scores), abs=1e-12)
        files = np.array([f"f{i}" for i in range(n)])
        for size in (0.2, 0.35):
            tr, va, tr_y, va_y = train_test_split(
                files, y, test_size=size, shuffle=True, random_state=42)
            keep, held = common.holdout_rows(n, size, 42)
            np.testing.assert_array_equal(files[keep], tr)
            np.testing.assert_array_equal(files[held], va)
            np.testing.assert_array_equal(y[held], va_y)
    with pytest.raises(ValueError, match="both classes"):
        adversarial_test.roc_auc(np.ones(4), np.arange(4))


def _write_sets(root, n_train=14, n_test=8, seed=3):
    rng = np.random.RandomState(seed)
    classes = [f"c{c}" for c in range(3)]
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, split))
        rows = []
        for i in range(n):
            m = int(rng.uniform(0.8, 1.3) * 44100)
            # the test clips are louder: the sets differ
            gain = 0.3 if split == "train" else 0.9
            audio = gain * np.sin(2 * np.pi * (200 + 100 * (i % 3))
                                  * np.arange(m) / 44100) \
                + 0.02 * rng.randn(m)
            name = f"{split}{i:02d}.wav"
            audio_io.write_wav(os.path.join(root, split, name), audio, 44100)
            rows.append((name, classes[i % 3]))
        with open(os.path.join(root, f"{split}.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["fname", "labels"])
            w.writerows(rows)
    with open(os.path.join(root, "classmap.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(classes)}, f)


def _argv(root, *extra):
    return ["--train_df", os.path.join(root, "train.csv"),
            "--train_data_dir", os.path.join(root, "train"),
            "--test_df", os.path.join(root, "test.csv"),
            "--test_data_dir", os.path.join(root, "test"),
            "--classmap", os.path.join(root, "classmap.json"),
            "--features", "mel_1024_1024_16", "--batch_size", "4",
            "--epochs", "2", "--max_audio_length", "1", "--val_size", "0.4",
            "--num_workers", "0", "--batches_to_save", "1",
            "--plots_dir", os.path.join(root, "plots"), *extra]


def test_adversarial_cli_end_to_end(tmp_path, capsys):
    """The CLI on the CPU: an AUC in [0, 1] each epoch, printed; a mean
    domain score for each class of the class map; the plots of one
    validation batch (matplotlib imports here); ``--max_samples`` draws
    the same rows each run."""
    root = str(tmp_path)
    _write_sets(root)
    out = adversarial_test.main(_argv(root, "--device", "cpu",
                                      "--max_samples", "12"))
    assert len(out["auc"]) == 2
    assert all(0.0 <= a <= 1.0 for a in out["auc"])
    printed = capsys.readouterr().out
    assert printed.count("AUC: ") == 2
    assert out["classes"] == ["c0", "c1", "c2"]
    assert out["mean_scores"].shape == (3,)
    assert os.listdir(os.path.join(root, "plots"))
    again = adversarial_test.main(_argv(root, "--device", "cpu",
                                        "--max_samples", "12"))
    np.testing.assert_allclose(again["auc"], out["auc"])


def test_adversarial_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        adversarial_test.main(_argv("x"))
