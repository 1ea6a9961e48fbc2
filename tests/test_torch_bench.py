"""The port's bench (``freesound_classification_tpu_torch/bench.py``)
against the repository's ``bench.py``, on the CPU: the clip lengths, bucket
ladder, batches, filler rows and pad fraction; the fold weights; the
inference program against the JAX one at a small width; and a run of the
whole bench at tiny sizes.

``bench.py`` is loaded from its file (``tests/_jax_scripts.py``). Its
``main()`` runs here with its device work stubbed out (no model, no
compile, the waves kept only as shapes), so the plan it builds, its numpy
draws and its printed pad fraction are its own.
"""

import json
import math
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from freesound_classification_tpu.data.bucketing import (
    make_bucket_ladder as jax_ladder,
)
from freesound_classification_tpu.models.classifiers import (
    TwoDimensionalCNN as JaxCNN,
)
from freesound_classification_tpu.models.frontend import Frontend as JaxFrontend
from freesound_classification_tpu_torch import bench, interop
from freesound_classification_tpu_torch.data.bucketing import (
    make_bucket_ladder,
)
from tests._jax_scripts import load_script

SR = 44100
NET = dict(num_conv_blocks=2, start_deep_supervision_on=0, conv_base_depth=8,
           growth_rate=1.5, aggregation_type="max")
# bench.py's keys less the XLA traffic ones (hbm_gbps, hbm_gbps_xla_ub,
# train_hbm_gbps_*), which have no PyTorch counterpart
KEYS = {"metric", "value", "unit", "vs_baseline", "mfu",
        "train_step_ms_noaug", "train_step_ms_aug", "train_mfu_noaug",
        "train_mfu_aug", "train_mfu"}

torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module")
def bench_py():
    return load_script("bench.py")


class _Shape:
    """A wave reduced to its shape, keeping its first rows' head."""

    def __init__(self, wave):
        self.shape = wave.shape
        self.head = wave[:4, :4096].copy()


def _run_bench_py(bench_py, monkeypatch, capsys):
    """``bench.py``'s ``main()`` with the device stubbed: returns the
    (wave stub, lengths) of each batch of its first pass, in order, and
    its printed pad-fraction line."""
    calls = []

    def infer_5fold(wave, lengths):
        calls.append((wave, np.asarray(lengths)))
        return np.zeros(1, np.float32)

    monkeypatch.setattr(bench_py, "_wait_for_tpu", lambda: None)
    monkeypatch.setattr(bench_py, "build_model_and_params",
                        lambda key: (None, None, None))
    monkeypatch.setattr(bench_py, "bench_train_steps", lambda: {})
    monkeypatch.setattr(bench_py, "jax",
                        types.SimpleNamespace(jit=lambda fn: infer_5fold))
    monkeypatch.setattr(bench_py, "jnp", types.SimpleNamespace(
        asarray=lambda x: _Shape(x) if x.dtype == np.float32 else x,
        sum=np.sum))
    bench_py.main()
    lines = capsys.readouterr().out.strip().splitlines()
    n_batches = len(calls) // 2  # a warm-up pass, then the timed one
    return calls[:n_batches], [ln for ln in lines
                               if ln.startswith("# pad_fraction")]


def test_plan_matches_bench_py(bench_py, monkeypatch, capsys):
    """1120 clips: the same lengths, ladder, batch shapes, rows (filler
    rows repeat a bucket's first clips), pad fraction and numpy waves."""
    lengths = bench.synthetic_clip_lengths(bench.N_CLIPS)
    np.testing.assert_array_equal(
        lengths, bench_py.synthetic_clip_lengths(bench.N_CLIPS))
    assert make_bucket_ladder(int(lengths.max()), min_length=SR) == \
        jax_ladder(int(lengths.max()), min_length=SR)
    calls, pad_line = _run_bench_py(bench_py, monkeypatch, capsys)
    plan = bench.inference_plan(lengths)
    assert [(len(chunk), length) for length, chunk in plan] == \
        [w.shape for w, _ in calls]
    for (_, chunk), (_, want) in zip(plan, calls):
        np.testing.assert_array_equal(lengths[chunk], want)
    n_rows = sum(len(chunk) for _, chunk in plan)
    assert n_rows > bench.N_CLIPS  # the plan has filler rows
    assert sorted(set(np.concatenate([c for _, c in plan]))) == \
        list(range(bench.N_CLIPS))
    pad = (n_rows - bench.N_CLIPS) / n_rows
    assert pad_line == [
        f"# pad_fraction={pad:.4f} ({n_rows - bench.N_CLIPS} filler rows of "
        f"{n_rows}; reported clips/s undercounts by this fraction)"]
    wave, ln = bench.inference_batches(lengths, plan[:1], "cpu")[0]
    np.testing.assert_array_equal(wave[:4, :4096].numpy(), calls[0][0].head)
    np.testing.assert_array_equal(ln.numpy(), calls[0][1])
    assert ln.dtype == torch.int32


@pytest.mark.parametrize("n,per_batch", [(40, 3), (9, 1)])
def test_small_plans_match_bench_py(bench_py, monkeypatch, capsys, n,
                                    per_batch):
    """The plan at other clip counts and batch budgets: ``bench.py``'s
    budget of 128 clips of 10 s becomes ``per_batch`` clips (its constant
    128 swapped in the code of its ``main``), so buckets split into several
    chunks, or every chunk takes the floor of 8 clips."""
    monkeypatch.setattr(bench_py, "N_CLIPS", n)
    lengths = bench.synthetic_clip_lengths(n)
    code = bench_py.main.__code__
    assert code.co_consts.count(128) == 1
    monkeypatch.setattr(bench_py.main, "__code__", code.replace(
        co_consts=tuple(per_batch if c == 128 else c
                        for c in code.co_consts)))
    calls, _ = _run_bench_py(bench_py, monkeypatch, capsys)
    plan = bench.inference_plan(lengths, per_batch * SR * 10)
    assert [(len(chunk), length) for length, chunk in plan] == \
        [w.shape for w, _ in calls]
    for (_, chunk), (_, want) in zip(plan, calls):
        np.testing.assert_array_equal(lengths[chunk], want)


def test_fold_variables_are_the_probes():
    """The probe's folds (``scripts/probe_dft_context.py``: jax.tree.map
    perturbations from RandomState(100 + i), then |v| + 0.05 on the batch
    statistics) from the same random draw, bit for bit."""
    shape = {k: NET[k] for k in ("num_conv_blocks",
                                 "start_deep_supervision_on",
                                 "conv_base_depth", "growth_rate")}
    params, stats = interop.random_jax_variables(**shape, n_classes=80,
                                                 seed=4)
    host_vars = {"params": params, "batch_stats": stats}
    want = []
    for i in range(3):
        r = np.random.RandomState(100 + i)
        want.append(jax.tree.map(
            lambda leaf: leaf + (0.01 * r.randn(*leaf.shape)).astype(
                leaf.dtype), host_vars))
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *want)
    stacked["batch_stats"] = jax.tree.map(lambda v: np.abs(v) + 0.05,
                                          stacked["batch_stats"])
    got = bench.random_fold_variables(3, NET, seed=4)
    got = jax.tree.map(lambda *xs: np.stack(xs),
                       *[{"params": p, "batch_stats": s} for p, s in got])
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(
                                     stacked)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert jax.tree.structure(got) == jax.tree.structure(stacked)


def test_inference_program_matches_jax():
    """The bench's program (log-mel frontend, folds in a loop, mean of the
    sigmoids) at a small width in float32 against ``bench.py``'s
    ``infer_5fold`` built from the JAX package: its ``Frontend`` with the
    Pallas mel kernel (interpreted) and ``dft_precision="default"`` (one
    pass, which XLA computes in float32 on the CPU) and ``TwoDimensionalCNN``
    with ``phase_pool=(True,)`` (a lowering of the same block0). 1e-4 on
    probabilities: the featurizations ~1e-6 relative apart (FFT against
    the block-DFT), the convolutions in another float32 order."""
    variables = bench.random_fold_variables(2, NET, seed=5)
    ours = bench.inference_predictor(
        bench.fold_models(variables, NET, dtype=torch.float32), "cpu")
    model = JaxCNN(**NET, n_classes=bench.N_CLASSES, fused_infer=False,
                   phase_pool=(True,))
    frontend = JaxFrontend(bench.FEATURES, "2d", sr=SR, use_pallas=True,
                           dft_precision="default")
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        {"params": p, "batch_stats": s} for p, s in variables])

    @jax.jit
    def infer_5fold(wave, lengths):
        inputs, fl = frontend(wave, lengths)
        logits = jax.vmap(lambda v: model.apply(v, inputs, fl, train=False)[
            "class_logits"])(stacked)
        return jnp.mean(jax.nn.sigmoid(logits), axis=0)

    lengths = (np.array([1.2, 1.9, 1.0, 1.4, 2.3]) * SR).astype(np.int64)
    plan = bench.inference_plan(lengths, max_batch_elems=3 * SR * 2)
    assert [len(c) for _, c in plan] == [1, 3, 1]  # three buckets
    for wave, ln in bench.inference_batches(lengths, plan, "cpu"):
        want = np.asarray(infer_5fold(jnp.asarray(wave.numpy()),
                                      jnp.asarray(ln.numpy())))
        got = ours.predict_batch(wave, ln)
        assert got.shape == want.shape == (len(ln), bench.N_CLASSES)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_bench_runs_on_cpu_at_tiny_sizes(capsys):
    """Every key, finite and positive, on the last line; the device, pad
    fraction and kernel-launch lines before it (the CPU takes the plain
    twins and counts no launch)."""
    record = bench.run("cpu", n_clips=6, network=NET, n_folds=2,
                       max_batch_elems=4 * SR, train_batch=2,
                       train_seconds=1, train_steps=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert set(record) == KEYS
    assert record["metric"] == "5fold_melcnn_inference_clips_per_sec_per_chip"
    assert record["unit"] == "clips/s"
    for key in KEYS - {"metric", "unit"}:
        assert math.isfinite(record[key]) and record[key] > 0, key
    assert record["train_mfu"] == record["train_mfu_noaug"]
    assert record["vs_baseline"] == pytest.approx(
        record["value"] / (1120 / 60))
    assert json.loads(lines[-1]) == record
    assert lines[0] == "cpu"
    assert lines[1].startswith("# pad_fraction=")
    launches = json.loads(lines[2][len("# kernel launches "):])
    assert set(launches) == {"inference", "train_noaug", "train_aug"}
    assert all(set(v) == {"K1", "K2", "K3"} for v in launches.values())


def test_bench_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run() would run the bench")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()
