"""The port's profiling against the JAX package's, on the CPU: ``StepTimer``,
``maybe_trace`` and ``annotate`` (``utils/profiling.py``), the train CLIs'
``--profile`` (a trace of epoch 1 only), and the stage functions of the two
probes (``probes/train_step_split.py``, ``probes/model_ablation.py``), which
time them on the card."""

import csv
import glob
import json
import os

import numpy as np
import pytest
import torch

from freesound_classification_tpu.utils import profiling as jprofiling
from freesound_classification_tpu_torch.cli import train_2d_cnn
from freesound_classification_tpu_torch.data import audio_io
from freesound_classification_tpu_torch.probes import (
    model_ablation,
    train_step_split,
)
from freesound_classification_tpu_torch.training import (
    engine as engine_module,
)
from freesound_classification_tpu_torch.utils import profiling

TINY = {"num_conv_blocks": 2, "start_deep_supervision_on": 0,
        "conv_base_depth": 8, "growth_rate": 1.5, "aggregation_type": "max"}


class _Clock:
    def __init__(self, ticks):
        self.ticks = iter(ticks)

    def __call__(self):
        return next(self.ticks)


@pytest.mark.parametrize("ema", [0.9, 0.5])
def test_step_timer_equals_jax(monkeypatch, ema):
    """The same EMA step time and clips/s from the same clock readings."""
    rng = np.random.RandomState(0)
    ticks = np.cumsum(rng.uniform(0.01, 0.3, size=20)).tolist()
    clips = rng.randint(1, 64, size=10).tolist()
    timers = []
    for module in (jprofiling, profiling):
        monkeypatch.setattr(module.time, "perf_counter", _Clock(ticks))
        timer = module.StepTimer(ema)
        steps = []
        for n in clips:
            timer.start()
            steps.append(timer.stop(n))
            steps.append(timer.step_time)
        timers.append((steps, timer.clips_per_sec, timer.total_clips,
                       timer.total_time))
    assert timers[0] == timers[1]


def test_step_timer_stop_without_start_raises():
    with pytest.raises(RuntimeError):
        profiling.StepTimer().stop(1)


def test_maybe_trace_writes_a_trace_with_the_annotations(tmp_path):
    """A trace lands in the directory and names the annotated range; a
    falsy directory traces nothing."""
    with profiling.maybe_trace(None), profiling.maybe_trace(""):
        torch.ones(3).sum()
    assert os.listdir(tmp_path) == []
    log_dir = str(tmp_path / "profile")
    with profiling.maybe_trace(log_dir):
        with profiling.annotate("stage_under_test"):
            torch.randn(8, 8) @ torch.randn(8, 8)
    traces = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(traces) == 1
    events = json.load(open(traces[0]))["traceEvents"]
    assert any(e.get("name") == "stage_under_test" for e in events)


def _write_dataset(root, n=20):
    rng = np.random.RandomState(1)
    os.makedirs(os.path.join(root, "train"))
    classes = ["a", "b", "c"]
    rows = []
    for i in range(n):
        length = int(rng.uniform(0.7, 1.4) * 44100)
        t = np.arange(length) / 44100
        audio = (0.3 * np.sin(2 * np.pi * 300.0 * (i % 3 + 1) * t)
                 + 0.01 * rng.randn(length)).astype(np.float32)
        audio_io.write_wav(os.path.join(root, "train", f"c{i}.wav"), audio,
                           44100)
        rows.append([f"c{i}.wav", classes[i % 3]])
    with open(os.path.join(root, "train.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["fname", "labels"])
        writer.writerows(rows)
    with open(os.path.join(root, "classmap.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(classes)}, f)


@pytest.mark.parametrize("epochs", [1, 2])
def test_train_cli_profile_traces_epoch_one_only(tmp_path, monkeypatch,
                                                 epochs):
    """--profile traces epoch 1 (the first after warm-up) into
    <experiment>/summaries/profile, as the JAX engine does: a 2-epoch run
    leaves one trace naming the step's stages, a 1-epoch run none. Only
    the traced epoch's steps open the named ranges."""
    root = str(tmp_path)
    _write_dataset(root)
    opened = []

    def counted(name):
        opened.append(name)
        return profiling.annotate(name)

    monkeypatch.setattr(engine_module, "annotate", counted)
    experiment = train_2d_cnn.main([
        "--train_df", f"{root}/train.csv", "--train_data_dir",
        f"{root}/train", "--classmap", f"{root}/classmap.json",
        "--device", "cpu", "--features", "mel_512_256_32",
        "--num_conv_blocks", "2", "--conv_base_depth", "8",
        "--start_deep_supervision_on", "0", "--aggregation_type", "max",
        "--optimizer", "adam", "--p_mixup", "0.5", "--p_aug", "0.75",
        "--batch_size", "4", "--max_audio_length", "1",
        "--epochs", str(epochs), "--n_folds", "4", "--folds", "1",
        "--num_workers", "0", "--profile", "--log_interval", "100",
        "--experiments_dir", f"{root}/exp"])
    profile = os.path.join(experiment.experiment_dir, "summaries",
                           "profile")
    traces = glob.glob(os.path.join(profile, "*.pt.trace.json"))
    assert len(traces) == epochs - 1
    with open(os.path.join(experiment.experiment_dir, "results.json")) as f:
        steps = json.load(f)["fold1"]["train_steps"]
    assert len(opened) == (5 * steps[1] if epochs == 2 else 0)
    for path in traces:
        names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
        assert {"augment", "frontend", "forward", "backward",
                "optimizer"} <= names


def test_train_step_split_stages_run_small_on_the_cpu():
    """Every stage of the probe's two splits runs; its whole augmented step
    moves the model's parameters, and the inference stages' sigmoid-mean
    equals ``predict_batch``."""
    stages = dict(train_step_split.train_stages("cpu", TINY, batch=4,
                                                seconds=1))
    assert list(stages)[-2:] == ["step, augmented", "step, no augmentation"]
    for name, fn in stages.items():
        fn()
    infer = train_step_split.inference_stages("cpu", TINY, n_folds=2,
                                              batch=3, seconds=1)
    outs = {name: fn() for name, fn in infer}
    assert [n for n, _ in infer] == [
        "host-to-device copy", "featurization (K1)", "fold 0 forward",
        "fold 1 forward", "sigmoid-mean", "predict_batch"]
    torch.testing.assert_close(outs["sigmoid-mean"], outs["predict_batch"])


def test_model_ablation_variants_run_small_on_the_cpu():
    """Each variant runs; K1 and its plain tail featurize alike, and the
    fused eval forward agrees with the unfused one."""
    outs = {name: fn() for name, fn in model_ablation.variants(
        "cpu", TINY, depths=(1, 2), batch=2, seconds=1)}
    assert len(outs) == 8
    torch.testing.assert_close(outs["featurize, K1"][0],
                               outs["featurize, plain tail"][0])
    torch.testing.assert_close(
        outs["eval forward, bf16 fused (K4/K5), depth 2"].float(),
        outs["eval forward, bf16, depth 2"].float(), atol=2e-2, rtol=0)


def test_launch_log_appends_each_process_counts(tmp_path, monkeypatch):
    """With ``$FSC_LAUNCH_LOG`` set, a CLI run as a program zeroes the
    wrappers' counts and appends its argv and launches at exit; unset, it
    registers nothing."""
    from freesound_classification_tpu_torch.cli import common
    from freesound_classification_tpu_torch.ops import kernels

    registered = []
    monkeypatch.setattr(common.atexit, "register", registered.append)
    monkeypatch.delenv(common.LAUNCH_LOG_ENV, raising=False)
    common.log_launches_at_exit()
    assert registered == []

    path = tmp_path / "launches.jsonl"
    monkeypatch.setenv(common.LAUNCH_LOG_ENV, str(path))
    monkeypatch.setattr(common.sys, "argv", ["train_2d_cnn.py", "--x"])
    for name in kernels.launch_counts():
        monkeypatch.setattr(getattr(kernels, name), "launches", 7)
    for run in range(2):
        common.log_launches_at_exit()
        kernels.pv_resynth.launches += 3 + run
        registered.pop()()
    lines = [json.loads(line) for line in open(path)]
    assert [rec["argv"] for rec in lines] == [["train_2d_cnn.py", "--x"]] * 2
    assert [rec["launches"]["pv_resynth"] for rec in lines] == [3, 4]
    assert all(n == 0 for rec in lines for k, n in rec["launches"].items()
               if k != "pv_resynth")
    assert set(lines[0]["launches"]) == {
        "mel_project_log", "resample_linear", "pv_resynth",
        "resnet_block_2d_fused", "resnet_block_1d_fused",
        "basic_block_fused", "conv_head_fused", "mel_log_split"}

