"""The port's span recorder (``utils/profiling.span``) on the CPU: off by
default and then silent, on inside ``tracing()`` and under an active
``torch.profiler``, its records (threads, parents, attributes) on the
profiler's clock, the spans of the loader, the engine and the ensemble, the
loader's producer stopping with its consumer, and ``maybe_trace``'s
``spans.json``."""

import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from freesound_classification_tpu_torch.cli import common
from freesound_classification_tpu_torch.data import audio_io
from freesound_classification_tpu_torch.data.dataset import ClipDataset
from freesound_classification_tpu_torch.data.loader import make_loader
from freesound_classification_tpu_torch.models.classifiers import (
    TwoDimensionalCNN,
)
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops.augment import (
    AugmentConfig,
    make_augmenter,
)
from freesound_classification_tpu_torch.training.engine import Engine
from freesound_classification_tpu_torch.training.ensemble import (
    EnsemblePredictor,
)
from freesound_classification_tpu_torch.utils import profiling

SR = 44100
DESCRIPTOR = "mel_512_256_32"
N_CLASSES = 3
NETWORK = dict(num_conv_blocks=2, start_deep_supervision_on=0,
               conv_base_depth=8, growth_rate=1.5, aggregation_type="max")
STAGES = ("augment", "frontend", "forward", "backward", "optimizer")


@pytest.fixture(autouse=True)
def _fresh_records():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def counted_ranges(monkeypatch):
    """Every ``record_function`` and NVTX range the port opens, by name."""
    opened = []
    record_function = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        opened.append(name)
        return record_function(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", opened.append)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: None)
    return opened


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """12 tone clips of 0.4-1.4 s and their labels."""
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.RandomState(0)
    files, labels = [], []
    for i in range(12):
        n = int(rng.uniform(0.4, 1.4) * SR)
        t = np.arange(n) / SR
        audio = (0.3 * np.sin(2 * np.pi * 220.0 * (i % 3 + 1) * t)
                 + 0.01 * rng.randn(n)).astype(np.float32)
        path = os.path.join(root, f"c{i}.wav")
        audio_io.write_wav(path, audio, SR)
        files.append(path)
        labels.append(f"k{i % N_CLASSES}")
    return files, labels


def _train_loader(clips, num_workers):
    files, labels = clips
    classmap = {f"k{k}": k for k in range(N_CLASSES)}
    return make_loader(ClipDataset(files, raw_labels=labels,
                                   classmap=classmap, max_audio_length=1,
                                   sr=SR, seed=3),
                       common.default_ladder(1), batch_size=2, train=True,
                       seed=5, num_workers=num_workers)


def _model(seed):
    torch.manual_seed(seed)
    return TwoDimensionalCNN(**NETWORK, n_classes=N_CLASSES)


def _engine():
    cfg = types.SimpleNamespace(optimizer="adam", learning_rate=1e-3,
                                scheduler="steplr_1_0.5", weight_decay=0.0)
    return Engine(_model(0), Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu"),
                  cfg, augment=make_augmenter(AugmentConfig(
                      p_mixup=0.5, p_aug=0.5, p_shuffle=0.5)),
                  seed=3, device="cpu")


def _predictor():
    return EnsemblePredictor([_model(1), _model(2)],
                             Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu"),
                             "cpu")


def _names(records):
    names = {}
    for r in records:
        names[r.name] = names.get(r.name, 0) + 1
    return names


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_off_by_default_records_nothing_and_opens_no_range(counted_ranges):
    assert not profiling.enabled()
    with profiling.span("off", batch=1):
        pass
    assert profiling.span("a") is profiling.span("b")
    assert counted_ranges == [] and profiling.spans() == []


@pytest.mark.parametrize("switch", ["tracing", "profiler"])
def test_tracing_and_an_active_profiler_each_turn_spans_on(
        switch, counted_ranges, monkeypatch):
    """On, a span opens the profiler's range, and an NVTX range where CUDA
    is available (which the span alone asks here)."""
    block = (profiling.tracing() if switch == "tracing"
             else torch.profiler.profile(
                 activities=[torch.profiler.ProfilerActivity.CPU]))
    with block:
        assert profiling.enabled()
        with profiling.span("on"):
            pass
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with profiling.span("on, with a card"):
            pass
        monkeypatch.undo()
    assert not profiling.enabled()
    with profiling.span("after"):
        pass
    assert [r.name for r in profiling.spans()] == ["on", "on, with a card"]
    assert counted_ranges == ["on", "on, with a card", "on, with a card"]


def test_records_hold_threads_parents_and_attributes():
    with profiling.tracing():
        with profiling.span("outer", step=4):
            with profiling.span("inner"):
                pass
            with profiling.span("sibling", fold=1):
                pass

        def worker():
            with profiling.span("on_thread", batch=2):
                pass

        thread = threading.Thread(target=worker)
        thread.start()
        thread.join()
    records = profiling.spans()
    assert [r.name for r in records] == ["outer", "inner", "sibling",
                                         "on_thread"]
    outer, inner, sibling, other = records
    assert outer.parent is None and other.parent is None
    assert inner.parent == 0 and sibling.parent == 0
    assert outer.attrs == {"step": 4} and sibling.attrs == {"fold": 1}
    assert other.attrs == {"batch": 2}
    assert outer.thread == threading.get_ident() != other.thread
    for r in records:
        assert r.start_ns <= r.end_ns
    assert outer.start_ns <= inner.start_ns <= sibling.end_ns <= outer.end_ns
    assert profiling.spans() == records  # reading does not clear
    profiling.reset()
    assert profiling.spans() == []


def test_a_span_open_across_reset_is_no_parent():
    with profiling.tracing():
        with profiling.span("before"):
            profiling.reset()
            with profiling.span("after"):
                pass
    [after] = profiling.spans()
    assert after.name == "after" and after.parent is None


def test_annotate_opens_its_ranges_always_and_keeps_a_record_when_on(
        counted_ranges):
    with profiling.annotate("always"):
        pass
    assert counted_ranges == ["always"]
    assert profiling.spans() == []
    with profiling.tracing(), profiling.annotate("kept"):
        pass
    assert [r.name for r in profiling.spans()] == ["kept"]


def test_main_thread_span_lies_on_the_profilers_clock():
    """A span's recorded start and end lie within 0.5 ms of the kineto
    user annotation of the same range."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("clocked"):
            torch.randn(64, 64) @ torch.randn(64, 64)
            time.sleep(0.002)
    [record] = profiling.spans()
    [event] = [e for e in prof.profiler.kineto_results.events()
               if e.name() == "clocked" and e.is_user_annotation()]
    start = event.start_ns()
    end = start + event.duration_ns()
    assert abs(record.start_ns - start) < 500_000
    assert abs(record.end_ns - end) < 500_000


def test_maybe_trace_writes_spans_json_beside_the_trace(tmp_path):
    log_dir = str(tmp_path / "profile")
    with profiling.tracing(), profiling.span("before the trace"):
        pass
    for _ in range(2):  # a second traced block adds its spans
        with profiling.maybe_trace(log_dir):
            with profiling.span("traced", step=7):
                with profiling.span("nested"):
                    pass
    events = json.load(open(os.path.join(log_dir,
                                         "spans.json")))["traceEvents"]
    assert [e["name"] for e in events] == ["traced", "nested"] * 2
    traced, nested = events[:2]
    assert traced["ph"] == "X" and traced["args"]["step"] == 7
    assert nested["args"]["parent"] == traced["args"]["index"] == 0
    assert traced["tid"] == threading.get_ident()
    assert traced["ts"] <= nested["ts"] and nested["dur"] <= traced["dur"]
    assert abs(traced["ts"] - time.time_ns() / 1e3) < 60e6
    assert [r.name for r in profiling.spans()] == ["traced", "nested"]


# ---------------------------------------------------------------------------
# the loader, the engine and the ensemble
# ---------------------------------------------------------------------------


def test_loader_decode_spans_from_worker_threads_carry_positions(clips):
    loader = _train_loader(clips, num_workers=2)
    with profiling.tracing():
        batches = list(loader)
    records = profiling.spans()
    decodes = [r for r in records if r.name == "loader.decode"]
    waits = [r for r in records if r.name == "loader.wait"]
    assert sorted(r.attrs["batch"] for r in decodes) == list(
        range(len(batches)))
    assert {r.thread for r in decodes}.isdisjoint({threading.get_ident()})
    # one wait a batch, and the last for the pass's end, all on this thread
    assert [r.attrs["batch"] for r in waits] == list(range(len(batches) + 1))
    assert {r.thread for r in waits} == {threading.get_ident()}


def test_loader_with_no_workers_decodes_on_the_consumers_thread(clips):
    loader = _train_loader(clips, num_workers=0)
    with profiling.tracing():
        n = len(list(loader))
    records = profiling.spans()
    assert [r.attrs["batch"] for r in records] == list(range(n))
    assert {r.name for r in records} == {"loader.decode"}
    assert {r.thread for r in records} == {threading.get_ident()}


def test_a_consumer_that_stops_stops_the_producer(clips, monkeypatch):
    """A consumer breaking after one batch, once the producer waits on a
    full queue, leaves no producer blocked there: the thread exits within
    a second, the pass's decodes not yet started cancelled (a decode here
    takes 20 ms a clip)."""
    files, labels = clips
    loader = _train_loader((files * 4, labels * 4), num_workers=1)
    decode = loader.dataset.decode

    def slow(*args, **kwargs):
        time.sleep(0.02)
        return decode(*args, **kwargs)

    monkeypatch.setattr(loader.dataset, "decode", slow)
    assert len(loader) >= 20
    before = set(threading.enumerate())
    with profiling.tracing():
        for _ in loader:
            time.sleep(0.3)  # the queue fills and the producer waits
            started = sum(r.name == "loader.decode"
                          for r in profiling.spans())
            break
        producers = [t for t in threading.enumerate()
                     if t.name == "DataLoader producer" and t not in before]
        for thread in producers:
            thread.join(timeout=1.0)
            assert not thread.is_alive()
    decoded = [r for r in profiling.spans() if r.name == "loader.decode"]
    assert len(decoded) <= started + 3 < len(loader)


def test_train_epoch_records_each_span_once_a_step(clips):
    engine = _engine()
    loader = _train_loader(clips, num_workers=2)
    engine.make_optimizer(2 * len(loader), len(loader))
    engine.train_epoch(loader, log_interval=100)  # untraced: nothing kept
    assert profiling.spans() == []
    with profiling.tracing():
        stats = engine.train_epoch(loader, log_interval=100)
    steps = stats["steps"]
    names = _names(profiling.spans())
    for name in STAGES + ("h2d", "loader.decode"):
        assert names.pop(name) == steps, name
    assert names.pop("loader.wait") == steps + 1
    assert names == {}
    main = threading.get_ident()
    assert {r.thread for r in profiling.spans()
            if r.name in STAGES + ("h2d",)} == {main}


def test_predict_loader_records_each_span_once_a_batch(clips):
    files, _ = clips
    loader = make_loader(ClipDataset(files, sr=SR),
                         common.default_ladder(None), batch_size=4,
                         num_workers=1)
    predictor = _predictor()
    with profiling.tracing():
        probs = predictor.predict_loader(loader)
    assert probs.shape == (len(files), N_CLASSES)
    batches = len(loader)
    records = profiling.spans()
    names = _names(records)
    for name in ("h2d", "predict.frontend", "predict.readback",
                 "loader.decode"):
        assert names.pop(name) == batches, name
    assert names.pop("predict.fold") == 2 * batches
    assert names.pop("loader.wait") == batches + 1
    assert names == {}
    folds = [r.attrs["fold"] for r in records if r.name == "predict.fold"]
    assert folds == [0, 1] * batches


def test_spans_off_the_train_and_predict_paths_open_and_keep_nothing(
        clips, counted_ranges):
    """With spans off, a train epoch and a predict pass open no range of
    the port's and keep no record."""
    engine = _engine()
    loader = _train_loader(clips, num_workers=2)
    engine.make_optimizer(len(loader), len(loader))
    engine.train_epoch(loader, log_interval=100)
    files, _ = clips
    _predictor().predict_loader(make_loader(
        ClipDataset(files, sr=SR), common.default_ladder(None),
        batch_size=4, num_workers=1))
    assert counted_ranges == [] and profiling.spans() == []
