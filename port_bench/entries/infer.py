"""An inference cell: the port's ``EnsemblePredictor.predict_loader`` over
the predict CLI's loader, whole passes over the test set at a time.

Set-up draws the folds' weights from the seed (their BatchNorm statistics
calibrated by the reference on the seed's first clips, so the eval-mode
activations have a trained model's scale), builds the ensemble as the
predict CLI does (unfused, bf16), and runs one pass, which warms every
bucket's shapes. The window runs whole passes until ``--seconds`` have
passed (a traced run profiles whole passes more after it): its end-to-end
metric is the median interval between two batches' hand-overs on the
device's clock, over every batch of the window, and its clips per host
second are logged and read per layer. Every pass's answers are kept, and the rows that the seed samples
(the longest clips among them) are compared with the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import corpus, flops, harness, weights
from port_bench import trace as trace_lib
from port_bench.feed import Feed
from port_bench.reference import frontend as ref_frontend
from port_bench.reference import infer as ref_infer
from port_bench.reference.model import FP32, Quant

TRACE_SECONDS = 4.0
CALIBRATION_CLIPS = 32
CALIBRATION_SECONDS = 5


class InferCell:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.traffic = run.cell.traffic
        self.device = run.device
        self.s = harness.seeds(run.seed)
        self.attempted = self.failed = 0  # over the window and the trace

    def fold_states(self) -> list:
        """The folds' weights, BatchNorm statistics calibrated by the
        reference (its seconds are not set-up: ``Run.not_setup_s``)."""
        t0 = harness.now()
        try:
            return self._fold_states()
        finally:
            self.run.not_setup_s += harness.now() - t0

    def _fold_states(self) -> list:
        cfg, t = self.cfg, self.traffic
        states = weights.make(cfg, self.s["weights"], self.device,
                              n_models=t["n_folds"])
        wavs = [ref_frontend.read_wav(self.files[i])
                for i in range(min(CALIBRATION_CLIPS, len(self.files)))]
        with torch.no_grad():
            return ref_infer.calibrate(
                cfg, states, wavs, CALIBRATION_SECONDS * cfg["sr"],
                self.device)

    def setup(self, p, kernel_log) -> None:
        cfg, t = self.cfg, self.traffic
        paths, self.samples = corpus.corpus(
            t["lengths"], t["n_clips"], t["corpus_seed"],
            threads=t["num_workers"], root=self.run.data_root)
        harness.stamp(self.run, "corpus ready")
        order = np.random.default_rng(self.s["data"]).permutation(
            t["n_clips"])
        self.files = [paths[i] for i in order]
        self.samples = self.samples[order]
        self.ladder = harness.ladder(p, None, cfg["sr"])
        loader = p.loader.make_loader(
            p.dataset.ClipDataset(self.files, sr=cfg["sr"]), self.ladder,
            batch_size=t["batch_size"], train=False, shuffle=False,
            drop_last=False, num_workers=t["num_workers"])
        self.feed = Feed(loader, self.device.type == "cuda")
        models = [harness.build_model(p, cfg, state, self.device)
                  for state in self.fold_states()]
        frontend = harness.frontend(p, cfg, self.device)
        self.predictor = p.ensemble.EnsemblePredictor(models, frontend,
                                                      self.device)
        harness.stamp(self.run, "ensemble built")
        self.passes = [self.predictor.predict_loader(self.feed)]
        self.sync()
        harness.stamp(self.run, "first pass predicted")

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> dict:
        """Whole passes until ``seconds`` have passed: the end-to-end
        metric and the logged rate, and ``self.measured``."""
        feed = self.feed
        feed.timing, feed.events, feed.shapes, feed.waits = True, [], [], []
        t0 = harness.now()
        n = 0
        while harness.now() - t0 < seconds:
            self.passes.append(self.predictor.predict_loader(feed))
            n += 1
        self.sync()
        wall = harness.now() - t0
        feed.timing = False
        self.count(n)
        self.measured = harness.Window(
            seconds=wall, clips=n * self.traffic["n_clips"],
            waits=list(feed.waits), flops=self.flops(feed.shapes))
        return {"infer_batch_p50_ms":
                1e3 * float(np.percentile(feed.step_seconds(), 50)),
                "clips_per_s.infer": self.measured.clips / wall}

    def flops(self, shapes: list) -> float:
        """Every fold's eval forward over the batch shapes."""
        return sum(self.traffic["n_folds"] * flops.forward(self.cfg, rows,
                                                           length)
                   for rows, length in shapes)

    def count(self, n: int) -> None:
        recent = self.passes[-n:]
        self.attempted += n * self.traffic["n_clips"]
        self.failed += int(sum((~np.isfinite(out)).any(axis=1).sum()
                               for out in recent))

    def traced(self, p, kernel_log, seconds: float) -> harness.Readings:
        """After the window, whole passes under the profiler, at least
        ``TRACE_SECONDS`` (or ``seconds`` where shorter)."""
        feed = self.feed
        feed.timing, feed.tracing = True, True
        feed.events, feed.shapes, feed.waits = [], [], []
        kernel_log.on = True
        holder, n = {}, 0
        with trace_lib.profiled(holder):
            t0 = harness.now()
            while harness.now() - t0 < min(seconds, TRACE_SECONDS):
                self.passes.append(self.predictor.predict_loader(feed))
                n += 1
        kernel_log.on = False
        feed.timing = feed.tracing = False
        self.count(n)
        t = holder["trace"]
        return harness.Readings(
            kind="infer", window=self.measured, trace=t,
            batches=len(feed.shapes), clips=n * self.traffic["n_clips"],
            kernel_bound_s=kernel_log.bounds(),
            kernel_device_s=harness.kernel_device_seconds(t, kernel_log),
            cuda=self.device.type == "cuda")

    def free(self) -> None:
        del self.predictor
        self.feed.loader = None

    def sample(self) -> np.ndarray:
        """The checked rows: the longest clips and a draw of the others."""
        t = self.traffic
        n = t["n_clips"]
        k = min(t["check_rows"], n)
        longest = np.argsort(-self.samples, kind="stable")[: k // 8]
        rest = np.setdiff1d(np.arange(n), longest)
        drawn = np.random.default_rng(self.s["sample"]).choice(
            rest, size=k - longest.size, replace=False)
        return np.sort(np.concatenate([longest, drawn]))

    def reference(self, q: Quant = FP32) -> np.ndarray:
        rows = self.sample()
        wavs = [ref_frontend.read_wav(self.files[i]) for i in rows]
        states = self.fold_states()
        ladder = ref_frontend.bucket_ladder(30 * self.cfg["sr"],
                                            self.cfg["sr"] // 2)
        return rows, ref_infer.predict(self.cfg, states, wavs, ladder,
                                       self.device, q)


def gap(passes: list, rows: np.ndarray, want: np.ndarray) -> float:
    """The widest gap of any pass's probability from the reference's, over
    the checked rows and every class."""
    return float(max(np.abs(out[rows] - want).max() for out in passes))


def run(r, p, kernel_log) -> dict:
    cell = InferCell(r)
    cell.setup(p, kernel_log)
    r.setup_done()
    metrics, readings = harness.measure(r, cell, p, kernel_log)
    peak = torch.cuda.max_memory_allocated() if r.cuda else 0
    cell.free()
    r.window_closed()
    rows, want = cell.reference()
    correct, shown = harness.verdict(
        {"prob_gap": gap(cell.passes, rows, want)}, r.cell.limits, [])
    return {"correct": correct, "attempted": cell.attempted,
            "failed": cell.failed, "metrics": metrics,
            "device": harness.device_info(
                r.cuda, readings.trace if readings else None, peak),
            "readings": readings, "check": shown}
