"""A training cell: the port's ``Engine.train_epoch`` over its bucketed train
loader, whole epochs at a time, as the train CLI drives one fold.

Set-up builds one engine (model, optimizer, augmenter) from the seed and
trains its first epoch through the same loader and call as the window: the
first three steps are the ones the reference follows (their losses, the
first gradient as Adam's state holds it after step 1, each leaf's change
after step 3), the rest of the epoch warms every bucket's shapes. The
window then trains whole epochs until ``--seconds`` have passed; a traced
run profiles whole epochs more after it.
"""

from __future__ import annotations

import contextlib
import sys
import types

import numpy as np
import torch

from port_bench import corpus, flops, harness, weights
from port_bench import trace as trace_lib
from port_bench.feed import Feed
from port_bench.reference import frontend as ref_frontend
from port_bench.reference import train as ref_train
from port_bench.reference.model import FP32, Quant, head_width

CHECKED_STEPS = 3
TRACE_SECONDS = 4.0  # at least this much of whole epochs is traced


def dropout_masks(cfg: dict, rows: int, seed: int, device, n: int) -> list:
    """The head's dropout masks of the first ``n`` steps, worked out from
    the seed of the device's default generator: the same draw the model
    makes, one (rows, width) tensor of the model's type a step."""
    if device.type == "cuda":
        torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)
    ones = torch.ones(rows, head_width(cfg), dtype=harness.dtype_of(cfg),
                      device=device)
    return [torch.nn.functional.dropout(ones, cfg["output_dropout"],
                                        training=True).float()
            for _ in range(n)]


class TrainCell:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.traffic = run.cell.traffic
        self.device = run.device
        self.s = harness.seeds(run.seed)
        self.attempted = self.failed = 0  # over the window and the trace

    # ------------------------------------------------------------------
    def setup(self, p, kernel_log) -> None:
        cfg, traffic, s = self.cfg, self.traffic, self.s
        n = cfg["fold_clips"]
        self.paths, self.samples = corpus.corpus(
            traffic["lengths"], n, traffic["corpus_seed"],
            threads=traffic["num_workers"], root=self.run.data_root)
        harness.stamp(self.run, "corpus ready")
        rng = np.random.default_rng(s["data"])
        self.order = rng.permutation(n)
        labels = corpus.label_strings(n, cfg["n_classes"],
                                      traffic["labels_per_clip"], rng)
        files = [self.paths[i] for i in self.order]
        classmap = corpus.classmap(cfg["n_classes"])
        self.dataset = p.dataset.ClipDataset(
            files, raw_labels=labels, classmap=classmap,
            max_audio_length=cfg["max_audio_length"], sr=cfg["sr"],
            seed=s["crop"])
        loader = p.loader.make_loader(
            self.dataset, harness.ladder(p, cfg["max_audio_length"],
                                         cfg["sr"]),
            batch_size=cfg["batch_size"], train=True, seed=s["loader"],
            num_workers=traffic["num_workers"])
        self.feed = Feed(loader, self.device.type == "cuda")
        state = weights.make(cfg, s["weights"], self.device)[0]
        model = harness.build_model(p, cfg, state, self.device)
        frontend = harness.frontend(p, cfg, self.device)
        augment = p.augment.make_augmenter(p.augment.AugmentConfig(
            p_mixup=cfg["p_mixup"], p_aug=cfg["p_aug"],
            p_shuffle=cfg["p_shuffle"], sr=cfg["sr"]))
        train_config = types.SimpleNamespace(
            optimizer=cfg["optimizer"], learning_rate=cfg["lr"],
            scheduler=cfg["scheduler"], weight_decay=cfg["weight_decay"],
            accumulation_steps=1)
        self.engine = p.engine.Engine(
            model, frontend, train_config, loss=cfg["loss"], augment=augment,
            seed=s["engine"], device=self.device)
        steps = len(self.feed)
        self.engine.make_optimizer(steps * cfg["epochs"], steps)
        self.aug_scale = float(traffic["aug_scale"])
        harness.stamp(self.run, "engine built")
        self._checked_steps(model)
        self.epoch()  # the checked steps, then every bucket's shapes
        self.sync()
        harness.stamp(self.run, "first epoch trained")

    def _checked_steps(self, model) -> None:
        """Hooks that read the train state around the first steps."""
        names = [k for k, _ in model.named_parameters()]
        params = dict(model.named_parameters())
        start = {k: v.detach().clone() for k, v in params.items()}
        self.truth = {"names": names}
        beta1 = 0.9

        def first_grad():
            # no optimizer state after a step is no gradient: NaN
            state = self.engine.optimizer.state
            self.truth["grad"] = torch.stack([
                (state[params[k]]["exp_avg"] / (1.0 - beta1)).double().norm()
                if "exp_avg" in state.get(params[k], {})
                else torch.tensor(float("nan"), dtype=torch.float64,
                                  device=self.device)
                for k in names])

        def change():
            self.truth["change"] = torch.stack([
                (params[k].detach() - start[k]).double().norm()
                for k in names])
            start.clear()
            self.engine.loss_fn = loss_fn

        # the rows' losses of the checked steps, as the engine computes them
        loss_fn, rows = self.engine.loss_fn, []
        self.truth["row_losses"] = rows

        def recording(logits, labels, average=True):
            out = loss_fn(logits, labels, average=average)
            if not average:
                rows.append(out.detach().double().clone())
            return out

        self.engine.loss_fn = recording

        self.feed.hooks = {1: first_grad, CHECKED_STEPS: change}
        self.feed.keep = CHECKED_STEPS
        torch_seed = self.s["dropout"]
        if self.device.type == "cuda":
            torch.cuda.manual_seed(torch_seed)
        else:
            torch.manual_seed(torch_seed)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def epoch(self) -> dict:
        with contextlib.redirect_stdout(sys.stderr):
            stats = self.engine.train_epoch(
                self.feed, aug_scale=self.aug_scale,
                log_interval=self.traffic["log_interval"])
        if "losses_first" not in self.truth:
            self.truth["losses_first"] = np.asarray(
                stats["losses"][:CHECKED_STEPS], dtype=np.float64)
        return stats

    # ------------------------------------------------------------------
    def count(self, losses: list) -> None:
        losses = np.concatenate(losses)
        self.attempted += len(losses)
        self.failed += int((~np.isfinite(losses)).sum())

    def window(self, seconds: float) -> dict:
        """Whole epochs until ``seconds`` have passed: the end-to-end
        metrics, and ``self.measured``."""
        feed = self.feed
        feed.timing, feed.events, feed.shapes, feed.waits = True, [], [], []
        losses = []
        t0 = harness.now()
        while harness.now() - t0 < seconds:
            losses.append(self.epoch()["losses"])
        feed.mark()
        self.sync()
        wall = harness.now() - t0
        feed.timing = False
        steps = feed.step_seconds()
        clips = sum(rows for rows, _ in feed.shapes)
        self.count(losses)
        self.measured = harness.Window(
            seconds=wall, clips=clips, waits=list(feed.waits),
            flops=sum(flops.train_step(self.cfg, rows, length)
                      for rows, length in feed.shapes))
        return {"train_clips_per_s": clips / wall,
                "train_step_p95_ms": 1e3 * float(np.percentile(steps, 95))}

    def traced(self, p, kernel_log, seconds: float) -> harness.Readings:
        """After the window, whole epochs under the profiler, at least
        ``TRACE_SECONDS`` (or ``seconds`` where shorter), with the engine's
        ranges on."""
        feed, engine = self.feed, self.engine
        feed.timing, feed.tracing = True, True
        feed.events, feed.shapes, feed.waits = [], [], []
        engine._stage = p.profiling.annotate
        kernel_log.on = True
        holder, losses = {}, []
        with trace_lib.profiled(holder):
            t0 = harness.now()
            while harness.now() - t0 < min(seconds, TRACE_SECONDS):
                losses.append(self.epoch()["losses"])
        kernel_log.on = False
        engine._stage = p.engine._no_range
        feed.timing = feed.tracing = False
        self.count(losses)
        t = holder["trace"]
        return harness.Readings(
            kind="train", window=self.measured, trace=t,
            batches=len(feed.shapes),
            clips=sum(rows for rows, _ in feed.shapes),
            kernel_bound_s=kernel_log.bounds(),
            kernel_device_s=harness.kernel_device_seconds(t, kernel_log),
            cuda=self.device.type == "cuda")

    # ------------------------------------------------------------------
    def free(self) -> None:
        for key in ("grad", "change"):
            self.truth[key] = self.truth[key].cpu().numpy()
        self.truth["row_losses"] = [r.cpu().numpy()
                                    for r in self.truth["row_losses"]]
        del self.engine
        self.feed.loader = None

    def reference(self, q: Quant = FP32) -> dict:
        """The reference's readings of the checked steps (``q``: the
        precision of its model)."""
        cfg, s = self.cfg, self.s
        wavs = [ref_frontend.read_wav(path) for path in
                (self.paths[i] for i in self.order)]
        labels = self.dataset.labels
        max_samples = int(cfg["max_audio_length"] * cfg["sr"])
        problems = [m for m in (ref_train.check_rows(b, wavs, labels,
                                                     max_samples)
                                for b in self.feed.kept) if m]
        rows = [b["signal"].shape[0] for b in self.feed.kept]
        masks = dropout_masks(cfg, rows[0], s["dropout"], self.device,
                              len(rows))
        state = weights.make(cfg, s["weights"], self.device)[0]
        steps = self.steps_per_epoch()
        with torch.autocast(self.device.type, enabled=False):
            out = ref_train.follow(cfg, self.feed.kept, state, self.aug_scale,
                                   s["engine"], masks, steps, self.device, q)
        out["problems"] = problems
        return out

    def steps_per_epoch(self) -> int:
        """Full batches an epoch, from the clip lengths and the ladder."""
        cfg = self.cfg
        ladder = ref_frontend.bucket_ladder(
            int(cfg["max_audio_length"] * cfg["sr"]), cfg["sr"] // 2)
        crop = int(cfg["max_audio_length"] * cfg["sr"])
        counts = {}
        for n in self.samples:
            b = ref_frontend.bucket_length(min(int(n), crop), ladder)
            counts[b] = counts.get(b, 0) + 1
        return sum(c // cfg["batch_size"] for c in counts.values())


def gaps(truth: dict, ref: dict, leave_out: tuple = ()) -> dict:
    """The readings of the checked steps against the reference's:

    - each step's loss gap over the reference's loss: the first step's
      (``loss_gap_first``) and the worst (``loss_gap``);
    - the first step's rows' losses: the root mean square of their gaps
      over the mean of the reference's (``row_loss_gap``);
    - each leaf's gap of first-gradient norms and of change norms, over
      the larger of the reference's norm of that leaf and of the median
      leaf: the worst leaf (``grad_gap``, ``change_gap``), the median
      leaf (``*_median``) and the 95th percentile (``grad_gap_q95``);
    - ``grad_gap_worst``: the worst gradient gap of the moved leaves (as
      below) whose names start with none of ``leave_out``;
    - ``rounding_grad``: over the leaves whose reference gradient is under
      a thousandth of the median leaf's (nought to rounding, as a bias
      before a BatchNorm), the largest gradient gap over the median leaf's
      norm: the arithmetic's rounding alone. Those leaves are left out of
      the change and of ``grad_gap_worst``; the others are the moved
      leaves."""
    if sorted(truth["names"]) != sorted(ref["names"]):
        raise ValueError("the port's leaves are not the reference's")
    at = {name: i for i, name in enumerate(truth["names"])}
    order = [at[name] for name in ref["names"]]
    truth = dict(truth, grad=np.asarray(truth["grad"])[order],
                 change=np.asarray(truth["change"])[order])
    loss = np.abs(truth["losses_first"] - ref["losses"]) / np.abs(
        ref["losses"])
    g_ref, g = ref["grad"], truth["grad"]
    grad = np.abs(g - g_ref) / np.maximum(g_ref, np.median(g_ref))
    moved = g_ref >= 1e-3 * np.median(g_ref)
    rounding = (np.abs(g - g_ref)[~moved].max() / np.median(g_ref)
                if (~moved).any() else float("nan"))
    kept = moved & ~np.array([n.startswith(tuple(leave_out))
                              for n in ref["names"]])
    c_ref, c = ref["change"][moved], truth["change"][moved]
    change = np.abs(c - c_ref) / np.maximum(c_ref, np.median(c_ref))
    rows, rows_ref = truth["row_losses"][0], ref["row_losses"][0]
    row = np.sqrt(np.mean((rows - rows_ref) ** 2)) / np.abs(rows_ref).mean()
    return {"loss_gap_first": float(loss[0]), "loss_gap": float(loss.max()),
            "row_loss_gap": float(row),
            "grad_gap": float(grad.max()),
            "grad_gap_worst": float(grad[kept].max()),
            "grad_gap_median": float(np.median(grad)),
            "grad_gap_q95": float(np.quantile(grad, 0.95)),
            "rounding_grad": float(rounding),
            "change_gap": float(change.max()),
            "change_gap_median": float(np.median(change))}


def run(r, p, kernel_log) -> dict:
    cell = TrainCell(r)
    cell.setup(p, kernel_log)
    r.setup_done()
    metrics, readings = harness.measure(r, cell, p, kernel_log)
    peak = torch.cuda.max_memory_allocated() if r.cuda else 0
    cell.free()
    r.window_closed()
    ref = cell.reference()
    correct, shown = harness.verdict(gaps(cell.truth, ref, r.cell.leave_out),
                                     r.cell.limits,
                                     ref["problems"])
    return {"correct": correct, "attempted": cell.attempted,
            "failed": cell.failed, "metrics": metrics,
            "device": harness.device_info(
                r.cuda, readings.trace if readings else None, peak),
            "readings": readings, "check": shown}
