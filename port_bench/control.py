"""The readings that the correctness limits are set from, on the card at a
cell's own size, many seeds in one process:

    python3 -m port_bench.control --workload <cell> --seeds 1 2 3 ... \
        [--fault-seeds 1 2 3] [--out readings.jsonl]

For each seed, against the reference:

- the port's sound run, its set-up, whose first epoch holds the checked
  steps (an inference seed: one pass): the lower readings;
- the control, the reference with every value that the port keeps in bf16
  rounded through fp8 (the nearest precision below the configuration's
  bf16), and beside it an int8 rounding: the upper readings;
- for each fault seed, each fault of ``faults.py`` that the cell can have,
  planted in the port.

One JSON line a reading: {"workload", "seed", "kind": "program" |
"control" | "control_int8" | <fault>, readings...}. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from port_bench import faults, harness, spec as spec_lib
from port_bench.entries import infer as infer_entry
from port_bench.entries import train as train_entry
from port_bench.reference.model import FP8, INT8
from port_bench.run import Run, cache_environment


TF32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def _program(run: Run, p, fault):
    """The cell's set-up (the checked steps only, or one inference pass),
    with ``fault`` planted where given, at PyTorch's TF32 settings; returns
    the cell object."""
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        TF32
    ctx = faults.planted(fault) if fault else contextlib.nullcontext()
    kernel_log = harness.KernelLog()
    with ctx:
        if run.cell.traffic["entry"] == "train":
            cell = train_entry.TrainCell(run)
            cell.setup(p, kernel_log)
        else:
            cell = infer_entry.InferCell(run)
            cell.setup(p, kernel_log)
    cell.free()
    return cell


def _train_readings(truth: dict, ref: dict, leave_out: tuple) -> dict:
    """``train_entry.gaps``, each step's loss gap, and the three worst
    leaves of the first gradient and of the change, by name (the look that
    a seed reading far above the others asks for)."""
    out = train_entry.gaps(truth, ref, leave_out)
    out["loss_gaps"] = [float(v) for v in np.abs(
        truth["losses_first"] - ref["losses"]) / np.abs(ref["losses"])]
    at = {name: i for i, name in enumerate(truth["names"])}
    g_ref, c_ref = ref["grad"], ref["change"]
    moved = g_ref >= 1e-3 * np.median(g_ref)
    for key, scale in (("grad", np.median(g_ref)),
                       ("change", np.median(c_ref[moved]))):
        mine = np.array([truth[key][at[n]] for n in ref["names"]])
        gap = np.abs(mine - ref[key]) / np.maximum(ref[key], scale)
        if key == "change":
            gap = np.where(moved, gap, -1.0)
        worst = np.argsort(-np.nan_to_num(gap, nan=np.inf))[:3]
        out[f"{key}_worst"] = [[ref["names"][i], float(mine[i]),
                                float(ref[key][i])] for i in worst]
    return out


def measure(run: Run, p, fault_seeds: set, out) -> None:
    train = run.cell.traffic["entry"] == "train"
    cell = _program(run, p, None)
    run.window_closed()
    t0 = time.perf_counter()
    if train:
        ref = cell.reference()
        ref_s = time.perf_counter() - t0
        leave_out = run.cell.leave_out
        rows = [("program", _train_readings(cell.truth, ref, leave_out))]
        for kind, q in (("control", FP8), ("control_int8", INT8)):
            c = cell.reference(q)
            rows.append((kind, _train_readings(
                {"names": c["names"], "losses_first": c["losses"],
                 "row_losses": c["row_losses"], "grad": c["grad"],
                 "change": c["change"]}, ref, leave_out)))
    else:
        idx, want = cell.reference()
        ref_s = time.perf_counter() - t0
        rows = [("program", {"prob_gap": infer_entry.gap(cell.passes, idx,
                                                         want)})]
        for kind, q in (("control", FP8), ("control_int8", INT8)):
            _, low = cell.reference(q)
            rows.append((kind, {"prob_gap": float(np.abs(low - want).max())}))
    problems = ref.get("problems", []) if train else []
    if run.seed in fault_seeds:
        for fault in (faults.TRAIN if train else faults.INFER):
            bad = _program(run, p, fault)
            run.window_closed()
            if train:
                reading = _train_readings(bad.truth, ref, leave_out)
            else:
                reading = {"prob_gap": infer_entry.gap(bad.passes, idx,
                                                       want)}
            rows.append((fault, reading))
    for kind, reading in rows:
        line = {"workload": run.cell.name, "seed": run.seed, "kind": kind,
                "reference_s": ref_s, "problems": problems, **reading}
        out.write(json.dumps(line) + "\n")
        out.flush()
        harness.log(json.dumps(line))
    if run.cuda:
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    cell = spec_lib.load_cell(args.workload)
    cache_environment(spec_lib.ROOT)
    if not torch.cuda.is_available():
        harness.log("port_bench.control: no CUDA card")
        return 3
    p = harness.port()
    out = open(args.out, "a") if args.out else sys.stdout
    try:
        for seed in args.seeds:
            run = Run(cell=cell, seed=seed, seconds=0.0, trace=False,
                      device=torch.device("cuda", 0))
            measure(run, p, set(args.fault_seeds), out)
    finally:
        if args.out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
