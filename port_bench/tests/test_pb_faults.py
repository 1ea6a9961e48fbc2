"""A run drives the port with a fault planted underneath (``faults.py``)
and ``correct`` comes out false; the control, the reference computed in
fp8 in the port's place, comes out not correct under each cell's limits.
Tiny cells on the CPU; the sound runs beside them come out correct."""

from __future__ import annotations

import pytest
import torch

from port_bench import control, faults, harness
from port_bench.entries import train as train_entry
from port_bench.entries import infer as infer_entry
from port_bench.reference.model import FP8
from port_bench.run import Run
from pb_tiny import run_tiny, tiny_cell

CASES = [("melcnn2d.train_noaug", f) for f in faults.TRAIN] + [
    ("melcnn2d.train_aug", "unchanged"), ("resnet34.train_aug", "half_train")
] + [("melcnn2d.infer_5fold", f) for f in faults.INFER]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault, data_root):
    with faults.planted(fault):
        out = run_tiny(name, data_root)
    assert out["correct"] is False


@pytest.mark.parametrize("name", ["melcnn2d.train_noaug",
                                  "melcnn2d.infer_5fold"])
def test_sound_run_is_correct(name, data_root):
    assert run_tiny(name, data_root)["correct"] is True


@pytest.mark.parametrize("name", ["melcnn2d.train_aug", "resnet34.train_aug",
                                  "melcnn2d.train_noaug",
                                  "melcnn2d.infer_5fold"])
def test_control_is_not_correct(name, data_root):
    cell = tiny_cell(name)
    run = Run(cell=cell, seed=2 ** 31 + 5, seconds=0.0, trace=False,
              device=torch.device("cpu"), data_root=data_root)
    sound = control._program(run, harness.port(), None)
    run.window_closed()
    if cell.traffic["entry"] == "train":
        ref, low = sound.reference(), sound.reference(FP8)
        readings = train_entry.gaps(
            {"names": low["names"], "losses_first": low["losses"],
             "row_losses": low["row_losses"], "grad": low["grad"],
             "change": low["change"]}, ref, cell.leave_out)
    else:
        (rows, want), (_, low) = sound.reference(), sound.reference(FP8)
        readings = {"prob_gap": infer_entry.gap([low], slice(None), want)}
    correct, _ = harness.verdict(readings, cell.limits, [])
    assert correct is False
