"""The benchmark's analytic FLOP count (``port_bench.flops``) against
``FlopCounterMode`` on the port's plain path, at every configuration's own
widths and a small batch."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import flops, harness, spec, weights
from port_bench.reference.frontend import parse_mel


CONFIGS = sorted(p.stem for p in (spec.BENCH_DIR / "configs").glob("*.json"))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("samples", [44100, 3 * 22050 + 1000])
def test_train_step_flops_match_the_counter(name, samples):
    cfg = dict(spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json"),
               dtype="float32")
    p = harness.port()
    model = harness.build_model(p, cfg, weights.make(cfg, 1, "cpu")[0],
                                "cpu").train()
    _, hop, n_mels = parse_mel(cfg["features"])
    frames = samples // hop + 1
    spec_in = torch.randn(2, n_mels, frames, 1)
    lengths = torch.tensor([frames, frames // 2])
    labels = torch.zeros(2, cfg["n_classes"])
    labels[:, :2] = 1.0
    loss_fn = p.engine.make_loss(cfg["loss"])
    with FlopCounterMode(display=False) as forward_count:
        logits = model(spec_in, lengths)
    assert forward_count.get_total_flops() == flops.forward(cfg, 2, samples)
    with FlopCounterMode(display=False) as step_count:
        loss_fn(model(spec_in, lengths), labels).backward()
    assert step_count.get_total_flops() == flops.train_step(cfg, 2, samples)
    assert logits.shape == (2, cfg["n_classes"])
