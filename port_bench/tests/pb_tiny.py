"""Tiny versions of the cells, which the CPU runs in seconds: two blocks
of depth 8, 32 mel bands, 24 clips of 0.4-3 s (20 to predict), float32."""

from __future__ import annotations

import torch

TINY_CONFIG = {"num_conv_blocks": 2, "conv_base_depth": 8, "growth_rate": 1.5,
               "start_deep_supervision_on": 0, "features": "mel_512_256_32",
               "batch_size": 4, "max_audio_length": 2, "fold_clips": 24,
               "dtype": "float32"}
TINY_TRAFFIC = {"lengths": {"dist": "lognormal", "mu": 0.0, "sigma": 0.5,
                            "min_s": 0.4, "max_s": 3.0},
                "num_workers": 2}
TINY_INFER = {"n_clips": 20, "check_rows": 12, "batch_size": 8}


def tiny_cell(name: str, config: str | None = None, **traffic):
    """The cell ``name`` at the tiny size, with ``traffic`` overriding its
    mix's parameters. A name of BENCHMARK.json, or ``resnet34.train_aug``:
    ``melcnn2d.train_aug`` with ``configs/resnet34.json`` and
    ``cells/resnet34.train_aug.json``; ``config`` puts
    ``configs/<config>.json`` in place of the configuration."""
    from port_bench import spec

    if name == "resnet34.train_aug":
        c = spec.load_cell("melcnn2d.train_aug")._replace(
            name=name, **spec.checks(name))
        config = config or "resnet34"
    else:
        c = spec.load_cell(name)
    cfg = (c.config if config is None
           else spec.load_json(spec.BENCH_DIR / "configs" / f"{config}.json"))
    mix = dict(c.traffic, **TINY_TRAFFIC)
    if mix["entry"] == "infer":
        mix.update(TINY_INFER)
    mix.update(traffic)
    return c._replace(config=dict(cfg, **TINY_CONFIG), traffic=mix)


def run_tiny(name: str, data_root, seed: int = 2 ** 31 + 17,
             trace: bool = False, seconds: float = 0.5,
             config: str | None = None, **traffic) -> dict:
    """One whole run of the tiny cell on the CPU: its result line's dict."""
    from port_bench import run as run_lib

    r = run_lib.Run(cell=tiny_cell(name, config, **traffic), seed=seed,
                    seconds=seconds, trace=trace,
                    device=torch.device("cpu"), data_root=data_root)
    return run_lib.execute(r)
