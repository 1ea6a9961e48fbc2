"""Time kernels of copies of the port in turns, one process a copy.

    python -m freesound_classification_tpu_torch.probes.kernel_turns \\
        k8,k6 v1=build/v1 v2=build/v2 v2_timing=build/v2_timing:nocheck

Each copy is a directory holding a ``freesound_classification_tpu_torch``
package (its own ``csrc/``, built into its own ``build/``): a version of a
kernel to compare, or one made only to time a part of it (``:nocheck``).
The copies are built together; then each is timed in its own process, in
turns (first to last, then back), at the paths' shapes: K8 at the 2d
CNN's block0 head (B 128 x 10 s: (128, 2, 128, 431) -> (128, 64, 64,
215)), K6 at the hierarchical model's six block shapes on channels-
contiguous maps, K2 at the effects chain's shape for the bench's train
batch (48 rows x 10 s; unmasked, and the chain's masked call
``augment.resample_rate``), K9 at the probe's shape (64 clips x 10 s of a
bf16 [re | im] spectrum, F 1025, M 128), and ``step``: one augmented train
step of the bench (B = 64 x 10 s), its device busy time beside it. A copy
is first checked against its plain twin (one bf16 step of the largest
output for K6 and K8, 1e-6 for K2, 1e-4 for K9) unless it is
``:nocheck``. Per run: ms per call by CUDA events (50 calls after 3
warm-up calls), and each call's device time by ``torch.profiler``, in sum
and by kernel. The first line is the card's name and power limit.

The timing helpers (``cuda_ms``, ``device_kernels``) and the inputs of K2
and K9 (``k2_inputs``, ``k9_inputs``) are also ``chip_smoke.py``'s.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

K6_SHAPES = ((128, 64, 215), (128, 96, 107), (128, 144, 53),
             (128, 216, 26), (128, 324, 13), (128, 486, 6))
K8_SHAPE = (128, 2, 128, 431)
K8_DEPTH = 64
K2_SHAPE = (48, 441000)
K2_TOL = 1e-6
K9_CLIPS = 64
K9_TOL = 1e-4
SR = 44100


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events, after
    three warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn, calls: int = 5) -> list:
    """The device kernels under ``fn`` by ``torch.profiler``: (name, mean
    ms per call of ``fn``, launches per call), longest first; empty where
    the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    found = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0)
        if us > 0:
            name = e.key.replace("void ", "").replace(
                "(anonymous namespace)::", "")
            found.append((name, us / calls / 1e3, e.count / calls))
    return sorted(found, key=lambda k: -k[1])


def _device_split(fn, calls: int = 10) -> dict:
    """The device time of one call of ``fn`` by kernel name, in ms."""
    return {name: ms for name, ms, _ in device_kernels(fn, calls)}


def _device_ms(fn, calls: int = 10) -> float:
    """The device time of one call of ``fn``, summed over its kernels."""
    return sum(_device_split(fn, calls).values())


def chain_wave(rows: int, length: int, seed: int):
    """Tones plus noise at clip-like levels, on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.arange(length, device="cuda") / SR
    freq = 100.0 + 4000.0 * torch.rand(rows, 1, device="cuda", generator=gen)
    return (0.3 * torch.sin(2 * torch.pi * freq * t)
            + 0.05 * torch.randn(rows, length, device="cuda", generator=gen))


def k2_inputs(rows: int, length: int) -> tuple:
    """K2's wave, factors and valid lengths as the effects chain gives
    them: clip-like rows, speed U(0.9, 1.1) x 2^(cents/1200) with |cents|
    < 300, and lengths of half to all of a row."""
    import torch

    wave = chain_wave(rows, length, 1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    factor = (0.9 + 0.2 * torch.rand(rows, device="cuda", generator=gen)) \
        * torch.exp2((600 * torch.rand(rows, device="cuda", generator=gen)
                      - 300) / 1200)
    lengths = torch.randint(length // 2, length + 1, (rows,), device="cuda",
                            generator=gen, dtype=torch.int32)
    return wave, factor, lengths


def k9_inputs(clips: int) -> tuple:
    """K9's bf16 [re | im] spectrum, as the fast featurization makes it of
    ``clips`` clip-like waves of 10 s, and its (F, M) filterbank."""
    from freesound_classification_tpu_torch.ops import fast_featurize

    front = fast_featurize.FastFrontend("mel_2048_1024_128", sr=SR,
                                        device="cuda")
    return (fast_featurize.cat_dft_spectrum(chain_wave(clips, 10 * SR, 9),
                                            front.basis), front.fb_t)


def _error(got, want) -> tuple:
    got, want = got.float(), want.float()
    return ((got - want).abs().max().item(),
            2.0 ** -7 * want.abs().max().item())


def _block(block, prefix: str, seed: int, **net):
    """``block`` with the random JAX-layout variables of ``interop`` (a
    one-block network ``net``) under ``prefix``, eval, on the card."""
    from freesound_classification_tpu_torch import interop

    params, stats = interop.random_jax_variables(
        num_conv_blocks=1, start_deep_supervision_on=0, growth_rate=1.0,
        n_classes=2, seed=seed, **net)
    block.load_state_dict({
        k[len(prefix):]: v
        for k, v in interop.from_jax_variables(params, stats).items()
        if k.startswith(prefix)})
    return block.cuda().eval()


def child(what: list, check: bool) -> dict:
    """Time this process's copy of the port (first on ``sys.path``)."""
    import torch

    from freesound_classification_tpu_torch.models import blocks
    from freesound_classification_tpu_torch.ops import (
        head_infer,
        kernels,
        resnet_infer,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    if "k8" in what:
        block = _block(blocks.ConvBlock2d(K8_SHAPE[1], K8_DEPTH),
                       "blocks.0.", 50, conv_base_depth=K8_DEPTH)
        wts = resnet_infer.fused_weights(block, head_infer.fold_head_params,
                                         kernels.pack_conv_head)
        b, _, h, w = K8_SHAPE
        gen = torch.Generator(device="cuda").manual_seed(52)
        spec = 3.0 * torch.randn(b, h, w, 1, device="cuda",
                                 generator=gen) - 5.0
        freq = torch.linspace(-1.0, 1.0, h, device="cuda")[None, :, None,
                                                            None]
        x = torch.cat([spec, freq.expand(b, h, w, 1)], dim=-1).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        err, tol = _error(kernels.conv_head_fused(x, wts),
                          kernels.conv_head_fused_reference(x, wts))
        if check and not err <= tol:
            raise SystemExit(f"K8 disagrees with its plain twin: {err}")

        def run():
            return kernels.conv_head_fused(x, wts)

        out["k8"] = {"ms": cuda_ms(run, 50), "device_ms": _device_ms(run),
                     "err": err}
    if "k6" in what:
        ms, device = [], []
        for i, shape in enumerate(K6_SHAPES):
            block = _block(blocks.ResnetBlock1d(shape[1]),
                           "blocks.0.resnet.", 20 + 2 * i,
                           conv_base_depth=shape[1],
                           model_kind="hierarchical_cnn", input_dim=8)
            wts = resnet_infer.fused_weights(
                block, resnet_infer.fold_block_params_1d)
            gen = torch.Generator(device="cuda").manual_seed(20 + 2 * i)
            x = torch.randn(shape, device="cuda", generator=gen).to(
                torch.bfloat16).transpose(1, 2).contiguous().transpose(1, 2)
            err, tol = _error(
                kernels.resnet_block_1d_fused(x, wts),
                kernels.resnet_block_1d_fused_reference(x, wts))
            if check and not err <= tol:
                raise SystemExit(f"K6 {shape} disagrees with its plain "
                                 f"twin: {err}")

            def run():
                return kernels.resnet_block_1d_fused(x, wts)

            ms.append(cuda_ms(run, 50))
            device.append(_device_ms(run))
        out["k6"] = {"ms": ms, "sum": sum(ms), "device_ms": device,
                     "device_sum": sum(device)}
    if "k2" in what:
        out["k2"] = _k2(check)
    if "k9" in what:
        out["k9"] = _k9(check)
    if "step" in what:
        from freesound_classification_tpu_torch import bench

        device = torch.device("cuda")
        engine = bench.train_engine(device, bench.NETWORK, True, 16)
        wave, lengths, labels = bench.train_batch(device)

        def step():
            engine.train_step(wave, lengths, labels)

        out["step"] = {"ms": cuda_ms(step, iters=5),
                       "busy_ms": _device_ms(step, calls=3)}
    return out


def _k2(check: bool) -> dict:
    """K2 unmasked and through the chain's masked call (``k2_inputs``)."""
    from freesound_classification_tpu_torch.ops import augment, kernels

    wave, factor, lengths = k2_inputs(*K2_SHAPE)
    want = kernels.resample_linear_reference(wave, factor)
    want_masked = kernels.resample_linear_reference(wave, factor, lengths)
    err = (kernels.resample_linear(wave, factor) - want).abs().max().item()
    err_masked = (augment.resample_rate(wave, lengths, factor)[0]
                  - want_masked).abs().max().item()
    if check and not max(err, err_masked) <= K2_TOL:
        raise SystemExit(f"K2 disagrees with its plain twin: {err}, masked "
                         f"{err_masked}")

    def run():
        return kernels.resample_linear(wave, factor)

    def masked():
        return augment.resample_rate(wave, lengths, factor)

    return {"ms": cuda_ms(run, 50), "device": _device_split(run),
            "masked_ms": cuda_ms(masked, 50),
            "masked_device": _device_split(masked),
            "err": err, "err_masked": err_masked}


def _k9(check: bool) -> dict:
    """K9 on ``k9_inputs``: the spectrum of noise-and-tone clips."""
    from freesound_classification_tpu_torch.ops import kernels

    spec, fb_t = k9_inputs(K9_CLIPS)
    n_freq = fb_t.shape[0]

    def run():
        return kernels.mel_log_split(spec, fb_t, n_freq, n_freq)

    err = (run() - kernels.mel_log_split_reference(
        spec, fb_t, n_freq, n_freq)).abs().max().item()
    if check and not err <= K9_TOL:
        raise SystemExit(f"K9 disagrees with its plain twin: {err}")
    return {"ms": cuda_ms(run, 50), "device": _device_split(run),
            "err": err}


def _child(copy: str, *args: str, **kw):
    """This file run as a child process on ``copy``'s package (this file
    need not be in the copy)."""
    path = os.path.abspath(copy)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", *args],
        env=dict(os.environ, PYTHONPATH=path), cwd=path, **kw)


def main(argv: list) -> None:
    if argv[0] == "--child":
        if argv[1] == "build":
            from freesound_classification_tpu_torch.ops import build

            build.build()
            return
        from freesound_classification_tpu_torch.ops import kernels

        print("RESULT " + json.dumps(dict(
            child(argv[2].split(","), argv[1] == "check"),
            package=os.path.dirname(os.path.dirname(kernels.__file__)))))
        return
    what = argv[0]
    copies = {}
    for arg in argv[1:]:
        name, spec = arg.split("=")
        path, _, flag = spec.partition(":")
        copies[name] = (path, flag != "nocheck")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    t0 = time.time()
    procs = [_child(path, "build") for path, _ in copies.values()]
    if any(p.wait() != 0 for p in procs):
        raise SystemExit("a copy failed to build")
    print(f"built {len(copies)} copies in {time.time() - t0:.1f} s",
          flush=True)
    names = list(copies)
    failed = False
    for name in names + names[::-1]:
        path, check = copies[name]
        proc = _child(path, "check" if check else "nocheck", what,
                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                      text=True)
        stdout, stderr = proc.communicate()
        lines = [line for line in stdout.splitlines()
                 if line.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            failed = True
            print(f"{name} failed:\n{stdout[-2000:]}{stderr[-3000:]}",
                  flush=True)
            continue
        print(f"{name} {lines[0][len('RESULT '):]}", flush=True)
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
