"""Time K6 and K8 of copies of the port in turns, one process a copy.

    python -m freesound_classification_tpu_torch.probes.kernel_turns \\
        k8,k6 v1=build/v1 v2=build/v2 v2_timing=build/v2_timing:nocheck

Each copy is a directory holding a ``freesound_classification_tpu_torch``
package (its own ``csrc/``, built into its own ``build/``): a version of a
kernel to compare, or one made only to time a part of it (``:nocheck``).
The copies are built together; then each is timed in its own process, in
turns (first to last, then back), at the paths' shapes: K8 at the 2d
CNN's block0 head (B 128 x 10 s: (128, 2, 128, 431) -> (128, 64, 64,
215)), K6 at the hierarchical model's six block shapes on channels-
contiguous maps. A copy is first checked against its plain twin (one bf16
step of the largest output) unless it is ``:nocheck``. Per run: ms per call
by CUDA events (50 calls after 3 warm-up calls), and each call's device
time by ``torch.profiler``. The first line is the card's name and power
limit.
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


def _ms(fn, iters: int = 50) -> float:
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


def _device_ms(fn, calls: int = 10) -> float:
    """The device time of one call of ``fn``, summed over its kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "device_time_total", 0)
               for e in prof.key_averages()) / calls / 1e3


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

        out["k8"] = {"ms": _ms(run), "device_ms": _device_ms(run),
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

            ms.append(_ms(run))
            device.append(_device_ms(run))
        out["k6"] = {"ms": ms, "sum": sum(ms), "device_ms": device,
                     "device_sum": sum(device)}
    return out


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
