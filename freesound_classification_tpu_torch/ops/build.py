"""Build the port's CUDA sources into one shared library, at first use.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one ``.so`` with a plain C
interface, loaded with ``ctypes``. The library lands in
``build/torch_kernels/`` at the repository root (git-ignored), named by a hash
of the sources, the flags and the compiler, so an edited source or flag builds
anew and an unchanged one is reused. Nothing is built when a module is
imported: ``load_library()`` builds on its first call. A build writes its
objects and library under ``interop.temporary_name`` (host and pid) and
renames the library into place last; the next build on the same host
removes what a killed build left (``interop.clear_dead_temporaries``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def library_path(nvcc: str) -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(os.path.realpath(nvcc).encode())
    return BUILD_DIR / f"libfsc_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of the same inputs exists.

    The compilers' reports (registers, shared memory and spills per kernel,
    from ``-Xptxas -v``) are kept beside the library as ``<name>.log``.
    """
    nvcc = nvcc_path()
    lib = library_path(nvcc)
    if lib.exists():
        return lib
    from freesound_classification_tpu_torch import interop

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a killed build's library and objects: its pid is dead
    interop.clear_dead_temporaries(str(BUILD_DIR), "libfsc_kernels_")
    tmp = BUILD_DIR / interop.temporary_name(lib.name)
    objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    reports = [proc.communicate()[0] for proc in procs]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *map(str, objects)]
    try:
        for cmd, proc, report in zip(cmds, procs, reports):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{report}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("".join(reports))
    # rename last, so a concurrent process never loads a half-written file
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every exported C function."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    # int mel_log_launch(spec, stride_b, stride_f, stride_t, fb, band_lo,
    #                    band_hi, out, B, F, T, M, stream) -> cudaError_t
    lib.mel_log_launch.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr, ptr,
                                   i32, i32, i32, i32, ptr]
    lib.mel_log_launch.restype = i32
    # int resample_launch(wave, factor, lengths, out, B, L, max_factor,
    #                     stream) -> cudaError_t
    lib.resample_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, f32, ptr]
    lib.resample_launch.restype = i32
    # int pv_resynth_launch(mag, dphi, phase0, rate, basis_tiles, sums,
    #                       spill, out, B, t_in, F, bins_pad, hop, rows,
    #                       max_rate, stream) -> cudaError_t
    lib.pv_resynth_launch.argtypes = [ptr] * 8 + [i32] * 6 + [f32, ptr]
    lib.pv_resynth_launch.restype = i32
    # int resnet_block_1d_launch(x, sb, st, x_channels, w1, w2, w3, bias,
    #                            slope, h1, h2, out, osb, ost, pairs, B, C,
    #                            cp, T, n_launches, bm0, bn0, smem0, bm1,
    #                            bn1, smem1, bm2, bn2, smem2, stream)
    #     -> cudaError_t
    lib.resnet_block_1d_launch.argtypes = ([ptr] + [i64] * 2 + [i32]
                                           + [ptr] * 8 + [i64] * 2
                                           + [i32] * 15 + [ptr])
    lib.resnet_block_1d_launch.restype = i32
    # int basic_block_launch(x, sb, sh, sw, x_channels, w1, w2, bias, h1,
    #                        out, osb, osh, osw, pairs, B, C, cp, H, W, bm,
    #                        bn, smem, stream) -> cudaError_t
    lib.basic_block_launch.argtypes = ([ptr] + [i64] * 3 + [i32]
                                       + [ptr] * 5 + [i64] * 3 + [i32] * 9
                                       + [ptr])
    lib.basic_block_launch.restype = i32
    # int resnet_block_2d_launch(x, sb, sh, sw, x_channels, w1, w2, w3, bias,
    #                            slope, h1, out, osb, osh, osw, pairs, B, C,
    #                            cp, H, W, bm, bn, smem, tail_bm,
    #                            tail_bn, tail_smem, stream) -> cudaError_t
    lib.resnet_block_2d_launch.argtypes = ([ptr] + [i64] * 3 + [i32]
                                           + [ptr] * 7 + [i64] * 3
                                           + [i32] * 12 + [ptr])
    lib.resnet_block_2d_launch.restype = i32
    # int conv_head_launch(x, x_bf16, s_in, t_in, w, scale, shift, alpha,
    #                      out, B, C_in, H, W, depth, sb, sc, sh, sw, osb,
    #                      osh, osw, smem, stream) -> cudaError_t
    lib.conv_head_launch.argtypes = ([ptr, i32] + [ptr] * 7 + [i32] * 5
                                     + [i64] * 7 + [i32, ptr])
    lib.conv_head_launch.restype = i32
    # int mel_log_split_launch(spec, W, im_offset, packed, band_lo, band_hi,
    #                          out, rows, F, T, M, blocks, smem, stream)
    #     -> cudaError_t
    lib.mel_log_split_launch.argtypes = ([ptr, i32, i32] + [ptr] * 4
                                         + [i32] * 6 + [ptr])
    lib.mel_log_split_launch.restype = i32
    return lib
