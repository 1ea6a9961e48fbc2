"""Build the port's CUDA sources into one shared library, at first use.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
``.so`` with a plain C interface, loaded with ``ctypes``. The library lands in
``build/torch_kernels/`` at the repository root (git-ignored), named by a hash
of the sources, the flags and the compiler, so an edited source or flag builds
anew and an unchanged one is reused. Nothing is built when a module is
imported: ``load_library()`` builds on its first call.
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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

    The compiler's report (registers, shared memory and spills per kernel,
    from ``-Xptxas -v``) is kept beside the library as ``<name>.log``.
    """
    nvcc = nvcc_path()
    lib = library_path(nvcc)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    # rename last, so a concurrent process never loads a half-written file
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every exported C function."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # int mel_log_launch(spec, stride_b, stride_f, stride_t, fb, out,
    #                    B, F, T, M, stream) -> cudaError_t
    lib.mel_log_launch.argtypes = [ptr, i64, i64, i64, ptr, ptr,
                                   i32, i32, i32, i32, ptr]
    lib.mel_log_launch.restype = i32
    return lib
