"""Builds and loads the CUDA kernels of ``lbm_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, for ``sm_90a`` (Hopper), into ``lbm_tpu_torch/build/``. The
file name carries a hash of the sources and flags, so a changed source
builds anew and an unchanged one loads the library already built. The
library is bound with ctypes: ``c_void_p`` for every pointer and the
stream, ``c_int``/``c_float`` for sizes and scalars. Each entry point
returns the CUDA error code of its launches; callers raise when it is not
0. Nothing is built at import time: the first call that needs a kernel
builds it, and a build failure raises.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_RUN_ARGTYPES = {
    "lbm_step_run": [_P, _P, _P, _P, _P, _P, _I, _I, _I] + [_F] * 7 + [_P],
    "lbm_aa_run": [_P, _P, _P, _P, _P, _I, _I, _I] + [_F] * 7 + [_P],
}


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise BuildError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library. Its ``build_info``
    says what was done: path, whether nvcc ran, seconds, flags, sources."""
    out = os.path.join(BUILD_DIR, f"liblbm_kernels_{_source_hash()}.so")
    t0 = time.perf_counter()
    built = not os.path.exists(out)
    if built:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(out)
    for name, argtypes in _RUN_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name in ("lbm_step_num_blocks", "lbm_aa_num_blocks"):
        fn = getattr(lib, name)
        fn.argtypes = [_I, _I]
        fn.restype = ctypes.c_uint
    lib.build_info = dict(
        path=out, built=built, seconds=time.perf_counter() - t0,
        flags=" ".join(NVCC_FLAGS), sources=[os.path.relpath(s, _PKG) for s in sources()],
    )
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} (cudaError_t)")
