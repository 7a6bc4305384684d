"""Builds and loads the CUDA kernels of ``lbm_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (Hopper), one process
per source, all started together, and links the objects into one shared
library with a plain C interface in ``lbm_tpu_torch/build/``. The
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_C = ctypes.POINTER(ctypes.c_float)  # the codec: NULL (f32 storage) or 12 floats (c16)
_RUN_ARGTYPES = {
    "lbm_step_run": [_P, _P, _P, _P, _P, _P, _I, _I, _I] + [_F] * 7 + [_C, _P],
    "lbm_aa_run": [_P, _P, _P, _P, _P, _I, _I, _I] + [_F] * 7 + [_C, _P],
    # band kernels: (buf_a, buf_b, nobst, av, partials, ticket, ny, nx,
    # block, depth, panel, n_passes, 7 scalars, codec, stream)
    "lbm_band_run": [_P] * 6 + [_I] * 6 + [_F] * 7 + [_C, _P],
    "lbm_band2_run": [_P] * 6 + [_I] * 6 + [_F] * 7 + [_C, _P],
    "lbm_band3_run": [_P] * 6 + [_I] * 6 + [_F] * 7 + [_C, _P],
    # (state, next, slab_a, slab_b, nobst, av, partials, ticket, ny, nx,
    # block, depth, panel, kpasses, sblock, n_gens, 7 scalars, codec, stream)
    "lbm_slab_run": [_P] * 8 + [_I] * 8 + [_F] * 7 + [_C, _P],
    "lbm_deep_run": [_P] * 6 + [_I] * 6 + [_F] * 7 + [_C, _P],
    # (state_a, state_b, last_a, first_a, last_b, first_b, nobst, av,
    # partials, ticket, ny, nx, block, depth, panel, n_passes, 7 scalars,
    # codec, stream)
    "lbm_temporal_run": [_P] * 10 + [_I] * 6 + [_F] * 7 + [_C, _P],
    # (buf_a, buf_b, nobst, av, partials, ny, nx, n_steps, chunk, blocks,
    # 7 scalars, stream)
    "lbm_resident_run": [_P] * 5 + [_I] * 5 + [_F] * 7 + [_P],
    "lbm_resident_max_blocks": [],
    # (table, s0, count, py, px, ry, rx, ny, pitch, lead, av, av_stride,
    # partials, ticket, parity, n_steps, mode, fill_first, 6 scalars, codec,
    # stream)
    "lbm_shard_run": [_P] + [_I] * 9 + [_P, _I, _P, _P] + [_I] * 4 + [_F] * 6 + [_C, _P],
    "lbm_enable_peer": [_I, _I],
    # (table, s0, count, nshards, buf_a, buf_b, halo_dn, halo_up, nobst,
    # nob_dn, nob_up, av, av_stride, partials, ticket, ny, nx, block, depth,
    # panel, parity, n_passes, 7 scalars, codec, stream)
    "lbm_band_sharded_run": [_P] + [_I] * 3 + [_P] * 8 + [_I] + [_P] * 2 + [_I] * 7
                            + [_F] * 7 + [_C, _P],
    "lbm_band2_sharded_run": [_P] + [_I] * 3 + [_P] * 8 + [_I] + [_P] * 2 + [_I] * 7
                             + [_F] * 7 + [_C, _P],
}
_COUNT_ARGTYPES = {
    "lbm_step_num_blocks": [_I, _I],
    "lbm_aa_num_blocks": [_I, _I],
    "lbm_band_num_tiles": [_I, _I, _I, _I],  # (ny, nx, block, panel)
}


def codec(dev):
    """The ``codec`` argument of an entry point for a run's storage: None
    (NULL) for f32, the 12 floats of ``DevSpec.codec()`` for c16. Every
    entry point that runs steps takes it before the stream, but K4's,
    which stores f32 only as in the JAX package."""
    return None if dev is None else (ctypes.c_float * 12)(*dev.codec())


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
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources()]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", src, "-o", obj] for src, obj in zip(sources(), objs)]
        cmds.append([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs])
        try:
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True) for cmd in cmds[:-1]]
            results = []
            for cmd, proc in zip(cmds, procs):
                err = proc.communicate()[1]
                results.append((cmd, proc.returncode, err))
            if all(rc == 0 for _, rc, _ in results):
                link = subprocess.run(cmds[-1], capture_output=True, text=True)
                results.append((cmds[-1], link.returncode, link.stderr))
            for cmd, rc, err in results:
                if rc != 0:
                    raise BuildError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(out)
    for name, argtypes in _RUN_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in _COUNT_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
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
