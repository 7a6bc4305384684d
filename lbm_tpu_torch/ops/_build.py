"""Builds and loads the CUDA kernels of ``lbm_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (Hopper), one process
per source, all started together, and links the objects into one shared
library with a plain C interface in ``lbm_tpu_torch/build/``. The
file name carries a hash of the sources and flags, so a changed source
builds anew and an unchanged one loads the library already built. The
link takes libcuda (``-lcuda``, against the toolkit's stub where it has
one: the card's own ``libcuda.so.1`` is loaded at run time) for the
stream memory operations of ``lbm_shard_ipc_run``. The
library is bound with ctypes: ``c_void_p`` for every pointer and the
stream, ``c_ulonglong`` for device addresses and sizes held as integers,
``c_int``/``c_float`` for sizes and scalars. Each entry point
returns the CUDA error code of its launches; callers raise when it is not
0. ``lbm_launch_count`` reads the library's count of its own kernel
launches in the process. Nothing is built at import time: the first call
that needs a kernel builds it, and a build failure raises.

The kernels built on ``csrc/trapezoid.cuh`` (K5, K6 and K11) are compiled
with constant row and plane strides for one list of windows, those of the
driver's schedules (``runtime/driver.py::trapezoid_schedules`` and
``band3_schedules``, K11's 16-bit split final passes included), and with
the strides of its geometry for any other window. The windows reach the
sources as a line ``#define LBM_TRAP_WINDOWS ww, wh, ...`` in a header that
nvcc includes before each of them (not a ``-D`` flag: nvcc reads its value
as a comma-separated list of macros).
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
_U = ctypes.c_ulonglong
_I = ctypes.c_int
_F = ctypes.c_float


class Storage(ctypes.Structure):
    """The ``storage`` argument of the entry points, the ctypes mirror of
    ``csrc/lbm_common.cuh::Storage``: the kind of the state's storage and,
    at c16, the 12 floats of ``DevSpec.codec()``."""

    _fields_ = [("kind", ctypes.c_int), ("codec", ctypes.c_float * 12)]


STORAGE_KINDS = {"f32": 0, "c16": 1, "bf16": 2}  # lbm_common.cuh::StorageKind
_S = ctypes.POINTER(Storage)  # passed a Storage, by reference
_RUN_ARGTYPES = {
    # (..., 7 scalars, word, storage, stream): word 1 the word form, 0 the
    # one-cell form
    "lbm_step_run": [_P, _P, _P, _P, _P, _P, _I, _I, _I] + [_F] * 7 + [_I, _S, _P],
    "lbm_aa_run": [_P, _P, _P, _P, _P, _I, _I, _I] + [_F] * 7 + [_I, _S, _P],
    # (word, kind, out[3]) and (word, odd, kind, out[3]): registers, local
    # bytes and blocks per SM of a form's kernel
    "lbm_step_attrs": [_I, _I, _P],
    "lbm_aa_attrs": [_I, _I, _I, _P],
    "lbm_c16_sweep": [_S, _P, _P],  # (codec, bad[2], stream)
    # band kernels: (buf_a, buf_b, nobst, av, partials, ticket, ny, nx,
    # block, depth, panel, n_passes, 7 scalars, codec, stream)
    "lbm_band_run": [_P] * 6 + [_I] * 6 + [_F] * 7 + [_S, _P],
    "lbm_band2_run": [_P] * 6 + [_I] * 6 + [_F] * 7 + [_S, _P],
    "lbm_band3_run": [_P] * 6 + [_I] * 7 + [_F] * 7 + [_S, _P],  # ... n_passes, fuse_last, ...
    # (state, next, slab_a, slab_b, nobst, av, partials, ticket, ny, nx,
    # block, depth, panel, kpasses, sblock, n_gens, 7 scalars, codec, stream)
    "lbm_slab_run": [_P] * 8 + [_I] * 8 + [_F] * 7 + [_S, _P],
    "lbm_deep_run": [_P] * 6 + [_I] * 6 + [_F] * 7 + [_S, _P],
    # (state_a, state_b, last_a, first_a, last_b, first_b, nobst, av,
    # partials, ticket, ny, nx, block, depth, panel, n_passes, 7 scalars,
    # codec, stream)
    "lbm_temporal_run": [_P] * 10 + [_I] * 6 + [_F] * 7 + [_S, _P],
    # (buf, nob8, nobst, av, partials, ny, nx, n_steps, chunk, blocks,
    # l2_bytes, 7 scalars, stream)
    "lbm_resident_run": [_P] * 5 + [_I] * 5 + [_U] + [_F] * 7 + [_P],
    "lbm_resident_max_blocks": [],
    # (buf_a, buf_b, exch, nobst, av, partials, ny, nx, n_steps, chunk,
    # blocks, rows, depth, smem_bytes, 7 scalars, stream)
    "lbm_resident_smem_run": [_P] * 6 + [_I] * 8 + [_F] * 7 + [_P],
    "lbm_resident_smem_bytes": [_I, _I, _I],  # (nx, rows, depth)
    "lbm_grid_sync_probe": [_I, _I, _I, _P],  # (blocks, threads, syncs, stream)
    "lbm_cluster_sync_probe": [_I, _I, _I, _I, _P],  # (blocks, threads, cluster, syncs, stream)
    # (table, s0, count, py, px, ry, rx, ny, pitch, lead, av, av_stride,
    # partials, ticket, parity, n_steps, mode, fill_first, 6 scalars, codec,
    # stream)
    "lbm_shard_run": [_P] + [_I] * 9 + [_P, _I, _P, _P] + [_I] * 4 + [_F] * 6 + [_S, _P],
    # (table, s0, count, py, ry, rx, ny, pitch, lead, rows, av, av_stride,
    # partials, ticket, parity, 6 scalars, codec, stream)
    "lbm_shard_rows_run": [_P] + [_I] * 8 + [_P, _P, _I, _P, _P, _I] + [_F] * 6 + [_S, _P],
    "lbm_enable_peer": [_I, _I],
    # K12 across processes: (ry, pitch, offsets[5]); (bytes, base*, handle);
    # (handle, base*); (base); (base); (dst, src, bytes, stream); (table,
    # rank, world, ry, rx, ny, pitch, lead, inbox, to_next, to_prev, done,
    # n_steps, av, partials, ticket, 6 scalars, stream)
    "lbm_shard_ipc_layout": [_I, _I, _P],
    "lbm_shard_ipc_alloc": [_U, _P, _P],
    "lbm_shard_ipc_open": [_P, _P],
    "lbm_shard_ipc_close": [_U],
    "lbm_shard_ipc_free": [_U],
    "lbm_shard_ipc_copy": [_U, _U, _U, _P],
    "lbm_shard_ipc_release": [_U],  # (inbox)
    "lbm_shard_ipc_run": [_P] + [_I] * 7 + [_U] * 3 + [_I] * 2 + [_P] * 3 + [_F] * 6 + [_P],
    # (table, s0, count, nshards, buf_a, buf_b, halo_dn, halo_up, nobst,
    # nob_dn, nob_up, av, av_stride, partials, ticket, ny, nx, block, depth,
    # panel, parity, n_passes, 7 scalars, codec, stream)
    "lbm_band_sharded_run": [_P] + [_I] * 3 + [_P] * 8 + [_I] + [_P] * 2 + [_I] * 7
                            + [_F] * 7 + [_S, _P],
    "lbm_band2_sharded_run": [_P] + [_I] * 3 + [_P] * 8 + [_I] + [_P] * 2 + [_I] * 7
                             + [_F] * 7 + [_S, _P],
}
_COUNT_ARGTYPES = {
    "lbm_step_num_blocks": [_I, _I],
    "lbm_aa_num_blocks": [_I, _I],
    "lbm_band_num_tiles": [_I, _I, _I, _I],  # (ny, nx, block, panel)
}


def storage(dev) -> Storage:
    """The ``storage`` argument of an entry point for a run's storage
    ``dev`` (``ops/devspace.py``): None for f32, a ``DevSpec`` for c16,
    ``BF16`` for bf16. Every entry point that runs steps takes it before
    the stream, but K4's, which stores f32 only as in the JAX package."""
    if dev is None:
        return Storage(STORAGE_KINDS["f32"])
    if dev.name == "c16":
        return Storage(STORAGE_KINDS["c16"], (ctypes.c_float * 12)(*dev.codec()))
    return Storage(STORAGE_KINDS[dev.name])


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


def trap_windows() -> tuple[tuple[int, int], ...]:
    """The windows ``(width, height)`` that K5, K6 and K11 are compiled
    for with constant strides: those of the driver's K5/K6 schedules, and
    of its K11 schedules with the passes of T-2 and 2 steps that split a
    16-bit K11 run's final pass (``ops/band3.py::split_final``)."""
    from lbm_tpu_torch.runtime import driver

    trap = {(panel + 2 * depth, block + 2 * depth)
            for block, depth, panel in driver.trapezoid_schedules()}
    band3 = {(panel + 2 * t, block + 2 * t) for block, depth, panel in driver.band3_schedules()
             for t in {depth, depth - 2, 2} if t >= 2}
    return tuple(sorted(trap | band3))


def windows_define() -> str:
    """The header that gives ``csrc/trapezoid.cuh`` its windows."""
    pairs = ", ".join(f"{ww}, {wh}" for ww, wh in trap_windows())
    return f"#define LBM_TRAP_WINDOWS {pairs}\n"


def link_flags() -> list[str]:
    """libcuda for the link: ``-lcuda``, with the toolkit's stub
    directory where it has one."""
    stubs = os.path.join(os.path.dirname(os.path.dirname(_nvcc())), "lib64", "stubs")
    return (["-L" + stubs] if os.path.isdir(stubs) else []) + ["-lcuda"]


def _source_hash(define: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(define.encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library. Its ``build_info``
    says what was done: path, whether nvcc ran, seconds, flags, the
    constant-stride windows, sources."""
    define = windows_define()
    out = os.path.join(BUILD_DIR, f"liblbm_kernels_{_source_hash(define)}.so")
    t0 = time.perf_counter()
    built = not os.path.exists(out)
    if built:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        header = f"{tmp}.windows.h"
        with open(header, "w") as f:
            f.write(define)
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources()]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-include", header, "-c", src, "-o", obj]
                for src, obj in zip(sources(), objs)]
        cmds.append([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs, *link_flags()])
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
            for path in [*objs, header]:
                if os.path.exists(path):
                    os.remove(path)
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
    lib.lbm_launch_count.argtypes = []
    lib.lbm_launch_count.restype = ctypes.c_ulonglong
    lib.build_info = dict(
        path=out, built=built, seconds=time.perf_counter() - t0,
        flags=" ".join(NVCC_FLAGS), windows=trap_windows(),
        sources=[os.path.relpath(s, _PKG) for s in sources()],
    )
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} (cudaError_t)")
