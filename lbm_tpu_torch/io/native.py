"""ctypes bindings for the native C++ IO layer (native/lbm_io.cpp), the
same library the JAX package binds (counterpart of ``lbm_tpu/io/native.py``).

The library is optional: ``available()`` is False until ``make -C native``
has produced ``liblbm_io.so``, and ``lbm_tpu_torch.io.files`` falls back to the
byte-identical pure-Python writers.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "liblbm_io.so",
)


@functools.lru_cache(maxsize=1)
def _lib():
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.lbm_write_av_vels.restype = ctypes.c_int
    lib.lbm_write_av_vels.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
    ]
    lib.lbm_write_final_state.restype = ctypes.c_int
    lib.lbm_write_final_state.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.lbm_read_obstacles.restype = ctypes.c_int64
    lib.lbm_read_obstacles.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def available() -> bool:
    return _lib() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def write_av_vels(path, av_vels: np.ndarray) -> None:
    vals = np.ascontiguousarray(av_vels, dtype=np.float64)
    rc = _lib().lbm_write_av_vels(os.fspath(path).encode(), _dptr(vals), vals.size)
    if rc != 0:
        raise OSError(f"native av_vels write failed for {path}")


def write_final_state(path, u_x, u_y, u, pressure, obstacles) -> None:
    ny, nx = obstacles.shape
    args = [np.ascontiguousarray(a, dtype=np.float64) for a in (u_x, u_y, u, pressure)]
    obst = np.ascontiguousarray(obstacles, dtype=np.int32)
    rc = _lib().lbm_write_final_state(
        os.fspath(path).encode(),
        nx,
        ny,
        *(_dptr(a) for a in args),
        obst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise OSError(f"native final_state write failed for {path}")


def read_obstacles(path, nx: int, ny: int) -> np.ndarray:
    """Returns the mask, or raises with the offending line number (mirrors
    the range/blocked checks of d2q9-bgk.c:615-625)."""
    mask = np.zeros((ny, nx), dtype=np.int32)
    rc = _lib().lbm_read_obstacles(
        os.fspath(path).encode(),
        nx,
        ny,
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc == -1:
        raise OSError(f"could not open {path}")
    if rc != 0:
        raise ValueError(f"{path}:{rc}: malformed or out-of-range obstacle entry")
    return mask
