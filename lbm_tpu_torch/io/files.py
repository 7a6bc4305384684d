"""File formats of the reference solver, reproduced byte-for-byte
(counterpart of ``lbm_tpu/io/files.py``; numpy only).

- params file: 7 whitespace-separated fields — nx, ny, maxIters,
  reynolds_dim (ints), density, accel, omega (floats) (d2q9-bgk.c:499-525).
- obstacle file: ``x y 1`` triples; coordinates range-checked, the blocked
  flag must equal 1, duplicate entries are tolerated (d2q9-bgk.c:596-631).
- final_state.dat: one line per cell, row-major (y outer, x inner),
  ``"%d %d %.12E %.12E %.12E %.12E %d\\n"`` = x y u_x u_y |u| pressure obst
  (d2q9-bgk.c:900). Obstacle cells write u=0 and pressure = density/3
  (d2q9-bgk.c:862-866).
- av_vels.dat: ``"%d:\\t%.12E\\n"`` per timestep (d2q9-bgk.c:915).

The writers prefer the native C++ fast path (``lbm_tpu_torch.io.native``) when the
shared library has been built, and fall back to pure Python otherwise; both
produce identical bytes.
"""

from __future__ import annotations

import os

import numpy as np

from lbm_tpu_torch.models.d2q9 import C_SQ, LBMParams


class InputError(ValueError):
    """Raised on malformed params / obstacle files (mirrors the reference's
    fatal ``die()`` paths, d2q9-bgk.c:933-939)."""


def read_params(path: str | os.PathLike) -> LBMParams:
    """Parse the 7-field params file (d2q9-bgk.c:499-525).

    Like ``fscanf``, tokens are whitespace-separated; layout (one value per
    line in the shipped inputs) is not significant.
    """
    with open(path, "r") as f:
        tokens = f.read().split()
    if len(tokens) < 7:
        raise InputError(f"{path}: expected 7 values, found {len(tokens)}")
    try:
        nx, ny, max_iters, reynolds_dim = (int(t) for t in tokens[:4])
        density, accel, omega = (float(t) for t in tokens[4:7])
    except ValueError as e:
        raise InputError(f"{path}: could not parse params: {e}") from e
    if nx <= 0 or ny <= 0 or max_iters <= 0:
        raise InputError(f"{path}: non-positive grid size or iteration count")
    return LBMParams(
        nx=nx,
        ny=ny,
        max_iters=max_iters,
        reynolds_dim=reynolds_dim,
        density=density,
        accel=accel,
        omega=omega,
    )


def read_obstacles(path: str | os.PathLike, params: LBMParams) -> np.ndarray:
    """Parse the obstacle list into a ``(ny, nx)`` int32 mask
    (d2q9-bgk.c:596-631): each line is ``x y blocked``; x in [0,nx), y in
    [0,ny), blocked must be 1; duplicates are harmless re-assignments
    (the 128x128 input repeats its corner cells)."""
    nat = _native_io()
    if nat is not None:
        try:
            return nat.read_obstacles(path, params.nx, params.ny)
        except ValueError as e:
            raise InputError(str(e)) from e
        except OSError:
            pass  # fall through for the Python open() error message
    mask = np.zeros((params.ny, params.nx), dtype=np.int32)
    with open(path, "r") as f:
        for lineno, line in enumerate(f, start=1):
            fields = line.split()
            if not fields:
                continue
            if len(fields) != 3:
                raise InputError(
                    f"{path}:{lineno}: expected 3 values per line, got {len(fields)}"
                )
            try:
                x, y, blocked = (int(v) for v in fields)
            except ValueError as e:
                raise InputError(f"{path}:{lineno}: non-integer field: {e}") from e
            if not 0 <= x < params.nx:
                raise InputError(f"{path}:{lineno}: obstacle x-coord out of range")
            if not 0 <= y < params.ny:
                raise InputError(f"{path}:{lineno}: obstacle y-coord out of range")
            if blocked != 1:
                raise InputError(f"{path}:{lineno}: obstacle blocked value should be 1")
            mask[y, x] = blocked
    return mask


def _native_io():
    try:
        from lbm_tpu_torch.io import native

        return native if native.available() else None
    except Exception:
        return None


def write_final_state(
    path: str | os.PathLike,
    params: LBMParams,
    cells: np.ndarray,
    obstacles: np.ndarray,
) -> None:
    """Write final_state.dat from a ``(9, ny, nx)`` state (d2q9-bgk.c:840-902).

    Moments are recomputed from the distributions exactly as the reference
    does in ``write_values``; obstacle cells get u=0 and
    pressure = density * c_sq (d2q9-bgk.c:862-866).
    """
    cells = np.asarray(cells, dtype=np.float64)
    obstacles = np.asarray(obstacles)
    ny, nx = obstacles.shape
    obst = obstacles != 0

    rho = cells.sum(axis=0)
    # Numerators grouped exactly as the reference (d2q9-bgk.c:877-892):
    # (a+b+c) - (d+e+f), so an at-rest state cancels to exactly zero.
    u_x = np.where(
        obst, 0.0, ((cells[1] + cells[5] + cells[8]) - (cells[3] + cells[6] + cells[7])) / rho
    )
    u_y = np.where(
        obst, 0.0, ((cells[2] + cells[5] + cells[6]) - (cells[4] + cells[7] + cells[8])) / rho
    )
    u = np.sqrt(u_x * u_x + u_y * u_y)
    pressure = np.where(obst, params.density * C_SQ, rho * C_SQ)

    nat = _native_io()
    if nat is not None:
        nat.write_final_state(path, u_x, u_y, u, pressure, obstacles)
        return

    with open(path, "w") as f:
        lines = []
        for ii in range(ny):
            for jj in range(nx):
                lines.append(
                    "%d %d %.12E %.12E %.12E %.12E %d\n"
                    % (
                        jj,
                        ii,
                        u_x[ii, jj],
                        u_y[ii, jj],
                        u[ii, jj],
                        pressure[ii, jj],
                        obstacles[ii, jj],
                    )
                )
        f.write("".join(lines))


def write_av_vels(path: str | os.PathLike, av_vels: np.ndarray) -> None:
    """Write av_vels.dat: ``"%d:\\t%.12E\\n"`` per step (d2q9-bgk.c:913-916)."""
    av_vels = np.asarray(av_vels, dtype=np.float64)
    nat = _native_io()
    if nat is not None:
        nat.write_av_vels(path, av_vels)
        return
    with open(path, "w") as f:
        f.write("".join("%d:\t%.12E\n" % (i, v) for i, v in enumerate(av_vels)))
