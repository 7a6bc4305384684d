"""Obstacle-geometry generators (counterpart of ``lbm_tpu/utils/geometry.py``).

The reference ships four obstacle files whose geometries are: a closed box
(full walls on all four edges — 128x128, 256x256), a vertical channel with a
horizontal divider (128x256), and a box with a vertical divider wall
(1024x1024) — see SURVEY.md §2.1. These generators reproduce those families
programmatically so the framework is standalone (grids of any size), and can
emit the reference's ``x y 1`` file format.
"""

from __future__ import annotations

import numpy as np


def box(nx: int, ny: int) -> np.ndarray:
    """Closed box: walls on all four edges (the 128x128 / 256x256 family)."""
    mask = np.zeros((ny, nx), dtype=np.int32)
    mask[0, :] = mask[-1, :] = 1
    mask[:, 0] = mask[:, -1] = 1
    return mask


def channel_with_divider(nx: int, ny: int, divider_row: int | None = None) -> np.ndarray:
    """Vertical channel (walls at x=0 and x=nx-1) bisected by a full
    horizontal wall (the 128x256 family; divider defaults to row ny//2-1)."""
    mask = np.zeros((ny, nx), dtype=np.int32)
    mask[:, 0] = mask[:, -1] = 1
    mask[divider_row if divider_row is not None else ny // 2 - 1, :] = 1
    return mask


def box_with_vertical_wall(nx: int, ny: int, wall_col: int | None = None) -> np.ndarray:
    """Closed box plus a full vertical wall (the 1024x1024 family; the
    reference puts it at x=341 ≈ nx/3)."""
    mask = box(nx, ny)
    mask[:, wall_col if wall_col is not None else nx // 3] = 1
    return mask


def write_obstacle_file(path, mask: np.ndarray) -> None:
    """Emit the reference's ``x y 1`` format (d2q9-bgk.c:596-631 parser)."""
    ys, xs = np.nonzero(mask)
    with open(path, "w") as f:
        f.write("".join(f"{x} {y} 1\n" for y, x in zip(ys.tolist(), xs.tolist())))


def write_params_file(path, nx, ny, max_iters, reynolds_dim, density, accel, omega) -> None:
    """Emit the reference's 7-line params format (d2q9-bgk.c:499-525)."""
    with open(path, "w") as f:
        f.write(f"{nx}\n{ny}\n{max_iters}\n{reynolds_dim}\n{density}\n{accel}\n{omega}\n")
