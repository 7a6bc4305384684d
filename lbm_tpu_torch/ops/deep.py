"""The deep route (counterpart of ``lbm_tpu/ops/pallas_deep.py``).

``run_deep`` advances a ``(9, ny, nx)`` f32 state ``n_iters`` steps, T per
pass, and returns ``(cells, av)`` with ``av[t] = inv_tot_cells *
sum(nobst * |u|)`` of step t; the ``n_iters % T`` remainder runs on
``ops/step.py::run_step`` (kernel K1 on CUDA).

A pass is the temporal route's (``ops/temporal.py``: row blocks of
``block`` rows, T steps on the shrinking trapezoid, forcing at every
window row whose global row is ny-2), but the halo rows are read straight
from the pass's input state, which nothing writes during the pass; the
output goes to a second buffer. No row packs are carried.

On a CUDA tensor the passes run kernel K6 (``csrc/deep.cu``) on 2-D tiles
of ``block`` rows by ``panel`` columns, every pass of a run from one C
call. On a CPU tensor it runs the plain versions (``step_deep_plain``,
``run_deep_plain``) on full rows. Any other device raises; a CUDA tensor
never falls back.

The TPU kernel's ``T % 8 == 0``, ``B % T == 0``, ``nx % 128`` and ``B | ny``
exist for Mosaic's strip BlockSpecs and are not ported: K6 takes any
``block`` and ``depth`` >= 1 on a grid with ``ny >= 2``.

c16 storage (``dev``, ``pallas_deep.py``'s ``dev=``): K6 decodes its
window, halos included, from the int16 input state and encodes its tile;
the plain pass decodes the state before and encodes after (one rounding
per pass of T steps).
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import band_common as BC
from lbm_tpu_torch.ops.step import count_launches, forcing_weights
from lbm_tpu_torch.ops.temporal import PLANE_COPIES, blocks_to_state, trapezoid_plain, window_rows


def deep_supported(ny: int, nx: int, block: int, depth: int, panel: int | None = None) -> bool:
    """``ny >= 2`` as K1, and a schedule of positive sizes."""
    del nx
    return ny >= 2 and block >= 1 and depth >= 1 and (panel is None or panel >= 1)


def step_deep_plain(cells, nobst, density, accel, omega, block, depth, *, inv_tot_cells=1.0,
                    paired="fused", dev=None):
    """One pass of ``depth`` steps in plain PyTorch (``pallas_deep.step_deep``);
    returns ``(cells, av)`` with ``depth`` av values. ``dev``: c16 storage."""
    ny = cells.shape[1]
    w1a, w2a = forcing_weights(density, accel)
    rows = window_rows(ny, block, depth, cells.device)

    def one_pass(state):
        win = state[:, rows].permute(1, 0, 2, 3)  # (nblk, 9, B+2T, nx)
        out, sums = trapezoid_plain(win, nobst[rows], rows, ny, block, depth, float(omega),
                                    w1a, w2a, paired)
        inv = torch.tensor(inv_tot_cells, dtype=torch.float32, device=state.device)
        return blocks_to_state(out, ny), sums * inv

    return BC.coded(dev, one_pass)(cells)


def _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, paired, dev=None):
    def run_passes(cells, npasses):
        av = []
        for _ in range(npasses):
            cells, a = step_deep_plain(cells, nobst, density, accel, omega, block, depth,
                                       inv_tot_cells=inv_tot_cells, paired=paired, dev=dev)
            av.append(a)
        return cells, torch.cat(av)

    return run_passes


def _passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, paired, device,
            dev=None):
    """``run_passes`` of ``run_creep`` for the device of the state."""
    if device.type == "cpu":
        return _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, paired,
                             dev)
    if device.type != "cuda":
        raise ValueError(f"no deep kernel for device {device}")
    if not (isinstance(paired, str) and paired.startswith("fused")):
        raise ValueError("the CUDA deep kernel implements the fused collision form only")

    def run_passes(cells, npasses):
        out = BC.launch_passes("lbm_deep_run", "deep kernel", cells.contiguous().clone(), nobst,
                               density, accel, omega, inv_tot_cells, block, depth, panel,
                               npasses, PLANE_COPIES, dev)
        count_launches(run_deep, npasses * depth, dev)
        return out

    return run_passes


def step_deep(cells, nobst, density, accel, omega, block, depth, *, panel=None,
              inv_tot_cells=1.0, paired="fused", dev=None):
    """One pass of ``depth`` steps: kernel K6 on CUDA, ``step_deep_plain`` on
    CPU. Returns ``(cells, av)`` with ``depth`` values."""
    BC.check_schedule(cells, nobst, depth, block, depth, panel, dev)
    return _passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, paired,
                   cells.device, dev)(cells, 1)


def run_deep_plain(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
                   inv_tot_cells=1.0, paired="fused", dev=None):
    """The deep schedule in plain PyTorch; returns ``(cells, av)``."""
    BC.check_schedule(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, paired,
                           dev)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, paired, dev)


def run_deep(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
             inv_tot_cells=1.0, paired="fused", dev=None):
    """Run ``n_iters`` steps, ``depth`` per pass: kernel K6 on CUDA (and K1
    for the remainder), ``run_deep_plain`` on CPU. ``cells`` is left
    unchanged. The kernel implements the fused collision form. ``dev``:
    c16 storage (int16 ``cells``)."""
    if cells.device.type == "cpu":
        return run_deep_plain(cells, nobst, density, accel, omega, n_iters, block, depth,
                              panel=panel, inv_tot_cells=inv_tot_cells, paired=paired, dev=dev)
    BC.check_schedule(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, paired,
                     cells.device, dev)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, paired, dev)


run_deep.launches = 0  # steps K6 advanced in this process
run_deep.launches_c16 = 0  # steps K6 advanced at c16
