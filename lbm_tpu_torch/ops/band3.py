"""The in-place AA band route (counterpart of ``lbm_tpu/ops/pallas_band3.py``).

``run_band3`` runs the band schedule of ``ops/band_common.py`` on ONE
window buffer in the AA arrangement of ``ops/aa.py``:

- S (before an even step): slot ``(x, i)`` holds the arrival ``t_i(x)``;
- C (before an odd step): slot ``(x, opp(i))`` holds ``f*_i(x)``.

The even step is cell-local (S -> C); the odd step gathers ``t_k`` from
``(x - c_k, opp(k))`` and scatters to ``(x + c_k, k)`` (C -> S), with wrap
inside the window, so garbage creeps 0 + 2 cells per double step: T over
T steps, the band invariant. T is even, so a pass maps S to S, and the
state stays in S between passes (two copies in device memory, because
neighbouring tiles read each other's halos). ``stream_planes`` converts
R -> S once per run and S -> R at the end; the ``n_iters % T`` remainder
runs on K1 in R space.

Forcing of the ny-2 rows, as in ``pallas_band3.py:39-59``:

- the run's first forcing is ``force_s`` on the full periodic S state;
- each even step applies the C-space forcing of the odd step that follows
  to the colliding cell's own outputs before it writes them (the TPU
  kernel does the same 1-row update at the start of the odd step);
- each odd step fuses the NEXT even step's S-space forcing: the cell on a
  forcing row adds the delta to its own scattered values, with the mask
  taken from its own outputs ``f*_3, f*_6, f*_7``;
- the last odd step of the run's final pass is not fused, so the stored
  state is unforced for the S -> R exit. On the card that is a kernel
  argument, not the TPU's split into (T-2, fused) + (2, unfused) calls,
  which its compile helper forced.

On a CUDA tensor the passes run kernel K11 (``csrc/band3.cu``); on a CPU
tensor ``run_band3_plain``, which keeps K11's arrangements and forcing
placement on all windows at once. Any other device raises.

c16 storage (``dev``): the S arrangement is int16 codes between passes
(``stream_planes`` rolls raw codes); K11 decodes its window and encodes
its tile, the plain passes decode and encode around each pass, the run's
first forcing decodes rows ny-3..ny-1, forces them and re-encodes them
(``force_s``, ``pallas_band3.py:550-567``), and the remainder runs on K1
at c16.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import band_common as BC
from lbm_tpu_torch.ops.aa import force_even_plain, stream_planes
from lbm_tpu_torch.ops.collision import bgk_relax
from lbm_tpu_torch.ops.devspace import decode_state, encode_state
from lbm_tpu_torch.ops.step import count_launches, forcing_weights

PLANE_COPIES = 1  # one window of the 9 planes per block, updated in place


def band3_supported(ny: int, nx: int, block: int, depth: int, panel: int | None = None) -> bool:
    """Even depth, so a pass maps S to S, and ``block >= 2 * depth``
    (pallas_band3.py:91-99); ``ny >= 2`` as K1."""
    del nx
    return (ny >= 2 and depth >= 2 and depth % 2 == 0 and block >= 2 * depth
            and (panel is None or panel >= 1))


def force_s(state, nobst, w1a: float, w2a: float, dev=None):
    """S-space forcing on the full periodic state (``pallas_band3.force_s``).
    Its docstring states it is bit-identical to ``pallas_aa.force_even``, so
    this is ``ops/aa.py::force_even_plain``. With ``dev`` (c16), as
    ``_force_s_storage``: rows ny-3..ny-1 decoded, forced and re-encoded."""
    if dev is None:
        return force_even_plain(state, nobst, w1a, w2a)
    ny = state.shape[1]
    out = state.clone()
    rows = force_even_plain(decode_state(state[:, ny - 3:], dev), nobst[ny - 3:], w1a, w2a)
    out[:, ny - 3:] = encode_state(rows, dev)
    return out


def _check(cells, nobst, n_iters, block, depth, panel, dev=None):
    BC.check_schedule(cells, nobst, n_iters, block, depth, panel, dev)
    _, ny, nx = cells.shape
    if not band3_supported(ny, nx, block, depth, panel):
        raise ValueError(f"band3 schedule unsupported: grid {ny}x{nx}, block {block}, "
                         f"depth {depth}, panel {panel} (needs even depth and block >= 2*depth)")
    if dev is not None and ny < 3:
        raise ValueError(f"band3 at c16 needs ny >= 3 (its first forcing re-encodes rows "
                         f"ny-3..ny-1), got {ny}")


def s_step_plain(omega, w1a, w2a, paired, depth, fuse_last):
    """K11's even/odd steps on windows; the last odd step of the pass fuses
    the next forcing only if ``fuse_last``."""
    shifts = [(BC.CYS[k], BC.CXS[k]) for k in range(9)]

    def step(s, planes, nob, frow):
        fluid = nob > 0.0
        if s % 2 == 0:
            relaxed, u_sq = bgk_relax(planes, omega, paired=paired)
            out = [torch.where(fluid, relaxed[k], planes[BC.OPP[k]]) for k in range(9)]
            out = BC.force_windows(out, nob, frow, w1a, w2a)
            return [out[BC.OPP[j]] for j in range(9)], u_sq
        t = [torch.roll(planes[BC.OPP[k]], shifts=shifts[k], dims=(1, 2)) for k in range(9)]
        relaxed, u_sq = bgk_relax(t, omega, paired=paired)
        out = [torch.where(fluid, relaxed[k], t[BC.OPP[k]]) for k in range(9)]
        if fuse_last or s < depth - 1:
            out = BC.force_windows(out, nob, frow, w1a, w2a)
        return [torch.roll(out[k], shifts=shifts[k], dims=(1, 2)) for k in range(9)], u_sq

    return step


def _in_s_space(nobst, density, accel, s_passes, dev=None):
    """Wrap S -> S passes into R -> R: stream, force once, run, unstream."""
    w1a, w2a = forcing_weights(density, accel)

    def run_passes(cells, npasses):
        state = force_s(stream_planes(cells).contiguous(), nobst, w1a, w2a, dev)
        state, av = s_passes(state, npasses)
        return stream_planes(state, -1).contiguous(), av

    return run_passes


def _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, paired,
                  dev=None):
    w1a, w2a = forcing_weights(density, accel)

    def step_for(p, npasses):
        return s_step_plain(float(omega), w1a, w2a, paired, depth, p < npasses - 1)

    return _in_s_space(nobst, density, accel,
                       BC.plain_passes(nobst, inv_tot_cells, block, depth, panel, step_for, dev),
                       dev)


def _passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, paired, device,
            dev=None):
    """``run_passes`` of ``run_creep`` for the device of the state."""
    if device.type == "cpu":
        return _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel,
                             paired, dev)
    if device.type != "cuda":
        raise ValueError(f"no band3 kernel for device {device}")
    if not (isinstance(paired, str) and paired.startswith("fused")):
        raise ValueError("the CUDA band3 kernel implements the fused collision form only")

    def s_passes(state, npasses):
        out = BC.launch_passes("lbm_band3_run", "band3 kernel", state, nobst, density, accel,
                               omega, inv_tot_cells, block, depth, panel, npasses, PLANE_COPIES,
                               dev)
        count_launches(run_band3, npasses * depth, dev)
        return out

    return _in_s_space(nobst, density, accel, s_passes, dev)


def run_band3_plain(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
                    inv_tot_cells=1.0, paired="fused", dev=None):
    """The band3 schedule in plain PyTorch; returns ``(cells, av)``."""
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel,
                           paired, dev)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, paired, dev)


def run_band3(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
              inv_tot_cells=1.0, paired="fused", dev=None):
    """Run ``n_iters`` steps, ``depth`` per in-place pass: kernel K11 on CUDA
    (and K1 for the remainder), ``run_band3_plain`` on CPU. ``cells`` is
    left unchanged. The kernel implements the fused collision form.
    ``dev``: c16 storage (int16 ``cells``)."""
    if cells.device.type == "cpu":
        return run_band3_plain(cells, nobst, density, accel, omega, n_iters, block, depth,
                               panel=panel, inv_tot_cells=inv_tot_cells, paired=paired, dev=dev)
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, paired,
                     cells.device, dev)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, paired, dev)


run_band3.launches = 0  # steps K11 advanced in this process
run_band3.launches_c16 = 0  # steps K11 advanced at c16
