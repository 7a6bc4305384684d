"""The in-place AA band route (counterpart of ``lbm_tpu/ops/pallas_band3.py``).

``run_band3`` runs the band schedule of ``ops/band_common.py`` on ONE
window buffer in the AA arrangement of ``ops/aa.py``:

- S (before an even step): slot ``(x, i)`` holds the arrival ``t_i(x)``;
- C (before an odd step): slot ``(x, opp(i))`` holds ``f*_i(x)``.

The even step is cell-local (S -> C); the odd step gathers ``t_k`` from
``(x - c_k, opp(k))`` and scatters to ``(x + c_k, k)`` (C -> S), so the
values that stay genuine shrink by 0 + 2 cells per double step: T over T
steps, the band invariant. T is even, so a pass maps S to S, and the
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
  state is unforced for the S -> R exit.

The JAX package runs the final pass as two calls, (T-2 steps, fused) then
(2, unfused), each storing the state (``pallas_band3.py:669-677``). At
f32 that is one pass's function; at c16 and bf16 it is one more rounding
of the state after step T-2 of the final pass, so at 16 bits both the
kernel route and the plain version split the final pass the same way
(``split_final``).

On a CUDA tensor the passes run kernel K11 (``csrc/band3.cu``). Its pass
opens with the even step and closes with the odd one, so its load is step
0 (each window cell relaxed as it arrives from S) and its store is step
T-1 (each central S slot sent to device memory by its one writer, the cell
x - c_k), and step s updates only the window cells at least s cells from
every edge (K6's trapezoid). On a CPU tensor ``run_band3_plain`` runs that
pass on all windows at once (``k11_step_plain``): the same arrangements,
forcing placement and regions, NaN wherever the kernel's window is not
updated. Any other device raises.

c16 storage (``dev``): the S arrangement is int16 codes between passes
(``stream_planes`` rolls raw codes); K11 decodes its window and encodes
its tile, the plain passes decode and encode around each pass, the run's
first forcing decodes rows ny-3..ny-1, forces them and re-encodes them
(``force_s``, ``pallas_band3.py:550-567``), and the remainder runs on K1
at c16. bf16 storage (``dev=BF16``) takes the same path with bfloat16 in
place of the codes: K11 widens and rounds once per pass, and the run's
first forcing rounds rows ny-3..ny-1 once more, as the JAX package's
``_force_s_storage`` does for a bfloat16 state.
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


# K11's tiers (``band_common.tiered``; its load fused into its first step,
# its store into its last, the steps between on K6's trapezoid), a window
# of one copy at constant strides. On an H100 (chip_smoke phase 32's sweep
# of T 4, 8 and 16 at 512^2-4096^2 and every storage, each candidate at
# constant strides, and the two tiers in turns in one process, PERF.md
# section 6): (36, 4, 56), a 44 x 64 window, took 4-14% less time than
# (24, 4, 56) at 4096^2 (8,436 tiles) in every storage; (24, 4, 56), a
# 32 x 64 window, took 4-28% less at 1024^2 and 512^2, and at 2048^2
# (3,182 tiles) was within 1% at f32 and 4-7% faster at c16, 3% slower at
# bf16. The build compiles these windows, and those of their split 16-bit
# final passes, with constant strides (``ops/_build.py::trap_windows``).
BAND3_TIERS = (((36, 4, 56), 4000), ((24, 4, 56), 0))


def schedule(params, dtype) -> tuple[int, int, int] | None:
    """K11's schedule ``(block, depth, panel)`` on the grid of ``params``
    (driver.py:691-720 of the JAX package); None for a dtype it does not
    store (``band_common.tiered``)."""
    return BC.tiered(params, dtype, BAND3_TIERS, band3_supported)


def force_s(state, nobst, w1a: float, w2a: float, dev=None):
    """S-space forcing on the full periodic state (``pallas_band3.force_s``).
    Its docstring states it is bit-identical to ``pallas_aa.force_even``, so
    this is ``ops/aa.py::force_even_plain``. With ``dev`` (c16 or bf16),
    as ``_force_s_storage`` (pallas_band3.py:550-567): rows ny-3..ny-1
    decoded, forced and re-encoded, at bf16 one more rounding of those
    rows (its ``dev is None`` branch)."""
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
        raise ValueError(f"band3 at {dev.name} needs ny >= 3 (its first forcing re-encodes "
                         f"rows ny-3..ny-1), got {ny}")


def s_step_plain(omega, w1a, w2a, depth, fuse_last):
    """K11's even/odd steps on whole windows, wrapping at their edges; the
    last odd step of the pass fuses the next forcing only if
    ``fuse_last``."""
    shifts = [(BC.CYS[k], BC.CXS[k]) for k in range(9)]

    def step(s, planes, nob, frow):
        fluid = nob > 0.0
        if s % 2 == 0:
            relaxed, u_sq = bgk_relax(planes, omega)
            out = [torch.where(fluid, relaxed[k], planes[BC.OPP[k]]) for k in range(9)]
            out = BC.force_windows(out, nob, frow, w1a, w2a)
            return [out[BC.OPP[j]] for j in range(9)], u_sq
        t = [torch.roll(planes[BC.OPP[k]], shifts=shifts[k], dims=(1, 2)) for k in range(9)]
        relaxed, u_sq = bgk_relax(t, omega)
        out = [torch.where(fluid, relaxed[k], t[BC.OPP[k]]) for k in range(9)]
        if fuse_last or s < depth - 1:
            out = BC.force_windows(out, nob, frow, w1a, w2a)
        return [torch.roll(out[k], shifts=shifts[k], dims=(1, 2)) for k in range(9)], u_sq

    return step


def k11_step_plain(omega, w1a, w2a, depth, fuse_last):
    """K11's pass as the kernel runs it (``csrc/band3.cu``): the steps of
    ``s_step_plain``, step s (0-based) updating only what the window cells
    at least s cells from every edge write (an even step: every slot of the
    cell; an odd step: slot k of the cell x + c_k), every other slot and
    sum NaN. The central tile after the last step is what the kernel
    stores, so a NaN there would be a value it never computed."""
    inner = s_step_plain(omega, w1a, w2a, depth, fuse_last)
    nan = float("nan")

    def step(s, planes, nob, frow):
        out, u_sq = inner(s, planes, nob, frow)
        wh, ww = nob.shape[1:]
        rows = torch.arange(wh, device=nob.device)[:, None]
        cols = torch.arange(ww, device=nob.device)[None, :]

        def region(dy, dx):  # the writer cell of each slot is at inset >= s
            r, c = rows - dy, cols - dx
            return (r >= s) & (r < wh - s) & (c >= s) & (c < ww - s)

        cell = region(0, 0)
        if s % 2 == 0:
            return [torch.where(cell, p, nan) for p in out], torch.where(cell, u_sq, nan)
        return ([torch.where(region(BC.CYS[k], BC.CXS[k]), out[k], nan) for k in range(9)],
                torch.where(cell, u_sq, nan))

    return step


def split_final(depth: int, dev) -> bool:
    """Whether the final pass of a run is two passes, of T-2 steps and of 2,
    each storing (and so rounding) the state: at 16-bit storage, as the
    JAX package's two calls round it; at f32 one pass is the same."""
    return dev is not None and depth > 2


def _split_passes(passes, depth, dev):
    """``s_passes(state, npasses)`` from ``passes(depth, fuse_last)``, a
    pass loop of ``depth``-step passes whose last pass fuses the next
    forcing only with ``fuse_last``: the final pass split as
    ``split_final`` says."""

    def s_passes(state, npasses):
        if not split_final(depth, dev):
            return passes(depth, False)(state, npasses)
        avs = []
        if npasses > 1:
            state, av = passes(depth, True)(state, npasses - 1)
            avs.append(av)
        for steps, fuse in ((depth - 2, True), (2, False)):
            state, av = passes(steps, fuse)(state, 1)
            avs.append(av)
        return state, torch.cat(avs)

    return s_passes


def _in_s_space(nobst, density, accel, s_passes, dev=None):
    """Wrap S -> S passes into R -> R: stream, force once, run, unstream."""
    w1a, w2a = forcing_weights(density, accel)

    def run_passes(cells, npasses):
        state = stream_planes(cells).contiguous()
        ny = state.shape[1]
        if ny >= 3:  # the forcing changes rows ny-3..ny-1 only: force them in place
            state[:, ny - 3:] = force_s(state[:, ny - 3:], nobst[ny - 3:], w1a, w2a, dev)
        else:
            state = force_s(state, nobst, w1a, w2a, dev)
        state, av = s_passes(state, npasses)
        return stream_planes(state, -1).contiguous(), av

    return run_passes


def _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, dev=None):
    w1a, w2a = forcing_weights(density, accel)

    def passes(steps, fuse_last):
        def step_for(p, npasses):
            return k11_step_plain(float(omega), w1a, w2a, steps, fuse_last or p < npasses - 1)

        return BC.plain_passes(nobst, inv_tot_cells, block, steps, panel, step_for, dev)

    return _in_s_space(nobst, density, accel, _split_passes(passes, depth, dev), dev)


def _passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, device, dev=None):
    """``run_passes`` of ``run_creep`` for the device of the state."""
    if device.type == "cpu":
        return _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, dev)
    if device.type != "cuda":
        raise ValueError(f"no band3 kernel for device {device}")

    def passes(steps, fuse_last):
        def run_passes(state, npasses):
            out = BC.launch_passes("lbm_band3_run", "band3 kernel", state, nobst, density, accel,
                                   omega, inv_tot_cells, block, steps, panel, npasses,
                                   PLANE_COPIES, dev, extra=(int(fuse_last),))
            count_launches(run_band3, npasses * steps, dev)
            return out

        return run_passes

    return _in_s_space(nobst, density, accel, _split_passes(passes, depth, dev), dev)


def run_band3_plain(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
                    inv_tot_cells=1.0, dev=None):
    """The band3 schedule in plain PyTorch; returns ``(cells, av)``."""
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, dev)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, dev)


def run_band3(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
              inv_tot_cells=1.0, dev=None):
    """Run ``n_iters`` steps, ``depth`` per in-place pass: kernel K11 on CUDA
    (and K1 for the remainder), ``run_band3_plain`` on CPU. ``cells`` is
    left unchanged. The kernel implements the fused collision form.
    ``dev``: 16-bit storage (int16 c16 codes or bf16 ``cells``)."""
    if cells.device.type == "cpu":
        return run_band3_plain(cells, nobst, density, accel, omega, n_iters, block, depth,
                               panel=panel, inv_tot_cells=inv_tot_cells, dev=dev)
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel,
                     cells.device, dev)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, dev)


run_band3.launches = 0  # steps K11 advanced in this process
run_band3.launches_c16 = 0  # steps K11 advanced at c16
run_band3.launches_bf16 = 0  # steps K11 advanced at bf16
