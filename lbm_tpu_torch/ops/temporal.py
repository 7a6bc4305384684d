"""The temporal route (counterpart of ``lbm_tpu/ops/pallas_temporal.py``).

``run_temporal`` advances a ``(9, ny, nx)`` f32 state ``n_iters`` steps, T
per pass over the grid, and returns ``(cells, av)`` with ``av[t] =
inv_tot_cells * sum(nobst * |u|)`` of step t; the ``n_iters % T``
remainder runs on ``ops/step.py::run_step`` (kernel K1 on CUDA).

A pass works on row blocks of ``block`` rows (the last one may be shorter).
Block i's window is its own rows plus T rows above and below; step s
(1..T) computes only the window rows still valid, ``B + 2(T - s)`` of them
(the shrinking trapezoid), so after T steps exactly the block's rows
remain. The carried state is ``(cells, last_t, first_t)``: packs of shape
``(nblk, 9T, nx)``, plane k at rows ``[kT, kT + T)``, indexed by the block
that produced them (``make_halos_t``): ``last_t[j]`` is block j's last T
rows, ``first_t[j]`` its first T. Block i reads ``last_t[i-1]`` above and
``first_t[i+1]`` below (wrapped), and a pass returns ``(out, last_o,
first_o)``, its own output's packs in the same order. The forcing of row
ny-2 is applied at every window row whose global row is ny-2, halo rows
included, so any block height works, a single block that wraps onto itself
too.

On a CUDA tensor the passes run kernel K5 (``csrc/temporal.cu``): 2-D
tiles of ``block`` rows by ``panel`` columns whose x halo comes from the
pass's read-only input state, the y halo from the packs, each tile's
window in ONE shared-memory copy stepped in place in the AA arrangement
on the trapezoid (``csrc/trapezoid.cuh``); every pass of a run is issued
by one C call, the odd passes taking the tiles from the last one back
(``band_common.cuh::pass_order``). On a CPU tensor it runs the plain
versions (``step_t_plain``, ``run_temporal_plain``) on full rows with a
periodic roll in x, the same function; ``run_temporal_aa_plain`` takes the
kernel's schedule instead (``trapezoid_aa_plain``), for the tests. Any
other device raises; a CUDA tensor never falls back.

The TPU kernel's ``B % 8``, ``nx % 128`` and ``B | ny`` are Mosaic
constraints and are not ported. A block's packs are its own rows, so T may
not exceed any block's height, the last one of a ragged grid included.

c16 storage (``dev``, ``pallas_temporal.py``'s ``dev=``): the state and the
packs hold int16 codes (``make_halos_t`` packs the input's codes); K5 and
``step_t_plain`` decode the window's three sources as they read them and
encode the pass's output once, the packs from the same codes as the state
rows they copy (one rounding per pass of T steps).

bf16 storage (``dev=devspace.BF16``): the state and the packs hold
bfloat16, rounded once per pass from the same f32 values.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops import band_common as BC
from lbm_tpu_torch.ops.collision import bgk_relax, u_mag
from lbm_tpu_torch.ops.devspace import decode_state, encode_state
from lbm_tpu_torch.ops.step import (_CXS, _CYS, _OPP, count_launches, forcing_weights,
                                    kernel_scalars)

PLANE_COPIES = 1  # one window of the 9 planes per block, stepped in place (csrc/trapezoid.cuh)


def tiles_of_pass(ny: int, nx: int, block: int, panel: int | None) -> tuple[int, int]:
    """``(tiles, tail)`` of one pass of K5 or K6: the ``block`` x ``panel``
    tiles it launches, and those in its last round of ``BC.TRAP_SLOTS``
    blocks when that round is partial (else 0)."""
    tiles = -(-ny // block) * (1 if panel is None else -(-nx // panel))
    return tiles, tiles % BC.TRAP_SLOTS


def block_heights(ny: int, block: int) -> tuple[int, int]:
    """``(nblk, last)``: the number of row blocks and the last one's height."""
    nblk = -(-ny // block)
    return nblk, ny - (nblk - 1) * block


def temporal_supported(ny: int, nx: int, block: int, depth: int, panel: int | None = None) -> bool:
    """``ny >= 2`` as K1, and a depth of at least 1 and at most every row
    block's height, the last block's included (a block's packs are its own
    rows)."""
    del nx
    if ny < 2 or block < 1 or depth < 1 or (panel is not None and panel < 1):
        return False
    return depth <= min(block, block_heights(ny, block)[1])


# K5 and K6 in one window copy, one table for both (``band_common.tiered``).
# On an H100 (chip_smoke phase 27's sweep, every candidate's window with
# constant strides, two runs, PERF.md section 6): (36, 4, 56), a 44 x 64
# window of 113 KB, two blocks per SM (TRAP_SLOTS on the card), was the
# fastest or within 2.3% of it for both kernels from 1024^2 to 4096^2, and
# took 7-9% less time than (32, 4, 40) at 1024^2; at 512^2 (150 tiles) it
# took 26-27% more, and (32, 4, 40) was the fastest; at 256^2, where that
# makes under half a wave, the 32 x 32 window of (24, 4, 24) took 15-19%
# less time. At 1024^2 its 551 tiles run as two whole rounds of TRAP_SLOTS
# and a third of 23, yet the third costs ~2 us of a 70-us pass (504 and
# 522 tiles took 66.0 and 67.9 us); every cut into whole rounds whose
# window holds two blocks per SM took more time (chip_smoke phase 33: (43,
# 4, 48), 528 tiles, 1-3% more; (47, 4, 43) and (43, 4, 47) 10-12% more):
# a panel that is not a multiple of 8 columns cost 9-16% more per cell at
# 2048^2, one that is 1-5%. The kernels are compiled with these windows'
# strides as constants (``ops/_build.py::trap_windows``).
TRAPEZOID_TIERS = (((36, 4, 56), 2 * BC.TRAP_SLOTS), ((32, 4, 40), 132), ((24, 4, 24), 0))


def schedule(params, dtype) -> tuple[int, int, int] | None:
    """K5's schedule ``(block, depth, panel)`` on the grid of ``params``
    (``pick_block``/``pick_depth`` of the JAX package); None for a dtype it
    does not store (``band_common.tiered``)."""
    return BC.tiered(params, dtype, TRAPEZOID_TIERS, temporal_supported)


def _check(cells, nobst, n_iters, block, depth, panel, dev=None):
    BC.check_schedule(cells, nobst, n_iters, block, depth, panel, dev)
    _, ny, nx = cells.shape
    if not temporal_supported(ny, nx, block, depth, panel):
        raise ValueError(f"temporal schedule unsupported: grid {ny}x{nx}, block {block}, "
                         f"depth {depth}, panel {panel} (depth must not exceed any block's "
                         "height, the last block's included)")


def make_halos_t(cells, block, depth):
    """The initial packs ``(last_t, first_t)`` of ``cells``, indexed by
    producer block (``pallas_temporal.make_halos_t``)."""
    _, ny, nx = cells.shape
    nblk, _ = block_heights(ny, block)
    starts = torch.arange(nblk, device=cells.device) * block
    ends = starts + block
    ends[-1] = ny
    off = torch.arange(depth, device=cells.device)[None, :]

    def pack(rows):  # (nblk, T) global rows -> (nblk, 9T, nx), plane-major
        return cells[:, rows].permute(1, 0, 2, 3).reshape(nblk, 9 * depth, nx).contiguous()

    return pack((ends - depth)[:, None] + off), pack(starts[:, None] + off)


def window_rows(ny, block, depth, device):
    """Global rows ``(nblk, B+2T)`` of every block's window, wrapped."""
    nblk, _ = block_heights(ny, block)
    return (torch.arange(nblk, device=device)[:, None] * block - depth
            + torch.arange(block + 2 * depth, device=device)[None, :]) % ny


def trapezoid_plain(win, nob, rows, ny, block, depth, omega, w1a, w2a):
    """T steps of every block's window on the shrinking trapezoid, in plain
    PyTorch, the step algebra of ``pallas_temporal._kernel``.

    ``win`` is ``(nblk, 9, B+2T, nx)``, ``nob`` ``(nblk, B+2T, nx)`` and
    ``rows`` their global rows. A ragged last block of ``b`` rows holds its
    halo at window rows ``[T + b, 2T + b)``; its rows below that never reach
    its output. Returns the blocks' output rows ``(nblk, 9, B, nx)`` and the
    T per-step sums of ``nob * |u|`` over the rows inside the grid."""
    nblk = win.shape[0]
    b, t = block, depth
    frow_all = (rows == ny - 2).to(win.dtype)[:, :, None]
    inside = (torch.arange(nblk, device=win.device)[:, None] * b
              + torch.arange(b, device=win.device)[None, :]) < ny
    nob_mid = nob[:, t:t + b] * inside.to(win.dtype)[:, :, None]
    planes = list(win.unbind(1))
    sums = torch.empty(t, dtype=win.dtype, device=win.device)
    for s in range(1, t + 1):
        u = t - s + 1
        n_in, n_out = b + 2 * u, b + 2 * (u - 1)
        planes = BC.force_windows(planes, nob[:, s - 1:s - 1 + n_in],
                                  frow_all[:, s - 1:s - 1 + n_in], w1a, w2a)
        # Output row o pulls input row o + 1 - cy; x wraps over the full row.
        pulled = [torch.roll(planes[k][:, 1 - _CYS[k]:1 - _CYS[k] + n_out], _CXS[k], dims=2)
                  for k in range(9)]
        relaxed, u_sq = bgk_relax(pulled, omega)
        fluid = nob[:, s:s + n_out] > 0.0
        planes = [torch.where(fluid, relaxed[k], pulled[_OPP[k]]) for k in range(9)]
        sums[s - 1] = torch.sum(nob_mid * u_mag(u_sq[:, u - 1:u - 1 + b]))
    return torch.stack(planes, 1), sums


def trapezoid_aa_plain(win, nob, rows, ny, block, depth, panel, omega, w1a, w2a):
    """``trapezoid_plain``'s function on the kernels' schedule
    (``csrc/trapezoid.cuh``), in plain PyTorch, with its arguments and
    results and the tiles' ``panel`` (None: the full row).

    Each block's window rows are cut into tiles of ``panel`` columns with a
    T-column halo, wrapped. A tile's window enters the AA arrangement's
    slots (slot opp(k) of a cell holds R_k, the value leaving it along k)
    with the forcing of the ny-2 rows added cell-locally; step s (1..T)
    runs only on window rows ``[s, bi + 2T - s)`` and columns
    ``[s, pi + 2T - s)`` of a tile of ``bi x pi`` cells: odd steps gather,
    relax and scatter, even ones relax in place, each adding the forcing of
    the step after it but the last. After an odd T the store takes R_k of
    a central cell from where the last step scattered it. Every slot that a
    step does not write becomes NaN, so a read outside what the schedule
    computed shows in the result."""
    nblk, _, wh, nx = win.shape
    b, t = block, depth
    p = nx if panel is None else panel
    ntx = -(-nx // p)
    dev = win.device
    cols = (torch.arange(ntx, device=dev)[:, None] * p - t
            + torch.arange(p + 2 * t, device=dev)[None, :]) % nx

    def tiles(x):  # (nblk, C, wh, nx) -> (nblk * ntx, C, wh, p + 2T)
        return x[..., cols].permute(0, 3, 1, 2, 4).reshape(nblk * ntx, x.shape[1], wh, -1)

    def rows_of(x):  # (nblk * ntx, C, b, p) -> (nblk, C, b, nx)
        c = x.shape[1]
        return x.reshape(nblk, ntx, c, b, p).permute(0, 2, 3, 1, 4).reshape(
            nblk, c, b, ntx * p)[..., :nx]

    nobw = tiles(nob[:, None])[:, 0]
    frow = (rows == ny - 2).to(win.dtype)[:, None, :, None].expand(nblk, ntx, wh, 1)
    frow = frow.reshape(nblk * ntx, wh, 1)
    # Each tile's window extent: the last row block and column tile may be short.
    hi_r = torch.full((nblk, ntx), b + 2 * t, device=dev)
    hi_r[-1] = block_heights(ny, b)[1] + 2 * t
    hi_c = torch.full((nblk, ntx), p + 2 * t, device=dev)
    hi_c[:, -1] = nx - (ntx - 1) * p + 2 * t
    rr = torch.arange(wh, device=dev)[None, :, None]
    cc = torch.arange(p + 2 * t, device=dev)[None, None, :]
    hi_r, hi_c = hi_r.reshape(-1, 1, 1), hi_c.reshape(-1, 1, 1)
    inside = (torch.arange(nblk, device=dev)[:, None] * b
              + torch.arange(b, device=dev)[None, :]) < ny
    nob_mid = nob[:, t:t + b] * inside.to(win.dtype)[:, :, None]
    fluid = nobw > 0.0
    nan = torch.tensor(float("nan"), dtype=win.dtype, device=dev)
    planes = BC.force_windows(list(tiles(win).unbind(1)), nobw, frow, w1a, w2a)
    slots = [planes[_OPP[j]] for j in range(9)]
    sums = torch.empty(t, dtype=win.dtype, device=dev)
    shift = [(_CYS[k], _CXS[k]) for k in range(9)]
    for s in range(1, t + 1):
        region = (rr >= s) & (rr < hi_r - s) & (cc >= s) & (cc < hi_c - s)
        if s % 2:
            tk = [torch.roll(slots[_OPP[k]], shift[k], (1, 2)) for k in range(9)]
        else:
            tk = slots
        relaxed, u_sq = bgk_relax(tk, omega)
        out = [torch.where(fluid, relaxed[k], tk[_OPP[k]]) for k in range(9)]
        if s < t:
            out = BC.force_windows(out, nobw, frow, w1a, w2a)
        if s % 2:
            slots = [torch.where(torch.roll(region, shift[k], (1, 2)),
                                 torch.roll(out[k], shift[k], (1, 2)), nan) for k in range(9)]
        else:
            slots = [torch.where(region, out[_OPP[j]], nan) for j in range(9)]
        u = rows_of(u_sq[:, None, t:t + b, t:t + p])[:, 0]
        sums[s - 1] = torch.sum(nob_mid * u_mag(torch.where(inside[:, :, None], u, 0.0)))
    if t % 2:
        res = [torch.roll(slots[k], (-_CYS[k], -_CXS[k]), (1, 2)) for k in range(9)]
    else:
        res = [slots[_OPP[k]] for k in range(9)]
    return rows_of(torch.stack([x[:, t:t + b, t:t + p] for x in res], 1)), sums


def aa_trapezoid(panel):
    """``trapezoid_aa_plain`` on tiles of ``panel`` columns, as the ``trap``
    of ``step_t_plain`` and ``deep.step_deep_plain``."""

    def trap(win, nob, rows, ny, block, depth, omega, w1a, w2a):
        return trapezoid_aa_plain(win, nob, rows, ny, block, depth, panel, omega, w1a, w2a)

    return trap


def blocks_to_state(out, ny):
    """``(nblk, 9, B, nx)`` block rows -> the ``(9, ny, nx)`` state."""
    nblk, _, b, nx = out.shape
    return out.permute(1, 0, 2, 3).reshape(9, nblk * b, nx)[:, :ny].contiguous()


def on_planes(codec, blocks, dev):
    """``codec`` (``decode_state`` or ``encode_state``) on ``(nblk, 9, ...)``
    blocks; unchanged without ``dev``."""
    return blocks if dev is None else codec(blocks.transpose(0, 1), dev).transpose(0, 1)


def step_t_plain(state, nobst, density, accel, omega, block, depth, *, inv_tot_cells=1.0,
                 dev=None, trap=trapezoid_plain):
    """One pass of ``depth`` steps in plain PyTorch (``step_t_pallas``).
    Returns ``((cells, last_o, first_o), av)`` with ``depth`` av values.
    ``dev``: 16-bit storage (c16 codes or bf16 in the state and packs);
    ``trap``: the window's steps, ``trapezoid_plain`` (the pull on full
    rows) or ``aa_trapezoid(panel)`` (K5's schedule)."""
    cells, last_t, first_t = state
    _, ny, nx = cells.shape
    nblk, last = block_heights(ny, block)
    t = depth
    w1a, w2a = forcing_weights(density, accel)
    rows = window_rows(ny, block, depth, cells.device)
    win = cells[:, rows].permute(1, 0, 2, 3).clone()  # (nblk, 9, B+2T, nx)
    above = last_t.view(nblk, 9, t, nx).roll(1, dims=0)
    below = first_t.view(nblk, 9, t, nx).roll(-1, dims=0)
    win[:, :, :t] = above
    win[:-1, :, t + block:2 * t + block] = below[:-1]
    win[-1, :, t + last:2 * t + last] = below[-1]
    out, sums = trap(on_planes(decode_state, win, dev), nobst[rows], rows, ny, block, depth,
                     float(omega), w1a, w2a)
    out = on_planes(encode_state, out, dev)
    first_o = out[:, :, :t].reshape(nblk, 9 * t, nx)
    last_o = torch.cat([out[:-1, :, block - t:block], out[-1:, :, last - t:last]])
    last_o = last_o.reshape(nblk, 9 * t, nx)
    inv = torch.tensor(inv_tot_cells, dtype=torch.float32, device=cells.device)
    return (blocks_to_state(out, ny), last_o.contiguous(), first_o.contiguous()), sums * inv


def _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, dev=None,
                  trap=trapezoid_plain):
    def run_passes(cells, npasses):
        state = (cells, *make_halos_t(cells, block, depth))
        av = []
        for _ in range(npasses):
            state, a = step_t_plain(state, nobst, density, accel, omega, block, depth,
                                    inv_tot_cells=inv_tot_cells, dev=dev, trap=trap)
            av.append(a)
        return state[0], torch.cat(av)

    return run_passes


def _launch(state, nobst, density, accel, omega, inv_tot_cells, block, depth, panel, npasses,
            dev=None):
    """``npasses`` passes of K5 from one C call; returns ``(state, av)``."""
    cells, last_t, first_t = (x.contiguous() for x in state)
    _, ny, nx = cells.shape
    b, p, t = BC.tile_shape(nx, block, depth, panel)
    BC.check_smem("temporal kernel", PLANE_COPIES, nx, block, depth, panel)
    lib = _build.library()
    bufs = [cells.clone(), torch.empty_like(cells), last_t.clone(), first_t.clone(),
            torch.empty_like(last_t), torch.empty_like(first_t)]
    nobst = nobst.contiguous()
    av = torch.empty(npasses * t, dtype=torch.float32, device=cells.device)
    partials = torch.empty(lib.lbm_band_num_tiles(ny, nx, b, p) * t, dtype=torch.float32,
                           device=cells.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=cells.device)
    with torch.cuda.device(cells.device):
        stream = torch.cuda.current_stream(cells.device).cuda_stream
        rc = lib.lbm_temporal_run(
            *(x.data_ptr() for x in bufs), nobst.data_ptr(), av.data_ptr(),
            partials.data_ptr(), ticket.data_ptr(), ny, nx, b, t, p, npasses,
            *kernel_scalars(density, accel, omega, inv_tot_cells), _build.storage(dev), stream,
        )
    _build.check(rc, "temporal kernel")
    count_launches(run_temporal, npasses * t, dev)
    o = npasses % 2  # the buffers of the last pass's output
    return (bufs[o], bufs[2 + 2 * o], bufs[3 + 2 * o]), av


def _device_check(device):
    if device.type != "cuda":
        raise ValueError(f"no temporal kernel for device {device}")


def step_t(state, nobst, density, accel, omega, block, depth, *, panel=None, inv_tot_cells=1.0,
           dev=None):
    """One pass of ``depth`` steps on ``(cells, last_t, first_t)``: kernel K5
    on CUDA, ``step_t_plain`` on CPU. Returns ``((cells, last_o, first_o),
    av)``. ``dev``: 16-bit storage (c16 codes or bf16 in the state and packs)."""
    cells = state[0]
    _check(cells, nobst, depth, block, depth, panel, dev)
    if cells.device.type == "cpu":
        return step_t_plain(state, nobst, density, accel, omega, block, depth,
                            inv_tot_cells=inv_tot_cells, dev=dev)
    _device_check(cells.device)
    return _launch(state, nobst, density, accel, omega, inv_tot_cells, block, depth, panel, 1,
                   dev)


def run_temporal_plain(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
                       inv_tot_cells=1.0, dev=None):
    """The temporal schedule in plain PyTorch; returns ``(cells, av)``."""
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, dev)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, dev)


def run_temporal_aa_plain(cells, nobst, density, accel, omega, n_iters, block, depth, *,
                          panel=None, inv_tot_cells=1.0, dev=None):
    """``run_temporal_plain``'s function on K5's schedule (2-D tiles, the AA
    steps on the trapezoid: ``trapezoid_aa_plain``) in plain PyTorch;
    returns ``(cells, av)``."""
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth,
                           dev, aa_trapezoid(panel))
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, dev)


def run_temporal(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
                 inv_tot_cells=1.0, dev=None):
    """Run ``n_iters`` steps, ``depth`` per pass: kernel K5 on CUDA (and K1
    for the remainder), ``run_temporal_plain`` on CPU. ``cells`` is left
    unchanged. The kernel implements the fused collision form. ``dev``:
    16-bit storage (int16 c16 codes or bf16 ``cells``)."""
    if cells.device.type == "cpu":
        return run_temporal_plain(cells, nobst, density, accel, omega, n_iters, block, depth,
                                  panel=panel, inv_tot_cells=inv_tot_cells, dev=dev)
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    _device_check(cells.device)

    def run_passes(c, npasses):
        state = (c, *make_halos_t(c, block, depth))
        (c, _, _), av = _launch(state, nobst, density, accel, omega, inv_tot_cells, block,
                                depth, panel, npasses, dev)
        return c, av

    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        run_passes, dev)


run_temporal.launches = 0  # steps K5 advanced in this process
run_temporal.launches_c16 = 0  # steps K5 advanced at c16
run_temporal.launches_bf16 = 0  # steps K5 advanced at bf16
