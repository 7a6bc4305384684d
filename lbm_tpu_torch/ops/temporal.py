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
pass's read-only input state, the y halo from the packs; every pass of a
run is issued by one C call. On a CPU tensor it runs the plain versions
(``step_t_plain``, ``run_temporal_plain``) on full rows with a periodic
roll in x, the same function. Any other device raises; a CUDA tensor never
falls back.

The TPU kernel's ``B % 8``, ``nx % 128`` and ``B | ny`` are Mosaic
constraints and are not ported. A block's packs are its own rows, so T may
not exceed any block's height, the last one of a ragged grid included.

c16 storage (``dev``, ``pallas_temporal.py``'s ``dev=``): the state and the
packs hold int16 codes (``make_halos_t`` packs the input's codes); K5 and
``step_t_plain`` decode the window's three sources as they read them and
encode the pass's output once, the packs from the same codes as the state
rows they copy (one rounding per pass of T steps).
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops import band_common as BC
from lbm_tpu_torch.ops.collision import bgk_relax, u_mag
from lbm_tpu_torch.ops.devspace import decode_state, encode_state
from lbm_tpu_torch.ops.step import (_CXS, _CYS, _OPP, count_launches, forcing_weights,
                                    kernel_scalars)

PLANE_COPIES = 2  # the window's two ping-pong copies (csrc/trapezoid.cuh)


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


def trapezoid_plain(win, nob, rows, ny, block, depth, omega, w1a, w2a, paired):
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
        relaxed, u_sq = bgk_relax(pulled, omega, paired=paired)
        fluid = nob[:, s:s + n_out] > 0.0
        planes = [torch.where(fluid, relaxed[k], pulled[_OPP[k]]) for k in range(9)]
        sums[s - 1] = torch.sum(nob_mid * u_mag(u_sq[:, u - 1:u - 1 + b]))
    return torch.stack(planes, 1), sums


def blocks_to_state(out, ny):
    """``(nblk, 9, B, nx)`` block rows -> the ``(9, ny, nx)`` state."""
    nblk, _, b, nx = out.shape
    return out.permute(1, 0, 2, 3).reshape(9, nblk * b, nx)[:, :ny].contiguous()


def on_planes(codec, blocks, dev):
    """``codec`` (``decode_state`` or ``encode_state``) on ``(nblk, 9, ...)``
    blocks; unchanged without ``dev``."""
    return blocks if dev is None else codec(blocks.transpose(0, 1), dev).transpose(0, 1)


def step_t_plain(state, nobst, density, accel, omega, block, depth, *, inv_tot_cells=1.0,
                 paired="fused", dev=None):
    """One pass of ``depth`` steps in plain PyTorch (``step_t_pallas``).
    Returns ``((cells, last_o, first_o), av)`` with ``depth`` av values.
    ``dev``: c16 storage (int16 state and packs)."""
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
    out, sums = trapezoid_plain(on_planes(decode_state, win, dev), nobst[rows], rows, ny, block,
                                depth, float(omega), w1a, w2a, paired)
    out = on_planes(encode_state, out, dev)
    first_o = out[:, :, :t].reshape(nblk, 9 * t, nx)
    last_o = torch.cat([out[:-1, :, block - t:block], out[-1:, :, last - t:last]])
    last_o = last_o.reshape(nblk, 9 * t, nx)
    inv = torch.tensor(inv_tot_cells, dtype=torch.float32, device=cells.device)
    return (blocks_to_state(out, ny), last_o.contiguous(), first_o.contiguous()), sums * inv


def _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, paired, dev=None):
    def run_passes(cells, npasses):
        state = (cells, *make_halos_t(cells, block, depth))
        av = []
        for _ in range(npasses):
            state, a = step_t_plain(state, nobst, density, accel, omega, block, depth,
                                    inv_tot_cells=inv_tot_cells, paired=paired, dev=dev)
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
            *kernel_scalars(density, accel, omega, inv_tot_cells), _build.codec(dev), stream,
        )
    _build.check(rc, "temporal kernel")
    count_launches(run_temporal, npasses * t, dev)
    o = npasses % 2  # the buffers of the last pass's output
    return (bufs[o], bufs[2 + 2 * o], bufs[3 + 2 * o]), av


def _device_check(device, paired):
    if device.type != "cuda":
        raise ValueError(f"no temporal kernel for device {device}")
    if not (isinstance(paired, str) and paired.startswith("fused")):
        raise ValueError("the CUDA temporal kernel implements the fused collision form only")


def step_t(state, nobst, density, accel, omega, block, depth, *, panel=None, inv_tot_cells=1.0,
           paired="fused", dev=None):
    """One pass of ``depth`` steps on ``(cells, last_t, first_t)``: kernel K5
    on CUDA, ``step_t_plain`` on CPU. Returns ``((cells, last_o, first_o),
    av)``. ``dev``: c16 storage (int16 state and packs)."""
    cells = state[0]
    _check(cells, nobst, depth, block, depth, panel, dev)
    if cells.device.type == "cpu":
        return step_t_plain(state, nobst, density, accel, omega, block, depth,
                            inv_tot_cells=inv_tot_cells, paired=paired, dev=dev)
    _device_check(cells.device, paired)
    return _launch(state, nobst, density, accel, omega, inv_tot_cells, block, depth, panel, 1,
                   dev)


def run_temporal_plain(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
                       inv_tot_cells=1.0, paired="fused", dev=None):
    """The temporal schedule in plain PyTorch; returns ``(cells, av)``."""
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, paired,
                           dev)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, paired, dev)


def run_temporal(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
                 inv_tot_cells=1.0, paired="fused", dev=None):
    """Run ``n_iters`` steps, ``depth`` per pass: kernel K5 on CUDA (and K1
    for the remainder), ``run_temporal_plain`` on CPU. ``cells`` is left
    unchanged. The kernel implements the fused collision form. ``dev``:
    c16 storage (int16 ``cells``)."""
    if cells.device.type == "cpu":
        return run_temporal_plain(cells, nobst, density, accel, omega, n_iters, block, depth,
                                  panel=panel, inv_tot_cells=inv_tot_cells, paired=paired,
                                  dev=dev)
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    _device_check(cells.device, paired)

    def run_passes(c, npasses):
        state = (c, *make_halos_t(c, block, depth))
        (c, _, _), av = _launch(state, nobst, density, accel, omega, inv_tot_cells, block, depth,
                                panel, npasses, dev)
        return c, av

    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        run_passes, paired, dev)


run_temporal.launches = 0  # steps K5 advanced in this process
run_temporal.launches_c16 = 0  # steps K5 advanced at c16
