"""The resident route (counterpart of ``lbm_tpu/ops/pallas_resident.py``).

``run_resident`` advances a ``(9, ny, nx)`` f32 state ``n_iters`` whole-grid
steps, ``chunk`` steps per kernel launch, and returns ``(cells, av)`` with
``av[t] = inv_tot_cells * sum(nobst * |u|)`` of step t.

On a CUDA tensor it runs kernel K4 (``csrc/resident.cu``), one persistent
cooperative launch per chunk, every chunk of a run issued by one C call, in
one of two forms picked from the shapes before any launch:

- the shared-memory form, wherever ``resident_smem_config`` finds a
  schedule: block b holds whole rows ``[b*B, b*B + B)`` with T ghost rows
  above and below in shared memory for the whole launch, runs T steps per
  pass on a window that shrinks by a row at each edge per step, and
  exchanges its edge rows with its neighbours through a buffer in device
  memory, double-buffered by pass parity, at one grid-wide barrier per
  pass. ``run_resident_slabs_plain`` is that schedule in plain PyTorch;
- the global-memory form elsewhere (grids whose window rows do not fit a
  block's shared memory): ONE copy of the state, stepped in place in K2's
  AA arrangement with a grid-wide barrier between steps, each block a
  fixed slab of cells for the whole call. The call starts on R with the
  gather step (slot j of the arrangement in plane opp(j), so R is the C
  arrangement), forces the cells of row ny-2 of R once before it, and
  adds each next step's forcing to the outputs of those cells, but the
  call's last step; after an odd number of steps the wrapper turns the S
  arrangement back into R as K2's exit does (``aa.stream_planes``).
  ``run_resident_aa_plain`` is that schedule in plain PyTorch, bitwise
  ``run_resident_plain``.

Each C call adds its schedule's ``schedule_counts`` to the open call's
counters (``runtime/trace.py``): the grid barriers its launches meet, and
for the shared-memory form the cell updates computed on ghost rows and the
bytes through the exchange buffer. Counted in Python from the shapes, once
a call; on the CPU nothing is counted.

The shared-memory form's final state is whichever buffer its last launch
wrote (the TPU kernel ends an even-length chunk with a whole-state copy
into its output window; the card has no output window to fill). On a CPU
tensor ``run_resident`` runs ``run_resident_plain``, the same steps in
plain PyTorch. Any other device raises; a CUDA tensor never falls back.

The TPU kernel's gates (``nx % 128``, ``ny % 8``, the 40 MB VMEM budget,
``_pick_tile`` and the value-carried path for states up to 4 MB) exist for
VMEM and Mosaic and are not ported: K4 takes any grid with ``ny >= 2``.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops.aa import stream_planes
from lbm_tpu_torch.ops.band_common import SMEM_LIMIT
from lbm_tpu_torch.ops.collision import bgk_relax, u_mag
from lbm_tpu_torch.ops.step import (_CXS, _CYS, _OPP, check_inputs, force_deltas, force_row,
                                    forcing_weights, kernel_scalars, step_plain)
from lbm_tpu_torch.runtime import trace

# Steps per launch, as pallas_resident._CHUNK_STEPS; 1023 measured 12% slower
# at 128^2 and within 2% at 256^2-1024^2.
CHUNK_STEPS = 255
_THREADS = 256  # csrc/resident.cu::kThreads
_SMEM_THREADS = 512  # csrc/resident.cu::kSmemThreads, a block of the shared-memory form
_SMEM_WARPS = _SMEM_THREADS // 32
# The most steps per pass of the shared-memory form.
SMEM_MAX_DEPTH = 4
# The most blocks per SM of the global-memory form. On an H100 (chip_smoke
# phase 32, in turns, two runs, PERF.md section 6) 3 blocks per SM took
# 2-16% less time than 4 at 512^2, 768^2, 896^2-1024^2 (with the L2
# window where ``l2_window`` sets it) and 2048^2, the sizes of the 1024^2
# deck and the 2048^2 walls deck; 2-27% more at 832^2 and 1088^2-1280^2,
# and 22% more at 4096^2.
BLOCKS_PER_SM = 3


def resident_supported(ny: int, nx: int) -> bool:
    """Every grid K1 takes: ``ny >= 2`` (the forcing row ny-2 exists)."""
    del nx
    return ny >= 2


def resident_smem_bytes(nx: int, rows: int, depth: int) -> int:
    """Dynamic shared memory of a block of the shared-memory form
    (``csrc/resident.cu::smem_form_bytes``): two f32 copies of the 9 planes
    and the not-obstacle plane of its ``rows + 2 depth`` by ``nx`` window
    (76 B per cell), the global row of each window row, and one partial sum
    per warp and step."""
    wh = rows + 2 * depth
    return 4 * 19 * wh * nx + 4 * wh + 4 * _SMEM_WARPS * depth


def smem_depth(nx: int) -> int:
    """The preferred steps per pass for rows of ``nx`` cells: one more than
    the rows one sweep of a block's threads covers, at most
    ``SMEM_MAX_DEPTH``. Each step of a pass recomputes two rows fewer of
    the ghost rows, so the wider the rows, the more a deeper pass costs
    against the barrier it saves: on an H100 the sweep of chip_smoke phase
    23 ran fastest at T 4 on 128-wide rows and T 3 on 256-wide ones
    (PERF.md)."""
    return max(1, min(SMEM_MAX_DEPTH, _SMEM_THREADS // nx + 1))


def resident_smem_config(ny: int, nx: int, max_blocks: int):
    """``(blocks, rows, depth, smem_bytes)`` of the shared-memory form: the
    fewest rows per block that keep the blocks within ``max_blocks`` (one
    per SM), and the deepest pass up to ``smem_depth(nx)`` whose window
    fits a block's shared memory; None where none fits (then the
    global-memory form runs)."""
    if ny < 2 or nx < 1 or max_blocks < 1:
        return None
    rows = -(-ny // max_blocks)
    for depth in range(smem_depth(nx), 0, -1):
        need = resident_smem_bytes(nx, rows, depth)
        if need <= SMEM_LIMIT:
            return -(-ny // rows), rows, depth, need
    return None


def schedule_counts(ny: int, nx: int, n_iters: int, chunk: int, config=None) -> dict:
    """The counters of one C call of K4 over ``n_iters`` steps in launches of
    ``chunk``: ``grid_barriers``, ``ghost_updates`` and ``exchange_bytes``.

    Shared-memory form (``config = (blocks, rows, depth, smem_bytes)``): a
    launch of L steps runs passes of ``depth`` steps, the last shorter; it
    meets one ``grid.sync()`` after each pass (the exchange's, then the
    final one before the av reduction), and exchanges between its passes.
    A pass of p steps computes p(p-1) ghost rows of ``nx`` cells a block.
    An exchange moves 36 B a cell (9 f32 values) of each block's own rows
    within ``depth`` of an edge out and its 2 ``depth`` ghost rows in.

    Global-memory form (``config`` None): one barrier a step, and the entry
    barrier of the call's first launch; no ghost rows, no exchange."""
    if config is None:
        return {"grid_barriers": n_iters + 1, "ghost_updates": 0, "exchange_bytes": 0}
    blocks, rows, depth, _ = config
    last = ny - (blocks - 1) * rows  # the last block's rows
    moved = 36 * nx * ((blocks - 1) * min(rows, 2 * depth) + min(last, 2 * depth)
                       + blocks * 2 * depth)
    barriers = ghost = 0
    for steps, launches in ((chunk, n_iters // chunk), (n_iters % chunk, 1)):
        full, rest = divmod(steps, depth)
        passes = full + (rest > 0)
        barriers += launches * passes
        ghost += launches * (full * depth * (depth - 1) + rest * (rest - 1))
    exchanges = barriers - -(-n_iters // chunk)
    return {"grid_barriers": barriers, "ghost_updates": ghost * blocks * nx,
            "exchange_bytes": exchanges * moved}


def _count(ny, nx, n_iters, chunk, config=None) -> None:
    for name, n in schedule_counts(ny, nx, n_iters, chunk, config).items():
        trace.count(name, n)


def _check(cells, nobst, n_iters, chunk):
    check_inputs(cells, nobst, n_iters, 2)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def run_resident_plain(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, *,
                       chunk=CHUNK_STEPS):
    """``n_iters`` steps in chunks of ``chunk``, in plain PyTorch; returns
    ``(cells, av)``."""
    _check(cells, nobst, n_iters, chunk)
    w1a, w2a = forcing_weights(density, accel)
    inv = torch.tensor(inv_tot_cells, dtype=torch.float32, device=cells.device)
    av = torch.empty(n_iters, dtype=torch.float32, device=cells.device)
    for start in range(0, n_iters, chunk):
        for t in range(start, min(start + chunk, n_iters)):
            cells, tot = step_plain(cells, nobst, w1a, w2a, float(omega))
            av[t] = tot * inv
    return cells, av


def _aa_launch_plain(state, nobst, w1a, w2a, omega, first, steps, last):
    """One launch of the global-memory form: ``steps`` steps of a call on
    ``state`` (plane j holds slot opp(j) of the AA arrangement), the first
    of them the call's step ``first`` (a gather step when even); ``last``:
    the launch ends the call. Returns the state and the per-step sums."""
    planes = list(state.unbind(0))
    if first == 0:
        planes = force_row(planes, nobst, w1a, w2a)
    fluid = nobst > 0.0
    sums = torch.empty(steps, dtype=state.dtype, device=state.device)
    for st in range(steps):
        gather = (first + st) % 2 == 0
        if gather:  # t_k from plane k at x - c_k
            t = [torch.roll(planes[k], shifts=(_CYS[k], _CXS[k]), dims=(0, 1)) for k in range(9)]
        else:  # t_k from plane opp(k) of the cell
            t = [planes[_OPP[k]] for k in range(9)]
        relaxed, u_sq = bgk_relax(t, omega)
        out = [torch.where(fluid, relaxed[k], t[_OPP[k]]) for k in range(9)]
        if not (last and st + 1 == steps):
            out = force_row(out, nobst, w1a, w2a)
        if gather:  # value k to plane opp(k) at x + c_k
            planes = [torch.roll(out[_OPP[j]], shifts=(_CYS[_OPP[j]], _CXS[_OPP[j]]),
                                 dims=(0, 1)) for j in range(9)]
        else:  # value k to plane k of the cell
            planes = out
        sums[st] = torch.sum(nobst * u_mag(u_sq))
    return torch.stack(planes), sums


def as_regular(state, n_steps: int):
    """R from the global-memory form's state after ``n_steps`` steps of a
    call: R itself after an even count, the S arrangement (slot k in plane
    opp(k)) after an odd one, which ``stream_planes`` turns back as K2's
    exit does."""
    if n_steps % 2 == 0:
        return state
    return stream_planes(state[torch.as_tensor(_OPP, device=state.device)], -1).contiguous()


def run_resident_aa_plain(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, *,
                          chunk=CHUNK_STEPS):
    """The global-memory form's schedule in plain PyTorch, launch by launch
    of ``chunk`` steps: one copy of the state stepped in the AA arrangement
    from R, the forcing placed as the kernel places it. Returns ``(cells,
    av)``, bitwise ``run_resident_plain``'s."""
    _check(cells, nobst, n_iters, chunk)
    w1a, w2a = forcing_weights(density, accel)
    inv = torch.tensor(inv_tot_cells, dtype=torch.float32, device=cells.device)
    av = torch.empty(n_iters, dtype=torch.float32, device=cells.device)
    state = cells
    for start in range(0, n_iters, chunk):
        steps = min(chunk, n_iters - start)
        state, sums = _aa_launch_plain(state, nobst, w1a, w2a, float(omega), start, steps,
                                       start + steps == n_iters)
        av[start:start + steps] = sums * inv
    return as_regular(state, n_iters), av


def _window_step(win, nob, frow, r0, r1, own, w1a, w2a, omega):
    """One step of window rows ``[r0, r1)`` from rows ``[r0-1, r1+1)`` of
    ``win`` (9, wh, nx): the forcing of the rows marked by ``frow`` at the
    source, the pull with wrap in x, BGK, bounce-back. Returns the window
    and the sum of ``nob * |u|`` over window rows ``own``."""
    src = list(win[:, r0 - 1:r1 + 1].unbind(0))
    nsrc, fsrc = nob[r0 - 1:r1 + 1], frow[r0 - 1:r1 + 1, None]
    ok = (src[3] - w1a > 0.0) & (src[6] - w2a > 0.0) & (src[7] - w2a > 0.0)
    amask = ok.to(win.dtype) * nsrc
    for k, w in force_deltas(w1a, w2a):
        src[k] = torch.where(fsrc, src[k] + w * amask, src[k])
    n = r1 - r0
    t = [torch.roll(src[k][1 - _CYS[k]:1 - _CYS[k] + n], shifts=_CXS[k], dims=1)
         for k in range(9)]
    relaxed, u_sq = bgk_relax(t, omega)
    fluid = nob[r0:r1] > 0.0
    out = win.clone()
    out[:, r0:r1] = torch.stack([torch.where(fluid, relaxed[k], t[_OPP[k]]) for k in range(9)])
    lo, hi = own
    return out, torch.sum(nob[lo:hi] * u_mag(u_sq[lo - r0:hi - r0]))


def _exchange(ex, blocks, t):
    """The exchange between two passes through ``ex`` (9, ny, nx), the
    buffer of the pass's parity: each block's own rows within ``t`` of an
    edge into it, then every block's ghost rows from it."""
    for y0, bi, _, win, _, _ in blocks:
        edge = [rr for rr in range(bi) if rr < t or rr >= bi - t]
        ex[:, [y0 + rr for rr in edge]] = win[:, [t + rr for rr in edge]]
    for blk in blocks:
        bi, grow = blk[1], blk[2]
        ghost = list(range(t)) + list(range(t + bi, bi + 2 * t))
        blk[3] = blk[3].clone()
        blk[3][:, ghost] = ex[:, grow[ghost]]


def _slabs_launch(cells, nobst, w1a, w2a, omega, steps, rows, depth):
    """One launch of the shared-memory form: ``steps`` steps; returns the
    state and the per-step sums, each the sum over blocks in block order."""
    _, ny, nx = cells.shape
    t = depth
    blocks = []  # [y0, bi, global rows of the window, window, its not-obstacle rows, forcing rows]
    for y0 in range(0, ny, rows):
        bi = min(rows, ny - y0)
        grow = (torch.arange(bi + 2 * t, device=cells.device) + (y0 - t)) % ny
        blocks.append([y0, bi, grow, cells[:, grow], nobst[grow], grow == ny - 2])
    exch = cells.new_empty((2,) + tuple(cells.shape))
    sums = torch.empty(steps, dtype=cells.dtype, device=cells.device)
    done = npass = 0
    while done < steps:
        length = min(t, steps - done)
        per_block = []
        for blk in blocks:
            _, bi, _, win, nob, frow = blk
            part = []
            for s in range(1, length + 1):
                win, tot = _window_step(win, nob, frow, t - length + s, t + bi + length - s,
                                        (t, t + bi), w1a, w2a, omega)
                part.append(tot)
            blk[3] = win
            per_block.append(torch.stack(part))
        sums[done:done + length] = torch.stack(per_block).sum(0)
        done += length
        if done < steps:
            _exchange(exch[npass % 2], blocks, t)
        npass += 1
    out = torch.empty_like(cells)
    for y0, bi, _, win, _, _ in blocks:
        out[:, y0:y0 + bi] = win[:, t:t + bi]
    return out, sums


def run_resident_slabs_plain(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, rows,
                             depth, *, chunk=CHUNK_STEPS):
    """The shared-memory form's schedule in plain PyTorch: per launch of
    ``chunk`` steps, slabs of ``rows`` rows (the last fewer) with ``depth``
    ghost rows on each side, passes of ``depth`` steps (the launch's last
    shorter) on rows that shrink by one at each edge per step, and the
    exchange of edge rows by pass parity between passes. Returns
    ``(cells, av)``: the cells of ``run_resident_plain`` bit for bit, the
    av series summed per block, then over blocks."""
    _check(cells, nobst, n_iters, chunk)
    if rows < 1 or depth < 1:
        raise ValueError(f"bad slab schedule: rows {rows}, depth {depth}")
    w1a, w2a = forcing_weights(density, accel)
    inv = torch.tensor(inv_tot_cells, dtype=torch.float32, device=cells.device)
    av = torch.empty(n_iters, dtype=torch.float32, device=cells.device)
    for start in range(0, n_iters, chunk):
        steps = min(chunk, n_iters - start)
        cells, sums = _slabs_launch(cells, nobst, w1a, w2a, float(omega), steps, rows, depth)
        av[start:start + steps] = sums * inv
    return cells, av


def max_blocks(device) -> int:
    """The most blocks of K4's global-memory form the card holds at once
    (occupancy x SMs)."""
    lib = _build.library()
    with torch.cuda.device(device):
        n = lib.lbm_resident_max_blocks()
    if n <= 0:
        _build.check(-n, "resident kernel occupancy")
    return n


def sm_count(device) -> int:
    """The card's streaming multiprocessors: the shared-memory form's most
    blocks (one per SM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def grid_blocks(device, ny: int, nx: int) -> int:
    """The blocks ``run_resident`` gives the global-memory form: what the
    card holds at once, at most ``BLOCKS_PER_SM`` per SM, and never more
    than one thread per cell."""
    per_sm = min(max_blocks(device), BLOCKS_PER_SM * sm_count(device))
    return min(per_sm, -(-ny * nx // _THREADS))


def l2_window(state_bytes: int, device) -> bool:
    """Whether the global-memory form sets a persisting-L2 access-policy
    window over a state of ``state_bytes``: from 0.6 to 0.85 of the card's
    L2. On an H100 (50 MiB of L2; chip_smoke phase 32 at 3 blocks per SM,
    in turns, two runs, PERF.md section 6) the window took 3-13% less time
    at 960^2-1088^2 (33.2-42.6 MB, 0.63-0.81 of the L2), 0.2-2.3% more at
    768^2-896^2 (0.40-0.55), 20% more at 1152^2 (0.91) and 1.4-2.9x the
    time above the L2; between those sizes it is unmeasured."""
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    return 3 * l2 <= 5 * state_bytes and 20 * state_bytes <= 17 * l2


def launch(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, chunk, blocks):
    """K4's global-memory form on ``blocks`` blocks: one cooperative launch
    per chunk, all from one C call, on one copy of the state, with a
    persisting-L2 window over it where ``l2_window`` says. A grid larger
    than the card can hold at once raises (the launch is refused); nothing
    shrinks it."""
    lib = _build.library()
    _, ny, nx = cells.shape
    buf = cells.contiguous().clone()
    l2 = l2_window(buf.numel() * buf.element_size(), buf.device)
    nobst = nobst.contiguous()
    nob8 = torch.empty((ny, nx), dtype=torch.uint8, device=buf.device)
    av = torch.empty(n_iters, dtype=torch.float32, device=buf.device)
    partials = torch.empty(min(chunk, n_iters) * blocks, dtype=torch.float32, device=buf.device)
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        rc = lib.lbm_resident_run(
            buf.data_ptr(), nob8.data_ptr(), nobst.data_ptr(),
            av.data_ptr(), partials.data_ptr(), ny, nx, n_iters, chunk, blocks,
            buf.numel() * buf.element_size() if l2 else 0,
            *kernel_scalars(density, accel, omega, inv_tot_cells), stream,
        )
    _build.check(rc, f"resident kernel ({blocks} blocks)")
    _count(ny, nx, n_iters, chunk)
    run_resident.launches += n_iters
    return as_regular(buf, n_iters), av


def launch_smem(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, chunk, config):
    """K4's shared-memory form on ``config = (blocks, rows, depth,
    smem_bytes)`` (``resident_smem_config``): one cooperative launch per
    chunk, all from one C call. The C entry refuses a config that does not
    match the grid and its carve, and the card a grid it cannot hold at
    once: either raises."""
    blocks, rows, depth, smem = config
    lib = _build.library()
    _, ny, nx = cells.shape
    a = cells.contiguous().clone()
    b = torch.empty_like(a)
    exch = torch.empty((2,) + tuple(a.shape), dtype=torch.float32, device=a.device)
    nobst = nobst.contiguous()
    av = torch.empty(n_iters, dtype=torch.float32, device=a.device)
    partials = torch.empty(min(chunk, n_iters) * blocks, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.lbm_resident_smem_run(
            a.data_ptr(), b.data_ptr(), exch.data_ptr(), nobst.data_ptr(), av.data_ptr(),
            partials.data_ptr(), ny, nx, n_iters, chunk, blocks, rows, depth, smem,
            *kernel_scalars(density, accel, omega, inv_tot_cells), stream,
        )
    _build.check(rc, f"resident kernel, shared-memory form ({blocks} blocks of {rows} rows, "
                     f"T {depth}, {smem} B)")
    _count(ny, nx, n_iters, chunk, config)
    run_resident.launches_smem += n_iters
    return (a if -(-n_iters // chunk) % 2 == 0 else b), av


def run_resident(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, *, chunk=CHUNK_STEPS):
    """Run ``n_iters`` steps, ``chunk`` per launch: kernel K4 on CUDA (the
    shared-memory form where ``resident_smem_config`` finds a schedule, the
    global-memory form elsewhere), ``run_resident_plain`` on CPU. ``cells``
    is left unchanged. The kernel implements the fused collision form."""
    if cells.device.type == "cpu":
        return run_resident_plain(cells, nobst, density, accel, omega, n_iters, inv_tot_cells,
                                  chunk=chunk)
    if cells.device.type != "cuda":
        raise ValueError(f"no resident kernel for device {cells.device}")
    _check(cells, nobst, n_iters, chunk)
    ny, nx = cells.shape[1:]
    config = resident_smem_config(ny, nx, sm_count(cells.device))
    if config is not None:
        return launch_smem(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, chunk,
                           config)
    blocks = grid_blocks(cells.device, ny, nx)
    return launch(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, chunk, blocks)


run_resident.launches = 0  # steps K4's global-memory form advanced in this process
run_resident.launches_smem = 0  # steps K4's shared-memory form advanced in this process
