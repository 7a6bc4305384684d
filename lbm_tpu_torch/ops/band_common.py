"""Shared schedule of the band family (counterpart of ``lbm_tpu/ops/band_common.py``).

The three band routes (``ops/band.py``, ``ops/band2.py``, ``ops/band3.py``)
run the same garbage-creep schedule and differ only in the step body:

- the grid is cut into output tiles of ``block`` rows by ``panel`` columns
  (``panel=None``: the full row, the TPU kernels' full-row variant);
- a pass loads, for every tile, the window of ``(block + 2T) x (panel + 2T)``
  cells around it, with wrapped global row and column indices, so the
  periodic boundary needs no strip copies;
- it advances T steps inside the window. Streaming wraps at the WINDOW's
  edges, so the cells within s of an edge are garbage after s steps, but
  garbage creeps in one cell per step and never reaches the central tile;
- it stores the central ``block x panel`` cells (those inside the grid).

The forcing of row ny-2 is applied at every window row whose global row is
ny-2, at every step, halo rows included: this is the TPU kernels' two gated
static positions (``B+T-2`` of the last block, ``T-2`` of block 0)
generalised to any tile height, and to windows taller than the grid.

``creep_pass_plain`` is one pass in plain PyTorch on all windows at once,
as a batch tensor ``(nwin, 9, B+2T, P+2T)``; ``run_creep`` is the pass loop
with the ``n_iters % T`` remainder on ``ops/step.py::run_step``;
``launch_passes`` issues every pass of a run through one C entry point of
the CUDA kernels K7 (``csrc/band.cu``), K9 (``csrc/band2.cu``) and K11
(``csrc/band3.cu``).

The sharded form (K8, K10; ``parallel/sharded.py``): a 1-D mesh of shards
of ``ry`` rows each, given as a list of ``[cells]`` rows (the mesh's
``shards[i][0]``). A shard's windows take their rows from its own rows
between two halos of T rows, the previous shard's last T rows and the next
shard's first T rows, exchanged once per pass; x wraps within the shard's
full rows. ``creep_pass_plain(..., halo=...)`` is its plain pass,
``run_creep_sharded`` its pass loop with the remainder on the shard step
K3 (``ops/shard_step.py``), ``launch_passes_sharded`` the kernels' passes,
and ``ShardedKernel`` the wrappers that ``ops/band.py`` and
``ops/band2.py`` name. The per-step sums stay raw per shard; the mesh adds
them up.

The slab form (K13, ``ops/slab.py``): ``creep_pass_plain(..., r0=,
ny_global=, own=)`` runs a pass over one y-slab that wraps within itself,
its rows at global rows ``r0 + row`` for the forcing test, and sums only
the owned rows ``own``.

c16 storage (``dev``): the passes decode the state before a pass and
encode its result (``plain_passes``, ``plain_passes_sharded``: one
rounding per pass), and ``launch_passes``/``launch_passes_sharded`` hand
the kernel the codec; the window itself stays f32, as in the TPU kernels.
The sharded halos hold the neighbours' codes, as the JAX package's
ppermutes move them; the not-obstacle halos stay f32.

The TPU's BlockSpec strip views (``fullrow_specs``/``panel_specs``), the
extended mask ``nobst_ext`` and the 128-lane halo H do not carry over: the
window gather replaces them, and every tile's x halo is T columns.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops.collision import bgk_relax, u_mag
from lbm_tpu_torch.ops.shard_step import (address_table, device_runs, enable_peers, issue,
                                          neighbour_runs, run_shard_step, run_shard_step_plain)
from lbm_tpu_torch.ops.step import (_CXS, _CYS, _OPP, check_inputs, forcing_weights,
                                    kernel_scalars, run_step)

CYS, CXS, OPP = _CYS, _CXS, _OPP
# The forcing planes as (plane, sign, weight kind): kind 1 -> w1a, 2 -> w2a
# (kernels.cl:33-41).
FORCE = ((1, 1.0, 1), (3, -1.0, 1), (5, 1.0, 2),
         (6, -1.0, 2), (7, -1.0, 2), (8, 1.0, 2))

# Dynamic shared memory a band kernel's block may use on the H100: the
# 227 KB opt-in, less 1 KB for the kernels' static shared memory.
SMEM_LIMIT = 232448 - 1024
# Warps of a band kernel's 512-thread block: each keeps one partial sum per
# step in shared memory (band_common.cuh::smem_bytes).
_WARPS = 16


def tile_shape(nx: int, block: int, depth: int, panel: int | None):
    """``(B, P, T)`` of a schedule; ``panel=None`` is the full row."""
    return block, (nx if panel is None else panel), depth


def smem_bytes(plane_copies: int, nx: int, block: int, depth: int, panel: int | None) -> int:
    """Dynamic shared memory of one block of a band kernel whose window
    holds ``plane_copies`` sets of the 9 planes."""
    b, p, t = tile_shape(nx, block, depth, panel)
    wh, ww = b + 2 * t, p + 2 * t
    return (9 * plane_copies + 1) * 4 * wh * ww + 4 * (wh + ww) + 4 * _WARPS * t


def check_schedule(cells, nobst, n_iters, block, depth, panel, dev=None):
    check_inputs(cells, nobst, n_iters, 2, dev)
    if block < 1 or depth < 1 or (panel is not None and panel < 1):
        raise ValueError(f"bad band schedule: block {block}, depth {depth}, panel {panel}")


def window_indices(ny: int, nx: int, block: int, depth: int, panel: int | None, device):
    """Global rows ``(nty, B+2T)`` and columns ``(ntx, P+2T)`` of every
    tile's window, wrapped into the grid."""
    b, p, t = tile_shape(nx, block, depth, panel)
    nty, ntx = -(-ny // b), -(-nx // p)
    rows = (torch.arange(nty, device=device)[:, None] * b - t
            + torch.arange(b + 2 * t, device=device)[None, :]) % ny
    cols = (torch.arange(ntx, device=device)[:, None] * p - t
            + torch.arange(p + 2 * t, device=device)[None, :]) % nx
    return rows, cols


def gather_windows(x, rows, cols):
    """``(C, ny, nx)`` -> ``(nty * ntx, C, B+2T, P+2T)``."""
    nty, wh = rows.shape
    ntx, ww = cols.shape
    g = x[:, rows[:, None, :, None], cols[None, :, None, :]]  # (C, nty, ntx, wh, ww)
    return g.permute(1, 2, 0, 3, 4).reshape(nty * ntx, x.shape[0], wh, ww)


def scatter_central(win, ny: int, nx: int, block: int, depth: int, panel: int | None):
    """The central ``B x P`` cells of every window, back on the grid."""
    b, p, t = tile_shape(nx, block, depth, panel)
    nty, ntx = -(-ny // b), -(-nx // p)
    c = win.shape[1]
    mid = win[:, :, t:t + b, t:t + p].reshape(nty, ntx, c, b, p)
    return mid.permute(2, 0, 3, 1, 4).reshape(c, nty * b, ntx * p)[:, :ny, :nx].contiguous()


def creep_pass_plain(state, nobst, block, depth, panel, step, *, halo=None, r0=0,
                     ny_global=None, own=None):
    """One band pass of ``depth`` steps in plain PyTorch on all windows.

    ``step(s, planes, nob, frow)`` advances the 9 window planes (each
    ``(nwin, B+2T, P+2T)``) one step with rolls inside the window and
    returns ``(planes, u_sq)``; ``frow`` is 1.0 on the window rows whose
    global row is ny-2 (``(nwin, B+2T, 1)``). Returns the new state and
    the ``depth`` per-step sums of ``nob * |u|`` over the central cells,
    each reduced from its per-tile partials.

    ``halo=(dn, up, nob_dn, nob_up)``: ``state`` is one shard whose first
    row is global row ``r0`` of ``ny_global``; window rows come from its
    rows between the T rows ``dn`` above and ``up`` below (wrapped within
    those ``ry + 2T`` rows, beyond which only garbage is fed).

    Without ``halo``, ``r0`` and ``ny_global`` (the slab form) place the
    state's rows at global rows ``r0 + row`` of ``ny_global`` for the
    forcing test, the windows still wrapping within the state; ``own=(lo,
    hi)`` sums only the central cells of rows ``[lo, hi)``."""
    _, ny, nx = state.shape
    b, p, t = tile_shape(nx, block, depth, panel)
    rows, cols = window_indices(ny, nx, block, depth, panel, state.device)
    nty, ntx = rows.shape[0], cols.shape[0]
    base = (torch.arange(nty, device=state.device)[:, None] * b
            + torch.arange(b + 2 * t, device=state.device)[None, :])
    if halo is None:
        src, nob_src = state, nobst
    else:
        dn, up, nob_dn, nob_up = halo
        src = torch.cat([dn, state, up], dim=1)
        nob_src = torch.cat([nob_dn, nobst, nob_up], dim=0)
        rows = base % (ny + 2 * t)
    grows = (base + (r0 - t)) % (ny if ny_global is None else ny_global)
    win = gather_windows(src, rows, cols)
    nob = gather_windows(nob_src[None], rows, cols)[:, 0]
    frow_at = (ny if ny_global is None else ny_global) - 2
    frow = (grows == frow_at).to(win.dtype)[:, None, :, None].expand(nty, ntx, b + 2 * t, 1)
    frow = frow.reshape(nty * ntx, b + 2 * t, 1)
    # Central cells inside the grid (the owned rows): the ragged last tiles
    # store and sum only those.
    lo, hi = (0, ny) if own is None else own
    row_of = (torch.arange(nty, device=state.device)[:, None] * b
              + torch.arange(b, device=state.device)[None, :])
    valid_y = (row_of < ny) & (row_of >= lo) & (row_of < hi)
    valid_x = (torch.arange(ntx, device=state.device)[:, None] * p
               + torch.arange(p, device=state.device)[None, :]) < nx
    valid = (valid_y[:, None, :, None] & valid_x[None, :, None, :]).reshape(nty * ntx, b, p)
    nob_mid = nob[:, t:t + b, t:t + p] * valid.to(win.dtype)
    planes = list(win.unbind(1))
    sums = torch.empty(depth, dtype=win.dtype, device=state.device)
    for s in range(depth):
        planes, u_sq = step(s, planes, nob, frow)
        # Central band sliced before any arithmetic: edge garbage never
        # reaches the sums.
        partials = torch.sum(nob_mid * u_mag(u_sq[:, t:t + b, t:t + p]), dim=(1, 2))
        sums[s] = torch.sum(partials)
    return scatter_central(torch.stack(planes, 1), ny, nx, block, depth, panel), sums


def force_windows(planes, nob, frow, w1a, w2a):
    """Add the forcing deltas to the 9 values of speed 0..8 on the window
    rows marked by ``frow``, the joint mask from speeds 3, 6, 7 before any
    change (kernels.cl:29-41)."""
    ok = (planes[3] - w1a > 0.0) & (planes[6] - w2a > 0.0) & (planes[7] - w2a > 0.0)
    am = ok.to(nob.dtype) * nob * frow
    wgt = {1: w1a, 2: w2a}
    out = list(planes)
    for k, sign, kind in FORCE:
        out[k] = planes[k] + (sign * wgt[kind]) * am
    return out


def r_step_plain(omega, w1a, w2a, paired):
    """The regular-arrangement step of K7 and K9 on windows: forcing of the
    ny-2 rows, pull streaming with wrap inside the window, BGK, bounce-back."""

    def step(s, planes, nob, frow):
        planes = force_windows(planes, nob, frow, w1a, w2a)
        t = [torch.roll(planes[k], shifts=(CYS[k], CXS[k]), dims=(1, 2)) for k in range(9)]
        relaxed, u_sq = bgk_relax(t, omega, paired=paired)
        fluid = nob > 0.0
        return [torch.where(fluid, relaxed[k], t[OPP[k]]) for k in range(9)], u_sq

    return step


def run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
              run_passes, paired="fused", dev=None):
    """The family's pass loop: ``run_passes(cells, n_iters // depth)`` returns
    the state and the per-step av of the passes, then the ``n_iters % depth``
    remainder runs on ``ops/step.py::run_step`` (kernel K1 on CUDA)."""
    npasses, rem = divmod(n_iters, depth)
    av = torch.empty(n_iters, dtype=torch.float32, device=cells.device)
    if npasses:
        cells, av[:npasses * depth] = run_passes(cells, npasses)
    if rem:
        cells, av[npasses * depth:] = run_step(cells, nobst, density, accel, omega, rem,
                                               inv_tot_cells, paired, dev)
    return cells, av


def coded(dev, fn):
    """``fn(state) -> (state, ...)`` on f32 values: with ``dev`` (c16) the
    state is decoded before and encoded after (a pass's rounding points)."""
    if dev is None:
        return fn
    from lbm_tpu_torch.ops.devspace import decode_state, encode_state

    def run(state):
        out, *rest = fn(decode_state(state, dev))
        return (encode_state(out, dev), *rest)

    return run


def plain_passes(nobst, inv_tot_cells, block, depth, panel, step_for, dev=None):
    """``run_passes`` for the plain versions: ``step_for(p, npasses)`` gives
    pass p's step function."""

    def run_passes(state, npasses):
        inv = torch.tensor(inv_tot_cells, dtype=torch.float32, device=state.device)
        av = []
        for p in range(npasses):
            state, sums = coded(dev, lambda s: creep_pass_plain(
                s, nobst, block, depth, panel, step_for(p, npasses)))(state)
            av.append(sums * inv)
        return state, torch.cat(av)

    return run_passes


def check_smem(what: str, plane_copies: int, nx: int, block: int, depth: int,
               panel: int | None) -> None:
    """Raise if a tile's window does not fit the shared memory of a block."""
    b, p, t = tile_shape(nx, block, depth, panel)
    need = smem_bytes(plane_copies, nx, block, depth, panel)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{what}: a {b + 2 * t}x{p + 2 * t} window needs {need} B of shared memory, "
            f"more than the {SMEM_LIMIT} B a block can use; choose a smaller block or panel")


def launch_passes(entry: str, what: str, state, nobst, density, accel, omega, inv_tot_cells,
                  block, depth, panel, npasses, plane_copies, dev=None):
    """Issue ``npasses`` passes of a band kernel (K7, K9, K11) or of the deep
    kernel K6 through one C call on the current stream. ``state`` is
    consumed (the kernel ping-pongs between it and a second copy); returns
    ``(state, av)``. ``dev``: c16 storage (int16 ``state``)."""
    _, ny, nx = state.shape
    b, p, t = tile_shape(nx, block, depth, panel)
    check_smem(what, plane_copies, nx, block, depth, panel)
    lib = _build.library()
    a = state.contiguous()
    other = torch.empty_like(a)
    nobst = nobst.contiguous()
    av = torch.empty(npasses * t, dtype=torch.float32, device=a.device)
    ntiles = lib.lbm_band_num_tiles(ny, nx, b, p)
    partials = torch.empty(ntiles * t, dtype=torch.float32, device=a.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = getattr(lib, entry)(
            a.data_ptr(), other.data_ptr(), nobst.data_ptr(), av.data_ptr(),
            partials.data_ptr(), ticket.data_ptr(), ny, nx, b, t, p, npasses,
            *kernel_scalars(density, accel, omega, inv_tot_cells), _build.codec(dev), stream,
        )
    _build.check(rc, what)
    return (a if npasses % 2 == 0 else other), av


def neighbour_rows(flat, depth):
    """``(dn, up)``: per shard, the previous shard's last ``depth`` rows and
    the next shard's first ``depth`` rows, on the shard's device."""
    n = len(flat)
    dn = [flat[(z - 1) % n][..., -depth:, :].to(flat[z].device) for z in range(n)]
    up = [flat[(z + 1) % n][..., :depth, :].to(flat[z].device) for z in range(n)]
    return dn, up


def plain_passes_sharded(nob_shards, ny_global, block, depth, panel, step, dev=None):
    """``run_passes`` of ``run_creep_sharded`` in plain PyTorch: each pass
    takes the halos from the neighbour shards, then runs
    ``creep_pass_plain`` on every shard. Sums raw, ``(nshards, T)`` per pass.
    ``dev`` (c16): the shards, halo codes included, decoded before the
    pass and its results encoded after."""
    from lbm_tpu_torch.ops.devspace import decode_state, encode_state

    nobs = [row[0] for row in nob_shards]
    nob_dn, nob_up = neighbour_rows(nobs, depth)

    def run_passes(shards, npasses):
        flat = [row[0] for row in shards]
        ry = flat[0].shape[1]
        sums = []
        for _ in range(npasses):
            if dev is not None:
                flat = [decode_state(f, dev) for f in flat]
            dn, up = neighbour_rows(flat, depth)
            out = [creep_pass_plain(flat[z], nobs[z], block, depth, panel, step,
                                    halo=(dn[z], up[z], nob_dn[z], nob_up[z]), r0=z * ry,
                                    ny_global=ny_global) for z in range(len(flat))]
            flat = [o[0] if dev is None else encode_state(o[0], dev) for o in out]
            sums.append(torch.stack([o[1].to(flat[0].device) for o in out]))
        return [[f] for f in flat], torch.cat(sums, dim=1)

    return run_passes


def run_creep_sharded(shards, nob_shards, density, accel, omega, n_iters, ny_global, depth,
                      run_passes, paired="fused", plain=False, dev=None):
    """The sharded pass loop: ``run_passes(shards, n_iters // depth)``, then
    the ``n_iters % depth`` remainder on the shard step
    (``ops/shard_step.py::run_shard_step``, kernel K3 on CUDA; with
    ``plain``, its plain version on any device), at c16 with ``dev``.
    Returns the shards and the raw per-shard sums ``(nshards, n_iters)``."""
    npasses, rem = divmod(n_iters, depth)
    parts = []
    if npasses:
        shards, sums = run_passes(shards, npasses)
        parts.append(sums)
    if rem:
        if plain:
            shards, sums = run_shard_step_plain(shards, nob_shards, density, accel, omega, rem,
                                                ny_global, paired, dev)
        else:
            shards, sums = run_shard_step(shards, nob_shards, density, accel, omega, rem,
                                          ny_global, paired=paired, dev=dev)
        parts.append(sums)
    return shards, torch.cat(parts, dim=1)


def launch_passes_sharded(entry: str, what: str, shards, nob_shards, density, accel, omega,
                          block, depth, panel, npasses, plane_copies, dev=None):
    """Issue ``npasses`` passes of a sharded band kernel (K8, K10) over a
    1-D mesh. Each run of consecutive shards on one device
    (``shard_step.device_runs``) is stacked and launched together; each pass
    first copies its halos from the neighbour shards' edge rows, on the
    card or through peer addresses. With one device one C call issues every
    pass; across devices one call per run per pass, ordered by
    ``shard_step.issue``. ``dev``: c16 storage (int16 shards and halos).
    Returns the shards and their raw sums ``(nshards, npasses * depth)``
    on the first shard's device."""
    flat = [row[0] for row in shards]
    nobs = [row[0] for row in nob_shards]
    n = len(flat)
    _, ry, nx = flat[0].shape
    b, p, t = tile_shape(nx, block, depth, panel)
    check_smem(what, plane_copies, nx, block, depth, panel)
    lib = _build.library()
    ntiles = lib.lbm_band_num_tiles(ry, nx, b, p)
    scalars = kernel_scalars(density, accel, omega, 1.0)
    codec = _build.codec(dev)
    nob_dn, nob_up = neighbour_rows(nobs, t)  # the mask's halos, once per call
    runs = device_runs([f.device for f in flat])
    near = neighbour_runs(runs, n, 1)
    state = []  # per run: a, other, halo_dn, halo_up, nob, nob_dn, nob_up, av, partials, ticket
    for s0, count, dev in runs:
        part = slice(s0, s0 + count)
        a = torch.stack(flat[part])  # a copy: the input shards stay unchanged
        state.append((a, torch.empty_like(a),
                      torch.empty((count, 9, t, nx), dtype=a.dtype, device=dev),
                      torch.empty((count, 9, t, nx), dtype=a.dtype, device=dev),
                      torch.stack(nobs[part]), torch.stack(nob_dn[part]),
                      torch.stack(nob_up[part]),
                      torch.empty((count, npasses * t), dtype=torch.float32, device=dev),
                      torch.empty(count * t * ntiles, dtype=torch.float32, device=dev),
                      torch.zeros(count, dtype=torch.int32, device=dev)))
    entries = [(st[0][z], st[1][z]) for st, (_, count, _) in zip(state, runs) for z in range(count)]
    tables = {d: address_table(entries, d) for _, _, d in runs}
    if len(runs) > 1:
        enable_peers(lib, runs, near)

    def call(r, q, k):
        s0, count, dev = runs[r]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            a, other, hdn, hup, nob, ndn, nup, av, partials, ticket = state[r]
            rc = getattr(lib, entry)(
                tables[dev].data_ptr(), s0, count, n, a.data_ptr(), other.data_ptr(),
                hdn.data_ptr(), hup.data_ptr(), nob.data_ptr(), ndn.data_ptr(), nup.data_ptr(),
                av.data_ptr() + 4 * q * t, npasses * t, partials.data_ptr(), ticket.data_ptr(),
                ry, nx, b, t, p, q % 2, k, *scalars, codec, stream,
            )
        _build.check(rc, what)

    issue(runs, near, npasses, call)
    out = [st[npasses % 2][z] for st, (_, count, _) in zip(state, runs) for z in range(count)]
    return [[o] for o in out], torch.cat([st[7].to(flat[0].device) for st in state])


@dataclasses.dataclass(frozen=True)
class ShardedKernel:
    """The wrappers of a sharded band kernel (K8, K10): its name, its C
    entry, its schedule check ``supported(ny, nx, block, depth, panel)``,
    the copies of the window's 9 planes in shared memory, and a cap on the
    window's cells (None: shared memory only)."""

    name: str
    entry: str
    supported: Callable[..., bool]
    plane_copies: int
    max_window: int | None = None

    def check(self, shards, nob_shards, n_iters, block, depth, panel, dev=None) -> None:
        """A 1-D mesh of f32 (with ``dev``: int16) shards of at least
        ``depth`` rows, one device type, and a schedule the kernel takes on
        one shard."""
        if any(len(row) != 1 for row in shards) or len(nob_shards) != len(shards):
            raise ValueError("the sharded band routes take a 1-D mesh of row shards")
        for row, nob_row in zip(shards, nob_shards):
            check_inputs(row[0], nob_row[0], max(n_iters, 1), 1, dev)
        if len({tuple(row[0].shape) for row in shards}) != 1:
            raise ValueError("shards differ in shape")
        if len({row[0].device.type for row in shards}) != 1:
            raise ValueError("shards on more than one kind of device")
        if block < 1 or depth < 1 or (panel is not None and panel < 1):
            raise ValueError(f"bad band schedule: block {block}, depth {depth}, panel {panel}")
        ry, nx = shards[0][0].shape[1:]
        if depth > ry:
            raise ValueError(f"local grid {ry}x{nx} is shallower than the band depth {depth}: "
                             "the halo of a pass must come from the neighbour shards")
        if not self.supported(ry, nx, block, depth, panel):
            raise ValueError(f"{self.name} schedule unsupported on a {ry}x{nx} shard: block "
                             f"{block}, depth {depth}, panel {panel}")

    def passes(self, nob_shards, ny, density, accel, omega, block, depth, panel, paired,
               device, dev=None):
        """``run_passes`` of ``run_creep_sharded`` for ``device``: the plain
        passes on the CPU, the kernel's on CUDA."""
        if device.type == "cpu":
            w1a, w2a = forcing_weights(density, accel)
            return plain_passes_sharded(nob_shards, ny, block, depth, panel,
                                        r_step_plain(float(omega), w1a, w2a, paired), dev)
        if device.type != "cuda":
            raise ValueError(f"no {self.name} kernel for device {device}")
        if not (isinstance(paired, str) and paired.startswith("fused")):
            raise ValueError(f"the CUDA {self.name} kernel implements the fused collision form "
                             "only")
        b, p, t = tile_shape(nob_shards[0][0].shape[1], block, depth, panel)
        if self.max_window is not None and (b + 2 * t) * (p + 2 * t) > self.max_window:
            raise ValueError(f"{self.name} kernel: a {b + 2 * t}x{p + 2 * t} window exceeds the "
                             f"{self.max_window} cells its threads hold in registers")

        def run_passes(shards, npasses):
            return launch_passes_sharded(self.entry, f"{self.name} sharded kernel", shards,
                                         nob_shards, density, accel, omega, block, depth, panel,
                                         npasses, self.plane_copies, dev)

        return run_passes

    def step(self, shards, nob_shards, density, accel, omega, block, depth, ny, panel, paired,
             dev=None):
        """One pass of ``depth`` steps; the shards and their raw sums
        ``(nshards, depth)``."""
        self.check(shards, nob_shards, depth, block, depth, panel, dev)
        return self.passes(nob_shards, ny, density, accel, omega, block, depth, panel, paired,
                           shards[0][0].device, dev)(shards, 1)

    def run(self, shards, nob_shards, density, accel, omega, n_iters, block, depth, ny, panel,
            paired, plain=False, dev=None):
        """``n_iters`` steps, ``depth`` per pass, the remainder on the shard
        step: the kernel's passes on CUDA, the plain ones on the CPU or
        with ``plain``; ``dev``: c16 storage. The shards and their raw sums
        ``(nshards, n_iters)``."""
        self.check(shards, nob_shards, n_iters, block, depth, panel, dev)
        device = torch.device("cpu") if plain else shards[0][0].device
        passes = self.passes(nob_shards, ny, density, accel, omega, block, depth, panel, paired,
                             device, dev)
        return run_creep_sharded(shards, nob_shards, density, accel, omega, n_iters, ny, depth,
                                 passes, paired, plain=plain or device.type == "cpu", dev=dev)
