"""The hierarchical slab route (counterpart of ``lbm_tpu/ops/pallas_slab.py``).

One generation is K*T steps (K passes of the band schedule of
``ops/band_common.py``, T steps each). The grid is cut into ``ny // S``
y-slabs of S rows; slab j's buffer holds global rows ``[j*S - KT, j*S + S +
KT)``, ``KT = K*T``, so slab 0's first rows wrap to the grid's last. Each of
the K passes runs over the whole buffer, which wraps within itself, so
garbage creeps T rows per pass from each edge and the central S rows stay
genuine; they become rows ``[j*S, j*S + S)`` of the next state. What the
JAX kernel ``_kernel_slab`` adds to the band pass, and the port keeps:

- the forcing by global row: every window row whose global row is ny-2 is
  forced, the copies of that row in the neighbour slabs' halos included
  (``pallas_slab.py:104-107``);
- the per-step sums by ownership: a slab sums only its S central rows, so
  each (global row, step) pair is counted once (``:99-102``), the slabs in
  slab order;
- every slab of a generation reads the same input state and the slabs
  write disjoint rows (``:295-325``).

The ``n_iters % (K*T)`` remainder runs on ``ops/band.py::run_band`` (K7
passes, then the K1 tail), as ``run_band_slab``'s remainder runs the JAX
``run_band`` (``:332-338``).

On a CUDA tensor the generations run kernel K13 (``csrc/band.cu``, K7's
one-window pass in its slab mode): the slabs one after another, a slab's first
pass reading its rows straight from the state and its last pass storing
its central rows straight into the next state, the passes between them in
two slab buffers, so no copy of the state is made; the bet is that the two
slab buffers stay in the 50 MB L2 across a slab's K passes. On a CPU tensor
``run_band_slab_plain``. Any other device raises.

The route is quarantined as in the JAX package: the driver runs it only with
``LBM_ENABLE_SLAB=1`` (``runtime/driver.py::select_route``).

c16 and bf16 storage (``dev``): every pass rounds the slab buffer it
stores, the inner passes included, as the JAX slab kernel writes each
pass's buffer at the storage dtype (``pallas_slab.py:171, 217``).
"""

from __future__ import annotations

import os

import torch

from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops import band as B
from lbm_tpu_torch.ops import band_common as BC
from lbm_tpu_torch.ops.step import count_launches, forcing_weights, kernel_scalars


def slab_supported(ny: int, nx: int, block: int, depth: int, kpasses: int, sblock: int,
                   panel: int | None = None) -> bool:
    """The conditions of ``pallas_slab.slab_supported`` that carry meaning:
    ``K >= 1``, ``ny % S == 0``, ``ny > S`` (one slab is the plain band
    pass) and ``K*T <= S`` (a slab's halo reaches no further than its
    neighbour), with the band schedule on the slab's rows. The TPU's
    ``S % block == 0`` and ``2*K*T % block == 0`` keep its BlockSpec tiles
    aligned to the slab; the port's tiles are ragged already, and with its
    small-grid band schedule (24, 4, 24) and K = 4, ``2KT = 32`` is no
    multiple of 24, so they would refuse those grids: they are not kept."""
    return (kpasses >= 1 and sblock >= 1 and ny % sblock == 0 and ny > sblock
            and kpasses * depth <= sblock
            and B.band_supported(sblock + 2 * kpasses * depth, nx, block, depth, panel))


# Passes per slab visit (the JAX package's default).
_SLAB_K = 4


def schedule(params, dtype) -> tuple[int, int, int | None, int, int] | None:
    """K13's schedule ``(block, depth, panel, kpasses, sblock)`` on the grid
    of ``params`` (driver.py:501-529 of the JAX package), or None. The pass
    is K7's (``band.schedule``); ``LBM_SLAB_K`` sets the passes per slab
    visit (default 4) and ``LBM_SLAB_S`` the slab rows. The default S is the
    largest divisor of ny below ny: on an H100 the sweep (PERF.md, K13) ran
    fastest at S = ny/2 at 2048^2 and 4096^2 for every K, the larger the
    slab the faster (not the TPU's 4,194,304-cell slab, nor a slab whose
    two buffers fit the 50 MB L2: those ran 1.3-1.5x slower)."""
    cfg = B.schedule(params, dtype)
    if cfg is None:
        return None
    block, depth, panel = cfg
    k = int(os.environ.get("LBM_SLAB_K", str(_SLAB_K)))
    ov_s = os.environ.get("LBM_SLAB_S")
    if ov_s:
        s = int(ov_s)
        ok = slab_supported(params.ny, params.nx, block, depth, k, s, panel)
        return (block, depth, panel, k, s) if ok else None
    best = None
    for s in range(1, params.ny):
        if slab_supported(params.ny, params.nx, block, depth, k, s, panel):
            best = s
    return None if best is None else (block, depth, panel, k, best)


def _check(cells, nobst, n_iters, block, depth, kpasses, sblock, panel, dev):
    BC.check_schedule(cells, nobst, n_iters, block, depth, panel, dev)
    _, ny, nx = cells.shape
    if not slab_supported(ny, nx, block, depth, kpasses, sblock, panel):
        raise ValueError(
            f"slab kernel unsupported: grid {ny}x{nx}, block {block}, depth {depth}, "
            f"kpasses {kpasses}, sblock {sblock}, panel {panel} (needs ny % sblock == 0, "
            "ny > sblock and kpasses * depth <= sblock)")


def step_band_slab(slab, nob_slab, r0, density, accel, omega, block, depth, ny_global, own, *,
                   panel=None, dev=None):
    """The plain version of one K13 pass: advance one slab buffer ``depth``
    steps, its rows at global rows ``r0 + row`` (mod ``ny_global``) for the
    forcing, wrapping within the buffer, and sum only the owned rows
    ``own = (lo, hi)``. ``nob_slab`` is the mask of the buffer's rows.
    Returns ``(slab, (depth,) raw per-step sums)``."""
    w1a, w2a = forcing_weights(density, accel)
    step = BC.r_step_plain(float(omega), w1a, w2a)
    return BC.coded(dev, lambda s: BC.creep_pass_plain(
        s, nob_slab, block, depth, panel, step, r0=r0, ny_global=ny_global, own=own))(slab)


def run_band_slab_plain(cells, nobst, density, accel, omega, n_iters, block, depth, kpasses,
                        sblock, *, panel=None, inv_tot_cells=1.0, dev=None):
    """The slab schedule in plain PyTorch (slab inputs cut with wrapped row
    indices, as ``pallas_slab.slab_input``); returns ``(cells, av)``."""
    _check(cells, nobst, n_iters, block, depth, kpasses, sblock, panel, dev)
    _, ny, _ = cells.shape
    kt = kpasses * depth
    ngens, rem = divmod(n_iters, kt)
    av = torch.empty(n_iters, dtype=torch.float32, device=cells.device)
    inv = torch.tensor(inv_tot_cells, dtype=torch.float32, device=cells.device)
    own = (kt, kt + sblock)
    for g in range(ngens):
        sums = torch.zeros(kt, dtype=torch.float32, device=cells.device)
        centres = []
        for j in range(ny // sblock):
            r0 = j * sblock - kt
            rows = (torch.arange(sblock + 2 * kt, device=cells.device) + r0) % ny
            slab, nob = cells[:, rows], nobst[rows]
            for p in range(kpasses):
                slab, part = step_band_slab(slab, nob, r0, density, accel, omega, block, depth,
                                            ny, own, panel=panel, dev=dev)
                sums[p * depth:(p + 1) * depth] += part
            centres.append(slab[:, kt:kt + sblock])
        cells = torch.cat(centres, dim=1)
        av[g * kt:(g + 1) * kt] = sums * inv
    if rem:
        cells, av[ngens * kt:] = B.run_band_plain(
            cells, nobst, density, accel, omega, rem, block, depth, panel=panel,
            inv_tot_cells=inv_tot_cells, dev=dev)
    return cells, av


def run_band_slab(cells, nobst, density, accel, omega, n_iters, block, depth, kpasses, sblock, *,
                  panel=None, inv_tot_cells=1.0, dev=None):
    """Run ``n_iters`` steps, K*T per generation: kernel K13 on CUDA (the
    remainder on K7 and K1), ``run_band_slab_plain`` on CPU. ``cells`` is
    left unchanged. The kernel implements the fused collision form.
    ``dev``: 16-bit storage (int16 c16 codes or bf16 ``cells``)."""
    if cells.device.type == "cpu":
        return run_band_slab_plain(cells, nobst, density, accel, omega, n_iters, block, depth,
                                   kpasses, sblock, panel=panel, inv_tot_cells=inv_tot_cells,
                                   dev=dev)
    if cells.device.type != "cuda":
        raise ValueError(f"no slab kernel for device {cells.device}")
    _check(cells, nobst, n_iters, block, depth, kpasses, sblock, panel, dev)
    _, ny, nx = cells.shape
    kt = kpasses * depth
    rows = sblock + 2 * kt
    BC.check_smem("slab kernel", B.PLANE_COPIES, nx, block, depth, panel)
    ngens, rem = divmod(n_iters, kt)
    av = torch.empty(n_iters, dtype=torch.float32, device=cells.device)
    if ngens:
        lib = _build.library()
        b, p, t = BC.tile_shape(nx, block, depth, panel)
        state = cells.contiguous().clone()
        other = torch.empty_like(state)
        slab_a = torch.empty((9, rows, nx), dtype=state.dtype, device=state.device)
        slab_b = torch.empty_like(slab_a)
        nob = nobst.contiguous()
        partials = torch.empty(lib.lbm_band_num_tiles(rows, nx, b, p) * t, dtype=torch.float32,
                               device=state.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=state.device)
        with torch.cuda.device(state.device):
            stream = torch.cuda.current_stream(state.device).cuda_stream
            rc = lib.lbm_slab_run(
                state.data_ptr(), other.data_ptr(), slab_a.data_ptr(), slab_b.data_ptr(),
                nob.data_ptr(), av.data_ptr(), partials.data_ptr(), ticket.data_ptr(), ny, nx,
                b, t, p, kpasses, sblock, ngens,
                *kernel_scalars(density, accel, omega, inv_tot_cells), _build.storage(dev), stream,
            )
        _build.check(rc, "slab kernel")
        count_launches(run_band_slab, ngens * kt, dev)
        cells = state if ngens % 2 == 0 else other
    if rem:
        cells, av[ngens * kt:] = B.run_band(cells, nobst, density, accel, omega, rem, block,
                                            depth, panel=panel, inv_tot_cells=inv_tot_cells,
                                            dev=dev)
    return cells, av


run_band_slab.launches = 0  # steps K13 advanced in this process
run_band_slab.launches_c16 = 0  # steps K13 advanced at c16
run_band_slab.launches_bf16 = 0  # steps K13 advanced at bf16
