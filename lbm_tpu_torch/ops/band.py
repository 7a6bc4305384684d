"""The band route (counterpart of ``lbm_tpu/ops/pallas_band.py``).

``run_band`` advances a ``(9, ny, nx)`` f32 state ``n_iters`` steps on the
band schedule of ``ops/band_common.py``: ``n_iters // T`` passes, each
loading every tile's ``(B+2T) x (P+2T)`` window, taking T steps inside it
and storing the central ``B x P`` cells, then the ``n_iters % T``
remainder on K1. It returns ``(cells, av)`` with ``av[t] = inv_tot_cells *
sum(nobst * |u|)`` of step t.

On a CUDA tensor the passes run kernel K7 (``csrc/band.cu``): the window
in ONE shared-memory copy, stepped in place in the AA arrangement at any
T (``band_common.cuh``'s one-window pass, K9's body taken to any T and
any tile; an odd T ends on a scatter step and the store reads each value
where that step left it); every pass of a run is issued by one C call. On
a CPU tensor it runs ``run_band_plain``, the same schedule on all windows
at once in plain PyTorch (the pull); ``run_band_aa_plain`` takes the
kernel's AA steps instead, for the tests. Any other device raises; a CUDA
tensor never falls back.

The TPU's full-row and panel kernels (``_kernel``, ``_kernel_panel``) are
one function here: ``panel=None`` is the full row (window ``nx + 2T``
wide), ``panel=P`` a tile of P columns with a T-column halo. The window
must fit the shared memory of a block (``band_common.check_smem``).
``LBM_BAND_ROWFORCE`` and ``LBM_BAND_UNROLL`` are TPU A/B plumbing and are
not ported.

c16 storage (``dev``): K7 decodes its window and encodes its tile (one
rounding point per pass, ``pallas_band.py``'s ``dev=``), the plain passes
decode and encode around each pass, and the remainder runs on K1 at c16.
The slab route K13 (``ops/slab.py``) runs its remainder here.

``run_band_sharded`` runs the same passes over a 1-D mesh of row shards
(``parallel/sharded.py``, ``--mesh N --backend band``): kernel K8, the
counterpart of ``pallas_band.py::_kernel_sharded`` and ``_kernel_sharded_panel``, takes each
shard's window rows between its neighbours' T edge rows, copied once per
pass, and the ``n_iters % T`` remainder runs on the shard step K3;
``run_band_sharded_plain`` is its plain version, ``run_band_sharded_aa_plain``
the kernel's AA steps. At c16 (``dev``) K8 decodes and encodes as K7 does,
its halos carry the neighbours' codes, and the remainder runs on K3 at c16.

bf16 storage (``dev=devspace.BF16``): K7 and K8 widen their windows and
round their tiles, once per pass, K8's halos carry bfloat16.
"""

from __future__ import annotations

from lbm_tpu_torch.ops import band_common as BC
from lbm_tpu_torch.ops.step import count_launches, forcing_weights

PLANE_COPIES = 1  # one window of the 9 planes per block, stepped in place


def band_supported(ny: int, nx: int, block: int, depth: int, panel: int | None = None) -> bool:
    """Any tile and depth; ``ny >= 2`` as K1. The TPU kernel's ``nx % 128``,
    ``depth % 8`` and ``ny % block`` are tiling constraints that the window
    gather does not have."""
    del nx
    return ny >= 2 and depth >= 1 and block >= 1 and (panel is None or panel >= 1)


def schedule(params, dtype) -> tuple[int, int, int] | None:
    """K7's schedule ``(block, depth, panel)`` on the grid of ``params``
    (driver.py:468-498 of the JAX package), from ``band_common.BAND_TIERS``;
    None for a dtype it does not store (``band_common.tiered``)."""
    return BC.tiered(params, dtype, BC.BAND_TIERS, band_supported)


def _check(cells, nobst, n_iters, block, depth, panel, dev=None):
    BC.check_schedule(cells, nobst, n_iters, block, depth, panel, dev)
    _, ny, nx = cells.shape
    if not band_supported(ny, nx, block, depth, panel):
        raise ValueError(f"band schedule unsupported: grid {ny}x{nx}, block {block}, "
                         f"depth {depth}, panel {panel}")


def _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel,
                  dev=None, aa=False):
    w1a, w2a = forcing_weights(density, accel)
    step = (BC.aa_step_plain(float(omega), w1a, w2a, depth) if aa
            else BC.r_step_plain(float(omega), w1a, w2a))
    return BC.plain_passes(nobst, inv_tot_cells, block, depth, panel, lambda p, n: step, dev)


def _passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, device, dev=None):
    """``run_passes`` of ``run_creep`` for the device of the state."""
    if device.type == "cpu":
        return _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, dev)
    if device.type != "cuda":
        raise ValueError(f"no band kernel for device {device}")

    def run_passes(cells, npasses):
        out = BC.launch_passes("lbm_band_run", "band kernel", cells.contiguous().clone(), nobst,
                               density, accel, omega, inv_tot_cells, block, depth, panel,
                               npasses, PLANE_COPIES, dev)
        count_launches(run_band, npasses * depth, dev)
        return out

    return run_passes


def run_band_plain(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
                   inv_tot_cells=1.0, dev=None):
    """The band schedule in plain PyTorch; returns ``(cells, av)``."""
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, dev)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, dev)


def run_band_aa_plain(cells, nobst, density, accel, omega, n_iters, block, depth, *,
                      panel=None, inv_tot_cells=1.0, dev=None):
    """``run_band_plain``'s function with K7's steps in the AA arrangement
    (``band_common.aa_step_plain``), the kernel's schedule in plain PyTorch;
    returns ``(cells, av)``."""
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, dev,
                           aa=True)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, dev)


def run_band(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
             inv_tot_cells=1.0, dev=None):
    """Run ``n_iters`` steps, ``depth`` per pass: kernel K7 on CUDA (and K1
    for the remainder), ``run_band_plain`` on CPU. ``cells`` is left
    unchanged. The kernel implements the fused collision form. ``dev``:
    16-bit storage (int16 c16 codes or bf16 ``cells``)."""
    if cells.device.type == "cpu":
        return run_band_plain(cells, nobst, density, accel, omega, n_iters, block, depth,
                              panel=panel, inv_tot_cells=inv_tot_cells, dev=dev)
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel,
                     cells.device, dev)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, dev)


run_band.launches = 0  # steps K7 advanced in this process
run_band.launches_c16 = 0  # steps K7 advanced at c16
run_band.launches_bf16 = 0  # steps K7 advanced at bf16


_K8 = BC.ShardedKernel("band", "lbm_band_sharded_run", band_supported, PLANE_COPIES)


def step_band_sharded(shards, nob_shards, density, accel, omega, block, depth, ny, *,
                      panel=None, dev=None):
    """One pass of ``depth`` steps over a 1-D mesh of row shards (``shards[i][0]``
    holds global rows ``[i*ry, (i+1)*ry)`` of ``ny``): K8 on CUDA, the plain
    pass on CPU. Returns the shards and their raw sums ``(nshards, depth)``.
    ``dev``: 16-bit storage (int16 c16 codes or bf16 shards)."""
    out = _K8.step(shards, nob_shards, density, accel, omega, block, depth, ny, panel, dev)
    if shards[0][0].device.type == "cuda":
        count_launches(run_band_sharded, depth, dev)
    return out


def run_band_sharded_plain(shards, nob_shards, density, accel, omega, n_iters, block, depth,
                           ny, *, panel=None, dev=None):
    """The sharded band schedule in plain PyTorch, the remainder on the
    plain shard step; returns the shards and their raw sums ``(nshards, n_iters)``."""
    return _K8.run(shards, nob_shards, density, accel, omega, n_iters, block, depth, ny, panel,
                   plain=True, dev=dev)


def run_band_sharded_aa_plain(shards, nob_shards, density, accel, omega, n_iters, block,
                              depth, ny, *, panel=None, dev=None):
    """``run_band_sharded_plain``'s function with K8's steps in the AA
    arrangement (``band_common.aa_step_plain``); returns the shards and
    their raw sums ``(nshards, n_iters)``."""
    _K8.check(shards, nob_shards, n_iters, block, depth, panel, dev)
    w1a, w2a = forcing_weights(density, accel)
    passes = BC.plain_passes_sharded(nob_shards, ny, block, depth, panel,
                                     BC.aa_step_plain(float(omega), w1a, w2a, depth), dev)
    return BC.run_creep_sharded(shards, nob_shards, density, accel, omega, n_iters, ny, depth,
                                passes, plain=True, dev=dev)


def run_band_sharded(shards, nob_shards, density, accel, omega, n_iters, block, depth, ny, *,
                     panel=None, dev=None):
    """Run ``n_iters`` steps of a 1-D mesh of row shards, ``depth`` per pass:
    kernel K8 on CUDA (the ``n_iters % depth`` remainder on K3),
    ``run_band_sharded_plain`` on CPU. Returns the shards and their raw sums
    ``(nshards, n_iters)``. ``dev``: 16-bit storage (int16 c16 codes or bf16 shards)."""
    out = _K8.run(shards, nob_shards, density, accel, omega, n_iters, block, depth, ny, panel,
                  dev=dev)
    if shards[0][0].device.type == "cuda":
        count_launches(run_band_sharded, n_iters // depth * depth, dev)
    return out


run_band_sharded.launches = 0  # mesh steps K8 advanced in this process
run_band_sharded.launches_c16 = 0  # mesh steps K8 advanced at c16
run_band_sharded.launches_bf16 = 0  # mesh steps K8 advanced at bf16


def row_shard(cells, nobst, nob_dn, nob_up, rank, world, ny, density, accel, omega, block, depth,
              panel, n_passes, *, dev=None):
    """``n_passes`` passes of ``depth`` steps on shard ``rank`` of a 1-D row
    mesh of ``world`` shards, one per process, its halos received from the
    neighbour processes (``band_common.BandRowShard``): K8 on CUDA, its
    steps counted in ``run_band_sharded``'s launches; the plain pass on CPU."""
    return BC.BandRowShard(_K8, run_band_sharded, cells, nobst, nob_dn, nob_up, rank, world, ny, density,
                           accel, omega, block, depth, panel, n_passes, dev=dev)
