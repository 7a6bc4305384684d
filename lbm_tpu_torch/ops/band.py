"""The value-carrying band route (counterpart of ``lbm_tpu/ops/pallas_band.py``).

``run_band`` advances a ``(9, ny, nx)`` f32 state ``n_iters`` steps on the
band schedule of ``ops/band_common.py``: ``n_iters // T`` passes, each
loading every tile's ``(B+2T) x (P+2T)`` window, taking T steps inside it
and storing the central ``B x P`` cells, then the ``n_iters % T``
remainder on K1. It returns ``(cells, av)`` with ``av[t] = inv_tot_cells *
sum(nobst * |u|)`` of step t.

On a CUDA tensor the passes run kernel K7 (``csrc/band.cu``): each thread
carries its window cells' 9 values in registers across the T steps, the
counterpart of ``_kernel``'s planes carried as loop values, and streams
through one shared-memory exchange window; every pass of a run is issued
by one C call. On a CPU tensor it runs ``run_band_plain``, the same
schedule on all windows at once in plain PyTorch. Any other device raises;
a CUDA tensor never falls back.

The TPU's full-row and panel kernels (``_kernel``, ``_kernel_panel``) are
one function here: ``panel=None`` is the full row (window ``nx + 2T``
wide), ``panel=P`` a tile of P columns with a T-column halo. The kernel
holds at most ``MAX_WINDOW_CELLS`` window cells (its register budget).
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
``run_band_sharded_plain`` is its plain version. At c16 (``dev``) K8
decodes and encodes as K7 does, its halos carry the neighbours' codes,
and the remainder runs on K3 at c16.
"""

from __future__ import annotations

from lbm_tpu_torch.ops import band_common as BC
from lbm_tpu_torch.ops.step import count_launches, forcing_weights

PLANE_COPIES = 1  # one exchange window of the 9 planes per block
MAX_WINDOW_CELLS = 4096  # 512 threads x 8 cells held in registers (csrc/band.cu)


def band_supported(ny: int, nx: int, block: int, depth: int, panel: int | None = None) -> bool:
    """Any tile and depth; ``ny >= 2`` as K1. The TPU kernel's ``nx % 128``,
    ``depth % 8`` and ``ny % block`` are tiling constraints that the window
    gather does not have."""
    del nx
    return ny >= 2 and depth >= 1 and block >= 1 and (panel is None or panel >= 1)


def _check(cells, nobst, n_iters, block, depth, panel, dev=None):
    BC.check_schedule(cells, nobst, n_iters, block, depth, panel, dev)
    _, ny, nx = cells.shape
    if not band_supported(ny, nx, block, depth, panel):
        raise ValueError(f"band schedule unsupported: grid {ny}x{nx}, block {block}, "
                         f"depth {depth}, panel {panel}")


def _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, paired,
                  dev=None):
    w1a, w2a = forcing_weights(density, accel)
    step = BC.r_step_plain(float(omega), w1a, w2a, paired)
    return BC.plain_passes(nobst, inv_tot_cells, block, depth, panel, lambda p, n: step, dev)


def check_window(block, depth, panel, nx):
    """Raise if the kernel's threads cannot hold a window in registers."""
    b, p, t = BC.tile_shape(nx, block, depth, panel)
    if (b + 2 * t) * (p + 2 * t) > MAX_WINDOW_CELLS:
        raise ValueError(f"band kernel: a {b + 2 * t}x{p + 2 * t} window exceeds the "
                         f"{MAX_WINDOW_CELLS} cells its threads hold in registers")


def _passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, paired, device,
            dev=None):
    """``run_passes`` of ``run_creep`` for the device of the state."""
    if device.type == "cpu":
        return _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel,
                             paired, dev)
    if device.type != "cuda":
        raise ValueError(f"no band kernel for device {device}")
    if not (isinstance(paired, str) and paired.startswith("fused")):
        raise ValueError("the CUDA band kernel implements the fused collision form only")

    check_window(block, depth, panel, nobst.shape[1])

    def run_passes(cells, npasses):
        out = BC.launch_passes("lbm_band_run", "band kernel", cells.contiguous().clone(), nobst,
                               density, accel, omega, inv_tot_cells, block, depth, panel,
                               npasses, PLANE_COPIES, dev)
        count_launches(run_band, npasses * depth, dev)
        return out

    return run_passes


def run_band_plain(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
                   inv_tot_cells=1.0, paired="fused", dev=None):
    """The band schedule in plain PyTorch; returns ``(cells, av)``."""
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel,
                           paired, dev)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, paired, dev)


def run_band(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
             inv_tot_cells=1.0, paired="fused", dev=None):
    """Run ``n_iters`` steps, ``depth`` per pass: kernel K7 on CUDA (and K1
    for the remainder), ``run_band_plain`` on CPU. ``cells`` is left
    unchanged. The kernel implements the fused collision form. ``dev``:
    c16 storage (int16 ``cells``)."""
    if cells.device.type == "cpu":
        return run_band_plain(cells, nobst, density, accel, omega, n_iters, block, depth,
                              panel=panel, inv_tot_cells=inv_tot_cells, paired=paired, dev=dev)
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, paired,
                     cells.device, dev)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, paired, dev)


run_band.launches = 0  # steps K7 advanced in this process
run_band.launches_c16 = 0  # steps K7 advanced at c16


_K8 = BC.ShardedKernel("band", "lbm_band_sharded_run", band_supported, PLANE_COPIES,
                       MAX_WINDOW_CELLS)


def step_band_sharded(shards, nob_shards, density, accel, omega, block, depth, ny, *,
                      panel=None, paired="fused", dev=None):
    """One pass of ``depth`` steps over a 1-D mesh of row shards (``shards[i][0]``
    holds global rows ``[i*ry, (i+1)*ry)`` of ``ny``): K8 on CUDA, the plain
    pass on CPU. Returns the shards and their raw sums ``(nshards, depth)``.
    ``dev``: c16 storage (int16 shards)."""
    out = _K8.step(shards, nob_shards, density, accel, omega, block, depth, ny, panel, paired,
                   dev)
    if shards[0][0].device.type == "cuda":
        count_launches(run_band_sharded, depth, dev)
    return out


def run_band_sharded_plain(shards, nob_shards, density, accel, omega, n_iters, block, depth,
                           ny, *, panel=None, paired="fused", dev=None):
    """The sharded band schedule in plain PyTorch, the remainder on the
    plain shard step; returns the shards and their raw sums ``(nshards, n_iters)``."""
    return _K8.run(shards, nob_shards, density, accel, omega, n_iters, block, depth, ny, panel,
                   paired, plain=True, dev=dev)


def run_band_sharded(shards, nob_shards, density, accel, omega, n_iters, block, depth, ny, *,
                     panel=None, paired="fused", dev=None):
    """Run ``n_iters`` steps of a 1-D mesh of row shards, ``depth`` per pass:
    kernel K8 on CUDA (the ``n_iters % depth`` remainder on K3),
    ``run_band_sharded_plain`` on CPU. Returns the shards and their raw sums
    ``(nshards, n_iters)``. ``dev``: c16 storage (int16 shards)."""
    out = _K8.run(shards, nob_shards, density, accel, omega, n_iters, block, depth, ny, panel,
                  paired, dev=dev)
    if shards[0][0].device.type == "cuda":
        count_launches(run_band_sharded, n_iters // depth * depth, dev)
    return out


run_band_sharded.launches = 0  # mesh steps K8 advanced in this process
run_band_sharded.launches_c16 = 0  # mesh steps K8 advanced at c16
