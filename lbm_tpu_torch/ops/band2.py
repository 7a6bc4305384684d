"""The ping-pong band route (counterpart of ``lbm_tpu/ops/pallas_band2.py``).

``run_band2`` advances a ``(9, ny, nx)`` f32 state ``n_iters`` steps on the
band schedule of ``ops/band_common.py``: ``n_iters // T`` passes, each
loading every tile's ``(B+2T) x (P+2T)`` window, taking T steps inside it
and storing the central ``B x P`` cells, then the ``n_iters % T``
remainder on K1. It returns ``(cells, av)`` with ``av[t] = inv_tot_cells *
sum(nobst * |u|)`` of step t.

On a CUDA tensor the passes run kernel K9 (``csrc/band2.cu``): the window
lives in two shared-memory buffers, and each step pulls from one and writes
the other, as ``_kernel2`` does between its two VMEM scratch refs; every
pass of a run is issued by one C call. On a CPU tensor it runs
``run_band2_plain``, the same schedule on all windows at once in plain
PyTorch. Any other device raises; a CUDA tensor never falls back.

The TPU's full-row and panel kernels (``_kernel2``, ``_kernel2_panel``) are
one function here: ``panel=None`` is the full row (window ``nx + 2T``
wide), ``panel=P`` a tile of P columns with a T-column halo. The probe
variants, the clean-tile map and ``LBM_BAND2_TILEW`` are TPU A/B plumbing
and are not ported.

``run_band2_sharded`` runs the same passes over a 1-D mesh of row shards
(``parallel/sharded.py``, ``--mesh N --backend band2``): kernel K10, the
counterpart of ``pallas_band2.py::_kernel2_sharded`` and ``_kernel2_sharded_panel``, takes each
shard's window rows between its neighbours' T edge rows, copied once per
pass, and the ``n_iters % T`` remainder runs on the shard step K3;
``run_band2_sharded_plain`` is its plain version.

c16 storage (``dev``, ``pallas_band2.py``'s ``dev=``): K9 and K10 decode
their window as they load it and encode their tile as they store it, one
rounding per pass of T steps; the plain passes decode and encode around
each pass; K10's halos carry the neighbours' codes; the remainders run on
K1 and K3 at c16.
"""

from __future__ import annotations

from lbm_tpu_torch.ops import band_common as BC
from lbm_tpu_torch.ops.step import count_launches, forcing_weights

PLANE_COPIES = 2  # two windows of the 9 planes per block


def band2_supported(ny: int, nx: int, block: int, depth: int, panel: int | None = None) -> bool:
    """Even depth, so a pass ends in the buffer it started from, and
    ``block >= 2 * depth`` (pallas_band2.py:49-58); ``ny >= 2`` as K1."""
    del nx
    return (ny >= 2 and depth >= 2 and depth % 2 == 0 and block >= 2 * depth
            and (panel is None or panel >= 1))


def _check(cells, nobst, n_iters, block, depth, panel, dev=None):
    BC.check_schedule(cells, nobst, n_iters, block, depth, panel, dev)
    _, ny, nx = cells.shape
    if not band2_supported(ny, nx, block, depth, panel):
        raise ValueError(f"band2 schedule unsupported: grid {ny}x{nx}, block {block}, "
                         f"depth {depth}, panel {panel} (needs even depth and block >= 2*depth)")


def _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, paired,
                  dev=None):
    w1a, w2a = forcing_weights(density, accel)
    step = BC.r_step_plain(float(omega), w1a, w2a, paired)
    return BC.plain_passes(nobst, inv_tot_cells, block, depth, panel, lambda p, n: step, dev)


def _passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, paired, device,
            dev=None):
    """``run_passes`` of ``run_creep`` for the device of the state."""
    if device.type == "cpu":
        return _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel,
                             paired, dev)
    if device.type != "cuda":
        raise ValueError(f"no band2 kernel for device {device}")
    if not (isinstance(paired, str) and paired.startswith("fused")):
        raise ValueError("the CUDA band2 kernel implements the fused collision form only")

    def run_passes(cells, npasses):
        out = BC.launch_passes("lbm_band2_run", "band2 kernel", cells.contiguous().clone(), nobst,
                               density, accel, omega, inv_tot_cells, block, depth, panel,
                               npasses, PLANE_COPIES, dev)
        count_launches(run_band2, npasses * depth, dev)
        return out

    return run_passes


def step_band2(cells, nobst, density, accel, omega, block, depth, *, panel=None,
               inv_tot_cells=1.0, paired="fused", dev=None):
    """One pass of ``depth`` steps; returns ``(cells, av)`` of ``depth`` values."""
    _check(cells, nobst, depth, block, depth, panel, dev)
    return _passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, paired,
                   cells.device, dev)(cells, 1)


def run_band2_plain(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
                    inv_tot_cells=1.0, paired="fused", dev=None):
    """The band2 schedule in plain PyTorch; returns ``(cells, av)``."""
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _plain_passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel,
                           paired, dev)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, paired, dev)


def run_band2(cells, nobst, density, accel, omega, n_iters, block, depth, *, panel=None,
              inv_tot_cells=1.0, paired="fused", dev=None):
    """Run ``n_iters`` steps, ``depth`` per pass: kernel K9 on CUDA (and K1
    for the remainder), ``run_band2_plain`` on CPU. ``cells`` is left
    unchanged. The kernel implements the fused collision form. ``dev``:
    c16 storage (int16 ``cells``)."""
    if cells.device.type == "cpu":
        return run_band2_plain(cells, nobst, density, accel, omega, n_iters, block, depth,
                               panel=panel, inv_tot_cells=inv_tot_cells, paired=paired, dev=dev)
    _check(cells, nobst, n_iters, block, depth, panel, dev)
    passes = _passes(nobst, density, accel, omega, inv_tot_cells, block, depth, panel, paired,
                     cells.device, dev)
    return BC.run_creep(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, depth,
                        passes, paired, dev)


run_band2.launches = 0  # steps K9 advanced in this process
run_band2.launches_c16 = 0  # steps K9 advanced at c16


_K10 = BC.ShardedKernel("band2", "lbm_band2_sharded_run", band2_supported, PLANE_COPIES)


def step_band2_sharded(shards, nob_shards, density, accel, omega, block, depth, ny, *,
                       panel=None, paired="fused", dev=None):
    """One pass of ``depth`` steps over a 1-D mesh of row shards (``shards[i][0]``
    holds global rows ``[i*ry, (i+1)*ry)`` of ``ny``): K10 on CUDA, the plain
    pass on CPU. Returns the shards and their raw sums ``(nshards, depth)``.
    ``dev``: c16 storage (int16 shards)."""
    out = _K10.step(shards, nob_shards, density, accel, omega, block, depth, ny, panel,
                    paired, dev)
    if shards[0][0].device.type == "cuda":
        count_launches(run_band2_sharded, depth, dev)
    return out


def run_band2_sharded_plain(shards, nob_shards, density, accel, omega, n_iters, block, depth,
                            ny, *, panel=None, paired="fused", dev=None):
    """The sharded band2 schedule in plain PyTorch, the remainder on the
    plain shard step; returns the shards and their raw sums ``(nshards, n_iters)``."""
    return _K10.run(shards, nob_shards, density, accel, omega, n_iters, block, depth, ny,
                    panel, paired, plain=True, dev=dev)


def run_band2_sharded(shards, nob_shards, density, accel, omega, n_iters, block, depth, ny, *,
                      panel=None, paired="fused", dev=None):
    """Run ``n_iters`` steps of a 1-D mesh of row shards, ``depth`` per pass:
    kernel K10 on CUDA (the ``n_iters % depth`` remainder on K3),
    ``run_band2_sharded_plain`` on CPU. Returns the shards and their raw sums
    ``(nshards, n_iters)``. ``dev``: c16 storage (int16 shards)."""
    out = _K10.run(shards, nob_shards, density, accel, omega, n_iters, block, depth, ny,
                   panel, paired, dev=dev)
    if shards[0][0].device.type == "cuda":
        count_launches(run_band2_sharded, n_iters // depth * depth, dev)
    return out


run_band2_sharded.launches = 0  # mesh steps K10 advanced in this process
run_band2_sharded.launches_c16 = 0  # mesh steps K10 advanced at c16
