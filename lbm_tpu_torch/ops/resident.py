"""The resident route (counterpart of ``lbm_tpu/ops/pallas_resident.py``).

``run_resident`` advances a ``(9, ny, nx)`` f32 state ``n_iters`` whole-grid
steps, ``chunk`` steps per kernel launch, and returns ``(cells, av)`` with
``av[t] = inv_tot_cells * sum(nobst * |u|)`` of step t.

On a CUDA tensor it runs kernel K4 (``csrc/resident.cu``): one persistent
cooperative launch per chunk, each block holding a fixed slab of cells for
the whole chunk, the two state buffers ping-ponged with a grid-wide barrier
between steps, and every chunk of a run issued by one C call. The final
state is whichever buffer the last step wrote (the TPU kernel ends an
even-length chunk with a whole-state copy into its output window; the card
has no output window to fill). On a CPU tensor it runs
``run_resident_plain``, the same steps in plain PyTorch. Any other device
raises; a CUDA tensor never falls back.

The TPU kernel's gates (``nx % 128``, ``ny % 8``, the 40 MB VMEM budget,
``_pick_tile`` and the value-carried path for states up to 4 MB) exist for
VMEM and Mosaic and are not ported: K4 takes any grid with ``ny >= 2``.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops.step import check_inputs, forcing_weights, kernel_scalars, step_plain

CHUNK_STEPS = 255  # steps per launch, as pallas_resident._CHUNK_STEPS
_THREADS = 256  # csrc/resident.cu::kThreads


def resident_supported(ny: int, nx: int) -> bool:
    """Every grid K1 takes: ``ny >= 2`` (the forcing row ny-2 exists)."""
    del nx
    return ny >= 2


def _check(cells, nobst, n_iters, chunk):
    check_inputs(cells, nobst, n_iters, 2)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def run_resident_plain(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, *,
                       chunk=CHUNK_STEPS, paired="fused"):
    """``n_iters`` steps in chunks of ``chunk``, in plain PyTorch; returns
    ``(cells, av)``."""
    _check(cells, nobst, n_iters, chunk)
    w1a, w2a = forcing_weights(density, accel)
    inv = torch.tensor(inv_tot_cells, dtype=torch.float32, device=cells.device)
    av = torch.empty(n_iters, dtype=torch.float32, device=cells.device)
    for start in range(0, n_iters, chunk):
        for t in range(start, min(start + chunk, n_iters)):
            cells, tot = step_plain(cells, nobst, w1a, w2a, float(omega), paired)
            av[t] = tot * inv
    return cells, av


def max_blocks(device) -> int:
    """The most blocks of K4 the card holds at once (occupancy x SMs)."""
    lib = _build.library()
    with torch.cuda.device(device):
        n = lib.lbm_resident_max_blocks()
    if n <= 0:
        _build.check(-n, "resident kernel occupancy")
    return n


def launch(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, chunk, blocks):
    """K4 on ``blocks`` blocks: one cooperative launch per chunk, all from
    one C call. A grid larger than the card can hold at once raises (the
    launch is refused); nothing shrinks it."""
    lib = _build.library()
    _, ny, nx = cells.shape
    a = cells.contiguous().clone()
    b = torch.empty_like(a)
    nobst = nobst.contiguous()
    av = torch.empty(n_iters, dtype=torch.float32, device=a.device)
    partials = torch.empty(min(chunk, n_iters) * blocks, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.lbm_resident_run(
            a.data_ptr(), b.data_ptr(), nobst.data_ptr(), av.data_ptr(), partials.data_ptr(),
            ny, nx, n_iters, chunk, blocks,
            *kernel_scalars(density, accel, omega, inv_tot_cells), stream,
        )
    _build.check(rc, f"resident kernel ({blocks} blocks)")
    return (a if n_iters % 2 == 0 else b), av


def run_resident(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, *,
                 chunk=CHUNK_STEPS, paired="fused"):
    """Run ``n_iters`` steps, ``chunk`` per launch: kernel K4 on CUDA,
    ``run_resident_plain`` on CPU. ``cells`` is left unchanged. The kernel
    implements the fused collision form."""
    if cells.device.type == "cpu":
        return run_resident_plain(cells, nobst, density, accel, omega, n_iters, inv_tot_cells,
                                  chunk=chunk, paired=paired)
    if cells.device.type != "cuda":
        raise ValueError(f"no resident kernel for device {cells.device}")
    if not (isinstance(paired, str) and paired.startswith("fused")):
        raise ValueError("the CUDA resident kernel implements the fused collision form only")
    _check(cells, nobst, n_iters, chunk)
    ny, nx = cells.shape[1:]
    blocks = min(max_blocks(cells.device), -(-ny * nx // _THREADS))
    out = launch(cells, nobst, density, accel, omega, n_iters, inv_tot_cells, chunk, blocks)
    run_resident.launches += n_iters
    return out


run_resident.launches = 0  # steps K4 advanced in this process
