"""The fused one-step route (counterpart of ``lbm_tpu/ops/pallas_step.py``).

``run_step`` advances a ``(9, ny, nx)`` f32 state ``n_steps`` steps and
returns ``(cells, av)`` with ``av[t] = inv_tot_cells * sum(nobst * |u|)``
of step t. On a CUDA tensor it launches kernel K1 (``csrc/step.cu``): one
fused launch per step (forcing, pull streaming with periodic wrap,
bounce-back, BGK, |u| sum), ping-ponging between two buffers, with every
launch of the run issued by one C call. On a CPU tensor it runs
``step_plain``, the same function in plain PyTorch, which is what the CPU
tests hold against the JAX kernel. Any other device raises; a CUDA tensor
never falls back to the plain version.

The TPU kernel's tiling constraints (``nx % 128``, ``ny`` a multiple of the
row block) and its halo carry do not apply: K1 needs ``ny >= 2`` and
device memory for two states.

c16 storage (``dev``, an ``ops/devspace.py::DevSpec``): the state is int16
codes; K1 decodes each value it reads and encodes each value it writes
(``pallas_step.py:198-243``), and the plain version is decode,
``step_plain``, encode: the same rounding point, once per step.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.models.d2q9 import W0, W1, W2
from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops.collision import bgk_relax, u_mag

_CYS = (0, 0, 1, 0, -1, 1, 1, -1, -1)
_CXS = (0, 1, 0, -1, 0, 1, -1, -1, 1)
_OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)


def forcing_weights(density: float, accel: float):
    """``(w1a, w2a)``: the forcing added to the axis and diagonal speeds
    (kernels.cl:17-18), as Python floats."""
    return float(density * accel / 9.0), float(density * accel / 36.0)


def force_deltas(w1a: float, w2a: float):
    """``(speed, delta)`` of the six speeds the forcing changes."""
    return ((1, w1a), (3, -w1a), (5, w2a), (6, -w2a), (7, -w2a), (8, w2a))


def kernel_scalars(density: float, accel: float, omega: float, inv_tot_cells: float):
    """The float arguments of the kernels' C entry points, in order: the
    forcing weights, then the fused form's ``1 - omega`` and ``omega * w``,
    computed in double like the Python scalars of the plain version."""
    w1a, w2a = forcing_weights(density, accel)
    omega = float(omega)
    return (w1a, w2a, 1.0 - omega, omega * W0, omega * W1, omega * W2,
            float(inv_tot_cells))


def count_launches(wrapper, steps: int, dev) -> None:
    """Add ``steps`` to a kernel wrapper's launch count: ``launches`` at
    f32, ``launches_c16`` at c16 (``dev``)."""
    if dev is None:
        wrapper.launches += steps
    else:
        wrapper.launches_c16 += steps


def check_inputs(cells: torch.Tensor, nobst: torch.Tensor, n_steps: int, min_ny: int,
                 dev=None) -> None:
    """Shapes, dtypes and devices a kernel takes; ``dev`` (c16) wants int16 codes."""
    if cells.dim() != 3 or cells.shape[0] != 9:
        raise ValueError(f"state must be (9, ny, nx), got {tuple(cells.shape)}")
    if dev is not None:
        if cells.dtype != torch.int16 or nobst.dtype != torch.float32:
            raise ValueError("c16 storage takes an int16 state and an f32 not-obstacle plane")
    elif cells.dtype != torch.float32 or nobst.dtype != torch.float32:
        raise ValueError("the kernels take f32 state and an f32 not-obstacle plane"
                         + (" (int16 c16 codes need a DevSpec)" if cells.dtype == torch.int16
                            else ""))
    if tuple(nobst.shape) != tuple(cells.shape[1:]):
        raise ValueError(f"nobst {tuple(nobst.shape)} does not match the grid {tuple(cells.shape[1:])}")
    if nobst.device != cells.device:
        raise ValueError("state and nobst must be on one device")
    if cells.shape[1] < min_ny:
        raise ValueError(f"grid needs ny >= {min_ny}, got {cells.shape[1]}")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")


def step_plain(cells, nobst, w1a, w2a, omega, paired="fused"):
    """One fused step in plain PyTorch (``pallas_step._physics``): forcing of
    row ny-2 under the joint mask, pull streaming with periodic wrap, BGK,
    bounce-back. Returns ``(new_cells, tot_u)``."""
    r = cells.shape[1] - 2
    m = list(cells.unbind(0))
    ok = ((m[3][r] - w1a > 0.0) & (m[6][r] - w2a > 0.0) & (m[7][r] - w2a > 0.0))
    amask = ok.to(cells.dtype) * nobst[r]
    for k, w in force_deltas(w1a, w2a):
        plane = m[k].clone()
        plane[r] = plane[r] + w * amask
        m[k] = plane
    t = [torch.roll(m[k], shifts=(_CYS[k], _CXS[k]), dims=(0, 1)) for k in range(9)]
    relaxed, u_sq = bgk_relax(t, omega, paired=paired)
    fluid = nobst > 0.0
    out = torch.stack([torch.where(fluid, relaxed[k], t[_OPP[k]]) for k in range(9)])
    return out, torch.sum(nobst * u_mag(u_sq))


def run_step_plain(cells, nobst, density, accel, omega, n_steps, inv_tot_cells,
                   paired="fused", dev=None):
    """``n_steps`` of ``step_plain`` (with ``dev``, each between a decode and
    an encode); returns ``(cells, av)``."""
    from lbm_tpu_torch.ops.devspace import decode_state, encode_state

    check_inputs(cells, nobst, n_steps, 2, dev)
    w1a, w2a = forcing_weights(density, accel)
    inv = torch.tensor(inv_tot_cells, dtype=torch.float32, device=cells.device)
    av = torch.empty(n_steps, dtype=torch.float32, device=cells.device)
    for t in range(n_steps):
        full = cells if dev is None else decode_state(cells, dev)
        full, tot = step_plain(full, nobst, w1a, w2a, float(omega), paired)
        cells = full if dev is None else encode_state(full, dev)
        av[t] = tot * inv
    return cells, av


def run_step(cells, nobst, density, accel, omega, n_steps, inv_tot_cells, paired="fused",
             dev=None):
    """Run ``n_steps`` fused steps: kernel K1 on CUDA, ``run_step_plain`` on CPU.

    ``cells`` is left unchanged. ``inv_tot_cells`` is the f32 value of
    1 / (unblocked cells). The kernel implements the fused collision form.
    ``dev``: c16 storage (int16 ``cells``).
    """
    if cells.device.type == "cpu":
        return run_step_plain(cells, nobst, density, accel, omega, n_steps,
                              inv_tot_cells, paired, dev)
    if cells.device.type != "cuda":
        raise ValueError(f"no step kernel for device {cells.device}")
    if not (isinstance(paired, str) and paired.startswith("fused")):
        raise ValueError("the CUDA step kernel implements the fused collision form only")
    check_inputs(cells, nobst, n_steps, 2, dev)
    lib = _build.library()
    _, ny, nx = cells.shape
    a = cells.contiguous().clone()
    b = torch.empty_like(a)
    nobst = nobst.contiguous()
    av = torch.empty(n_steps, dtype=torch.float32, device=cells.device)
    partials = torch.empty(lib.lbm_step_num_blocks(ny, nx), dtype=torch.float32,
                           device=cells.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=cells.device)
    with torch.cuda.device(cells.device):
        stream = torch.cuda.current_stream(cells.device).cuda_stream
        rc = lib.lbm_step_run(
            a.data_ptr(), b.data_ptr(), nobst.data_ptr(), av.data_ptr(),
            partials.data_ptr(), ticket.data_ptr(), ny, nx, n_steps,
            *kernel_scalars(density, accel, omega, inv_tot_cells), _build.codec(dev), stream,
        )
    _build.check(rc, "step kernel")
    count_launches(run_step, n_steps, dev)
    return (a if n_steps % 2 == 0 else b), av


run_step.launches = 0  # K1 steps launched in this process
run_step.launches_c16 = 0  # K1 steps launched at c16
