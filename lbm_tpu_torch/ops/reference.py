"""Plain PyTorch D2Q9/BGK timestep (counterpart of ``lbm_tpu/ops/reference.py``).

The oracle for the kernels and the route of ``--backend reference`` and of
f64 runs. It mirrors the reference's two OpenCL kernels:

- ``accelerate_flow`` (kernels.cl:7-42): on row ``ny-2``, where the cell is
  unblocked and the three west-going populations stay strictly positive
  after the update (one joint mask, kernels.cl:29-32), add the forcing;
- ``stream`` + ``collide`` (kernels.cl:44-201): pull streaming with
  periodic wrap, bounce-back of the streamed values on obstacles, BGK
  relaxation elsewhere, and the sum of ``nobst * |u|``.

State is ``(9, ny, nx)`` at f32 or f64; nothing is updated in place.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.models.d2q9 import C_SQ, CX, CY, OPPOSITE, D2Q9


def accelerate_flow(cells, obstacles, density, accel):
    """Apply the forcing to row ``ny-2``; returns a new state."""
    dtype = cells.dtype
    w1 = torch.tensor(density * accel / 9.0, dtype=dtype, device=cells.device)
    w2 = torch.tensor(density * accel / 36.0, dtype=dtype, device=cells.device)
    row = cells.shape[1] - 2
    s = cells[:, row, :]
    free = obstacles[row, :] == 0
    mask = free & (s[3] - w1 > 0.0) & (s[6] - w2 > 0.0) & (s[7] - w2 > 0.0)
    m = mask.to(dtype)
    z = torch.zeros_like(m)
    delta = torch.stack([z, w1 * m, z, -w1 * m, z, w2 * m, -w2 * m, -w2 * m, w2 * m])
    out = cells.clone()
    out[:, row, :] += delta
    return out


def stream(cells):
    """Pull streaming with periodic wrap: plane k rolled by ``(CY[k], CX[k])``."""
    return torch.stack([
        torch.roll(cells[k], shifts=(int(CY[k]), int(CX[k])), dims=(0, 1))
        for k in range(9)
    ])


def collide(streamed, obstacles, omega):
    """Bounce-back + BGK collision + the per-step sum of ``nobst * |u|``.
    Returns ``(new_cells, tot_u)`` with ``tot_u`` a 0-d tensor."""
    dtype = streamed.dtype
    obst = (obstacles != 0)[None, :, :]
    rho, u_x, u_y = D2Q9.moments(streamed)
    feq = D2Q9.equilibrium(rho, u_x, u_y)
    relaxed = streamed + omega * (feq - streamed)
    bounced = streamed[torch.as_tensor(OPPOSITE, dtype=torch.long, device=streamed.device)]
    new_cells = torch.where(obst, bounced, relaxed).to(dtype)
    speed = torch.sqrt(u_x * u_x + u_y * u_y)
    nobst = (obstacles == 0).to(dtype)
    return new_cells, torch.sum(nobst * speed)


def lbm_step_reference(cells, obstacles, density, accel, omega):
    """One timestep: accelerate, stream, bounce/collide, reduce."""
    cells = accelerate_flow(cells, obstacles, density, accel)
    return collide(stream(cells), obstacles, omega)


def velocity_field(cells, obstacles):
    """``(u_x, u_y, |u|, pressure)`` with obstacle cells zeroed
    (d2q9-bgk.c:426-475, 857-896)."""
    rho, u_x, u_y = D2Q9.moments(cells)
    free = (obstacles == 0).to(cells.dtype)
    u_x = u_x * free
    u_y = u_y * free
    speed = torch.sqrt(u_x * u_x + u_y * u_y)
    pressure = torch.where(obstacles != 0, torch.zeros_like(rho), rho * C_SQ)
    return u_x, u_y, speed, pressure
