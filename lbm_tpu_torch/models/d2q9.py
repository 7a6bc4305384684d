"""The D2Q9 / BGK lattice model (counterpart of ``lbm_tpu/models/d2q9.py``).

Lattice constants, the equilibrium distribution and the parameter record,
with the reference solver's numbering (kernels.cl:58-61, 137-177):

    speed 0: rest          weight 4/9
    speeds 1-4: E,N,W,S    weight 1/9   (east = +x, north = +y)
    speeds 5-8: NE,NW,SW,SE weight 1/36

The state is one ``(9, ny, nx)`` tensor of speed planes, the layout of the
JAX package, kept at every public function of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NSPEEDS = 9

# c[k] = (cx, cy): the direction speed k moves while streaming.
CX = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1], dtype=np.int32)
CY = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1], dtype=np.int32)

# Opposite-direction map for bounce-back: 1<->3, 2<->4, 5<->7, 6<->8.
OPPOSITE = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)

W0 = 4.0 / 9.0
W1 = 1.0 / 9.0
W2 = 1.0 / 36.0
WEIGHTS = np.array([W0, W1, W1, W1, W1, W2, W2, W2, W2], dtype=np.float64)

C_SQ = 1.0 / 3.0


@dataclasses.dataclass(frozen=True)
class LBMParams:
    """The reference's 7-field params file (d2q9-bgk.c:23-32)."""

    nx: int
    ny: int
    max_iters: int
    reynolds_dim: int
    density: float
    accel: float
    omega: float

    @property
    def viscosity(self) -> float:
        return (2.0 / self.omega - 1.0) / 6.0

    def reynolds(self, av_velocity: float) -> float:
        return av_velocity * self.reynolds_dim / self.viscosity


def params_from_fields(nx, ny, max_iters, reynolds_dim, density, accel, omega) -> LBMParams:
    """An ``LBMParams`` from the seven fields of another package's record
    (for instance the JAX package's ``LBMParams``), coerced to the types
    the params file parser produces."""
    return LBMParams(
        nx=int(nx), ny=int(ny), max_iters=int(max_iters),
        reynolds_dim=int(reynolds_dim), density=float(density),
        accel=float(accel), omega=float(omega),
    )


def state_from_numpy(cells, device, dtype=torch.float32) -> torch.Tensor:
    """A contiguous ``(9, ny, nx)`` state tensor on ``device`` from a numpy array."""
    cells = np.asarray(cells)
    if cells.ndim != 3 or cells.shape[0] != NSPEEDS:
        raise ValueError(f"state must be (9, ny, nx), got {cells.shape}")
    return torch.as_tensor(cells).to(device=device, dtype=dtype).contiguous()


def obstacles_from_numpy(mask, device) -> torch.Tensor:
    """The ``(ny, nx)`` int32 obstacle mask (nonzero = blocked) on ``device``."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"obstacle mask must be (ny, nx), got {mask.shape}")
    return torch.as_tensor((mask != 0).astype(np.int32)).to(device).contiguous()


class D2Q9:
    """Stateless helpers for the D2Q9 model on torch tensors."""

    NSPEEDS = NSPEEDS
    CX = CX
    CY = CY
    OPPOSITE = OPPOSITE
    WEIGHTS = WEIGHTS
    C_SQ = C_SQ

    @staticmethod
    def initial_state(params: LBMParams, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """Uniform equilibrium at rest (d2q9-bgk.c:572-594): plane k holds
        ``density * w_k``. Returns a contiguous ``(9, ny, nx)`` tensor."""
        w = torch.tensor(WEIGHTS * params.density, dtype=dtype, device=device)
        return w[:, None, None].expand(NSPEEDS, params.ny, params.nx).contiguous()

    @staticmethod
    def moments(cells: torch.Tensor):
        """``(rho, u_x, u_y)`` of a ``(9, ny, nx)`` state (kernels.cl:109-131)."""
        rho = cells.sum(dim=0)
        u_x = (cells[1] + cells[5] + cells[8] - (cells[3] + cells[6] + cells[7])) / rho
        u_y = (cells[2] + cells[5] + cells[6] - (cells[4] + cells[7] + cells[8])) / rho
        return rho, u_x, u_y

    @staticmethod
    def equilibrium(rho, u_x, u_y):
        """Second-order BGK equilibrium of all 9 speeds (kernels.cl:148-177),
        ``w_k rho (1 + cu/c_sq + cu^2/(2 c_sq^2) - u_sq/(2 c_sq))``."""
        dtype, device = rho.dtype, rho.device
        u_sq = u_x * u_x + u_y * u_y
        common = 1.0 - u_sq / (2.0 * C_SQ)
        cx = torch.tensor(CX, dtype=dtype, device=device)[:, None, None]
        cy = torch.tensor(CY, dtype=dtype, device=device)[:, None, None]
        w = torch.tensor(WEIGHTS, dtype=dtype, device=device)[:, None, None]
        cu = cx * u_x[None] + cy * u_y[None]
        feq = w * rho[None] * (common[None] + cu / C_SQ + (cu * cu) / (2.0 * C_SQ * C_SQ))
        return feq.to(dtype)
