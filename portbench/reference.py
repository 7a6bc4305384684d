"""The benchmark's plain reference: the D2Q9 lattice-Boltzmann deck of the
reference solver (AlexDalt/HPC-Lattice-Boltzmann, ``kernels.cl``) in plain
PyTorch, written for the benchmark. It imports nothing of the program
under test and takes nothing the program made: the deck, the start state
and the obstacle mask come from the harness, which hands the same arrays
to the program.

One step on a ``(9, ny, nx)`` state, speeds numbered as the reference
numbers them (0 rest; 1-4 E, N, W, S; 5-8 NE, NW, SW, SE; north is +y):

1. ``accelerate_flow`` on row ``ny - 2``: where the cell is unblocked and
   speeds 3, 6 and 7 stay strictly positive after the update, add
   ``density * accel / 9`` to speed 1, take it from speed 3, add
   ``density * accel / 36`` to speeds 5 and 8 and take it from 6 and 7;
2. pull streaming with periodic wrap: plane k moves by ``(cy_k, cx_k)``;
3. at a blocked cell the streamed values bounce back (speed k takes the
   value of its opposite); elsewhere BGK relaxation towards the
   second-order equilibrium with ``omega``;
4. the step's speed sum over unblocked cells of ``|u|`` from the moments
   of the streamed values; the av series is that sum times the f32 value
   of ``1 / unblocked cells``.

Storage: f32, or a companded integer state (``Companded``) that is decoded
before each step and encoded after it, the physics between at f32: the
deviation of plane k from its rest value ``w_k * density`` stored as
``rint(lim * sign(d) * sqrt(|d| / h))``, ``lim = 32767`` in int16: the
c16 storage the deck's traffic names. The benchmark's tests
hold the program's c16 codec and its rounding points to it. The
benchmark's runs compare against the f32 reference.

``union_us`` is the trace arithmetic the benchmark reads device busy time
with: the length of the union of intervals.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
CY = (0, 0, 1, 0, -1, 1, 1, -1, -1)
OPPOSITE = (0, 3, 4, 1, 2, 7, 8, 5, 6)
WEIGHTS = (4.0 / 9.0,) + (1.0 / 9.0,) * 4 + (1.0 / 36.0,) * 4
# Steps per CUDA graph of the reference on a card.
GRAPH_STEPS = 64


@dataclasses.dataclass(frozen=True)
class Companded:
    """c16: companded int16 storage, ``lim`` codes each side of the rest
    value, up to a deviation of ``h``."""

    bg: tuple  # w_k * density, the rest value of each plane
    h: float
    lim: float = 32767.0
    dtype: torch.dtype = torch.int16

    @classmethod
    def for_deck(cls, density: float, accel: float) -> "Companded":
        """The companding of a deck: ``h = 64 * density * accel``."""
        return cls(bg=tuple(float(w * density) for w in WEIGHTS),
                   h=64.0 * float(density) * float(accel))

    def encode(self, cells: torch.Tensor) -> torch.Tensor:
        out = torch.empty(cells.shape, dtype=self.dtype, device=cells.device)
        for k in range(9):
            d = cells[k] - self.bg[k]
            s = torch.sign(d) * torch.sqrt(torch.abs(d) * (1.0 / self.h))
            out[k] = torch.clamp(torch.round(s * self.lim), -self.lim, self.lim).to(self.dtype)
        return out

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
        for k in range(9):
            r = codes[k].to(torch.float32) * (1.0 / self.lim)
            out[k] = r * torch.abs(r) * self.h + self.bg[k]
        return out


class Deck:
    """The constants of one deck on one device, made once."""

    def __init__(self, blocked: np.ndarray, density: float, accel: float, omega: float,
                 device):
        blocked = np.asarray(blocked) != 0
        self.ny, self.nx = blocked.shape
        self.device = torch.device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.blocked_idx = torch.as_tensor(np.flatnonzero(blocked), device=self.device)
        self.free = torch.as_tensor(~blocked, **f32)
        self.free_row = torch.as_tensor(~blocked[self.ny - 2], device=self.device)
        self.free_cells = int((~blocked).sum())
        self.inv_free = torch.tensor(np.float32(1.0 / self.free_cells), **f32)
        self.w1 = float(np.float32(density * accel / 9.0))
        self.w2 = float(np.float32(density * accel / 36.0))
        self.omega = float(omega)
        self.cx = torch.tensor(CX, **f32).view(9, 1, 1)
        self.cy = torch.tensor(CY, **f32).view(9, 1, 1)
        self.w = torch.tensor(WEIGHTS, **f32).view(9, 1, 1)
        self.opp = torch.tensor(OPPOSITE, device=self.device)
        sign = torch.tensor((0.0, 1.0, 0.0, -1.0, 0.0, 1.0, -1.0, -1.0, 1.0), **f32)
        self.force = torch.tensor((0.0, self.w1, 0.0, self.w1, 0.0,
                                   self.w2, self.w2, self.w2, self.w2), **f32) * sign

    def accelerate(self, f: torch.Tensor) -> None:
        """Step 1, in place on ``f`` (the caller's own state)."""
        row = f[:, self.ny - 2]
        ok = (self.free_row & (row[3] - self.w1 > 0.0) & (row[6] - self.w2 > 0.0)
              & (row[7] - self.w2 > 0.0))
        row += self.force[:, None] * ok.to(torch.float32)

    def stream(self, f: torch.Tensor) -> torch.Tensor:
        """Step 2: a new state."""
        return torch.stack([torch.roll(f[k], shifts=(CY[k], CX[k]), dims=(0, 1))
                            for k in range(9)])

    def collide(self, g: torch.Tensor, tot_out: torch.Tensor) -> torch.Tensor:
        """Steps 3 and 4 on the streamed state ``g``: returns the new state
        and writes the speed sum into the 0-d ``tot_out``."""
        rho = g.sum(0)
        ux = ((g[1] + g[5] + g[8]) - (g[3] + g[6] + g[7])) / rho
        uy = ((g[2] + g[5] + g[6]) - (g[4] + g[7] + g[8])) / rho
        usq = ux * ux + uy * uy
        cu = torch.addcmul(self.cx * ux, self.cy, uy)
        # w rho (1 + 3 cu + 4.5 cu^2 - 1.5 u^2): the equilibrium with c_sq = 1/3
        feq = cu * 4.5
        feq.add_(3.0).mul_(cu).add_(1.0 - 1.5 * usq).mul_(self.w).mul_(rho)
        out = torch.lerp(g, feq, self.omega)
        flat, gflat = out.view(9, -1), g.view(9, -1)
        flat[:, self.blocked_idx] = gflat[:, self.blocked_idx][self.opp]
        torch.sum(torch.sqrt(usq) * self.free, dim=(0, 1), out=tot_out)
        return out

    def advance(self, state: torch.Tensor, tots: torch.Tensor, storage=None) -> None:
        """``len(tots)`` steps on ``state`` in place (the f32 state, or its
        codes on ``storage``), each step's speed sum into ``tots``."""
        for t in range(tots.shape[0]):
            f = state if storage is None else storage.decode(state)
            self.accelerate(f)
            f = self.collide(self.stream(f), tots[t])
            state.copy_(f if storage is None else storage.encode(f))

    def run(self, start: np.ndarray, steps: int, storage: Companded | None = None):
        """``steps`` steps from the f32 ``start``; returns ``(av, final)``:
        the av series and the final state as f32 numpy arrays.

        On a card the steps run in blocks of ``GRAPH_STEPS`` recorded once
        as a CUDA graph and replayed: the same kernels on the same
        tensors, without the host's dispatch of each operation."""
        f = torch.tensor(np.asarray(start, np.float32), device=self.device)  # a copy
        state = f if storage is None else storage.encode(f)
        tots = torch.empty(steps, dtype=torch.float32, device=self.device)
        done = 0
        if self.device.type == "cuda" and steps >= GRAPH_STEPS:
            block = torch.empty(GRAPH_STEPS, dtype=torch.float32, device=self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):  # warm up on a copy, as capture asks
                self.advance(state.clone(), block[:1], storage)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.advance(state, block, storage)
            while steps - done >= GRAPH_STEPS:
                graph.replay()
                tots[done:done + GRAPH_STEPS].copy_(block)
                done += GRAPH_STEPS
            del graph
        self.advance(state, tots[done:], storage)
        f = state if storage is None else storage.decode(state)
        av = tots * self.inv_free
        return av.cpu().numpy(), f.cpu().numpy()


def union_us(spans, lo, hi):
    """Microseconds of [lo, hi) covered by the union of ``spans``."""
    total, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total
