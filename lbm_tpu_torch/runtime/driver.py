"""Simulation driver (counterpart of ``lbm_tpu/runtime/driver.py``).

The reference launches two kernels per step, syncs, and reads the whole
``tot_us`` buffer back to sum it on the host (d2q9-bgk.c:206-228,
408-420). Here the whole run stays on the device: the kernel routes issue
every step of the run from one C call, the per-step mean |u| is written
into an on-device ``(max_iters,)`` tensor, and nothing returns to the host
until the loop ends. The final state is the true last state.

Routes (``select_route``), as in the JAX package:

- ``auto`` at f32 -> ``aa`` (kernel K2 on CUDA; its plain version on an
  explicitly chosen CPU, so the CPU tests drive the card's route);
- ``pallas`` -> the fused one-step route (kernel K1 / its plain version);
- ``reference`` -> the plain step of ``ops/reference.py``;
- f64 -> ``reference``; an explicit ``aa`` or ``pallas`` with f64 raises.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from lbm_tpu_torch.models.d2q9 import D2Q9, LBMParams, obstacles_from_numpy
from lbm_tpu_torch.ops.aa import MIN_NY as AA_MIN_NY
from lbm_tpu_torch.ops.collision import paired_default
from lbm_tpu_torch.ops.reference import lbm_step_reference

BACKENDS = ("auto", "aa", "pallas", "reference")


@dataclasses.dataclass
class SimulationResult:
    cells: np.ndarray | None  # (9, ny, nx) final state (None: fetch_final=False)
    av_vels: np.ndarray  # (max_iters,) per-step mean |u| over unblocked cells
    elapsed: float  # seconds of the compute loop (kernel build excluded)
    compile_time: float  # seconds spent building or loading the kernels
    route: str = "reference"  # "aa", "pallas" or "reference"
    device: str = "cpu"  # the torch device the loop ran on

    def mlups(self, params: LBMParams) -> float:
        return params.nx * params.ny * params.max_iters / self.elapsed / 1e6

    def reynolds(self, params: LBMParams, obstacles: np.ndarray) -> float:
        """Reynolds number from the final state (d2q9-bgk.c:815-819)."""
        from lbm_tpu_torch.ops.reference import velocity_field

        obstacles = np.asarray(obstacles)
        _, _, speed, _ = velocity_field(torch.as_tensor(self.cells),
                                        torch.as_tensor(obstacles))
        free = obstacles == 0
        av = float(torch.sum(speed * torch.as_tensor(free, dtype=speed.dtype)))
        return params.reynolds(av / int(free.sum()))


def select_route(params: LBMParams, backend: str, dtype) -> str:
    """Resolve ``backend`` and ``dtype`` to ``"aa"``, ``"pallas"`` or
    ``"reference"`` (driver.py:365-430 and :943-1007 of the JAX package)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}; use float32 or float64")
    if backend == "reference":
        return "reference"
    if dtype == torch.float64:
        if backend in ("aa", "pallas"):
            raise ValueError(
                f"{backend} backend stores f32 only; use --precision f32 or "
                "--backend reference for f64"
            )
        return "reference"
    if backend == "aa" and params.ny < AA_MIN_NY:
        raise ValueError(f"grid {params.ny}x{params.nx} unsupported by the AA kernel (ny < 3)")
    if backend == "pallas" and params.ny < 2:
        raise ValueError(f"grid {params.ny}x{params.nx} unsupported by the step kernel (ny < 2)")
    if backend == "auto":
        return "aa" if params.ny >= AA_MIN_NY else "reference"
    return backend


def compute_chunk_sizes(
    start_step: int, max_iters: int, checkpoint_every: int = 0, chunk_every: int = 0
) -> list[int]:
    """Split ``[start_step, max_iters)`` so a boundary falls on every
    multiple of ``checkpoint_every`` and of ``chunk_every`` (each ignored
    when <= 0)."""
    strides = [s for s in (checkpoint_every, chunk_every) if s and s > 0]
    if not strides:
        return [max_iters - start_step]
    sizes = []
    step = start_step
    while step < max_iters:
        nxt = min([max_iters] + [(step // s + 1) * s for s in strides])
        sizes.append(nxt - step)
        step = nxt
    return sizes


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_simulation(
    params: LBMParams,
    obstacles: np.ndarray,
    *,
    device: torch.device | str,
    backend: str = "auto",
    dtype=torch.float32,
    initial_cells: np.ndarray | None = None,
    fetch_final: bool = True,
) -> SimulationResult:
    """Run ``params.max_iters`` steps on ``device`` and return the result.

    ``initial_cells`` replaces the equilibrium-at-rest start state.
    ``fetch_final=False`` leaves ``result.cells`` None.
    """
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    route = select_route(params, backend, dtype)
    obstacles = np.asarray(obstacles)
    if obstacles.shape != (params.ny, params.nx):
        raise ValueError(f"obstacle mask {obstacles.shape} != grid ({params.ny}, {params.nx})")
    if initial_cells is None:
        cells = D2Q9.initial_state(params, dtype=dtype, device=device)
    else:
        cells = torch.as_tensor(np.asarray(initial_cells)).to(device=device, dtype=dtype)
    obst = obstacles_from_numpy(obstacles, device)
    tot_cells = int(np.sum(obstacles == 0))  # d2q9-bgk.c:146-152
    # The f32 (or f64) value of 1/tot_cells multiplies each step's sum, so
    # the series rounds as the JAX driver's does (driver.py:1366-1368).
    inv_np = np.asarray(1.0 / tot_cells, dtype=np.float64 if dtype == torch.float64 else np.float32)
    paired = paired_default()  # read once, outside the loop
    n = params.max_iters

    t0 = time.perf_counter()
    if route != "reference" and device.type == "cuda":
        from lbm_tpu_torch.ops import _build

        _build.library()  # build or load before the timed loop
    compile_time = time.perf_counter() - t0

    _sync(device)
    t0 = time.perf_counter()
    if route == "reference":
        inv = torch.tensor(inv_np, device=device)
        av = torch.empty(n, dtype=dtype, device=device)
        for t in range(n):
            cells, tot_u = lbm_step_reference(
                cells, obst, params.density, params.accel, params.omega
            )
            av[t] = tot_u * inv
    else:
        nobst = (obst == 0).to(torch.float32)
        if route == "aa":
            from lbm_tpu_torch.ops.aa import run_aa as run
        else:
            from lbm_tpu_torch.ops.step import run_step as run
        cells, av = run(cells, nobst, params.density, params.accel, params.omega,
                        n, float(inv_np), paired=paired)
    _sync(device)
    elapsed = time.perf_counter() - t0

    return SimulationResult(
        cells=cells.cpu().numpy() if fetch_final else None,
        av_vels=av.cpu().numpy(),
        elapsed=elapsed,
        compile_time=compile_time,
        route=route,
        device=str(cells.device),
    )
