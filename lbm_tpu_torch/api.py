"""High-level Python API (counterpart of ``lbm_tpu/api.py``)::

    from lbm_tpu_torch.api import Simulation

    sim = Simulation.from_files("input_128x128.params", "obstacles_128x128.dat")
    result = sim.run(device="cuda:0")      # full maxIters on the card
    result.av_vels, result.cells           # the av_vels series, final state
    sim.reynolds(result)
    sim.write_outputs(result, out_dir=".")
    sim.run(mesh=4, device="cuda:0")       # four row shards on one card
    sim.run(mesh=(2, 2), devices=["cpu"] * 4)
    sim.run(device="cuda:0", dtype="c16")  # int16 companded state, decoded result
    sim.run(device="cuda:0", dtype=torch.bfloat16)  # bfloat16 state (experimental)
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lbm_tpu_torch.models.d2q9 import LBMParams
from lbm_tpu_torch.runtime.driver import SimulationResult, run_simulation


class Simulation:
    """A configured lattice-Boltzmann simulation: params + obstacle geometry."""

    def __init__(self, params: LBMParams, obstacles: np.ndarray):
        obstacles = np.asarray(obstacles)
        if obstacles.shape != (params.ny, params.nx):
            raise ValueError(
                f"obstacle mask shape {obstacles.shape} != grid ({params.ny}, {params.nx})"
            )
        self.params = params
        self.obstacles = obstacles

    @classmethod
    def from_files(cls, paramfile, obstaclefile) -> "Simulation":
        from lbm_tpu_torch.io import read_obstacles, read_params

        params = read_params(paramfile)
        return cls(params, read_obstacles(obstaclefile, params))

    def run(self, *, device=None, backend: str = "auto", dtype=None,
            mesh: int | tuple[int, int] = 0, devices=None, **kwargs) -> SimulationResult:
        """Run ``max_iters`` steps. ``device`` defaults as ``--device`` does
        (``$LBM_DEVICE``, else ``cuda:0``; the CPU only when named).
        ``mesh`` shards the run over N row shards (int) or a 2-D ``(py,
        px)`` mesh, on ``devices`` (one per shard), else every shard on
        ``device`` when it is given, else the first cards. ``dtype`` is a
        torch dtype (f32, f64, bf16) or ``"c16"`` (``runtime/driver.py``),
        None for f32.
        Other keywords pass through to the runner (checkpoints, resume,
        ``chunk_every``/``on_chunk`` on one device)."""
        if isinstance(mesh, tuple) or (mesh and mesh > 1):
            from lbm_tpu_torch.parallel import sharded

            count = mesh[0] * mesh[1] if isinstance(mesh, tuple) else mesh
            if devices is None and device is not None:
                devices = [device] * count
            if isinstance(mesh, tuple):
                return sharded.run_simulation_sharded_2d(
                    self.params, self.obstacles, mesh_shape=mesh, devices=devices,
                    backend=backend, dtype=dtype, **kwargs)
            return sharded.run_simulation_sharded(
                self.params, self.obstacles, n_devices=mesh, devices=devices, backend=backend,
                dtype=dtype, **kwargs)
        return run_simulation(self.params, self.obstacles, device=device,
                              backend=backend, dtype=dtype, **kwargs)

    def reynolds(self, result: SimulationResult) -> float:
        return result.reynolds(self.params, self.obstacles)

    def velocity_field(self, result: SimulationResult):
        """``(u_x, u_y, |u|, pressure)`` numpy fields of the final state."""
        from lbm_tpu_torch.ops.reference import velocity_field

        fields = velocity_field(torch.as_tensor(result.cells), torch.as_tensor(self.obstacles))
        return tuple(f.numpy() for f in fields)

    def write_outputs(self, result: SimulationResult, out_dir=".") -> None:
        from lbm_tpu_torch.io import write_av_vels, write_final_state

        os.makedirs(out_dir, exist_ok=True)
        write_final_state(os.path.join(out_dir, "final_state.dat"), self.params,
                          result.cells, self.obstacles)
        write_av_vels(os.path.join(out_dir, "av_vels.dat"), result.av_vels)
