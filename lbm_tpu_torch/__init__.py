"""lbm_tpu_torch — the D2Q9 lattice-Boltzmann framework on PyTorch and CUDA.

The port of the JAX package ``lbm_tpu`` to one NVIDIA Hopper GPU. It
mirrors ``lbm_tpu``'s layout and module names; the JAX package stays
unchanged as the reference each module is held against.

- ``lbm_tpu_torch.models``  — the D2Q9/BGK lattice model and the parameter record.
- ``lbm_tpu_torch.ops``     — the plain PyTorch reference step, the shared
                              collision, and the two kernel routes: ``ops/aa.py``
                              (kernel K2, ``csrc/aa.cu``) and ``ops/step.py``
                              (kernel K1, ``csrc/step.cu``), built by ``ops/_build.py``.
- ``lbm_tpu_torch.runtime`` — the driver (whole run on the device, av_vels kept
                              there) and device selection.
- ``lbm_tpu_torch.io``      — the reference's file formats, byte for byte.
- ``lbm_tpu_torch.utils``   — the 1% result checker and the deck geometries.

This module imports torch and numpy only, never JAX.
"""

from lbm_tpu_torch.models.d2q9 import D2Q9, LBMParams
from lbm_tpu_torch.runtime.driver import SimulationResult, run_simulation

__version__ = "0.1.0"

__all__ = [
    "D2Q9",
    "LBMParams",
    "SimulationResult",
    "run_simulation",
    "__version__",
]

from lbm_tpu_torch.api import Simulation  # noqa: E402

__all__.append("Simulation")
