"""lbm_tpu_torch — the D2Q9 lattice-Boltzmann framework on PyTorch and CUDA.

The port of the JAX package ``lbm_tpu`` to one NVIDIA Hopper GPU. It
mirrors ``lbm_tpu``'s layout and module names; the JAX package stays
unchanged as the reference each module is held against.

- ``lbm_tpu_torch.models``  — the D2Q9/BGK lattice model and the parameter record.
- ``lbm_tpu_torch.ops``     — the plain PyTorch reference step, the shared
                              collision, and the kernel routes: ``ops/aa.py``
                              (kernel K2, ``csrc/aa.cu``), ``ops/step.py``
                              (kernel K1, ``csrc/step.cu``) and the band family
                              ``ops/band.py``, ``ops/band2.py``, ``ops/band3.py``
                              (kernels K7, K9, K11, ``csrc/band*.cu``), and
                              ``ops/resident.py``, ``ops/temporal.py``,
                              ``ops/deep.py`` (kernels K4, K5, K6,
                              ``csrc/resident.cu``, ``temporal.cu``,
                              ``deep.cu``), built by ``ops/_build.py``.
                              The shard kernels K3 and K12
                              (``ops/shard_step.py``, ``csrc/shard_step.cu``)
                              and the sharded band passes K8, K10 (in
                              ``ops/band.py``, ``ops/band2.py``) serve
                              ``lbm_tpu_torch.parallel``.
- ``lbm_tpu_torch.parallel`` — ``--mesh N|PYxPX``: a mesh of devices driven
                              from this process (``parallel/sharded.py``);
                              ``--multihost``: one row shard per process
                              (``parallel/multihost.py``).
- ``lbm_tpu_torch.runtime`` — the driver (whole run on the device, av_vels kept
                              there, chunks ending on checkpoints), npz
                              checkpoints and device selection.
- ``lbm_tpu_torch.io``      — the reference's file formats, byte for byte.
- ``lbm_tpu_torch.utils``   — the 1% result checker, the deck geometries,
                              diagnostics (``--debug``, ``--check-nan``) and
                              the |u| heat map (``utils/viz.py``).

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
