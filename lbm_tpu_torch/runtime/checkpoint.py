"""Checkpoint / resume (counterpart of ``lbm_tpu/runtime/checkpoint.py``).

A checkpoint is one ``.npz`` file in the JAX package's format, so a
checkpoint written by either package resumes in the other: ``version``
(1), the full ``(9, ny, nx)`` distribution state ``cells``, the ``av_vels``
prefix, the completed ``step`` count, and ``params`` (the seven fields, f64)
to validate against the run. Writes are atomic (a temporary file renamed
over the target). The JAX package's orbax format is JAX-only and is not
ported. A 16-bit run's checkpoint holds the f32 values of its state (for
bf16 exact, so a resume gets the state's bits back); a bf16 checkpoint of
the JAX package, whose cells npz holds as raw 2-byte records, loads here
as those exact values.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from lbm_tpu_torch.models.d2q9 import LBMParams

FORMAT_VERSION = 1


def _params_list(params: LBMParams) -> list:
    return [params.nx, params.ny, params.max_iters, params.reynolds_dim, params.density,
            params.accel, params.omega]


def save_checkpoint(path, params: LBMParams, cells, av_vels, step: int) -> None:
    """Atomically write a checkpoint (write a temporary file, then rename)."""
    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)  # a snapshot can precede the run's first output
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, version=FORMAT_VERSION, cells=np.asarray(cells),
                     av_vels=np.asarray(av_vels), step=int(step),
                     params=np.array(_params_list(params), dtype=np.float64))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path, params: LBMParams):
    """Load a checkpoint and check that it belongs to ``params``. Returns
    ``(cells, av_vels, step)``."""
    with np.load(path) as data:
        version = int(data["version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        saved = data["params"]
        expect = np.array(_params_list(params), dtype=np.float64)
        if not np.allclose(saved, expect):
            raise ValueError(f"checkpoint params {saved.tolist()} do not match run params "
                             f"{expect.tolist()}")
        cells, av_vels, step = data["cells"], data["av_vels"], int(data["step"])
    if cells.dtype == np.dtype("V2"):
        # The JAX package saves a bf16 state (an ml_dtypes array) as raw
        # 2-byte records: their bits, shifted into the top half of an f32,
        # are its exact values.
        cells = (cells.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    if cells.shape != (9, params.ny, params.nx) or av_vels.shape != (step,):
        raise ValueError(f"checkpoint holds cells {cells.shape} and {av_vels.shape[0]} av values "
                         f"at step {step}; the run needs (9, {params.ny}, {params.nx}) and {step}")
    return cells, av_vels, step
