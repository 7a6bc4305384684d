"""Runtime diagnostics (counterpart of ``lbm_tpu/utils/diagnostics.py``).

The reference's debug facilities: the ``total_density`` mass-conservation
check and the per-step ``==timestep==`` report compiled under ``-DDEBUG``
(d2q9-bgk.c:229-233, 822-838), plus a guard against a state gone
non-finite, which the reference lacks. ``--debug`` and ``--check-nan``
wire them into the CLI.
"""

from __future__ import annotations

import numpy as np
import torch


def total_density(cells) -> float:
    """Sum of all distributions, conserved by stream, collide and
    bounce-back (d2q9-bgk.c:822-838). A tensor is summed with ``torch.sum``
    on its own device, in its own type; only the sum reaches the host."""
    return float(torch.sum(torch.as_tensor(cells)))


def debug_report(step: int, av_vel: float, cells) -> str:
    """The reference's per-step DEBUG block (d2q9-bgk.c:229-233)."""
    return (
        f"==timestep: {step}==\n"
        f"av velocity: {av_vel:.12E}\n"
        f"tot density: {total_density(cells):.12E}"
    )


class NaNError(RuntimeError):
    pass


def _all_finite(x) -> bool:
    if isinstance(x, torch.Tensor):
        return bool(torch.isfinite(x).all())
    return bool(np.isfinite(np.asarray(x)).all())


def check_finite(av_vels, cells=None, *, context: str = "") -> None:
    """Raise ``NaNError`` if the mean-velocity series (naming its first
    non-finite step) or the state is not finite. Takes tensors or arrays;
    a state tensor is tested on its own device."""
    av = av_vels.cpu().numpy() if isinstance(av_vels, torch.Tensor) else np.asarray(av_vels)
    where = f" ({context})" if context else ""
    if not np.isfinite(av).all():
        first = int(np.argmax(~np.isfinite(av)))
        raise NaNError(f"non-finite mean velocity at step {first}{where}")
    if cells is not None and not _all_finite(cells):
        raise NaNError(f"non-finite distribution state{where}")
