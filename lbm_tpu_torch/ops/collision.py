"""Shared BGK collision (counterpart of ``lbm_tpu/ops/collision.py``).

Three arithmetically equivalent forms of the reference's equilibrium and
relaxation (kernels.cl:109-177), on tuples of 9 tensors:

- ``literal``: one ``feq_k`` per plane, the reference's formula;
- ``paired``: opposite directions share a weight and ``cu_opp = -cu``, so
  each of the four (k, opp) pairs needs one quadratic and one linear term;
- ``fused`` (the default): the paired form with omega folded into the
  weights, ``(omega w) rho`` hoisted per weight class, and the velocity
  numerators built from the shared diagonal differences ``t5 - t7`` and
  ``t6 - t8``.

The CUDA kernels (``csrc/step.cu``, ``csrc/aa.cu``) write the fused form
with the same grouping, so kernel and plain version round alike.
``LBM_COLLIDE=literal|paired|fused`` picks the form of the plain versions;
it is read once per run, by the driver, outside any step loop.
"""

from __future__ import annotations

import os

import torch

from lbm_tpu_torch.models.d2q9 import C_SQ, W0, W1, W2

_FCX = (0.0, 1.0, 0.0, -1.0, 0.0, 1.0, -1.0, -1.0, 1.0)
_FCY = (0.0, 0.0, 1.0, 0.0, -1.0, 1.0, 1.0, -1.0, -1.0)
_WS = (W0, W1, W1, W1, W1, W2, W2, W2, W2)

# The four opposite-direction pairs with their shared weight and the linear
# term cu_k as (u_x, u_y) coefficients.
_PAIRS = (
    (1, 3, W1, (1.0, 0.0)),
    (2, 4, W1, (0.0, 1.0)),
    (5, 7, W2, (1.0, 1.0)),
    (6, 8, W2, (-1.0, 1.0)),
)


def paired_default():
    """The collision form from ``LBM_COLLIDE``: ``False`` (literal),
    ``True`` (paired) or ``"fused"`` (the default)."""
    mode = os.environ.get("LBM_COLLIDE", "fused")
    if mode == "literal":
        return False
    if mode == "paired":
        return True
    return "fused"


def u_mag(u_sq: torch.Tensor) -> torch.Tensor:
    """|u| from ``u_sq`` for the per-step av_vels sum."""
    return torch.sqrt(u_sq)


def moments(t):
    """``(rho, inv_rho, u_x, u_y, u_sq)`` from the 9 streamed planes, with
    the reference's summation grouping (d2q9-bgk.c:877-892): a state at rest
    cancels the velocity numerators to exactly 0.0."""
    t0, t1, t2, t3, t4, t5, t6, t7, t8 = t
    rho = (((t0 + t1) + (t2 + t3)) + ((t4 + t5) + (t6 + t7))) + t8
    inv_rho = 1.0 / rho
    u_x = ((t1 + t5 + t8) - (t3 + t6 + t7)) * inv_rho
    u_y = ((t2 + t5 + t6) - (t4 + t7 + t8)) * inv_rho
    u_sq = u_x * u_x + u_y * u_y
    return rho, inv_rho, u_x, u_y, u_sq


def _moments_fused(t):
    """``(rho, u_x, u_y, u_sq)`` through the shared diagonal differences
    ``d57`` and ``d68``; opposite-pair differences of a state at rest are
    exactly 0.0, so the numerators still cancel to zero."""
    t0, t1, t2, t3, t4, t5, t6, t7, t8 = t
    s13 = t1 + t3
    s24 = t2 + t4
    s57 = t5 + t7
    s68 = t6 + t8
    rho = ((s13 + s24) + (s57 + s68)) + t0
    inv_rho = 1.0 / rho
    d57 = t5 - t7
    d68 = t6 - t8
    u_x = (((t1 - t3) + d57) - d68) * inv_rho
    u_y = (((t2 - t4) + d57) + d68) * inv_rho
    u_sq = u_x * u_x + u_y * u_y
    return rho, u_x, u_y, u_sq


def _finish_fused(t, rho, u_x, u_y, omega):
    """The fused form's relax stage given the moments."""
    u_sq = u_x * u_x + u_y * u_y
    beta = 1.0 - omega
    common = 1.0 - u_sq * (0.5 / C_SQ)
    wr0 = (omega * W0) * rho
    wr1 = (omega * W1) * rho
    wr2 = (omega * W2) * rho
    relaxed = [None] * 9
    relaxed[0] = beta * t[0] + wr0 * common
    for k, kb, w, (ax, ay) in _PAIRS:
        wr = wr1 if w == W1 else wr2
        if ax and ay:
            cu = u_x + u_y if ax == 1.0 else u_y - u_x
        else:
            cu = u_x if ax else u_y
        q = wr * (common + (cu * cu) * (0.5 / (C_SQ * C_SQ)))
        d = wr * (cu * (1.0 / C_SQ))
        relaxed[k] = beta * t[k] + (q + d)
        relaxed[kb] = beta * t[kb] + (q - d)
    return tuple(relaxed), u_sq


def _bgk_fused(t, omega):
    rho, u_x, u_y, _ = _moments_fused(t)
    return _finish_fused(t, rho, u_x, u_y, omega)


def bgk_relax(t, omega, *, paired="fused"):
    """BGK-relax the 9 streamed planes ``t``; returns ``(relaxed, u_sq)``.

    ``relaxed`` is the 9-tuple ``t_k + omega (feq_k - t_k)`` before
    bounce-back; the caller applies its own obstacle select. ``paired`` is
    ``False`` (literal), ``True`` (paired) or ``"fused"``.
    """
    if isinstance(paired, str) and paired.startswith("fused"):
        return _bgk_fused(t, omega)
    rho, _, u_x, u_y, u_sq = moments(t)
    common = 1.0 - u_sq * (0.5 / C_SQ)
    relaxed = [None] * 9
    relaxed[0] = t[0] + omega * (W0 * rho * common - t[0])
    if paired:
        for k, kb, w, (ax, ay) in _PAIRS:
            if ax and ay:
                cu = ax * u_x + u_y if ax == 1.0 else u_y - u_x
            else:
                cu = u_x if ax else u_y
            wr = w * rho
            q = wr * (common + (cu * cu) * (0.5 / (C_SQ * C_SQ)))
            d = wr * (cu * (1.0 / C_SQ))
            relaxed[k] = t[k] + omega * ((q + d) - t[k])
            relaxed[kb] = t[kb] + omega * ((q - d) - t[kb])
    else:
        for k in range(1, 9):
            cu = _FCX[k] * u_x + _FCY[k] * u_y if _FCX[k] and _FCY[k] else (
                _FCX[k] * u_x if _FCX[k] else _FCY[k] * u_y
            )
            feq = _WS[k] * rho * (
                common + cu * (1.0 / C_SQ) + cu * cu * (0.5 / (C_SQ * C_SQ))
            )
            relaxed[k] = t[k] + omega * (feq - t[k])
    return tuple(relaxed), u_sq
