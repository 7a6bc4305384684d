"""The 16-bit storage modes: c16, companded int16 deviations (counterpart
of ``lbm_tpu/ops/devspace.py``), and bf16, plain bfloat16 planes.

A run's storage is ``dev``: None for f32, a ``DevSpec`` for c16, ``BF16``
for bf16. The kernels and plain versions that take ``dev`` load a stored
value through ``decode_*`` and store through ``encode_*``, so both modes
round at the same points, and the physics between them runs at f32.
bf16 (``Bf16Spec``) has no codec: decode widens exactly, encode rounds to
nearest even, as XLA's convert and torch's ``.to(torch.bfloat16)`` do.

Plain bf16 storage fails the reference's 1% gate: its 8-bit mantissa
rounds the full distribution values, whose mean ``w_k * density`` dwarfs
the ~1e-3 hydrodynamic signal. c16 stores what carries the information,
the deviation of plane k from the rest state ``bg_k = w_k * density``, as
a square-root companded int16:

    q = rint(LIM * sign(d) * sqrt(|d| / H))      (encode, clamped to +-LIM)
    d = (q / LIM) * |q / LIM| * H                 (decode)

A step moves 9 int16 planes in and out and the f32 mask: 40 B per cell
instead of 76. Only the load and the store change: the background is
uniform, so streaming commutes with it, bounce-back swaps planes of equal
weight (``bg[opp(k)] == bg[k]``), and the forcing deltas are additive. The
kernels decode to f32 right after each load and encode right before each
store; all physics runs at f32.

``H``, the largest |deviation| a code holds, is ``64 * density * accel``
unless ``LBM_C16_H`` sets it (the JAX package's rule). A saturated code is
clamped; the driver warns after a run whose state came within a factor
of 2 of H.

The arithmetic is the JAX package's, operation for operation, with its
Python-float constants rounded to f32 as JAX rounds a weak-typed scalar:
``1 / h`` and ``1 / LIM`` are taken in double, ``rint`` rounds half to
even (``torch.round``). The CUDA codec (``csrc/lbm_common.cuh::C16``)
takes the same constants from ``DevSpec.codec`` and rounds each product
on its own (no FMA).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from lbm_tpu_torch.models.d2q9 import W0, W1, W2

LIM = 32767.0

_WS = (W0, W1, W1, W1, W1, W2, W2, W2, W2)


@dataclasses.dataclass(frozen=True)
class DevSpec:
    """The companding parameters of a run."""

    bg: tuple  # the 9 per-plane backgrounds w_k * density
    h: float  # the largest representable |deviation|
    name = "c16"
    dtype = torch.int16

    @classmethod
    def for_params(cls, density: float, accel: float) -> "DevSpec":
        override = os.environ.get("LBM_C16_H")
        if override:
            h = float(override)
            if h <= 0.0:
                raise ValueError(f"LBM_C16_H={override}: must be > 0")
        else:
            h = 64.0 * float(density) * float(accel)
            if h <= 0.0:
                h = max(float(density) / 32.0, 1e-30)
        return cls(bg=tuple(float(w * density) for w in _WS), h=h)

    def codec(self) -> tuple:
        """The 12 floats the CUDA codec takes, in double (the C entry points
        round them to f32): bg_0..bg_8, 1/h, h, 1/LIM."""
        return (*self.bg, 1.0 / self.h, self.h, 1.0 / LIM)


@dataclasses.dataclass(frozen=True)
class Bf16Spec:
    """bf16 storage: bfloat16 planes, no codec."""

    name = "bf16"
    dtype = torch.bfloat16


BF16 = Bf16Spec()


def encode_value(d, h: float):
    """f32 deviation -> companded value in [-LIM, LIM], before the int cast."""
    s = torch.sign(d) * torch.sqrt(torch.abs(d) * (1.0 / h))
    return torch.clamp(torch.round(s * LIM), -LIM, LIM)


def decode_value(q, h: float):
    """Companded value (as f32) -> f32 deviation."""
    r = q * (1.0 / LIM)
    return r * torch.abs(r) * h


def encode_plane(f, k: int, spec):
    """Full f32 plane k -> int16 companded deviations (bf16: rounded)."""
    if isinstance(spec, Bf16Spec):
        return f.to(torch.bfloat16)
    return encode_value(f - spec.bg[k], spec.h).to(torch.int16)


def decode_plane(q, k: int, spec):
    """int16 companded plane k -> full f32 values (bf16: widened)."""
    if isinstance(spec, Bf16Spec):
        return q.to(torch.float32)
    return decode_value(q.to(torch.float32), spec.h) + spec.bg[k]


def encode_state(cells, spec):
    """``(9, ...)`` f32 planes -> int16 codes (bf16: bfloat16 planes)."""
    if isinstance(spec, Bf16Spec):
        return cells.to(torch.float32).to(torch.bfloat16)
    return torch.stack([encode_plane(cells[k].to(torch.float32), k, spec) for k in range(9)])


def decode_state(q, spec):
    """``(9, ...)`` int16 codes (bf16: bfloat16 planes) -> f32 planes."""
    if isinstance(spec, Bf16Spec):
        return q.to(torch.float32)
    return torch.stack([decode_plane(q[k], k, spec) for k in range(9)])


def max_abs_deviation(cells, spec: DevSpec) -> float:
    """Max |deviation| of an f32 state from the background."""
    cells = np.asarray(cells, np.float32)
    bg = np.asarray(spec.bg, np.float32).reshape(9, 1, 1)
    return float(np.max(np.abs(cells - bg)))


def max_abs_code(q) -> int:
    """Max |code| of an int16 state: one reduction where the state lies and
    one scalar fetched (the saturation probe)."""
    return int(torch.max(torch.abs(q.to(torch.int32))))


def saturation(maxq: float, spec: DevSpec) -> float:
    """The |deviation| a code of ``maxq`` decodes to (decode is monotone in |q|)."""
    return (maxq / LIM) ** 2 * spec.h


def lbm_step_reference_c16(q, obstacles, density, accel, omega, spec: DevSpec):
    """The plain reference step on c16 storage: decode, step, encode (one
    encode per step, the kernels' rounding points). Returns ``(q, tot_u)``."""
    from lbm_tpu_torch.ops.reference import lbm_step_reference

    new, tot_u = lbm_step_reference(decode_state(q, spec), obstacles, density, accel, omega)
    return encode_state(new, spec), tot_u


def carry_over(spec, codes, device="cpu"):
    """A companding spec of another package (anything with ``bg`` and ``h``,
    such as the JAX package's ``DevSpec``) and its int16 state as a numpy
    array -> ``(DevSpec, int16 tensor on device)``, unchanged bit for bit."""
    codes = np.asarray(codes)
    if codes.dtype != np.int16:
        raise ValueError(f"c16 codes are int16, got {codes.dtype}")
    port = DevSpec(bg=tuple(float(b) for b in spec.bg), h=float(spec.h))
    return port, torch.tensor(codes, device=device)
