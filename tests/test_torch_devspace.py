"""c16 storage (``lbm_tpu_torch/ops/devspace.py``) against the JAX package's
``lbm_tpu/ops/devspace.py``.

The codec is compared exactly: the port repeats the JAX package's f32
arithmetic operation for operation (``1/h`` and ``1/LIM`` taken in double
and rounded to f32, half-to-even ``rint``), so the same deviations give the
same codes and the same codes the same values. The reference step at c16
is compared at the c16 tolerance of tests/test_c16.py: decoded cells within
5e-6 (the two packages' f32 reference steps differ in the low bits, and a
low bit can move a code by one quantum at a rounding tie) and the |u| sums
at rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.models.d2q9 import D2Q9 as JD2Q9
from lbm_tpu.models.d2q9 import LBMParams as JParams
from lbm_tpu.ops import devspace as jdev
from lbm_tpu_torch.models.d2q9 import WEIGHTS, D2Q9, LBMParams
from lbm_tpu_torch.ops import devspace as tdev

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
# The official decks' (density, accel): 128^2, 128x256, 256^2 and 1024^2.
DECK_FORCING = [(0.1, 0.005), (0.1, 0.01)]


@pytest.fixture
def spec():
    return tdev.DevSpec.for_params(DENSITY, ACCEL)


def test_spec_matches_jax(spec, monkeypatch):
    monkeypatch.delenv("LBM_C16_H", raising=False)
    want = jdev.DevSpec.for_params(DENSITY, ACCEL)
    assert spec.bg == want.bg and spec.h == want.h == pytest.approx(64 * DENSITY * ACCEL)
    assert spec.bg[1] == spec.bg[3] and spec.bg[5] == spec.bg[7]  # opposite pairs
    assert tdev.DevSpec.for_params(0.1, 0.0).h == jdev.DevSpec.for_params(0.1, 0.0).h
    assert len(spec.codec()) == 12 and spec.codec()[9] == 1.0 / spec.h


def test_h_override(monkeypatch):
    monkeypatch.setenv("LBM_C16_H", "0.5")
    assert tdev.DevSpec.for_params(DENSITY, ACCEL).h == 0.5
    monkeypatch.setenv("LBM_C16_H", "-1")
    with pytest.raises(ValueError, match="must be > 0"):
        tdev.DevSpec.for_params(DENSITY, ACCEL)


def seeded_deviations(h, n=20000, seed=7):
    """Deviations across 12 orders of magnitude, both signs, zeros and
    values beyond +-H (clamped)."""
    rng = np.random.RandomState(seed)
    mag = 10.0 ** rng.uniform(-12, np.log10(3 * h), n)
    d = mag * np.where(rng.rand(n) < 0.5, -1, 1)
    d[:4] = [0.0, -0.0, 5 * h, -5 * h]
    return d.astype(np.float32)


@pytest.mark.parametrize("density,accel", DECK_FORCING)
def test_codec_matches_jax_exactly(density, accel):
    spec = tdev.DevSpec.for_params(density, accel)
    jspec = jdev.DevSpec.for_params(density, accel)
    d = seeded_deviations(spec.h)
    q = tdev.encode_value(torch.as_tensor(d), spec.h)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jdev.encode_value(jnp.asarray(d), jspec.h)))
    assert float(q.abs().max()) == tdev.LIM  # the clamp
    np.testing.assert_array_equal(
        tdev.decode_value(q, spec.h).numpy(),
        np.asarray(jdev.decode_value(jnp.asarray(q.numpy()), jspec.h)))
    rng = np.random.RandomState(3)
    cells = ((WEIGHTS * density)[:, None, None] * (1 + 0.05 * rng.randn(9, 8, 16))).astype(np.float32)
    got = tdev.encode_state(torch.as_tensor(cells), spec)
    want = np.asarray(jdev.encode_state(jnp.asarray(cells), jspec))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tdev.decode_state(got, spec).numpy(),
                                  np.asarray(jdev.decode_state(jnp.asarray(want), jspec)))


@pytest.mark.parametrize("density,accel", DECK_FORCING)
def test_every_code_round_trips(density, accel):
    """encode(decode(q)) == q for every code in [-32767, 32767] at the
    official decks' H. With the background added and taken away again
    (decode_plane/encode_plane) a few codes of |q| < ~60 move, but to a
    code that decodes to the same f32 value, so a checkpoint of decoded
    values resumes to the same physics."""
    spec = tdev.DevSpec.for_params(density, accel)
    q = torch.arange(-32767, 32768, dtype=torch.int32).to(torch.int16)
    back = tdev.encode_value(tdev.decode_value(q.to(torch.float32), spec.h), spec.h)
    assert torch.equal(back.to(torch.int16), q)
    for k in range(9):
        full = tdev.decode_plane(q, k, spec)
        assert torch.equal(tdev.decode_plane(tdev.encode_plane(full, k, spec), k, spec), full)


def test_rest_state_encodes_to_zero(spec):
    params = LBMParams(nx=16, ny=8, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    cells = D2Q9.initial_state(params, dtype=torch.float32)
    q = tdev.encode_state(cells, spec)
    assert int(q.abs().max()) == 0
    assert torch.equal(tdev.decode_state(q, spec), cells)
    jcells = JD2Q9.initial_state(JParams(16, 8, 1, 10, DENSITY, ACCEL, OMEGA), dtype=jnp.float32)
    np.testing.assert_array_equal(cells.numpy(), np.asarray(jcells))
    assert tdev.max_abs_code(q) == 0 and tdev.max_abs_deviation(cells.numpy(), spec) == 0.0


def test_reference_c16_matches_jax(spec):
    rng = np.random.RandomState(11)
    ny, nx = 16, 32
    obstacles = np.zeros((ny, nx), np.int32)
    obstacles[0] = obstacles[-1] = 1
    obstacles[rng.randint(1, ny - 1, 6), rng.randint(0, nx, 6)] = 1
    cells = ((WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))).astype(np.float32)
    jspec = jdev.DevSpec.for_params(DENSITY, ACCEL)
    jq = jdev.encode_state(jnp.asarray(cells), jspec)
    q = tdev.encode_state(torch.as_tensor(cells), spec)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    obst_t = torch.as_tensor(obstacles)
    for _ in range(4):
        jq, jtot = jdev.lbm_step_reference_c16(jq, jnp.asarray(obstacles), DENSITY, ACCEL, OMEGA,
                                               dev=(*jspec.bg, jspec.h))
        q, tot = tdev.lbm_step_reference_c16(q, obst_t, DENSITY, ACCEL, OMEGA, spec)
        assert q.dtype == torch.int16
        np.testing.assert_allclose(float(tot), float(jtot), rtol=1e-4)
    got = tdev.decode_state(q, spec).numpy()
    want = np.asarray(jdev.decode_state(jq, jspec))
    assert np.abs(got - want).max() < 5e-6


def test_carry_over_from_jax(spec):
    """A JAX DevSpec and its int16 state, carried into the port unchanged."""
    rng = np.random.RandomState(2)
    cells = ((WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, 4, 8))).astype(np.float32)
    jspec = jdev.DevSpec.for_params(DENSITY, ACCEL)
    jq = np.asarray(jdev.encode_state(jnp.asarray(cells), jspec))
    port, q = tdev.carry_over(jspec, jq)
    assert port == spec and q.dtype == torch.int16
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(tdev.decode_state(q, port).numpy(),
                                  np.asarray(jdev.decode_state(jnp.asarray(jq), jspec)))
    with pytest.raises(ValueError, match="int16"):
        tdev.carry_over(jspec, cells)
