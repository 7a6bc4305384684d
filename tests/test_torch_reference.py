"""The port's lattice model and plain reference step against the JAX package.

Inputs are made with numpy from a fixed seed and fed to both packages.
conftest.py turns on JAX's x64 mode, so every JAX array here is given its
dtype explicitly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.models.d2q9 import D2Q9 as JD2Q9
from lbm_tpu.models.d2q9 import LBMParams as JParams
from lbm_tpu.ops import reference as jref
from lbm_tpu_torch.models import d2q9
from lbm_tpu_torch.models.d2q9 import D2Q9, LBMParams
from lbm_tpu_torch.ops import reference as tref

NX, NY = 24, 16
DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85


def make_inputs(seed=42, nx=NX, ny=NY):
    rng = np.random.RandomState(seed)
    mask = np.zeros((ny, nx), dtype=np.int32)
    mask[0, :] = mask[-1, :] = 1
    mask[rng.randint(1, ny - 1, 10), rng.randint(0, nx, 10)] = 1
    w = d2q9.WEIGHTS * DENSITY
    state = w[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    return state, mask


def test_lattice_tables_match():
    from lbm_tpu.models import d2q9 as jd

    for name in ("CX", "CY", "OPPOSITE", "WEIGHTS"):
        np.testing.assert_array_equal(getattr(d2q9, name), getattr(jd, name))
    assert d2q9.C_SQ == jd.C_SQ


def test_params_properties_match():
    fields = dict(nx=NX, ny=NY, max_iters=7, reynolds_dim=10, density=DENSITY,
                  accel=ACCEL, omega=OMEGA)
    jp, tp = JParams(**fields), LBMParams(**fields)
    assert tp.viscosity == jp.viscosity
    assert tp.reynolds(0.0123) == jp.reynolds(0.0123)


def test_state_carried_across_exactly():
    """params_from_fields / state_from_numpy / obstacles_from_numpy round trip."""
    jp = JParams(nx=NX, ny=NY, max_iters=7, reynolds_dim=10, density=DENSITY,
                 accel=ACCEL, omega=OMEGA)
    tp = d2q9.params_from_fields(jp.nx, jp.ny, jp.max_iters, jp.reynolds_dim,
                                 jp.density, jp.accel, jp.omega)
    assert tp == LBMParams(**{f: getattr(jp, f) for f in
                              ("nx", "ny", "max_iters", "reynolds_dim", "density", "accel", "omega")})
    state, mask = make_inputs()
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        t = d2q9.state_from_numpy(state.astype(np_dtype), "cpu", dtype)
        assert t.dtype == dtype and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), state.astype(np_dtype))
    o = d2q9.obstacles_from_numpy(mask, "cpu")
    np.testing.assert_array_equal(o.numpy(), mask)
    with pytest.raises(ValueError):
        d2q9.state_from_numpy(state[:8], "cpu")
    with pytest.raises(ValueError):
        d2q9.obstacles_from_numpy(mask[None], "cpu")


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.float64, jnp.float64)])
def test_initial_state_matches(dtype, jdtype):
    fields = dict(nx=NX, ny=NY, max_iters=7, reynolds_dim=10, density=DENSITY,
                  accel=ACCEL, omega=OMEGA)
    want = np.asarray(JD2Q9.initial_state(JParams(**fields), dtype=jdtype))
    got = D2Q9.initial_state(LBMParams(**fields), dtype=dtype).numpy()
    np.testing.assert_array_equal(got, want)


def test_moments_and_equilibrium_match_f64():
    state, _ = make_inputs(seed=1)
    jr, jx, jy = JD2Q9.moments(jnp.asarray(state, jnp.float64))
    tr, tx, ty = D2Q9.moments(torch.as_tensor(state))
    for a, b in ((jr, tr), (jx, tx), (jy, ty)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-15)
    want = np.asarray(JD2Q9.equilibrium(jr, jx, jy))
    got = D2Q9.equilibrium(tr, tx, ty).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_reference_step_f64_five_steps():
    """Same f64 formula on both sides: max relative difference 1e-12."""
    state, mask = make_inputs()
    jc, tc = jnp.asarray(state, jnp.float64), torch.as_tensor(state)
    jo, to = jnp.asarray(mask), torch.as_tensor(mask)
    for _ in range(5):
        jc, jtot = jref.lbm_step_reference(jc, jo, DENSITY, ACCEL, OMEGA)
        tc, ttot = tref.lbm_step_reference(tc, to, DENSITY, ACCEL, OMEGA)
        assert tc.dtype == torch.float64
        np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-12)
    want = np.asarray(jc)
    assert np.abs(tc.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_reference_step_f32_five_steps():
    """f32 on both sides; op order differs only in the sums (cells within
    1e-6 of scale, tot_u rtol 1e-5)."""
    state, mask = make_inputs(seed=5)
    state = state.astype(np.float32)
    jc, tc = jnp.asarray(state, jnp.float32), torch.as_tensor(state)
    jo, to = jnp.asarray(mask), torch.as_tensor(mask)
    for _ in range(5):
        jc, jtot = jref.lbm_step_reference(jc, jo, DENSITY, ACCEL, OMEGA)
        tc, ttot = tref.lbm_step_reference(tc, to, DENSITY, ACCEL, OMEGA)
        assert tc.dtype == torch.float32
        np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-5)
    want = np.asarray(jc)
    assert np.abs(tc.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("part", ["accelerate_flow", "stream"])
def test_reference_parts_match_exactly_f64(part):
    state, mask = make_inputs(seed=9)
    if part == "stream":
        want = np.asarray(jref.stream(jnp.asarray(state, jnp.float64)))
        got = tref.stream(torch.as_tensor(state)).numpy()
    else:
        want = np.asarray(jref.accelerate_flow(jnp.asarray(state, jnp.float64),
                                               jnp.asarray(mask), DENSITY, ACCEL))
        got = tref.accelerate_flow(torch.as_tensor(state), torch.as_tensor(mask),
                                   DENSITY, ACCEL).numpy()
    np.testing.assert_array_equal(got, want)


def test_velocity_field_matches_f64():
    state, mask = make_inputs(seed=3)
    want = jref.velocity_field(jnp.asarray(state, jnp.float64), jnp.asarray(mask))
    got = tref.velocity_field(torch.as_tensor(state), torch.as_tensor(mask))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-18)


def test_state_at_rest_has_exact_zero_velocity():
    params = LBMParams(nx=NX, ny=NY, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    _, ux, uy = D2Q9.moments(D2Q9.initial_state(params))
    assert torch.count_nonzero(ux) == 0 and torch.count_nonzero(uy) == 0
