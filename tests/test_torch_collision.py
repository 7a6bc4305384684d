"""The port's BGK collision forms against ``lbm_tpu.ops.collision``.

Random f32 planes made with numpy go through both packages' ``bgk_relax``
in each form. Tolerance: atol 3e-7 of the planes' scale, the bound the
JAX package's oracle tests hold the forms to (collision.py:35-37).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import collision as jcol
from lbm_tpu_torch.models.d2q9 import WEIGHTS
from lbm_tpu_torch.ops import collision as tcol

OMEGA = 1.85


def planes(seed=0, shape=(16, 128), density=0.1):
    rng = np.random.RandomState(seed)
    w = WEIGHTS * density
    return (w[:, None, None] * (1 + 0.2 * rng.rand(9, *shape))).astype(np.float32)


@pytest.mark.parametrize("form", [False, True, "fused"], ids=["literal", "paired", "fused"])
@pytest.mark.parametrize("seed", [0, 1])
def test_bgk_relax_matches_jax(form, seed):
    p = planes(seed)
    jr, jusq = jcol.bgk_relax([jnp.asarray(x, jnp.float32) for x in p], OMEGA, paired=form)
    tr, tusq = tcol.bgk_relax(list(torch.as_tensor(p).unbind(0)), OMEGA, paired=form)
    scale = np.abs(p).max()
    for a, b in zip(jr, tr):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=3e-7 * scale)
    np.testing.assert_allclose(tusq.numpy(), np.asarray(jusq), rtol=1e-5, atol=1e-12)


def test_forms_agree_with_each_other():
    """The three forms regroup the same sums: within a few f32 ulps
    (1e-6 of scale, about 8 ulps)."""
    p = list(torch.as_tensor(planes(3)).unbind(0))
    base, _ = tcol.bgk_relax(p, OMEGA, paired=False)
    scale = float(max(x.abs().max() for x in p))
    for form in (True, "fused"):
        other, _ = tcol.bgk_relax(p, OMEGA, paired=form)
        for a, b in zip(base, other):
            assert float((a - b).abs().max()) <= 1e-6 * scale


def test_moments_match_jax():
    p = planes(4)
    jm = jcol.moments([jnp.asarray(x, jnp.float32) for x in p])
    tm = tcol.moments(list(torch.as_tensor(p).unbind(0)))
    for a, b in zip(jm, tm):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-9)
    jf = jcol._moments_fused([jnp.asarray(x, jnp.float32) for x in p])
    tf = tcol._moments_fused(list(torch.as_tensor(p).unbind(0)))
    for a, b in zip(jf, tf):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-9)


def test_fused_moments_cancel_at_rest():
    p = list(torch.as_tensor(planes(0) * 0 + (WEIGHTS * 0.1)[:, None, None]
                             .astype(np.float32)).unbind(0))
    _, ux, uy, usq = tcol._moments_fused(p)
    assert torch.count_nonzero(ux) == 0 and torch.count_nonzero(uy) == 0
    assert torch.count_nonzero(tcol.u_mag(usq)) == 0


def test_u_mag_matches_jax():
    x = np.random.RandomState(5).rand(64).astype(np.float32) * 1e-3
    np.testing.assert_allclose(tcol.u_mag(torch.as_tensor(x)).numpy(),
                               np.asarray(jcol.u_mag(jnp.asarray(x, jnp.float32))),
                               rtol=1e-7)


@pytest.mark.parametrize("backend", ["pallas", "aa", "deep", "resident"])
def test_lbm_collide_does_not_reach_the_port(monkeypatch, backend):
    """The port's routes compute the fused form, the kernels' one, whatever
    ``LBM_COLLIDE`` says: a CPU run on a 16x32 box with it set to the
    literal form gives the unset run's av series and final state bit for bit."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.runtime.driver import run_simulation
    from lbm_tpu_torch.utils.geometry import box

    params = LBMParams(nx=32, ny=16, max_iters=8, reynolds_dim=10, density=0.1, accel=0.005,
                       omega=OMEGA)
    runs = []
    for env in (None, "literal"):
        if env is None:
            monkeypatch.delenv("LBM_COLLIDE", raising=False)
        else:
            monkeypatch.setenv("LBM_COLLIDE", env)
        res = run_simulation(params, box(32, 16), backend=backend, device="cpu")
        assert res.route == backend
        runs.append(res)
    np.testing.assert_array_equal(runs[1].av_vels, runs[0].av_vels)
    np.testing.assert_array_equal(runs[1].cells, runs[0].cells)
