"""The fused one-step route (``lbm_tpu_torch/ops/step.py``) against the JAX
Pallas kernel ``pallas_step._kernel``, run in interpret mode on the CPU.

Tolerances, as tests/test_aa.py holds the JAX kernels: cells within 1e-5 of
the state's scale and per-step |u| sums at rtol 1e-4 (f32 with a different
operation order in the sums). The CUDA kernel K1 is held against
``step_plain`` on the card by ``chip_smoke.py`` and tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops.pallas_step import _prepare_obstacles, lbm_step_pallas_interpret
from lbm_tpu_torch.models.d2q9 import WEIGHTS
from lbm_tpu_torch.ops import step as tstep

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85


def make_setup(nx, ny, seed=3):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 8), rng.randint(0, nx, 8)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    return state.astype(np.float32), obstacles


def jax_steps(state, obstacles, iters, block):
    cells = jnp.asarray(state, jnp.float32)
    nobst = _prepare_obstacles(jnp.asarray(obstacles), jnp.float32)
    tots = []
    for _ in range(iters):
        cells, tot = lbm_step_pallas_interpret(cells, nobst, DENSITY, ACCEL, OMEGA,
                                               paired="fused", block=block)
        tots.append(float(tot))
    return np.asarray(cells), np.asarray(tots)


def nobst_of(obstacles):
    return torch.as_tensor((obstacles == 0).astype(np.float32))


@pytest.mark.parametrize("ny,block", [(16, 16), (24, 8)], ids=["128x16", "128x24-3blocks"])
@pytest.mark.parametrize("iters", [1, 2, 5])
def test_step_plain_matches_pallas_kernel(iters, ny, block):
    state, obstacles = make_setup(128, ny, seed=ny + iters)
    want, want_tot = jax_steps(state, obstacles, iters, block)
    cells, av = tstep.run_step(torch.as_tensor(state), nobst_of(obstacles), DENSITY,
                               ACCEL, OMEGA, iters, 1.0)
    scale = np.abs(want).max()
    assert cells.dtype == torch.float32 and av.shape == (iters,)
    assert np.abs(cells.numpy() - want).max() < 1e-5 * scale
    np.testing.assert_allclose(av.numpy(), want_tot, rtol=1e-4)


def test_step_plain_av_scaled_by_inv_tot_cells():
    state, obstacles = make_setup(128, 16)
    inv = float(np.float32(1.0 / np.sum(obstacles == 0)))
    _, raw = tstep.run_step(torch.as_tensor(state), nobst_of(obstacles), DENSITY, ACCEL,
                            OMEGA, 3, 1.0)
    _, av = tstep.run_step(torch.as_tensor(state), nobst_of(obstacles), DENSITY, ACCEL,
                           OMEGA, 3, inv)
    np.testing.assert_array_equal(av.numpy(), (raw * torch.tensor(inv)).numpy())


def test_run_step_leaves_input_unchanged():
    state, obstacles = make_setup(128, 16)
    cells = torch.as_tensor(state.copy())
    tstep.run_step(cells, nobst_of(obstacles), DENSITY, ACCEL, OMEGA, 2, 1.0)
    np.testing.assert_array_equal(cells.numpy(), state)


def test_kernel_scalars_are_the_python_constants():
    w1a, w2a, beta, ow0, ow1, ow2, inv = tstep.kernel_scalars(DENSITY, ACCEL, OMEGA, 0.25)
    assert (w1a, w2a) == (DENSITY * ACCEL / 9.0, DENSITY * ACCEL / 36.0)
    assert beta == 1.0 - OMEGA and inv == 0.25
    assert (ow0, ow1, ow2) == (OMEGA * (4.0 / 9.0), OMEGA * (1.0 / 9.0), OMEGA * (1.0 / 36.0))


@pytest.mark.parametrize("bad", ["shape", "dtype", "mask", "ny", "steps", "device"])
def test_run_step_rejects_bad_inputs(bad):
    state, obstacles = make_setup(128, 16)
    cells, nobst, n = torch.as_tensor(state), nobst_of(obstacles), 2
    if bad == "shape":
        cells = cells[:8]
    elif bad == "dtype":
        cells = cells.double()
    elif bad == "mask":
        nobst = nobst[:8]
    elif bad == "ny":
        cells, nobst = cells[:, :1], nobst[:1]
    elif bad == "steps":
        n = 0
    else:
        cells, nobst = cells.to("meta"), nobst.to("meta")
    with pytest.raises(ValueError):
        tstep.run_step(cells, nobst, DENSITY, ACCEL, OMEGA, n, 1.0)
