"""The deep route (``lbm_tpu_torch/ops/deep.py``) against the JAX Pallas
kernel ``pallas_deep._kernel``, run as tests/test_deep.py runs it
(``interpret=True``) on the CPU.

``run_deep_plain`` takes the same passes on full rows, the halo rows read
from the input state, the function kernel K6 computes on 2-D tiles; the
card holds K6 against it (``chip_smoke.py`` and tests/test_torch_cuda.py).
Tolerances as tests/test_deep.py: cells within 1e-5 of the state's scale,
per-step |u| sums at rtol 1e-4 (f32, another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import pallas_deep as jd
from lbm_tpu_torch.models.d2q9 import WEIGHTS
from lbm_tpu_torch.ops import deep as td
from lbm_tpu_torch.ops import step as tstep

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85


def make_setup(nx, ny, seed=7):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 10), rng.randint(0, nx, 10)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    return state.astype(np.float32), (obstacles == 0).astype(np.float32)


def assert_matches_jax(state, nobst, steps, block, depth):
    want, want_tot = jd.run_deep(jnp.asarray(state), jnp.asarray(nobst), DENSITY, ACCEL, OMEGA,
                                 steps, block, depth, interpret=True, paired="fused")
    cells, av = td.run_deep(torch.as_tensor(state), torch.as_tensor(nobst), DENSITY, ACCEL,
                            OMEGA, steps, block, depth)
    want = np.asarray(want)
    assert av.shape == (steps,)
    assert np.abs(cells.numpy() - want).max() < 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(av.numpy(), np.asarray(want_tot), rtol=1e-4)


@pytest.mark.parametrize("steps", [8, 19])
def test_deep_plain_matches_pallas_b16_t8(steps):
    """One pass, and two passes with a K1 remainder of 3."""
    state, nobst = make_setup(128, 32, seed=steps)
    assert_matches_jax(state, nobst, steps, 16, 8)


def test_deep_forcing_row_near_wrap():
    """From rest only the forcing makes a signal; at B16 T8 on 32 rows the
    forcing row ny-2 sits in the last block and in block 0's wrapped halo
    (tests/test_deep.py::test_deep_forcing_row_near_wrap)."""
    ny, nx = 32, 128
    state = np.broadcast_to((WEIGHTS * DENSITY)[:, None, None], (9, ny, nx)).astype(np.float32)
    nobst = np.ones((ny, nx), np.float32)
    nobst[0] = nobst[-1] = 0.0
    assert_matches_jax(state, nobst, 8, 16, 8)


def test_step_deep_is_one_pass():
    state, nobst = make_setup(64, 32, seed=2)
    cells, nob = torch.as_tensor(state), torch.as_tensor(nobst)
    one, sums = td.step_deep(cells, nob, DENSITY, ACCEL, OMEGA, 16, 8, panel=24)
    want, want_av = td.run_deep(cells, nob, DENSITY, ACCEL, OMEGA, 8, 16, 8, panel=24)
    assert torch.equal(one, want) and torch.equal(sums, want_av)


@pytest.mark.parametrize("block,depth", [(8, 4), (16, 3), (12, 2), (37, 5), (64, 8)])
def test_deep_plain_matches_step_at_ragged_shape(block, depth):
    """37 x 40 with blocks that do not divide the grid (a last block shorter
    than T, and blocks taller than the grid), where the JAX kernel cannot
    go: bitwise equal to K1's plain step."""
    state, nobst = make_setup(40, 37, seed=block)
    cells, nob = torch.as_tensor(state), torch.as_tensor(nobst)
    want, want_av = tstep.run_step_plain(cells, nob, DENSITY, ACCEL, OMEGA, 13, 1.0)
    got, av = td.run_deep(cells, nob, DENSITY, ACCEL, OMEGA, 13, block, depth, panel=16)
    assert torch.equal(got, want)
    np.testing.assert_allclose(av.numpy(), want_av.numpy(), rtol=1e-5)


def test_run_deep_leaves_input_unchanged():
    state, nobst = make_setup(64, 32)
    cells = torch.as_tensor(state.copy())
    td.run_deep(cells, torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA, 11, 16, 8)
    np.testing.assert_array_equal(cells.numpy(), state)


def test_deep_supported():
    assert td.deep_supported(64, 128, 64, 8)
    assert td.deep_supported(37, 40, 12, 5, 16)   # no T % 8, B % T or tiling constraint
    assert not td.deep_supported(1, 128, 16, 8)   # ny < 2
    assert not td.deep_supported(64, 128, 16, 0)


@pytest.mark.parametrize("bad", ["depth", "device", "dtype"])
def test_run_deep_rejects_bad_inputs(bad):
    state, nobst = make_setup(64, 32)
    cells, nob = torch.as_tensor(state), torch.as_tensor(nobst)
    depth = 8
    if bad == "depth":
        depth = 0
    elif bad == "device":
        cells, nob = cells.to("meta"), nob.to("meta")
    else:
        nob = nob.double()
    with pytest.raises(ValueError):
        td.run_deep(cells, nob, DENSITY, ACCEL, OMEGA, 8, 16, depth, panel=16)
