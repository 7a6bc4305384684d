"""The temporal route (``lbm_tpu_torch/ops/temporal.py``) against the JAX
Pallas kernel ``pallas_temporal._kernel``, run as tests/test_temporal.py
runs it (``interpret=True``) on the CPU.

``step_t_plain`` is one pass on full rows with the carried row packs, the
function kernel K5 computes on 2-D tiles; the card holds K5 against it
(``chip_smoke.py`` and tests/test_torch_cuda.py). The packs come back in
the JAX package's order, ``(cells, last_t, first_t)``, although the kernel
emits a block's first rows before its last (pallas_temporal.py:342-345):
the pass test compares both packs by name. Tolerances as
tests/test_temporal.py: cells within 1e-5 of the state's scale, per-step
|u| sums at rtol 1e-4 (f32, another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import pallas_temporal as jt
from lbm_tpu_torch.models.d2q9 import WEIGHTS
from lbm_tpu_torch.ops import step as tstep
from lbm_tpu_torch.ops import temporal as tt

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85


def make_setup(nx, ny, seed=5):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 10), rng.randint(0, nx, 10)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    return state.astype(np.float32), (obstacles == 0).astype(np.float32)


def close(got, want):
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() < 1e-5 * np.abs(want).max()


def test_make_halos_t_matches_jax():
    state, _ = make_setup(128, 32)
    last, first = tt.make_halos_t(torch.as_tensor(state), 8, 4)
    j_last, j_first = jt.make_halos_t(jnp.asarray(state), 8, 4)
    np.testing.assert_array_equal(last.numpy(), np.asarray(j_last))
    np.testing.assert_array_equal(first.numpy(), np.asarray(j_first))


@pytest.mark.parametrize("block,depth", [(8, 2), (16, 4)])
def test_step_t_plain_matches_pallas_pass(block, depth):
    """One pass from packs that do NOT equal the state's rows, so the halo
    must come from the packs: cells and both output packs."""
    state, nobst = make_setup(128, 32, seed=block)
    rng = np.random.RandomState(depth)
    last, first = jt.make_halos_t(jnp.asarray(state), block, depth)
    last = np.asarray(last) * np.float32(1 + 0.01 * rng.rand())
    first = np.asarray(first) * np.float32(1 - 0.01 * rng.rand())
    nob = jnp.asarray(nobst)
    (j_cells, j_last, j_first), j_sums = jt.step_t_pallas(
        (jnp.asarray(state), jnp.asarray(last), jnp.asarray(first)),
        jt.nobst_ext(nob, block, depth, jnp.float32), jnp.ones((1, 1), jnp.float32),
        DENSITY, ACCEL, OMEGA, block, depth, interpret=True, paired="fused")
    (cells, t_last, t_first), sums = tt.step_t(
        (torch.as_tensor(state), torch.as_tensor(last), torch.as_tensor(first)),
        torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA, block, depth)
    close(cells, j_cells)
    close(t_last, j_last)
    close(t_first, j_first)
    np.testing.assert_allclose(sums.numpy(), np.stack([np.asarray(s) for s in j_sums]),
                               rtol=1e-4)


@pytest.mark.parametrize("block,depth,steps", [(8, 2, 7), (16, 2, 5), (8, 4, 9), (16, 4, 11)])
def test_run_temporal_plain_matches_pallas(block, depth, steps):
    """Passes plus a remainder on K1's route."""
    state, nobst = make_setup(128, 32, seed=steps)
    want, want_tot = jt.run_temporal(jnp.asarray(state), jnp.asarray(nobst), DENSITY, ACCEL,
                                     OMEGA, steps, block, depth, interpret=True, paired="fused")
    cells, av = tt.run_temporal(torch.as_tensor(state), torch.as_tensor(nobst), DENSITY, ACCEL,
                                OMEGA, steps, block, depth)
    assert av.shape == (steps,)
    close(cells, want)
    np.testing.assert_allclose(av.numpy(), np.asarray(want_tot), rtol=1e-4)


def test_temporal_single_block_wrap():
    """One block of all 16 rows wraps onto itself: both copies of row ny-2
    in its window are forced (tests/test_temporal.py::
    test_temporal_single_block_wrap)."""
    state, nobst = make_setup(128, 16, seed=9)
    want, want_tot = jt.run_temporal(jnp.asarray(state), jnp.asarray(nobst), DENSITY, ACCEL,
                                     OMEGA, 8, 16, 4, interpret=True, paired="fused")
    cells, av = tt.run_temporal(torch.as_tensor(state), torch.as_tensor(nobst), DENSITY, ACCEL,
                                OMEGA, 8, 16, 4)
    close(cells, want)
    np.testing.assert_allclose(av.numpy(), np.asarray(want_tot), rtol=1e-4)


@pytest.mark.parametrize("block,depth", [(8, 4), (16, 3), (37, 5), (5, 1), (40, 6)])
def test_temporal_plain_matches_step_at_ragged_shape(block, depth):
    """37 x 40 with blocks that do not divide the grid (and one taller than
    it), where the JAX kernel cannot go: bitwise equal to K1's plain step."""
    state, nobst = make_setup(40, 37, seed=block)
    cells, nob = torch.as_tensor(state), torch.as_tensor(nobst)
    want, want_av = tstep.run_step_plain(cells, nob, DENSITY, ACCEL, OMEGA, 13, 1.0)
    got, av = tt.run_temporal(cells, nob, DENSITY, ACCEL, OMEGA, 13, block, depth, panel=16)
    assert torch.equal(got, want)
    np.testing.assert_allclose(av.numpy(), want_av.numpy(), rtol=1e-5)


def test_run_temporal_leaves_input_unchanged():
    state, nobst = make_setup(64, 32)
    cells = torch.as_tensor(state.copy())
    tt.run_temporal(cells, torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA, 11, 16, 4)
    np.testing.assert_array_equal(cells.numpy(), state)


def test_temporal_supported():
    assert tt.temporal_supported(64, 128, 16, 4)
    assert tt.temporal_supported(1000, 1000, 16, 4)     # ragged: last block of 8 rows
    assert tt.temporal_supported(60, 100, 5, 1, 24)     # no tiling constraint
    assert tt.temporal_supported(1001, 128, 16, 4)      # last block of 9 rows
    assert not tt.temporal_supported(1009, 128, 16, 4)  # last block of 1 row < T
    assert not tt.temporal_supported(64, 128, 4, 8)     # T > B
    assert not tt.temporal_supported(1, 128, 16, 1)     # ny < 2


@pytest.mark.parametrize("bad", ["depth", "device", "dtype"])
def test_run_temporal_rejects_bad_inputs(bad):
    state, nobst = make_setup(64, 32)
    cells, nob = torch.as_tensor(state), torch.as_tensor(nobst)
    depth = 4
    if bad == "depth":
        depth = 0
    elif bad == "device":
        cells, nob = cells.to("meta"), nob.to("meta")
    else:
        nob = nob.double()
    with pytest.raises(ValueError):
        tt.run_temporal(cells, nob, DENSITY, ACCEL, OMEGA, 8, 16, depth, panel=16)
