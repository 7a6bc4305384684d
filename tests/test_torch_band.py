"""The value-carrying band route (``lbm_tpu_torch/ops/band.py``) against the
JAX Pallas kernels ``pallas_band._kernel`` (full row) and ``_kernel_panel``,
run as tests/test_band.py runs them (``run_band(..., interpret=True)``) on
the CPU.

``run_band_plain`` takes the band schedule's passes on all windows at once,
with the window wrap and the generalised forcing rows of the CUDA kernel K7,
so holding it against the JAX kernels checks K7's schedule; the card holds
K7 against ``run_band_plain`` (``chip_smoke.py`` and
tests/test_torch_cuda.py). Tolerances as tests/test_band.py: cells within
1e-5 of the state's scale, per-step |u| sums at rtol 1e-4 (f32, another
summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import pallas_band as jb
from lbm_tpu_torch.models.d2q9 import WEIGHTS
from lbm_tpu_torch.ops import band as tb
from lbm_tpu_torch.ops import step as tstep

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85


def make_setup(nx, ny, seed=5):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 10), rng.randint(0, nx, 10)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    return state.astype(np.float32), (obstacles == 0).astype(np.float32)


def assert_matches_jax(state, nobst, n, block, depth, *, panel=None):
    kw = {} if panel is None else {"panel": panel, "halo": 128}
    want, want_tot = jb.run_band(
        jnp.asarray(state, jnp.float32), jnp.asarray(nobst, jnp.float32), DENSITY, ACCEL,
        OMEGA, n, block, depth, interpret=True, paired="fused", **kw,
    )
    cells, av = tb.run_band(torch.as_tensor(state), torch.as_tensor(nobst), DENSITY, ACCEL,
                              OMEGA, n, block, depth, panel=panel)
    want = np.asarray(want)
    assert cells.dtype == torch.float32 and av.shape == (n,)
    assert np.abs(cells.numpy() - want).max() < 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(av.numpy(), np.asarray(want_tot), rtol=1e-4)


@pytest.mark.parametrize("passes,rem", [(1, 0), (2, 3)], ids=["one-pass", "2T+3"])
@pytest.mark.parametrize("block,depth", [(16, 8), (32, 8), (32, 16)])
def test_band_plain_matches_pallas_band(block, depth, passes, rem):
    """Full row: the JAX kernel's (B+2T, nx) buffer is the port's panel=None."""
    state, nobst = make_setup(128, 64, seed=block + depth + passes)
    assert_matches_jax(state, nobst, passes * depth + rem, block, depth)


def test_band_plain_matches_pallas_band_panel():
    """The JAX panel variant (P=128, H=128) against the port's 128-column
    tiles with their T-column halo: the same function."""
    state, nobst = make_setup(256, 64, seed=11)
    assert_matches_jax(state, nobst, 2 * 8 + 3, 32, 8, panel=128)


def test_band_forcing_from_rest():
    """From rest only the forcing makes a signal: the forcing rows at the
    window edges (the TPU's gated positions) and the pass hand-off carry it
    (tests/test_band.py:35-49)."""
    ny, nx = 64, 128
    state = np.broadcast_to((WEIGHTS * DENSITY)[:, None, None], (9, ny, nx)).astype(np.float32)
    nobst = np.ones((ny, nx), np.float32)
    nobst[0] = nobst[-1] = 0.0
    assert_matches_jax(state, nobst, 16, 32, 16)


@pytest.mark.parametrize("block,depth,panel", [(8, 4, 12), (5, 3, 7), (8, 4, None)])
def test_band_plain_matches_step_at_ragged_shape(block, depth, panel):
    """40 x 36 with tiles that do not divide the grid, where the JAX kernels
    cannot go: bitwise equal to K1's plain step (same arithmetic)."""
    state, nobst = make_setup(36, 40, seed=4)
    cells, nob = torch.as_tensor(state), torch.as_tensor(nobst)
    want, want_av = tstep.run_step_plain(cells, nob, DENSITY, ACCEL, OMEGA, 11, 1.0)
    got, av = tb.run_band(cells, nob, DENSITY, ACCEL, OMEGA, 11, block, depth, panel=panel)
    assert torch.equal(got, want)
    np.testing.assert_allclose(av.numpy(), want_av.numpy(), rtol=1e-5)


def test_run_band_leaves_input_unchanged():
    state, nobst = make_setup(64, 32)
    cells = torch.as_tensor(state.copy())
    tb.run_band(cells, torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA, 11, 16, 4, panel=20)
    np.testing.assert_array_equal(cells.numpy(), state)


def test_band_supported():
    assert tb.band_supported(64, 128, 16, 8)
    assert tb.band_supported(64, 128, 8, 8)       # no block >= 2T rule
    assert tb.band_supported(64, 128, 5, 3, 7)    # any tile and depth
    assert not tb.band_supported(1, 128, 16, 8)   # ny < 2
    assert not tb.band_supported(64, 128, 16, 0)


@pytest.mark.parametrize("bad", ["depth", "device", "dtype"])
def test_run_band_rejects_bad_inputs(bad):
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
        tb.run_band(cells, nob, DENSITY, ACCEL, OMEGA, 16, 16, depth, panel=16)
