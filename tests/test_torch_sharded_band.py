"""The sharded band routes K8 (``--backend band``) and K10 (``band2``) of the
port's sharded path against the JAX package's ``run_simulation_sharded`` on
the 8 virtual CPU devices of tests/conftest.py, whose sharded band kernels
run in interpret mode.

Both packages get the same schedule: the port through its pickers
``ops/band.py::schedule``/``ops/band2.py::schedule``, patched here, the JAX
package through ``LBM_BAND_BLOCK``/``LBM_BAND_DEPTH`` (and
``LBM_BAND_PANEL`` for its panel kernels, whose 128-column x halo the port
replaces by a T-column one: the same function). The port's shards lie on
the CPU, where the routes run their plain versions. Tolerances are
tests/test_sharded.py's: cells atol 3e-7, av rtol 5e-5 and atol 3e-8.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.models.d2q9 import LBMParams as JParams
from lbm_tpu.parallel import sharded as jsh
from lbm_tpu_torch.models.d2q9 import LBMParams
from lbm_tpu_torch.ops import band as tband
from lbm_tpu_torch.ops import band2 as tband2
from lbm_tpu_torch.parallel import sharded as tsh
from lbm_tpu_torch.runtime import driver as tdriver

CELLS_ATOL, AV_RTOL, AV_ATOL = 3e-7, 5e-5, 3e-8


def band_case(ny, nx, iters, n):
    """tests/test_sharded.py's ``_band_case``, plus an obstacle on each side
    of every shard seam."""
    params = LBMParams(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10, density=0.1, accel=0.005,
                       omega=1.85)
    rng = np.random.RandomState(7)
    obs = np.zeros((ny, nx), dtype=np.int32)
    obs[0, :] = obs[-1, :] = 1
    obs[rng.randint(1, ny - 1, 12), rng.randint(0, nx, 12)] = 1
    for z in range(1, n):
        obs[z * ny // n - 1, 3 * z] = obs[z * ny // n, 3 * z + 1] = 1
    return params, obs


def use_schedule(monkeypatch, block, depth, panel):
    """The port's band pickers return ``(block, depth, panel)``."""
    for module in (tband, tband2):
        monkeypatch.setattr(module, "schedule", lambda params, dtype: (block, depth, panel))


def run_both(monkeypatch, backend, ny, nx, iters, n, block, depth, panel=None):
    params, obs = band_case(ny, nx, iters, n)
    use_schedule(monkeypatch, block, depth, panel)
    monkeypatch.setenv("LBM_BAND_BLOCK", str(block))
    monkeypatch.setenv("LBM_BAND_DEPTH", str(depth))
    if panel is not None:
        monkeypatch.setenv("LBM_BAND_PANEL", str(panel))
    want = jsh.run_simulation_sharded(JParams(**dataclasses.asdict(params)), obs, n_devices=n,
                                      backend=backend, dtype=jnp.float32)
    got = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * n, backend=backend)
    assert got.route == backend
    np.testing.assert_allclose(got.cells, np.asarray(want.cells), atol=CELLS_ATOL)
    np.testing.assert_allclose(got.av_vels, np.asarray(want.av_vels), rtol=AV_RTOL,
                               atol=AV_ATOL)


@pytest.mark.parametrize("backend", ["band", "band2"])
def test_full_row_matches_jax(monkeypatch, backend):
    """2 shards of 2 blocks, two passes and a 3-step remainder (on the
    shard step), the forcing row in the last shard."""
    run_both(monkeypatch, backend, 64, 128, 19, 2, 16, 8)


@pytest.mark.parametrize("backend", ["band", "band2"])
def test_panel_matches_jax(monkeypatch, backend):
    """Two 128-column panels, two passes and a remainder."""
    run_both(monkeypatch, backend, 64, 256, 19, 2, 16, 8, panel=128)


@pytest.mark.parametrize("backend", ["band", "band2"])
def test_forcing_row_in_a_halo_matches_jax(monkeypatch, backend):
    """4 shards: global row ny-2 lies in the last shard and in shard 0's
    upper halo; both copies are forced (one pass)."""
    run_both(monkeypatch, backend, 128, 128, 8, 4, 16, 8)


def test_band2_panel_forcing_row_in_a_halo_matches_jax(monkeypatch):
    run_both(monkeypatch, "band2", 128, 256, 8, 4, 16, 8, panel=128)


@pytest.mark.parametrize("route", ["band", "band2"])
@pytest.mark.parametrize("schedule", [(8, 4, None), (5, 2, 7), (16, 4, 40)])
def test_ragged_schedules_are_k1_plain(monkeypatch, route, schedule):
    """Shards of 25 rows under tiles that do not divide them, where the JAX
    kernels cannot go: bitwise the single-device K1 plain step, the av series
    within f32 summation order."""
    block, depth, panel = schedule
    if route == "band2" and block < 2 * depth:
        block = 2 * depth
    params, obs = band_case(100, 30, 11, 4)
    use_schedule(monkeypatch, block, depth, panel)
    got = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * 4, backend=route)
    want = tdriver.run_simulation(params, obs, device="cpu", backend="pallas")
    np.testing.assert_array_equal(got.cells, want.cells)
    np.testing.assert_allclose(got.av_vels, want.av_vels, rtol=1e-5)


def test_sharded_band_step_passes_raw_sums():
    """One pass of each route over 2 shards: the per-shard raw sums add up to
    the single-device band pass's."""
    _, obs = band_case(32, 24, 4, 2)
    rng = np.random.RandomState(3)
    cells = torch.as_tensor((0.01 * (1 + 0.05 * rng.rand(9, 32, 24))).astype(np.float32))
    nobst = torch.as_tensor((obs == 0).astype(np.float32))
    shards = [[cells[:, :16]], [cells[:, 16:]]]
    nob = [[nobst[:16]], [nobst[16:]]]
    for step, run in ((tband.step_band_sharded, tband.run_band),
                      (tband2.step_band2_sharded, tband2.run_band2)):
        out, sums = step(shards, nob, 0.1, 0.005, 1.85, 8, 4, 32, panel=12)
        want, want_av = run(cells, nobst, 0.1, 0.005, 1.85, 4, 8, 4, panel=12)
        assert sums.shape == (2, 4)
        assert torch.equal(torch.cat([out[0][0], out[1][0]], dim=1), want)
        np.testing.assert_allclose((sums[0] + sums[1]).numpy(), want_av.numpy(), rtol=1e-5)


@pytest.mark.parametrize("backend", ["band", "band2"])
def test_shallow_shards_refused_as_jax(backend):
    """Shards of 4 rows under the default depth-4 schedule pass; 2-row
    shards are refused with the JAX package's wording."""
    params, obs = band_case(16, 24, 4, 4)
    assert tsh.run_simulation_sharded(params, obs, devices=["cpu"] * 4,
                                      backend=backend).route == backend
    with pytest.raises(ValueError, match=f"local grid 2x24 unsupported by the {backend} kernel"):
        tsh.run_simulation_sharded(params, obs, devices=["cpu"] * 8, backend=backend)


@pytest.mark.parametrize("backend", ["band", "band2"])
def test_f64_refused_as_jax(backend):
    params, obs = band_case(16, 24, 4, 2)
    with pytest.raises(ValueError) as mine:
        tsh.run_simulation_sharded(params, obs, devices=["cpu"] * 2, backend=backend,
                                   dtype=torch.float64)
    with pytest.raises(ValueError) as theirs:
        jsh.run_simulation_sharded(JParams(**dataclasses.asdict(params)), obs, n_devices=2,
                                   backend=backend, dtype=jnp.float64)
    assert str(mine.value) == str(theirs.value)
