"""The band slice end to end on the CPU, against the JAX package.

``lbm_tpu_torch.cli.main`` (what ``python -m lbm_tpu_torch`` runs) with
``--backend band|band2|band3 --device cpu`` on a small "walls" deck (rows 0
and ny-1 blocked, as the JAX package's HBM-regime decks) is held against
``lbm_tpu.cli.main`` with the same backend, which runs the Pallas kernel in
interpret mode off the TPU: av_vels at rtol 1e-4, final_state pressure
within 1e-5 of its scale and the velocity columns within 1e-4 of theirs
(f32 with another operation order). The iteration count leaves a remainder
for both packages' schedules. The routing rules of the band backends, and
that the API reaches them, are checked here too.
"""

import json

import numpy as np
import pytest
import torch

from lbm_tpu import cli as jcli
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.api import Simulation
from lbm_tpu_torch.models.d2q9 import LBMParams
from lbm_tpu_torch.ops import band, band2, band3
from lbm_tpu_torch.runtime import driver as tdriver
from lbm_tpu_torch.utils.geometry import box, write_obstacle_file, write_params_file


def walls(nx, ny):
    mask = np.zeros((ny, nx), np.int32)
    mask[0, :] = mask[-1, :] = 1
    return mask


@pytest.fixture
def walls_deck(tmp_path):
    write_params_file(tmp_path / "input.params", 128, 64, 37, 10, 0.1, 0.005, 1.85)
    write_obstacle_file(tmp_path / "obstacles.dat", walls(128, 64))
    return str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat")


@pytest.mark.parametrize("backend", ["band", "band2", "band3"])
def test_band_path_matches_jax_cli(backend, walls_deck, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("LBM_DEVICE", raising=False)
    t_out, j_out = tmp_path / "torch", tmp_path / "jax"
    t_stats, j_stats = tmp_path / "t.json", tmp_path / "j.json"
    assert tcli.main([*walls_deck, "--backend", backend, "--device", "cpu", "--out-dir",
                      str(t_out), "--stats-json", str(t_stats)]) == 0
    assert jcli.main([*walls_deck, "--backend", backend, "--out-dir", str(j_out),
                      "--stats-json", str(j_stats)]) == 0
    capsys.readouterr()
    ts, js = json.loads(t_stats.read_text()), json.loads(j_stats.read_text())
    assert ts["route"] == ts["backend"] == js["backend"] == backend
    assert ts["torch_device"] == "cpu"
    t_av = np.loadtxt(t_out / "av_vels.dat", usecols=[1])
    j_av = np.loadtxt(j_out / "av_vels.dat", usecols=[1])
    assert t_av.shape == (37,)
    np.testing.assert_allclose(t_av, j_av, rtol=1e-4)
    t_fs = np.loadtxt(t_out / "final_state.dat")
    j_fs = np.loadtxt(j_out / "final_state.dat")
    np.testing.assert_array_equal(t_fs[:, [0, 1, 6]], j_fs[:, [0, 1, 6]])
    assert np.abs(t_fs[:, 5] - j_fs[:, 5]).max() < 1e-5 * np.abs(j_fs[:, 5]).max()
    assert np.abs(t_fs[:, 2:5] - j_fs[:, 2:5]).max() < 1e-4 * np.abs(j_fs[:, 2:5]).max()


@pytest.mark.parametrize("backend", ["band", "band2", "band3"])
def test_band_routes_match_step_route_on_cpu(backend):
    """A ragged grid (40 x 36) that no JAX band kernel takes: the band
    routes give K1's final state bit for bit."""
    params = LBMParams(nx=40, ny=36, max_iters=13, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    obstacles = box(40, 36)
    obstacles[9, 17] = 1
    ref = tdriver.run_simulation(params, obstacles, device="cpu", backend="pallas")
    res = tdriver.run_simulation(params, obstacles, device="cpu", backend=backend)
    assert res.route == backend and res.device == "cpu"
    np.testing.assert_array_equal(res.cells, ref.cells)
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-5)


@pytest.mark.parametrize("backend", ["band", "band2", "band3", "auto"])
def test_api_reaches_band_routes(backend):
    params = LBMParams(nx=128, ny=128, max_iters=6, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    result = Simulation(params, walls(128, 128)).run(device="cpu", backend=backend)
    assert result.route == ("resident" if backend == "auto" else backend)
    assert result.av_vels.shape == (6,) and np.isfinite(result.cells).all()


@pytest.mark.parametrize("backend,dtype,ny,nx,want", [
    ("band", torch.float32, 64, 128, "band"),
    ("band2", torch.float32, 64, 128, "band2"),
    ("band3", torch.float32, 64, 128, "band3"),
    ("band3", torch.float32, 2, 7, "band3"),
    # auto ran K11 (band3) and K2 (aa) on these grids until K4 (resident)
    # took every grid up to 384^2; the ids are the earlier ones.
    pytest.param("auto", torch.float32, 128, 128, "resident", id="auto-dtype4-128-128-band3"),
    pytest.param("auto", torch.float32, 127, 128, "resident", id="auto-dtype5-127-128-aa"),
    ("auto", torch.float64, 128, 128, "reference"),
    ("band", torch.float64, 64, 128, ValueError),
    ("band2", torch.float64, 64, 128, ValueError),
    ("band3", torch.float64, 64, 128, ValueError),
    ("band", torch.float32, 1, 128, ValueError),
    ("band2", torch.float32, 1, 128, ValueError),
    ("band3", torch.float32, 1, 128, ValueError),
    # auto ran K11 (band3) above K4's states until K6 (deep) took them; the
    # id is the earlier one.
    pytest.param("auto", torch.float32, 512, 512, "deep", id="auto-dtype13-512-512-band3"),
])
def test_select_route_band(backend, dtype, ny, nx, want):
    params = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    if want is ValueError:
        with pytest.raises(ValueError):
            tdriver.select_route(params, backend, dtype)
    else:
        assert tdriver.select_route(params, backend, dtype) == want


@pytest.mark.parametrize("config", [band.schedule, band2.schedule, band3.schedule])
def test_band_configs(config):
    params = LBMParams(nx=4096, ny=4096, max_iters=1, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    block, depth, panel = config(params, torch.float32)
    assert block >= 2 * depth and depth % 2 == 0 and panel >= 1
    assert config(params, torch.float64) is None


@pytest.mark.parametrize("backend", ["band", "band2", "band3"])
def test_cli_rejects_f64_band_routes(backend, walls_deck, capsys):
    assert tcli.main([*walls_deck, "--device", "cpu", "--precision", "f64",
                      "--backend", backend]) == 1
    assert capsys.readouterr().err.startswith("lbm_tpu_torch: error:")
