"""The resident, temporal and deep routes end to end on the CPU, against the
JAX package.

``lbm_tpu_torch.cli.main`` (what ``python -m lbm_tpu_torch`` runs) with
``--backend resident|temporal|deep --device cpu`` on a small "walls" deck
is held against ``lbm_tpu.cli.main`` with the same backend, which runs the
Pallas kernel in interpret mode off the TPU: av_vels at rtol 1e-4, and
both output files through the port's 1% checker (``utils/checker``), the
reference's gate. The iteration count leaves a remainder for the temporal
and deep schedules of both packages. The routing rules of the three
backends, their f64 and unsupported-grid errors, and that the API reaches
them, are checked here too.
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from lbm_tpu import cli as jcli
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.api import Simulation
from lbm_tpu_torch.models.d2q9 import LBMParams
from lbm_tpu_torch.ops import _build, deep, resident, temporal
from lbm_tpu_torch.runtime import driver as tdriver
from lbm_tpu_torch.utils.checker import check_files
from lbm_tpu_torch.utils.geometry import write_obstacle_file, write_params_file

ROUTES = ["resident", "temporal", "deep"]


def walls(nx, ny):
    mask = np.zeros((ny, nx), np.int32)
    mask[0, :] = mask[-1, :] = 1
    mask[ny // 3, nx // 4:nx // 2] = 1
    return mask


@pytest.fixture
def walls_deck(tmp_path):
    write_params_file(tmp_path / "input.params", 128, 64, 37, 10, 0.1, 0.005, 1.85)
    write_obstacle_file(tmp_path / "obstacles.dat", walls(128, 64))
    return str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat")


@pytest.mark.parametrize("backend", ROUTES)
def test_schedule_path_matches_jax_cli(backend, walls_deck, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("LBM_DEVICE", raising=False)
    t_out, j_out = tmp_path / "torch", tmp_path / "jax"
    t_stats = tmp_path / "t.json"
    assert tcli.main([*walls_deck, "--backend", backend, "--device", "cpu", "--out-dir",
                      str(t_out), "--stats-json", str(t_stats)]) == 0
    assert jcli.main([*walls_deck, "--backend", backend, "--out-dir", str(j_out)]) == 0
    capsys.readouterr()
    ts = json.loads(t_stats.read_text())
    assert ts["route"] == ts["backend"] == backend and ts["torch_device"] == "cpu"
    t_av = np.loadtxt(t_out / "av_vels.dat", usecols=[1])
    j_av = np.loadtxt(j_out / "av_vels.dat", usecols=[1])
    assert t_av.shape == (37,)
    np.testing.assert_allclose(t_av, j_av, rtol=1e-4)
    res = check_files(t_out / "av_vels.dat", t_out / "final_state.dat",
                      j_out / "av_vels.dat", j_out / "final_state.dat", tolerance=1.0)
    assert res.passed


@pytest.mark.parametrize("backend", ROUTES)
def test_schedule_routes_match_step_route_on_cpu(backend):
    """A ragged grid (40 x 37) that no JAX kernel of these routes takes:
    the final state equals K1's route bit for bit."""
    params = LBMParams(nx=40, ny=37, max_iters=13, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    obstacles = walls(40, 37)
    ref = tdriver.run_simulation(params, obstacles, device="cpu", backend="pallas")
    res = tdriver.run_simulation(params, obstacles, device="cpu", backend=backend)
    assert res.route == backend and res.device == "cpu"
    np.testing.assert_array_equal(res.cells, ref.cells)
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-5)


@pytest.mark.parametrize("backend", ROUTES)
def test_api_reaches_schedule_routes(backend):
    params = LBMParams(nx=64, ny=32, max_iters=9, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    result = Simulation(params, walls(64, 32)).run(device="cpu", backend=backend)
    assert result.route == backend
    assert result.av_vels.shape == (9,) and np.isfinite(result.cells).all()


@pytest.mark.parametrize("backend,dtype,ny,nx,want", [
    ("resident", torch.float32, 64, 128, "resident"),
    ("resident", torch.float32, 2, 7, "resident"),
    ("temporal", torch.float32, 64, 128, "temporal"),
    ("temporal", torch.float32, 1000, 1000, "temporal"),
    ("deep", torch.float32, 64, 128, "deep"),
    ("deep", torch.float32, 2, 7, "deep"),
    ("resident", torch.float64, 64, 128, ValueError),
    ("temporal", torch.float64, 64, 128, ValueError),
    ("deep", torch.float64, 64, 128, ValueError),
    ("resident", torch.float32, 1, 128, ValueError),
    ("temporal", torch.float32, 1, 128, ValueError),
    ("deep", torch.float32, 1, 128, ValueError),
    ("temporal", torch.float32, 289, 128, ValueError),  # a last block of 1 row < T in every tier
    ("temporal", torch.float32, 33, 128, "temporal"),  # 24-row blocks: a last block of 9 rows
])
def test_select_route_schedule(backend, dtype, ny, nx, want):
    params = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    if want is ValueError:
        with pytest.raises(ValueError):
            tdriver.select_route(params, backend, dtype)
    else:
        assert tdriver.select_route(params, backend, dtype) == want


def test_schedule_configs():
    params = LBMParams(nx=4096, ny=4096, max_iters=1, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    for schedule in (temporal.schedule, deep.schedule):
        block, depth, panel = schedule(params, torch.float32)
        assert 1 <= depth <= block and panel >= 1
        assert schedule(params, torch.float64) is None
    assert resident.CHUNK_STEPS >= 1
    with pytest.raises(ValueError):
        tdriver.select_route(params, "resident", torch.float64)


# K5's and K6's schedule per side of a square grid, and its tiles and the
# tiles of its last round of TRAP_SLOTS blocks when partial: at 1024^2 two
# whole rounds and 23 tiles, kept (a cut into whole rounds ran slower).
TRAPEZOID_PICKS = {256: ((24, 4, 24), (121, 121)), 512: ((32, 4, 40), (208, 208)),
                   1024: ((36, 4, 56), (551, 23)), 2048: ((36, 4, 56), (2109, 261)),
                   4096: ((36, 4, 56), (8436, 252))}


@pytest.mark.parametrize("n", list(TRAPEZOID_PICKS))
@pytest.mark.parametrize("module", [temporal, deep], ids=["temporal_config", "deep_config"])
def test_trapezoid_schedule_and_its_rounds(module, n):
    """K5's and K6's schedules at 256^2-4096^2 in every storage: the tiers'
    pick, a window compiled with constant strides, and its tiles per pass
    and in a partial last round (``ops/temporal.py::tiles_of_pass``)."""
    params = LBMParams(nx=n, ny=n, max_iters=1, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    want, tiles = TRAPEZOID_PICKS[n]
    for dtype in (torch.float32, "c16", torch.bfloat16):
        cfg = module.schedule(params, dtype)
        assert cfg == want and cfg in [c for c, _ in temporal.TRAPEZOID_TIERS]
        assert (cfg[2] + 2 * cfg[1], cfg[0] + 2 * cfg[1]) in _build.trap_windows()
        assert temporal.tiles_of_pass(n, n, cfg[0], cfg[2]) == tiles


def test_ops_never_import_the_driver():
    """The kernel layer keeps its schedules in its own modules: no
    ``ops/*.py`` imports ``runtime.driver``, and ``_build.trap_windows``
    does not load it. The package's ``__init__`` imports the driver, so a
    fresh interpreter drops it from ``sys.modules`` and from
    ``lbm_tpu_torch.runtime`` before the call and checks that the call does
    not load it again."""
    driver = "lbm_tpu_torch.runtime.driver"
    ops = pathlib.Path(_build.__file__).parent
    for path in sorted(ops.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            assert not any(n.startswith(driver) for n in names), f"{path.name} imports the driver"
    code = ("import sys; import lbm_tpu_torch.ops._build as b; import lbm_tpu_torch.runtime as r; "
            f"del sys.modules[{driver!r}], r.driver; b.trap_windows(); "
            f"print({driver!r} in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ops.parent.parent, timeout=120, check=True)
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("backend", ROUTES)
def test_cli_rejects_f64_schedule_routes(backend, walls_deck, capsys):
    assert tcli.main([*walls_deck, "--device", "cpu", "--precision", "f64",
                      "--backend", backend]) == 1
    assert capsys.readouterr().err.startswith("lbm_tpu_torch: error:")
