"""The port's main path end to end on the CPU, against the JAX package.

``lbm_tpu_torch.cli.main`` (what ``python -m lbm_tpu_torch`` runs) on a
generated 128x32 box deck, ``--backend auto`` at f32 with ``--device
cpu``, is held against ``lbm_tpu.cli.main`` with ``--backend reference``:
av_vels at rtol 1e-4, final_state pressure within 1e-5 of its scale and
the velocity columns within 1e-4 of theirs (f32 with a different operation
order). The routing, device and error rules
of the front door, and the rule that the port imports no JAX, are checked
here too.
"""

import ast
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from lbm_tpu import cli as jcli
from lbm_tpu.runtime import driver as jdriver
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.api import Simulation
from lbm_tpu_torch.io import read_obstacles, read_params
from lbm_tpu_torch.models.d2q9 import LBMParams
from lbm_tpu_torch.runtime import driver as tdriver
from lbm_tpu_torch.runtime.device import select_device
from lbm_tpu_torch.utils.geometry import box, write_obstacle_file, write_params_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def deck(tmp_path):
    write_params_file(tmp_path / "input.params", 128, 32, 50, 10, 0.1, 0.005, 1.85)
    write_obstacle_file(tmp_path / "obstacles.dat", box(128, 32))
    return str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat")


def test_slice_matches_jax_cli(deck, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("LBM_DEVICE", raising=False)
    t_out, j_out = tmp_path / "torch", tmp_path / "jax"
    stats = tmp_path / "stats.json"
    assert tcli.main([*deck, "--device", "cpu", "--out-dir", str(t_out),
                      "--stats-json", str(stats)]) == 0
    out = capsys.readouterr().out
    block = out[out.index("==done=="):].splitlines()
    assert block[0] == "==done=="
    assert block[1].startswith("Reynolds number:\t\t") and "E" in block[1]
    assert block[2].startswith("Elapsed time:\t\t\t") and block[2].endswith(" (s)")
    assert block[3].startswith("Elapsed user CPU time:\t\t")
    assert block[4].startswith("Elapsed system CPU time:\t")
    import json

    s = json.loads(stats.read_text())
    assert s["route"] == "aa" and s["torch_device"] == "cpu" and s["mlups"] > 0

    assert jcli.main([*deck, "--backend", "reference", "--out-dir", str(j_out)]) == 0
    t_av = np.loadtxt(t_out / "av_vels.dat", usecols=[1])
    j_av = np.loadtxt(j_out / "av_vels.dat", usecols=[1])
    assert t_av.shape == (50,)
    np.testing.assert_allclose(t_av, j_av, rtol=1e-4)
    t_fs = np.loadtxt(t_out / "final_state.dat")
    j_fs = np.loadtxt(j_out / "final_state.dat")
    np.testing.assert_array_equal(t_fs[:, [0, 1, 6]], j_fs[:, [0, 1, 6]])
    assert np.abs(t_fs[:, 5] - j_fs[:, 5]).max() < 1e-5 * np.abs(j_fs[:, 5]).max()
    # u_x, u_y, |u| are differences of populations over rho: held like the
    # |u| series, at 1e-4 of their scale.
    assert np.abs(t_fs[:, 2:5] - j_fs[:, 2:5]).max() < 1e-4 * np.abs(j_fs[:, 2:5]).max()

    # The API gives what the CLI wrote, byte for byte.
    sim = Simulation.from_files(*deck)
    result = sim.run(device="cpu")
    sim.write_outputs(result, out_dir=str(tmp_path / "api"))
    for name in ("av_vels.dat", "final_state.dat"):
        assert (tmp_path / "api" / name).read_bytes() == (t_out / name).read_bytes()


@pytest.mark.parametrize("backend", ["aa", "pallas", "reference"])
def test_routes_agree_on_cpu(backend):
    params = LBMParams(nx=40, ny=12, max_iters=9, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    obstacles = box(40, 12)
    obstacles[5, 17] = 1
    ref = tdriver.run_simulation(params, obstacles, device="cpu", backend="reference")
    res = tdriver.run_simulation(params, obstacles, device="cpu", backend=backend)
    assert res.route == backend and res.device == "cpu"
    assert np.abs(res.cells - ref.cells).max() < 1e-5 * np.abs(ref.cells).max()
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-4)
    assert res.av_vels.dtype == np.float32


def test_f64_reference_matches_jax_driver():
    params = LBMParams(nx=24, ny=16, max_iters=6, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    obstacles = box(24, 16)
    res = tdriver.run_simulation(params, obstacles, device="cpu", dtype=torch.float64)
    import jax.numpy as jnp

    from lbm_tpu.models.d2q9 import LBMParams as JParams

    want = jdriver.run_simulation(JParams(**dataclasses.asdict(params)), obstacles,
                                  backend="reference", dtype=jnp.float64)
    assert res.route == "reference" and res.cells.dtype == np.float64
    np.testing.assert_allclose(res.cells, want.cells, rtol=1e-12)
    np.testing.assert_allclose(res.av_vels, want.av_vels, rtol=1e-12)
    assert res.reynolds(params, obstacles) == pytest.approx(
        want.reynolds(JParams(**dataclasses.asdict(params)), obstacles), rel=1e-12)


@pytest.mark.parametrize("backend,dtype,ny,want", [
    ("auto", torch.float32, 32, "aa"),
    ("auto", torch.float64, 32, "reference"),
    ("auto", torch.float32, 2, "reference"),
    ("aa", torch.float32, 32, "aa"),
    ("pallas", torch.float32, 32, "pallas"),
    ("reference", torch.float32, 32, "reference"),
    ("reference", torch.float64, 32, "reference"),
    ("aa", torch.float64, 32, ValueError),
    ("pallas", torch.float64, 32, ValueError),
    ("aa", torch.float32, 2, ValueError),
    ("resident", torch.float32, 32, ValueError),
])
def test_select_route(backend, dtype, ny, want):
    params = LBMParams(nx=128, ny=ny, max_iters=1, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    if want is ValueError:
        with pytest.raises(ValueError):
            tdriver.select_route(params, backend, dtype)
    else:
        assert tdriver.select_route(params, backend, dtype) == want


@pytest.mark.parametrize("args", [(0, 100, 0, 0), (0, 100, 30, 0), (5, 100, 30, 7),
                                  (17, 40, 0, 8), (0, 9, 4, 4)])
def test_compute_chunk_sizes_matches_jax(args):
    assert tdriver.compute_chunk_sizes(*args) == jdriver.compute_chunk_sizes(*args)


def test_no_silent_cpu(deck, capsys, monkeypatch):
    """Without CUDA and without naming the CPU, the CLI exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("LBM_DEVICE", raising=False)
    assert tcli.main(list(deck)) == 1
    err = capsys.readouterr().err
    assert err.startswith("lbm_tpu_torch: error:") and "--device cpu" in err
    with pytest.raises(ValueError):
        Simulation.from_files(*deck).run()


def test_lbm_device_env_selects_cpu(monkeypatch):
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    assert select_device() == torch.device("cpu")
    monkeypatch.setenv("LBM_DEVICE", "zero")
    with pytest.raises(ValueError):
        select_device()


@pytest.mark.parametrize("extra", [["--precision", "f64", "--backend", "aa"],
                                   ["--precision", "f64", "--backend", "pallas"]])
def test_cli_rejects_f64_kernel_routes(deck, capsys, extra):
    assert tcli.main([*deck, "--device", "cpu", *extra]) == 1
    assert capsys.readouterr().err.startswith("lbm_tpu_torch: error:")


def test_cli_reports_bad_input_cleanly(tmp_path, capsys):
    (tmp_path / "bad.params").write_text("1 2\n")
    (tmp_path / "obs.dat").write_text("")
    assert tcli.main([str(tmp_path / "bad.params"), str(tmp_path / "obs.dat"),
                      "--device", "cpu"]) == 1
    assert capsys.readouterr().err.startswith("lbm_tpu_torch: error:")


def test_cli_list_devices(deck, capsys):
    assert tcli.main([*deck, "--list-devices"]) == 0
    assert "Available devices:" in capsys.readouterr().out


def test_api_mesh_not_yet_ported(deck):
    sim = Simulation.from_files(*deck)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        sim.run(device="cpu", mesh=2)
    with pytest.raises(ValueError):
        Simulation(sim.params, np.zeros((3, 3)))


def test_api_velocity_field_and_reynolds(deck):
    params = read_params(deck[0])
    sim = Simulation(params, read_obstacles(deck[1], params))
    result = sim.run(device="cpu", backend="reference")
    ux, uy, speed, pressure = sim.velocity_field(result)
    assert ux.shape == (32, 128) and np.isfinite(pressure).all()
    assert np.isfinite(sim.reynolds(result)) and sim.reynolds(result) > 0


def test_port_imports_no_jax():
    """An AST walk of every module of the port: no jax, no lbm_tpu."""
    files = glob.glob(os.path.join(REPO, "lbm_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "lbm_tpu"), f"{path} imports {name}"
