"""c16 storage under a mesh: the plain c16 forms of K3, K8 and K10 and the
plain c16 shard steps of ``lbm_tpu_torch/parallel/sharded.py``, against the
JAX package's ``run_simulation_sharded(_2d)(dtype="c16")`` on the 8
virtual CPU devices of tests/conftest.py.

The port's shards lie on the CPU, where the kernel routes run their plain
versions; off a TPU the JAX package runs its c16 shard steps as its
decode/step/encode jnp step or its Pallas kernels in interpret mode. The
rounding points are the JAX package's: one encode per step for K3 and the
plain steps, one per pass for K8 and K10, whose halos carry the
neighbours' codes. Tolerance, as tests/test_c16.py:256-335: decoded cells
within 5e-6, the av series at rtol 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lbm_tpu import cli as jcli
from lbm_tpu.models.d2q9 import LBMParams as JParams
from lbm_tpu.parallel import sharded as jsh
from lbm_tpu.runtime import checkpoint as jckpt
from lbm_tpu.runtime import driver as jdriver
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.models.d2q9 import WEIGHTS, LBMParams
from lbm_tpu_torch.ops import band as tband
from lbm_tpu_torch.ops import band2 as tband2
from lbm_tpu_torch.ops import devspace as tdev
from lbm_tpu_torch.ops import shard_step
from lbm_tpu_torch.ops.step import run_step_plain
from lbm_tpu_torch.parallel import sharded as tsh
from lbm_tpu_torch.runtime import checkpoint as tckpt
from lbm_tpu_torch.runtime import driver as tdriver
from lbm_tpu_torch.utils.checker import check_files
from lbm_tpu_torch.utils.geometry import write_obstacle_file, write_params_file

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
SPEC = tdev.DevSpec.for_params(DENSITY, ACCEL)
CPU8 = ["cpu"] * 8


def case(nx, ny, iters, seed, n=1):
    """Params, and a mask: walls on rows 0 and ny-1, 12 random obstacles and
    one on each side of every seam of ``n`` row shards."""
    params = LBMParams(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    rng = np.random.RandomState(seed)
    obs = np.zeros((ny, nx), dtype=np.int32)
    obs[0, :] = obs[-1, :] = 1
    obs[rng.randint(1, ny - 1, 12), rng.randint(0, nx, 12)] = 1
    for z in range(1, n):
        obs[z * ny // n - 1, 3 * z] = obs[z * ny // n, 3 * z + 1] = 1
    return params, obs


def jparams(p):
    return JParams(**dataclasses.asdict(p))


def assert_c16_matches(got, want):
    assert got.cells.dtype == np.float32 and got.av_vels.dtype == np.float32
    assert np.abs(got.cells - np.asarray(want.cells)).max() < 5e-6
    np.testing.assert_allclose(got.av_vels, np.asarray(want.av_vels), rtol=1e-3)


@pytest.mark.parametrize("backend,n", [("pallas", 2), ("pallas", 4), ("auto", 4),
                                       ("reference", 2)])
def test_1d_step_routes_c16_match_jax(backend, n):
    """K3's plain c16 form (``pallas``, ``auto``) and the plain c16 shard
    step (``reference``) against the JAX package's fused kernel per shard
    (interpret) or its decode/step/encode jnp step."""
    params, obs = case(128, 64, 6, seed=n, n=n)
    got = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * n, backend=backend,
                                     dtype="c16")
    want = jsh.run_simulation_sharded(jparams(params), obs, n_devices=n, backend=backend,
                                      dtype="c16")
    assert got.route == ("pallas" if backend == "auto" else backend)
    assert_c16_matches(got, want)


def use_schedule(monkeypatch, block, depth, panel):
    """Both packages on one band schedule: the port's pickers, the JAX
    package's env knobs."""
    for module in (tband, tband2):
        monkeypatch.setattr(module, "schedule", lambda params, dtype: (block, depth, panel))
    monkeypatch.setenv("LBM_BAND_BLOCK", str(block))
    monkeypatch.setenv("LBM_BAND_DEPTH", str(depth))
    if panel is not None:
        monkeypatch.setenv("LBM_BAND_PANEL", str(panel))


@pytest.mark.parametrize("panel", [None, 128], ids=["full-row", "panel"])
@pytest.mark.parametrize("backend", ["band", "band2"])
def test_band_routes_c16_match_jax(monkeypatch, backend, panel):
    """K8 and K10 at c16 on 2 shards of 2 blocks (B 16, T 8): two passes
    whose halos are the neighbours' codes, and a 3-step remainder on the
    shard step at c16."""
    params, obs = case(128 if panel is None else 256, 64, 19, seed=7, n=2)
    use_schedule(monkeypatch, 16, 8, panel)
    got = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * 2, backend=backend,
                                     dtype="c16")
    want = jsh.run_simulation_sharded(jparams(params), obs, n_devices=2, backend=backend,
                                      dtype="c16")
    assert got.route == backend
    assert_c16_matches(got, want)


@pytest.mark.parametrize("mesh,backend", [((2, 2), "auto"), ((2, 4), "reference")])
def test_2d_c16_matches_jax(mesh, backend):
    """The plain decode/step/encode 2-D step against
    ``make_sharded_c16_jnp_step_2d`` (tests/test_c16.py:287-302's deck)."""
    params, obs = case(24, 16, 4, seed=1)
    got = tsh.run_simulation_sharded_2d(params, obs, mesh_shape=mesh, devices=CPU8,
                                        backend=backend, dtype="c16")
    want = jsh.run_simulation_sharded_2d(jparams(params), obs, mesh_shape=mesh, backend=backend,
                                         dtype="c16")
    assert got.route == "reference"
    assert_c16_matches(got, want)


def test_2d_c16_checkpoint_resume(tmp_path):
    """A 2-D c16 checkpoint holds the decoded f32 state; the resumed run
    gives the uninterrupted one's bits (tests/test_c16.py:305-326), and the
    JAX package resumes the port's checkpoint to within the tolerance."""
    params, obs = case(24, 16, 6, seed=2)
    path = tmp_path / "ck.npz"
    full = tsh.run_simulation_sharded_2d(params, obs, mesh_shape=(2, 2), devices=CPU8,
                                         dtype="c16")
    p3 = dataclasses.replace(params, max_iters=3)
    tsh.run_simulation_sharded_2d(p3, obs, mesh_shape=(2, 2), devices=CPU8, dtype="c16",
                                  checkpoint_every=3, checkpoint_path=str(path))
    cells, av, step = tckpt.load_checkpoint(path, p3)
    assert cells.dtype == np.float32 and step == 3
    resumed = tsh.run_simulation_sharded_2d(params, obs, mesh_shape=(2, 2), devices=CPU8,
                                            dtype="c16", initial_cells=cells, start_step=step,
                                            av_vels_prefix=av)
    np.testing.assert_array_equal(resumed.cells, full.cells)
    np.testing.assert_array_equal(resumed.av_vels, full.av_vels)
    jcells, jav, jstep = jckpt.load_checkpoint(path, jparams(p3))
    theirs = jsh.run_simulation_sharded_2d(jparams(params), obs, mesh_shape=(2, 2), dtype="c16",
                                           initial_cells=jcells, start_step=jstep,
                                           av_vels_prefix=jav)
    assert_c16_matches(full, theirs)


def refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("what", ["overlap-1d", "pallas-2d"])
def test_c16_mesh_refusals_word_for_word(what):
    """``pallas-overlap`` at c16 (sharded.py:1155-1156) and 2-D ``pallas`` at
    c16 (:543-544) raise with the JAX package's wording."""
    params, obs = case(24, 16, 2, seed=0)
    if what == "overlap-1d":
        got = refusal(lambda: tsh.run_simulation_sharded(
            params, obs, devices=["cpu"] * 2, backend="pallas-overlap", dtype="c16"))
        want = refusal(lambda: jsh.run_simulation_sharded(
            jparams(params), obs, n_devices=2, backend="pallas-overlap", dtype="c16"))
    else:
        got = refusal(lambda: tsh.run_simulation_sharded_2d(
            params, obs, mesh_shape=(2, 2), devices=CPU8, backend="pallas", dtype="c16"))
        want = refusal(lambda: jsh.run_simulation_sharded_2d(
            jparams(params), obs, mesh_shape=(2, 2), backend="pallas", dtype="c16"))
    assert got == want and ("c16" in got or "f32-only" in got)


@pytest.mark.parametrize("mesh,ry,rx", [((4, 1), 5, 7), ((2, 3), 4, 6), ((1, 1), 9, 7)])
def test_k3_c16_plain_is_k1_c16_plain(mesh, ry, rx):
    """K3's plain c16 form joined over the mesh is bitwise K1's plain c16
    step: the same rounding point, every step."""
    py, px = mesh
    rng = np.random.RandomState(py + 10 * px)
    ny, nx = ry * py, rx * px
    cells = torch.as_tensor(((WEIGHTS * DENSITY)[:, None, None]
                             * (1 + 0.05 * rng.rand(9, ny, nx))).astype(np.float32))
    q = tdev.encode_state(cells, SPEC)
    nobst = torch.as_tensor((rng.rand(ny, nx) > 0.2).astype(np.float32))
    m = tsh.make_mesh_2d(py, px, ["cpu"] * (py * px))
    shards, sums = shard_step.run_shard_step(tsh.split(q, m), tsh.split(nobst, m), DENSITY, ACCEL,
                                             OMEGA, 7, ny, dev=SPEC)
    want, want_av = run_step_plain(q, nobst, DENSITY, ACCEL, OMEGA, 7, 1.0, dev=SPEC)
    assert torch.equal(tsh.gather(shards), want)
    np.testing.assert_allclose(tsh.mesh_totals(sums, 1.0).numpy(), want_av.numpy(), rtol=1e-5)


@pytest.mark.parametrize("name", ["K8", "K10"])
def test_sharded_band_c16_plain_is_single_device_c16(name):
    """K8 and K10's plain c16 forms joined over 4 shards of 25 rows (ragged
    16-row tiles, T 4, a remainder) are bitwise the single-device K7 and K9
    plain c16 runs: a pass's halo codes decode to the values the whole grid
    holds there."""
    run_sharded, run_single = {"K8": (tband.run_band_sharded, tband.run_band),
                               "K10": (tband2.run_band2_sharded, tband2.run_band2)}[name]
    params, obs = case(30, 100, 11, seed=4, n=4)
    rng = np.random.RandomState(9)
    cells = torch.as_tensor(((WEIGHTS * DENSITY)[:, None, None]
                             * (1 + 0.05 * rng.rand(9, 100, 30))).astype(np.float32))
    q = tdev.encode_state(cells, SPEC)
    nobst = torch.as_tensor((obs == 0).astype(np.float32))
    m = tsh.make_mesh(devices=["cpu"] * 4)
    shards, sums = run_sharded(tsh.split(q, m), tsh.split(nobst, m), DENSITY, ACCEL, OMEGA, 11,
                               16, 4, 100, panel=12, dev=SPEC)
    want, want_av = run_single(q, nobst, DENSITY, ACCEL, OMEGA, 11, 16, 4, panel=12, dev=SPEC)
    assert tsh.gather(shards).dtype == torch.int16
    assert torch.equal(tsh.gather(shards), want)
    np.testing.assert_allclose(tsh.mesh_totals(sums, 1.0).numpy(), want_av.numpy(), rtol=1e-5)


@pytest.fixture
def deck(tmp_path):
    params, obs = case(128, 32, 9, seed=21, n=2)
    write_params_file(tmp_path / "input.params", *dataclasses.astuple(params))
    write_obstacle_file(tmp_path / "obstacles.dat", obs)
    return params, obs, str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat")


@pytest.mark.parametrize("mesh", ["2", "2x2"])
def test_cli_mesh_c16_matches_jax_cli(deck, tmp_path, capsys, mesh):
    """``--mesh 2|2x2 --precision c16`` through both CLIs (``auto``): the 1%
    checker, av_vels at rtol 1e-3, pressure within 5e-6."""
    _, _, params_path, obst_path = deck
    out, ref = tmp_path / "port", tmp_path / "jax"
    assert tcli.main([params_path, obst_path, "--device", "cpu", "--mesh", mesh, "--precision",
                      "c16", "--out-dir", str(out)]) == 0
    assert jcli.main([params_path, obst_path, "--mesh", mesh, "--precision", "c16", "--out-dir",
                      str(ref)]) == 0
    capsys.readouterr()
    files = [d / f for d in (out, ref) for f in ("av_vels.dat", "final_state.dat")]
    assert check_files(*files, tolerance=1.0).passed
    np.testing.assert_allclose(np.loadtxt(files[0], usecols=[1]), np.loadtxt(files[2], usecols=[1]),
                               rtol=1e-3)
    pressure = [np.loadtxt(f, usecols=[5]) for f in (files[1], files[3])]
    assert np.abs(pressure[0] - pressure[1]).max() < 5e-6


def test_c16_mesh_checkpoint_resumes_in_jax_single_device(deck, tmp_path):
    """A 2-shard c16 checkpoint (decoded f32) resumed by the JAX
    single-device c16 run, held against the port's uninterrupted mesh run."""
    params, obs, _, _ = deck
    path = tmp_path / "ck.npz"
    full = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * 2, dtype="c16")
    head = dataclasses.replace(params, max_iters=4)
    tsh.run_simulation_sharded(head, obs, devices=["cpu"] * 2, dtype="c16", checkpoint_every=4,
                               checkpoint_path=str(path))
    cells, av, step = jckpt.load_checkpoint(path, jparams(head))
    theirs = jdriver.run_simulation(jparams(params), obs, backend="reference", dtype="c16",
                                    initial_cells=cells, start_step=step, av_vels_prefix=av)
    assert_c16_matches(full, theirs)


def test_c16_mesh_saturation_warning(monkeypatch):
    """One saturation check covers the largest code of every shard."""
    params, obs = case(24, 16, 3, seed=3)
    monkeypatch.setenv("LBM_C16_H", "1e-6")
    with pytest.warns(UserWarning, match="saturated") as record:
        tsh.run_simulation_sharded(params, obs, devices=["cpu"] * 4, dtype="c16")
    assert len([w for w in record if "saturated" in str(w.message)]) == 1
    monkeypatch.delenv("LBM_C16_H")
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tsh.run_simulation_sharded_2d(params, obs, mesh_shape=(2, 2), devices=CPU8, dtype="c16")
