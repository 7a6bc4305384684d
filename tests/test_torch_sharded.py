"""The port's sharded path (``lbm_tpu_torch/parallel/sharded.py``, the shard
step K3/K12 of ``ops/shard_step.py``) against the JAX package's
``run_simulation_sharded`` and ``run_simulation_sharded_2d`` on the 8
virtual CPU devices of tests/conftest.py.

The port's shards lie on the CPU (``devices=["cpu"] * n``), where the
kernel routes run their plain versions; the JAX ``pallas`` and
``pallas-overlap`` steps run their Pallas kernels in interpret mode.
Tolerances are tests/test_sharded.py's: cells within atol 3e-7, the av
series at rtol 5e-5 and atol 3e-8 (f32, another summation order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu import cli as jcli
from lbm_tpu.models.d2q9 import LBMParams as JParams
from lbm_tpu.parallel import sharded as jsh
from lbm_tpu.runtime import checkpoint as jckpt
from lbm_tpu.runtime import driver as jdriver
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.api import Simulation
from lbm_tpu_torch.models.d2q9 import LBMParams
from lbm_tpu_torch.ops import shard_step
from lbm_tpu_torch.ops.step import run_step_plain
from lbm_tpu_torch.parallel import sharded as tsh
from lbm_tpu_torch.runtime import checkpoint as tckpt
from lbm_tpu_torch.runtime import driver as tdriver
from lbm_tpu_torch.utils.checker import check_files
from lbm_tpu_torch.utils.geometry import write_obstacle_file, write_params_file

CELLS_ATOL, AV_RTOL, AV_ATOL = 3e-7, 5e-5, 3e-8
CPU8 = ["cpu"] * 8


def case(nx, ny, iters, seed, seams=()):
    """Params, and a mask: walls on rows 0 and ny-1, 12 random obstacles and
    one obstacle on each side of the given ``(row, col)`` shard seams."""
    params = LBMParams(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10, density=0.1, accel=0.005,
                       omega=1.85)
    rng = np.random.RandomState(seed)
    obs = np.zeros((ny, nx), dtype=np.int32)
    obs[0, :] = obs[-1, :] = 1
    obs[rng.randint(1, ny - 1, 12), rng.randint(0, nx, 12)] = 1
    for r, c in seams:
        obs[r - 1, c - 1] = obs[r, c] = 1
    return params, obs


def jparams(p):
    return JParams(**dataclasses.asdict(p))


def assert_matches(got, want):
    np.testing.assert_allclose(got.cells, np.asarray(want.cells), atol=CELLS_ATOL)
    np.testing.assert_allclose(got.av_vels, np.asarray(want.av_vels), rtol=AV_RTOL, atol=AV_ATOL)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_reference_matches_jax(n):
    params, obs = case(24, 16, 20, seed=42, seams=[(16 // n, 12)])
    got = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * n, backend="reference")
    want = jsh.run_simulation_sharded(jparams(params), obs, n_devices=n, backend="reference",
                                      dtype=jnp.float32)
    assert got.route == "reference" and got.shard_devices == ("cpu",) * n
    assert_matches(got, want)


def test_reference_f64_matches_jax_single_device():
    """f64: the sharded reference step is the single-device one's to 1e-11."""
    params, obs = case(24, 16, 20, seed=1)
    got = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * 4, backend="reference",
                                     dtype=torch.float64)
    want = jdriver.run_simulation(jparams(params), obs, backend="reference", dtype=jnp.float64)
    np.testing.assert_allclose(got.cells, np.asarray(want.cells), rtol=1e-11)
    np.testing.assert_allclose(got.av_vels, np.asarray(want.av_vels), rtol=1e-10)


@pytest.mark.parametrize("n", [2, 4])
def test_pallas_1d_matches_jax(n):
    params, obs = case(128, 32, 4, seed=5, seams=[(32 // n, 64)])
    got = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * n, backend="pallas")
    want = jsh.run_simulation_sharded(jparams(params), obs, n_devices=n, backend="pallas",
                                      dtype=jnp.float32)
    assert got.route == "pallas"
    assert_matches(got, want)


@pytest.mark.parametrize("mesh", [(2, 2), (2, 4), (4, 2), (1, 8)])
def test_pallas_2d_matches_jax(mesh):
    """The 2-D col_fix kernel's deck (tests/test_sharded.py), obstacles on a
    row and a column seam."""
    py, px = mesh
    params, obs = case(128 * px, 8 * py, 4, seed=3, seams=[(8 * (py > 1), 128)])
    got = tsh.run_simulation_sharded_2d(params, obs, mesh_shape=mesh, devices=CPU8,
                                        backend="pallas")
    want = jsh.run_simulation_sharded_2d(jparams(params), obs, mesh_shape=mesh,
                                         backend="pallas", dtype=jnp.float32)
    assert_matches(got, want)


@pytest.mark.parametrize("mesh", [4, (2, 2)], ids=["1d", "2d"])
def test_auto_matches_jax(mesh):
    """auto: the K3 plain version here, the jnp step in the JAX package off
    a TPU."""
    params, obs = case(24, 16, 12, seed=9, seams=[(8, 12)])
    if isinstance(mesh, tuple):
        got = tsh.run_simulation_sharded_2d(params, obs, mesh_shape=mesh, devices=CPU8)
        want = jsh.run_simulation_sharded_2d(jparams(params), obs, mesh_shape=mesh,
                                             dtype=jnp.float32)
    else:
        got = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * mesh)
        want = jsh.run_simulation_sharded(jparams(params), obs, n_devices=mesh,
                                          dtype=jnp.float32)
    assert got.route == "pallas"
    assert_matches(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_pallas_overlap_matches_jax(n):
    """The deck of test_sharded_overlap_rdma_matches_jnp: 128 x 16n, an
    obstacle on each side of the first seam."""
    params, obs = case(128, 16 * n, 4, seed=11, seams=[(16, 6)])
    got = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * n, backend="pallas-overlap")
    want = jsh.run_simulation_sharded(jparams(params), obs, n_devices=n,
                                      backend="pallas-overlap", dtype=jnp.float32)
    assert got.route == "pallas-overlap"
    assert_matches(got, want)


@pytest.mark.parametrize("mesh,ry,rx", [((1, 1), 4, 6), ((4, 1), 4, 6), ((2, 3), 4, 6),
                                         ((4, 4), 1, 1)])
def test_shard_step_plain_is_k1_plain(mesh, ry, rx):
    """The shard step's plain version joined over the mesh is bitwise the
    single-device K1 plain step, down to 1 x 1-cell shards."""
    py, px = mesh
    rng = np.random.RandomState(py * 10 + px)
    ny, nx = ry * py, rx * px
    cells = torch.as_tensor((0.01 * (1 + 0.05 * rng.rand(9, ny, nx))).astype(np.float32))
    nobst = torch.as_tensor((rng.rand(ny, nx) > 0.2).astype(np.float32))
    mesh_obj = tsh.make_mesh_2d(py, px, ["cpu"] * (py * px))
    shards, sums = shard_step.run_shard_step(tsh.split(cells, mesh_obj),
                                             tsh.split(nobst, mesh_obj), 0.1, 0.005, 1.85, 7, ny)
    want, want_av = run_step_plain(cells, nobst, 0.1, 0.005, 1.85, 7, 1.0)
    assert torch.equal(tsh.gather(shards), want)
    np.testing.assert_allclose(tsh.mesh_totals(sums, 1.0).numpy(), want_av.numpy(), rtol=1e-5)


def test_split_gather_and_meshes():
    x = torch.arange(2 * 6 * 8, dtype=torch.float32).reshape(2, 6, 8)
    mesh = tsh.make_mesh_2d(3, 2, ["cpu"] * 6)
    shards = tsh.split(x, mesh)
    assert mesh.shape == (3, 2) and tuple(shards[2][1].shape) == (2, 2, 4)
    assert torch.equal(tsh.gather(shards), x)
    assert tsh.make_mesh(devices=["cpu", "cpu"]).shape == (2, 1)
    with pytest.raises(ValueError, match="requested 1000 devices, only"):
        tsh.make_mesh(1000)
    with pytest.raises(ValueError, match="requested 3x3 mesh, only 8 devices"):
        tsh.make_mesh_2d(3, 3, CPU8)


def refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("backend", ["aa", "deep", "resident", "temporal"])
def test_single_device_backends_refused_as_jax(backend):
    params, obs = case(24, 16, 2, seed=0)
    jp = jparams(params)
    for mesh in (2, (2, 2)):
        if isinstance(mesh, tuple):
            got = refusal(lambda: tsh.run_simulation_sharded_2d(
                params, obs, mesh_shape=mesh, devices=CPU8, backend=backend))
            want = refusal(lambda: jsh.run_simulation_sharded_2d(
                jp, obs, mesh_shape=mesh, backend=backend))
        else:
            got = refusal(lambda: tsh.run_simulation_sharded(
                params, obs, devices=["cpu"] * mesh, backend=backend))
            want = refusal(lambda: jsh.run_simulation_sharded(jp, obs, n_devices=mesh,
                                                              backend=backend))
        assert got == want and "single-device only" in got


@pytest.mark.parametrize("what", ["overlap-2d", "band-2d", "f64-pallas", "f64-pallas-2d",
                                  "indivisible-1d", "indivisible-2d"])
def test_refusals_word_for_word(what):
    params, obs = case(24, 16, 2, seed=0)
    jp = jparams(params)
    kw = {}
    if what.startswith("f64"):
        kw = dict(backend="pallas")
    elif what == "overlap-2d":
        kw = dict(backend="pallas-overlap")
    elif what == "band-2d":
        kw = dict(backend="band")
    if what.endswith("2d"):
        shape = (2, 5) if what.startswith("indivisible") else (2, 2)
        got = refusal(lambda: tsh.run_simulation_sharded_2d(
            params, obs, mesh_shape=shape, devices=CPU8,
            dtype=torch.float64 if what.startswith("f64") else torch.float32, **kw))
        want = refusal(lambda: jsh.run_simulation_sharded_2d(
            jp, obs, mesh_shape=shape,
            dtype=jnp.float64 if what.startswith("f64") else jnp.float32, **kw))
    else:
        if what.startswith("indivisible"):
            params, obs = case(24, 18, 2, seed=0)
            jp = jparams(params)
        got = refusal(lambda: tsh.run_simulation_sharded(
            params, obs, devices=["cpu"] * 4,
            dtype=torch.float64 if what.startswith("f64") else torch.float32, **kw))
        want = refusal(lambda: jsh.run_simulation_sharded(
            jp, obs, n_devices=4, dtype=jnp.float64 if what.startswith("f64") else jnp.float32,
            **kw))
    assert got == want


@pytest.mark.parametrize("backend,mesh", [("band3", 2), ("band2", (2, 2)), ("band3", (2, 2))])
def test_kernel_backends_without_a_shard_kernel_raise(backend, mesh):
    """A deliberate difference: the JAX package runs its jnp step for these;
    the port, whose backends never run something other than their kernel,
    raises."""
    params, obs = case(128, 16, 2, seed=0)
    jp = jparams(params)
    if isinstance(mesh, tuple):
        msg = refusal(lambda: tsh.run_simulation_sharded_2d(
            params, obs, mesh_shape=mesh, devices=CPU8, backend=backend))
        jres = jsh.run_simulation_sharded_2d(jp, obs, mesh_shape=mesh, backend=backend,
                                             dtype=jnp.float32)
    else:
        msg = refusal(lambda: tsh.run_simulation_sharded(params, obs, devices=["cpu"] * mesh,
                                                         backend=backend))
        jres = jsh.run_simulation_sharded(jp, obs, n_devices=mesh, backend=backend,
                                          dtype=jnp.float32)
    assert backend in msg and ("no sharded kernel" in msg or "no 2-D-mesh kernel" in msg)
    assert np.isfinite(np.asarray(jres.cells)).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16])
def test_storage_modes_not_yet_ported(dtype):
    params, obs = case(24, 16, 2, seed=0)
    with pytest.raises(ValueError, match="not yet ported"):
        tsh.run_simulation_sharded(params, obs, devices=["cpu"] * 2, dtype=dtype)


@pytest.fixture
def deck(tmp_path):
    params, obs = case(256, 32, 9, seed=21, seams=[(16, 128), (8, 64)])
    write_params_file(tmp_path / "input.params", *dataclasses.astuple(params))
    write_obstacle_file(tmp_path / "obstacles.dat", obs)
    return params, obs, str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat")


def outputs(d):
    return d / "av_vels.dat", d / "final_state.dat"


@pytest.mark.parametrize("mesh,backend", [("4", "auto"), ("2x2", "pallas"),
                                          ("4", "pallas-overlap"), ("2x4", "reference")])
def test_cli_mesh_matches_jax_cli(deck, tmp_path, capsys, mesh, backend):
    _, _, params_path, obst_path = deck
    out, ref = tmp_path / "port", tmp_path / "jax"
    stats = tmp_path / "stats.json"
    assert tcli.main([params_path, obst_path, "--device", "cpu", "--mesh", mesh, "--backend",
                      backend, "--out-dir", str(out), "--stats-json", str(stats)]) == 0
    assert jcli.main([params_path, obst_path, "--mesh", mesh, "--backend", backend, "--out-dir",
                      str(ref)]) == 0
    capsys.readouterr()
    av = np.loadtxt(out / "av_vels.dat", usecols=[1])
    np.testing.assert_allclose(av, np.loadtxt(ref / "av_vels.dat", usecols=[1]), rtol=AV_RTOL,
                               atol=AV_ATOL)
    assert check_files(*outputs(out), *outputs(ref), tolerance=1.0).passed
    import json

    with open(stats) as f:
        s = json.load(f)
    n = 4 if mesh == "4" else int(mesh[0]) * int(mesh[2])
    assert s["mesh"] == mesh and len(s["shards"]) == n
    assert {sh["route"] for sh in s["shards"]} == {"pallas" if backend == "auto" else backend}


@pytest.mark.parametrize("mesh", ["4x", "x2", "four", "2x2x2"])
def test_cli_bad_mesh(deck, capsys, mesh):
    _, _, params_path, obst_path = deck
    assert tcli.main([params_path, obst_path, "--device", "cpu", "--mesh", mesh]) == 1
    assert "bad --mesh" in capsys.readouterr().err


def test_cli_mesh_refusal_exits_1(deck, capsys):
    _, _, params_path, obst_path = deck
    assert tcli.main([params_path, obst_path, "--device", "cpu", "--mesh", "2x2", "--backend",
                      "band"]) == 1
    assert "1-D-mesh only" in capsys.readouterr().err


def test_api_mesh(deck):
    params, obs, _, _ = deck
    sim = Simulation(params, obs)
    one = sim.run(mesh=4, device="cpu", backend="pallas")
    two = sim.run(mesh=(2, 2), devices=["cpu"] * 4, backend="pallas")
    single = sim.run(device="cpu", backend="pallas")
    assert one.shard_devices == ("cpu",) * 4 and two.shard_devices == ("cpu",) * 4
    np.testing.assert_array_equal(one.cells, single.cells)
    np.testing.assert_array_equal(two.cells, single.cells)


def test_port_sharded_checkpoint_resumes_in_jax(deck, tmp_path, capsys):
    """A checkpoint written by a 4-shard port run at step 6 resumed by the
    JAX single-device CLI, held against the port's uninterrupted run."""
    params, obs, params_path, obst_path = deck
    ckpt = tmp_path / "ck.npz"
    tsh.run_simulation_sharded(dataclasses.replace(params, max_iters=6), obs,
                               devices=["cpu"] * 4, backend="pallas", checkpoint_every=3,
                               checkpoint_path=str(ckpt))
    cells, av, step = tckpt.load_checkpoint(ckpt, dataclasses.replace(params, max_iters=6))
    tckpt.save_checkpoint(ckpt, params, cells, av, step)
    out, ref = tmp_path / "resumed", tmp_path / "full"
    assert jcli.main([params_path, obst_path, "--backend", "reference", "--resume",
                      "--checkpoint-path", str(ckpt), "--out-dir", str(out)]) == 0
    assert tcli.main([params_path, obst_path, "--device", "cpu", "--mesh", "4", "--out-dir",
                      str(ref)]) == 0
    capsys.readouterr()
    np.testing.assert_allclose(np.loadtxt(out / "av_vels.dat", usecols=[1]),
                               np.loadtxt(ref / "av_vels.dat", usecols=[1]), rtol=1e-4)
    assert check_files(*outputs(out), *outputs(ref), tolerance=1.0).passed


def test_jax_sharded_checkpoint_resumes_in_port(deck, tmp_path, capsys):
    """A checkpoint of a JAX 2x2 run at step 4 resumed by the port's
    single-device CLI, and the reverse: a port 2x2 checkpoint resumed by
    the JAX single-device run; each held against the other package."""
    params, obs, params_path, obst_path = deck
    jp = jparams(params)
    part = jsh.run_simulation_sharded_2d(dataclasses.replace(jp, max_iters=4), obs,
                                         mesh_shape=(2, 2), backend="reference",
                                         dtype=jnp.float32)
    ckpt = tmp_path / "jax.npz"
    jckpt.save_checkpoint(ckpt, jp, np.asarray(part.cells), np.asarray(part.av_vels), 4)
    out = tmp_path / "port_resumed"
    assert tcli.main([params_path, obst_path, "--device", "cpu", "--backend", "pallas",
                      "--resume", "--checkpoint-path", str(ckpt), "--out-dir", str(out)]) == 0
    full = jdriver.run_simulation(jp, obs, backend="reference", dtype=jnp.float32)
    capsys.readouterr()
    np.testing.assert_allclose(np.loadtxt(out / "av_vels.dat", usecols=[1]),
                               np.asarray(full.av_vels), rtol=1e-4)

    tpart = tsh.run_simulation_sharded_2d(dataclasses.replace(params, max_iters=5), obs,
                                          mesh_shape=(2, 2), devices=CPU8, backend="pallas")
    tckpt.save_checkpoint(tmp_path / "port.npz", params, tpart.cells, tpart.av_vels, 5)
    cells, av, step = jckpt.load_checkpoint(tmp_path / "port.npz", jp)
    resumed = jdriver.run_simulation(jp, obs, backend="reference", dtype=jnp.float32,
                                     initial_cells=cells, start_step=step, av_vels_prefix=av)
    mine = tdriver.run_simulation(params, obs, device="cpu", backend="pallas")
    np.testing.assert_allclose(np.asarray(resumed.cells), mine.cells, atol=CELLS_ATOL)
    np.testing.assert_allclose(np.asarray(resumed.av_vels), mine.av_vels, rtol=AV_RTOL,
                               atol=AV_ATOL)


def test_sharded_chunks_give_unchunked_bytes(tmp_path):
    """Checkpoint chunks of 4 on a 2x2 mesh: the state and av series are
    bitwise those of one chunk, and the last checkpoint holds the end."""
    params, obs = case(24, 16, 11, seed=4)
    full = tsh.run_simulation_sharded_2d(params, obs, mesh_shape=(2, 2), devices=CPU8)
    ckpt = tmp_path / "ck.npz"
    chunked = tsh.run_simulation_sharded_2d(params, obs, mesh_shape=(2, 2), devices=CPU8,
                                            checkpoint_every=4, checkpoint_path=str(ckpt))
    np.testing.assert_array_equal(chunked.cells, full.cells)
    np.testing.assert_array_equal(chunked.av_vels, full.av_vels)
    cells, av, step = tckpt.load_checkpoint(ckpt, params)
    assert step == 11
    np.testing.assert_array_equal(cells, full.cells)
