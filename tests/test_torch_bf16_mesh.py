"""bf16 storage under a mesh: the plain bf16 forms of K3, K8 and K10, the
f32 K12 between its casts, and the plain bf16 shard steps of
``lbm_tpu_torch/parallel/sharded.py``, against the JAX package's
``run_simulation_sharded(_2d)(dtype=jnp.bfloat16)`` on the 8 virtual CPU
devices of tests/conftest.py.

The port's shards lie on the CPU, where the kernel routes run their plain
versions; off a TPU the JAX package runs its Pallas kernels in interpret
mode. The rounding points are the JAX package's: once per step for K3,
once per pass for K8 and K10 (their halos carry the neighbours' bf16
values), and once per chunk for K12, which has no bf16 form: its runner
casts the shards to f32 at a chunk's start and back at its end
(sharded.py:466-468, :723-732). Tolerances as tests/test_torch_bf16.py
(``TOL``: 2 ulps, 1% of the cells, av rtol 1e-3); the plain bf16 step
(``reference``, and ``auto`` on a 2-D mesh) computes in bf16 on both sides
and is held loosely, as the single-device reference is there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu import cli as jcli
from lbm_tpu.models.d2q9 import LBMParams as JParams
from lbm_tpu.parallel import sharded as jsh
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.models.d2q9 import LBMParams
from lbm_tpu_torch.ops import band as tband
from lbm_tpu_torch.ops import band2 as tband2
from lbm_tpu_torch.parallel import sharded as tsh
from lbm_tpu_torch.runtime import checkpoint as tckpt
from lbm_tpu_torch.runtime import driver as tdriver
from lbm_tpu_torch.utils.geometry import write_obstacle_file, write_params_file
from test_torch_bf16 import TOL, ordered_bits

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
CPU8 = ["cpu"] * 8
BF16 = torch.bfloat16


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


def assert_bf16_runs_match(got, want, tol=TOL):
    """A port result (exact f32 values of a bf16 state) against a JAX bf16
    result, counted on the bit patterns."""
    max_ulps, max_fraction, av_rtol = tol
    assert got.cells.dtype == np.float32 and got.av_vels.dtype == np.float32
    np.testing.assert_array_equal(
        got.cells, torch.as_tensor(got.cells).to(BF16).float().numpy())
    ulps = np.abs(ordered_bits(got.cells) - ordered_bits(np.asarray(want.cells, np.float32)))
    assert ulps.max() <= max_ulps, ulps.max()
    assert (ulps > 0).mean() <= max_fraction, (ulps > 0).mean()
    np.testing.assert_allclose(got.av_vels, np.asarray(want.av_vels), rtol=av_rtol)


def assert_loosely(got, want):
    """The plain bf16 step on both sides, which round at other places
    (tests/test_torch_bf16.py::test_reference_bf16_tracks_jax_reference)."""
    want_cells = np.asarray(want.cells, np.float32)
    assert np.abs(got.cells - want_cells).max() <= 2.0 ** -7 * np.abs(want_cells).max()
    np.testing.assert_allclose(got.av_vels, np.asarray(want.av_vels), rtol=2e-2)


@pytest.mark.parametrize("backend,n", [("pallas", 2), ("pallas", 4), ("auto", 4),
                                       ("pallas-overlap", 2), ("pallas-overlap", 4)])
def test_1d_step_routes_bf16_match_jax(backend, n):
    """K3's plain bf16 form (``pallas``, ``auto``: one rounding per step) and
    K12's f32 plain version between the chunk's two casts
    (``pallas-overlap``) against the JAX package's kernels per shard (its
    ``auto`` takes the kernel on a TPU only: ``pallas`` names it here)."""
    params, obs = case(128, 64, 5, seed=n, n=n)
    got = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * n, backend=backend,
                                     dtype=BF16)
    want = jsh.run_simulation_sharded(jparams(params), obs, n_devices=n,
                                      backend="pallas" if backend == "auto" else backend,
                                      dtype=jnp.bfloat16)
    assert np.asarray(want.cells).dtype == jnp.bfloat16
    assert got.route == ("pallas" if backend == "auto" else backend)
    assert_bf16_runs_match(got, want)


def use_schedule(monkeypatch, block, depth, panel):
    """Both packages on one band schedule: the port's pickers, the JAX
    package's env knobs."""
    for module in (tband, tband2):
        monkeypatch.setattr(module, "schedule", lambda params, dtype: (block, depth, panel))
    monkeypatch.setenv("LBM_BAND_BLOCK", str(block))
    monkeypatch.setenv("LBM_BAND_DEPTH", str(depth))
    if panel is not None:
        monkeypatch.setenv("LBM_BAND_PANEL", str(panel))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("backend", ["band", "band2"])
def test_band_routes_bf16_match_jax(monkeypatch, backend, n):
    """K8 and K10 at bf16 (B 16, T 8) on 2 and 4 shards of 32 rows: one pass
    whose halos are the neighbours' bf16 values, and a 3-step remainder on
    the shard step at bf16."""
    params, obs = case(128, 32 * n, 11, seed=7 + n, n=n)
    use_schedule(monkeypatch, 16, 8, None)
    got = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * n, backend=backend,
                                     dtype=BF16)
    want = jsh.run_simulation_sharded(jparams(params), obs, n_devices=n, backend=backend,
                                      dtype=jnp.bfloat16)
    assert got.route == backend
    assert_bf16_runs_match(got, want)


def test_overlap_bf16_rounds_once_per_chunk(tmp_path):
    """``pallas-overlap`` at bf16 depends on where the chunks end: with
    checkpoints every 3 steps its state rounds after steps 3 and 6 as well,
    as the JAX package's runner does, and differs from the unchunked run."""
    params, obs = case(128, 64, 7, seed=3, n=2)
    kw = dict(backend="pallas-overlap", checkpoint_every=3)
    whole = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * 2,
                                       backend="pallas-overlap", dtype=BF16)
    got = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * 2, dtype=BF16,
                                     checkpoint_path=str(tmp_path / "t.npz"), **kw)
    want = jsh.run_simulation_sharded(jparams(params), obs, n_devices=2, dtype=jnp.bfloat16,
                                      checkpoint_path=str(tmp_path / "j.npz"), **kw)
    assert_bf16_runs_match(got, want)
    assert not np.array_equal(got.cells, whole.cells)
    cells, _, step = tckpt.load_checkpoint(tmp_path / "t.npz", params)
    assert step == 7
    np.testing.assert_array_equal(cells, got.cells)


@pytest.mark.parametrize("mesh,backend", [(2, "reference"), ((2, 2), "auto"),
                                          ((2, 4), "reference")])
def test_plain_bf16_steps_track_jax(mesh, backend):
    """``reference`` and the 2-D ``auto`` run the plain step on bf16 shards,
    as the JAX package runs its jnp step at bf16 (only f32 takes its 2-D
    kernel), held loosely over four steps."""
    params, obs = case(32, 16, 4, seed=1)
    if isinstance(mesh, tuple):
        got = tsh.run_simulation_sharded_2d(params, obs, mesh_shape=mesh, devices=CPU8,
                                            backend=backend, dtype=BF16)
        want = jsh.run_simulation_sharded_2d(jparams(params), obs, mesh_shape=mesh,
                                             backend=backend, dtype=jnp.bfloat16)
    else:
        got = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * mesh, backend=backend,
                                         dtype=BF16)
        want = jsh.run_simulation_sharded(jparams(params), obs, n_devices=mesh, backend=backend,
                                          dtype=jnp.bfloat16)
    assert got.route == "reference"
    assert_loosely(got, want)


def test_2d_pallas_bf16_is_refused_with_the_jax_wording():
    """A backend that names a kernel never runs something else: 2-D
    ``pallas`` at bf16 raises, with the message the JAX package gives."""
    params, obs = case(32, 16, 2, seed=0)
    with pytest.raises(ValueError) as mine:
        tsh.run_simulation_sharded_2d(params, obs, mesh_shape=(2, 2), devices=CPU8,
                                      backend="pallas", dtype=BF16)
    with pytest.raises(ValueError) as theirs:
        jsh.run_simulation_sharded_2d(jparams(params), obs, mesh_shape=(2, 2), backend="pallas",
                                      dtype=jnp.bfloat16)
    assert str(mine.value) == str(theirs.value) == "2-D-mesh pallas backend is f32-only"


@pytest.fixture
def deck(tmp_path):
    params, obs = case(128, 32, 50, seed=21, n=2)
    write_params_file(tmp_path / "input.params", *dataclasses.astuple(params))
    write_obstacle_file(tmp_path / "obstacles.dat", obs)
    return params, obs, str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat")


def test_cli_mesh_bf16_matches_jax_cli(deck, tmp_path, capsys):
    """``--mesh 2 --device cpu --precision bf16`` (``auto``: K3) through the
    port's CLI and ``--mesh 2 --backend pallas`` (the kernel the JAX
    package's auto takes on a TPU) through the JAX CLI, on the 128x32 deck
    of 50 steps: av_vels at rtol 1e-3, pressure within 2 bf16 ulps of its
    scale."""
    _, _, params_path, obst_path = deck
    out, ref = tmp_path / "port", tmp_path / "jax"
    assert tcli.main([params_path, obst_path, "--device", "cpu", "--mesh", "2", "--precision",
                      "bf16", "--out-dir", str(out)]) == 0
    assert jcli.main([params_path, obst_path, "--mesh", "2", "--backend", "pallas",
                      "--precision", "bf16", "--out-dir", str(ref)]) == 0
    assert "lbm_tpu_torch: warning: --precision bf16 is EXPERIMENTAL" in capsys.readouterr().err
    np.testing.assert_allclose(np.loadtxt(out / "av_vels.dat", usecols=[1]),
                               np.loadtxt(ref / "av_vels.dat", usecols=[1]), rtol=1e-3)
    pressure = [np.loadtxt(d / "final_state.dat", usecols=[5]) for d in (out, ref)]
    assert np.abs(pressure[0] - pressure[1]).max() <= 2.0 ** -6 * np.abs(pressure[1]).max()


def test_mesh_bf16_resume_is_bit_identical(deck, tmp_path):
    """A 2-shard bf16 checkpoint holds the exact f32 values; the resumed K3
    run gives the uninterrupted one's bits."""
    params, obs, _, _ = deck
    params = dataclasses.replace(params, max_iters=9)
    full = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * 2, dtype=BF16)
    path = tmp_path / "ck.npz"
    head = dataclasses.replace(params, max_iters=4)
    tsh.run_simulation_sharded(head, obs, devices=["cpu"] * 2, dtype=BF16, checkpoint_every=4,
                               checkpoint_path=str(path))
    cells, av, step = tckpt.load_checkpoint(path, head)
    resumed = tsh.run_simulation_sharded(params, obs, devices=["cpu"] * 2, dtype=BF16,
                                         initial_cells=cells, start_step=step, av_vels_prefix=av)
    np.testing.assert_array_equal(resumed.cells, full.cells)
    np.testing.assert_array_equal(resumed.av_vels, full.av_vels)
