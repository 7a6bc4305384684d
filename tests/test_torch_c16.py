"""c16 storage through the port's kernels and driver, against the JAX
package (``dev=`` on ``pallas_step``, ``pallas_aa``, ``pallas_band3`` and
``pallas_band``, run in interpret mode on the CPU, and ``dtype="c16"`` on
its driver and CLI).

The plain versions of K1, K2, K11 and K7 at c16 keep the JAX kernels'
rounding points: one encode per step for K1 and K2 (and K2's re-encoded
forcing rows), one per pass for K11 and K7, and K11's first forcing on
rows ny-3..ny-1. Tolerance, as tests/test_c16.py: decoded cells within
5e-6 and per-step sums at rtol 1e-3 (the two packages' f32 arithmetic
differs in the low bits, which can move a code by one quantum at a
rounding tie); a c16 run against the f32 run of the same route, cells
within 1e-5 and av at rtol 2e-3 (test_c16.py:87-95).
"""

import dataclasses
import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu import cli as jcli
from lbm_tpu.models.d2q9 import LBMParams as JParams
from lbm_tpu.ops import devspace as jdev
from lbm_tpu.ops import pallas_aa as jaa
from lbm_tpu.ops import pallas_band as jband
from lbm_tpu.ops import pallas_band3 as jb3
from lbm_tpu.ops.pallas_step import lbm_step_pallas_interpret
from lbm_tpu.runtime import checkpoint as jckpt
from lbm_tpu.runtime import driver as jdriver
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.models.d2q9 import WEIGHTS, LBMParams
from lbm_tpu_torch.ops import aa as taa
from lbm_tpu_torch.ops import band as tband
from lbm_tpu_torch.ops import band3 as tb3
from lbm_tpu_torch.ops import devspace as tdev
from lbm_tpu_torch.ops import step as tstep
from lbm_tpu_torch.parallel import sharded as tsharded
from lbm_tpu_torch.runtime import checkpoint as tckpt
from lbm_tpu_torch.runtime import driver as tdriver
from lbm_tpu_torch.utils.checker import check_files
from lbm_tpu_torch.utils.geometry import write_obstacle_file, write_params_file

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
SPEC = tdev.DevSpec.for_params(DENSITY, ACCEL)
JSPEC = jdev.DevSpec.for_params(DENSITY, ACCEL)
DEV = (*JSPEC.bg, JSPEC.h)


def make_setup(nx, ny, seed=5):
    """A seeded random state, its c16 codes and an f32 not-obstacle plane."""
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 8), rng.randint(0, nx, 8)] = 1
    state = ((WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))).astype(np.float32)
    codes = np.array(jdev.encode_state(jnp.asarray(state), JSPEC))
    return codes, (obstacles == 0).astype(np.float32), obstacles


def assert_c16_close(codes, av, want_codes, want_av):
    assert codes.dtype == torch.int16
    got = tdev.decode_state(codes, SPEC).numpy()
    want = np.asarray(jdev.decode_state(jnp.asarray(want_codes), JSPEC))
    assert np.abs(got - want).max() < 5e-6
    np.testing.assert_allclose(np.asarray(av), np.asarray(want_av), rtol=1e-3)


@pytest.mark.parametrize("iters", [1, 5])
def test_step_plain_c16_matches_pallas_step(iters):
    """K1's plain version at c16 against ``pallas_step._kernel(dev=)``
    (the 128 x 32 grid of tests/test_c16.py)."""
    codes, nobst, _ = make_setup(128, 32, seed=iters)
    cells, tots = jnp.asarray(codes), []
    for _ in range(iters):
        cells, tot = lbm_step_pallas_interpret(cells, jnp.asarray(nobst), DENSITY, ACCEL, OMEGA,
                                               paired="fused", dev=DEV)
        tots.append(float(tot))
    got, av = tstep.run_step(torch.as_tensor(codes), torch.as_tensor(nobst), DENSITY, ACCEL,
                             OMEGA, iters, 1.0, dev=SPEC)
    assert_c16_close(got, av, cells, tots)


@pytest.mark.parametrize("iters", [2, 3, 6])
def test_aa_plain_c16_matches_pallas_aa(iters):
    """K2's plain version at c16 against ``pallas_aa.run_aa(dev=)``, both exit
    parities (tests/test_aa.py:239-285's 128 x 16 grid), the forcing rows
    re-encoded where the JAX kernel stores them."""
    codes, nobst, _ = make_setup(128, 16, seed=3 + iters)
    want, want_tot = jaa.run_aa(jnp.asarray(codes), jnp.asarray(nobst), DENSITY, ACCEL, OMEGA,
                                iters, interpret=True, paired="fused", dev=DEV)
    got, av = taa.run_aa(torch.as_tensor(codes), torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA,
                         iters, 1.0, dev=SPEC)
    assert_c16_close(got, av, want, want_tot)


def test_aa_forcing_reencodes_only_its_rows():
    """At c16 the forcing launches touch one row of each of the six forced
    slots; every other code keeps its bits."""
    codes, nobst, _ = make_setup(32, 8, seed=1)
    q = torch.as_tensor(codes)
    w1a, w2a = tstep.forcing_weights(DENSITY, ACCEL)
    out = taa.force_even_plain(q, torch.as_tensor(nobst), w1a, w2a, SPEC)
    changed = {(k, r) for k, r in zip(*np.nonzero((out != q).any(dim=2).numpy()))}
    forced = {(k, (8 - 2 + tstep._CYS[k]) % 8) for k, _ in tstep.force_deltas(w1a, w2a)}
    assert changed and changed <= forced


@pytest.mark.parametrize("block,depth,n", [(16, 8, 8), (16, 8, 19), (32, 8, 32)],
                         ids=["one-pass", "two-passes-rem3", "four-passes"])
def test_band3_plain_c16_matches_pallas_band3(block, depth, n):
    """K11's plain version at c16 against ``pallas_band3.run_band3(dev=)``:
    the first forcing decoded and re-encoded on rows ny-3..ny-1, one encode
    per pass, the remainder on K1 at c16."""
    codes, nobst, _ = make_setup(128, 64, seed=block + n)
    want, want_tot = jb3.run_band3(jnp.asarray(codes), jnp.asarray(nobst), DENSITY, ACCEL, OMEGA,
                                   n, block, depth, interpret=True, paired="fused", dev=DEV)
    got, av = tb3.run_band3(torch.as_tensor(codes), torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA,
                            n, block, depth, dev=SPEC)
    assert_c16_close(got, av, want, want_tot)


def test_force_s_c16_matches_jax():
    codes, nobst, _ = make_setup(128, 16, seed=9)
    w1a, w2a = tstep.forcing_weights(DENSITY, ACCEL)
    want = np.asarray(jb3._force_s_storage(jnp.asarray(codes), jnp.asarray(nobst), w1a, w2a,
                                           dev=DEV))
    got = tb3.force_s(torch.as_tensor(codes), torch.as_tensor(nobst), w1a, w2a, SPEC)
    assert not np.array_equal(want, codes)
    np.testing.assert_array_equal(got.numpy(), want)


def test_band_plain_c16_matches_pallas_band():
    """K7 at c16 (the remainder passes of the c16 slab route and ``band`` at
    c16) against ``pallas_band.run_band(dev=)``: two passes and a K1 tail."""
    codes, nobst, _ = make_setup(128, 64, seed=21)
    want, want_tot = jband.run_band(jnp.asarray(codes), jnp.asarray(nobst), DENSITY, ACCEL, OMEGA,
                                    19, 16, 8, interpret=True, paired="fused", dev=DEV)
    got, av = tband.run_band(torch.as_tensor(codes), torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA,
                             19, 16, 8, dev=SPEC)
    assert_c16_close(got, av, want, want_tot)


def test_kernels_check_the_storage():
    codes, nobst, _ = make_setup(32, 16)
    q, nob = torch.as_tensor(codes), torch.as_tensor(nobst)
    with pytest.raises(ValueError, match="DevSpec"):
        tstep.run_step(q, nob, DENSITY, ACCEL, OMEGA, 2, 1.0)
    with pytest.raises(ValueError, match="int16"):
        taa.run_aa(q.float(), nob, DENSITY, ACCEL, OMEGA, 2, 1.0, dev=SPEC)


PARAMS = LBMParams(nx=128, ny=64, max_iters=19, reynolds_dim=10, density=DENSITY, accel=ACCEL,
                   omega=OMEGA)


def small_obstacles(seed=5):
    rng = np.random.RandomState(seed)
    obs = np.zeros((PARAMS.ny, PARAMS.nx), dtype=np.int32)
    obs[0, :] = obs[-1, :] = 1
    obs[rng.randint(1, PARAMS.ny - 1, 6), rng.randint(0, PARAMS.nx, 6)] = 1
    return obs


@pytest.mark.parametrize("backend", ["auto", "aa", "pallas", "band", "band3", "reference"])
def test_driver_c16_close_to_f32(backend):
    """Encode on upload, the kernels' c16 forms, decode on readback: the c16
    run tracks the f32 run of the same route (19 steps: passes and a K1
    remainder on the band routes)."""
    obs = small_obstacles()
    f32 = tdriver.run_simulation(PARAMS, obs, device="cpu", backend=backend)
    c16 = tdriver.run_simulation(PARAMS, obs, device="cpu", backend=backend, dtype="c16")
    assert c16.route == ("pallas" if backend == "auto" else backend)
    assert c16.cells.dtype == np.float32 and c16.av_vels.dtype == np.float32
    np.testing.assert_allclose(c16.cells, f32.cells, atol=1e-5)
    np.testing.assert_allclose(c16.av_vels, f32.av_vels, rtol=2e-3, atol=1e-9)


@pytest.mark.parametrize("backend", ["aa", "reference"])
def test_driver_c16_matches_jax_driver(backend):
    params = dataclasses.replace(PARAMS, ny=16, max_iters=7)
    obs = small_obstacles()[:16]
    obs[-1] = 1
    want = jdriver.run_simulation(JParams(**dataclasses.asdict(params)), obs, backend=backend,
                                  dtype="c16")
    got = tdriver.run_simulation(params, obs, device="cpu", backend=backend, dtype="c16")
    assert np.abs(got.cells - want.cells).max() < 5e-6
    np.testing.assert_allclose(got.av_vels, want.av_vels, rtol=1e-3)


@pytest.mark.parametrize("backend", ["aa", "pallas"])
def test_c16_resume_is_bit_identical(backend):
    """A c16 checkpoint holds the decoded f32 state; resuming re-encodes it,
    and every code decodes back to the value it was saved from
    (tests/test_torch_devspace.py), so a route that rounds every step (K2,
    K1) gives the uninterrupted run's bits (tests/test_aa.py:196-213)."""
    params = dataclasses.replace(PARAMS, max_iters=12)
    obs = small_obstacles(7)
    full = tdriver.run_simulation(params, obs, device="cpu", backend=backend, dtype="c16")
    first5 = tdriver.run_simulation(dataclasses.replace(params, max_iters=5), obs, device="cpu",
                                    backend=backend, dtype="c16")
    resumed = tdriver.run_simulation(params, obs, device="cpu", backend=backend, dtype="c16",
                                     initial_cells=first5.cells, start_step=5,
                                     av_vels_prefix=first5.av_vels)
    np.testing.assert_array_equal(resumed.cells, full.cells)
    np.testing.assert_array_equal(resumed.av_vels, full.av_vels)


def test_c16_checkpoints_hold_decoded_f32(tmp_path):
    path = tmp_path / "ck.npz"
    res = tdriver.run_simulation(PARAMS, small_obstacles(), device="cpu", backend="band3",
                                 dtype="c16", checkpoint_every=8, checkpoint_path=str(path))
    cells, av, step = tckpt.load_checkpoint(path, PARAMS)
    assert cells.dtype == np.float32 and step == PARAMS.max_iters
    np.testing.assert_array_equal(cells, res.cells)
    np.testing.assert_array_equal(av, res.av_vels)


def test_c16_checkpoints_cross_packages(tmp_path):
    """A c16 checkpoint of either package resumes in the other at c16."""
    params = dataclasses.replace(PARAMS, ny=16, max_iters=9)
    jparams = JParams(**dataclasses.asdict(params))
    obs = small_obstacles()[:16]
    obs[-1] = 1
    jfull = jdriver.run_simulation(jparams, obs, backend="aa", dtype="c16")
    tfull = tdriver.run_simulation(params, obs, device="cpu", backend="aa", dtype="c16")
    jpart = jdriver.run_simulation(dataclasses.replace(jparams, max_iters=4), obs, backend="aa",
                                   dtype="c16")
    jckpt.save_checkpoint(tmp_path / "j.npz", jparams, jpart.cells, jpart.av_vels, 4)
    cells, av, step = tckpt.load_checkpoint(tmp_path / "j.npz", params)
    got = tdriver.run_simulation(params, obs, device="cpu", backend="aa", dtype="c16",
                                 initial_cells=cells, start_step=step, av_vels_prefix=av)
    assert np.abs(got.cells - jfull.cells).max() < 5e-6
    np.testing.assert_allclose(got.av_vels, jfull.av_vels, rtol=1e-3)
    tpart = tdriver.run_simulation(dataclasses.replace(params, max_iters=4), obs, device="cpu",
                                   backend="aa", dtype="c16")
    tckpt.save_checkpoint(tmp_path / "t.npz", params, tpart.cells, tpart.av_vels, 4)
    cells, av, step = jckpt.load_checkpoint(tmp_path / "t.npz", jparams)
    back = jdriver.run_simulation(jparams, obs, backend="aa", dtype="c16", initial_cells=cells,
                                  start_step=step, av_vels_prefix=av)
    assert np.abs(back.cells - tfull.cells).max() < 5e-6
    np.testing.assert_allclose(back.av_vels, tfull.av_vels, rtol=1e-3)


@pytest.mark.parametrize("fetch_final", [True, False])
def test_saturation_warning(fetch_final, monkeypatch):
    """Every c16 run ends with the saturation check, from the max |code| on
    the device, whether or not the final state is fetched."""
    params = dataclasses.replace(PARAMS, max_iters=4)
    monkeypatch.setenv("LBM_C16_H", "1e-6")
    with pytest.warns(UserWarning, match="saturated"):
        res = tdriver.run_simulation(params, small_obstacles(), device="cpu", backend="pallas",
                                     dtype="c16", fetch_final=fetch_final)
    assert (res.cells is None) == (not fetch_final)
    monkeypatch.delenv("LBM_C16_H")
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tdriver.run_simulation(params, small_obstacles(), device="cpu", backend="pallas",
                               dtype="c16", fetch_final=fetch_final)


@pytest.mark.parametrize("ny,nx", [(256, 256), (1024, 1024), (2048, 2048), (3, 8)])
def test_auto_at_c16_runs_the_step_kernel(ny, nx):
    """auto at c16 runs K1, which rounds the codes every step, as the JAX
    package's auto does on the official decks: the band kernels round once
    per pass, and that cadence missed the 1% gate on the 256^2 deck (K11:
    av_vels 1.678% on an H100, PERF.md)."""
    params = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    assert tdriver.select_route(params, "auto", "c16") == "pallas"
    assert tdriver.select_route(params, "auto", torch.float32) != "pallas"


@pytest.mark.parametrize("backend,match", [
    ("resident", "resident backend does not support c16"),
    ("band2", "not yet ported for the band2 kernel"),
    ("temporal", "not yet ported for the temporal kernel"),
    ("deep", "not yet ported for the deep kernel"),
])
def test_c16_refusals(backend, match):
    with pytest.raises(ValueError, match=match):
        tdriver.run_simulation(PARAMS, small_obstacles(), device="cpu", backend=backend,
                               dtype="c16")


@pytest.mark.parametrize("mesh", [2, (2, 2)], ids=["1-D", "2-D"])
@pytest.mark.parametrize("backend", ["auto", "pallas", "reference"])
def test_c16_under_a_mesh_is_not_yet_ported(mesh, backend):
    kw = dict(backend=backend, dtype="c16")
    with pytest.raises(ValueError, match="not yet ported"):
        if isinstance(mesh, tuple):
            tsharded.run_simulation_sharded_2d(PARAMS, small_obstacles(), mesh_shape=mesh,
                                               devices=["cpu"] * 4, **kw)
        else:
            tsharded.run_simulation_sharded(PARAMS, small_obstacles(), devices=["cpu"] * 2, **kw)


@pytest.fixture
def deck(tmp_path):
    write_params_file(tmp_path / "input.params", 128, 32, 21, 10, DENSITY, ACCEL, OMEGA)
    obs = np.zeros((32, 128), np.int32)
    obs[0] = obs[-1] = 1
    obs[10:14, 40] = 1
    write_obstacle_file(tmp_path / "obstacles.dat", obs)
    return str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat")


def test_both_clis_at_c16(deck, tmp_path, capsys):
    t_out, j_out = tmp_path / "t", tmp_path / "j"
    assert tcli.main([*deck, "--device", "cpu", "--backend", "aa", "--precision", "c16",
                      "--out-dir", str(t_out)]) == 0
    assert jcli.main([*deck, "--backend", "aa", "--precision", "c16", "--out-dir",
                      str(j_out)]) == 0
    capsys.readouterr()
    files = [d / f for d in (t_out, j_out) for f in ("av_vels.dat", "final_state.dat")]
    assert check_files(*files, tolerance=1.0).passed
    np.testing.assert_allclose(np.loadtxt(files[0], usecols=[1]), np.loadtxt(files[2], usecols=[1]),
                               rtol=1e-3)
    t_fs, j_fs = np.loadtxt(files[1]), np.loadtxt(files[3])
    np.testing.assert_array_equal(t_fs[:, [0, 1, 6]], j_fs[:, [0, 1, 6]])
    assert np.abs(t_fs[:, 5] - j_fs[:, 5]).max() < 5e-6


def test_cli_c16_resume_and_refusals(deck, tmp_path, capsys):
    """``--precision c16`` with ``--checkpoint-every``/``--resume`` writes the
    uninterrupted run's bytes (K2); ``--mesh`` and ``resident`` at c16 exit 1."""
    full, part = tmp_path / "full", tmp_path / "part"
    base = [*deck, "--device", "cpu", "--backend", "aa", "--precision", "c16"]
    assert tcli.main([*base, "--out-dir", str(full)]) == 0
    ckpt = tmp_path / "ck.npz"
    res = tdriver.run_simulation(dataclasses.replace(tcli_params(deck), max_iters=8),
                                 np_obstacles(deck), device="cpu", backend="aa", dtype="c16")
    tckpt.save_checkpoint(ckpt, tcli_params(deck), res.cells, res.av_vels, 8)
    assert tcli.main([*base, "--resume", "--checkpoint-every", "5", "--checkpoint-path",
                      str(ckpt), "--out-dir", str(part)]) == 0
    for f in ("av_vels.dat", "final_state.dat"):
        assert filecmp.cmp(full / f, part / f, shallow=False)
    for extra in (["--mesh", "2"], ["--mesh", "2x1"]):
        assert tcli.main([*base, *extra]) == 1
    assert tcli.main([*deck, "--device", "cpu", "--backend", "resident", "--precision",
                      "c16"]) == 1
    assert "c16" in capsys.readouterr().err


def tcli_params(deck):
    from lbm_tpu_torch.io import read_params

    return read_params(deck[0])


def np_obstacles(deck):
    from lbm_tpu_torch.io import read_obstacles

    return read_obstacles(deck[1], tcli_params(deck))
