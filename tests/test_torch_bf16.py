"""bf16 storage on one device: the plain bf16 forms of K1, K2, K7 and K9
against the JAX kernels with a bfloat16 state, run in interpret mode on
the CPU as the JAX package's own tests run them, and
``dtype=torch.bfloat16`` through the driver, the CLI and checkpoints
(K5, K6, K11 and K13: tests/test_torch_bf16_passes.py; the mesh:
tests/test_torch_bf16_mesh.py).

The plain versions round where the JAX kernels write ``.astype(out_dtype)``:
once per step for K1 and K2 (and K2's forcing rows, which the JAX kernel
stores), once per pass for K5-K7, K9, K11 and K13, and once more on rows
ny-3..ny-1 for K11's first forcing (``_force_s_storage``) and after step
T-2 of its final pass. Both sides
compute in f32, in different orders, so a value next to a bf16 rounding
boundary may round one way here and the other there. Tolerance, up to one
pass and a K1 remainder: every cell within 2 bf16 ulps of the JAX value
(counted on the bit patterns), at most 1% of the cells differing at all,
and the av series at rtol 1e-3; measured: at most 1 ulp and 0.05% of the
cells. A rounding in the wrong place moves far more: K11 without the JAX
package's split of its final pass (below) left 26% of the cells 1-2 ulps
off after one pass. Over 2T+3 steps a flipped value, 1/256 of itself,
moves its neighbours across their own rounding boundaries in the next
pass and the remainder steps, so the flips spread: there the bound is 4
ulps, 5% of the cells and the av series at rtol 5e-3 (measured: K7, K9
0.2-0.7% and 2-3 ulps; K11, whose final pass rounds twice, 2-3% and 3
ulps).

The JAX reference step at bf16 computes in bf16 and XLA on the CPU may keep
intermediates at f32 (``xla_allow_excess_precision``), where torch rounds
after every operation: ``reference`` at bf16 is held loosely, over a few
steps (cells within 4 ulps at 2**-7 of their value, av at rtol 2e-2).
"""

import dataclasses
import filecmp
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu import cli as jcli
from lbm_tpu.models.d2q9 import D2Q9 as JD2Q9
from lbm_tpu.models.d2q9 import LBMParams as JParams
from lbm_tpu.ops import pallas_aa as jaa
from lbm_tpu.ops import pallas_band as jband
from lbm_tpu.ops import pallas_band2 as jb2
from lbm_tpu.ops import pallas_band3 as jb3
from lbm_tpu.ops import pallas_deep as jdeep
from lbm_tpu.ops import pallas_temporal as jtemp
from lbm_tpu.ops.pallas_slab import run_band_slab as j_run_band_slab
from lbm_tpu.ops.pallas_step import lbm_step_pallas_interpret
from lbm_tpu.runtime import checkpoint as jckpt
from lbm_tpu.runtime import driver as jdriver
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.api import Simulation
from lbm_tpu_torch.models.d2q9 import D2Q9, WEIGHTS, LBMParams
from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops import aa as taa
from lbm_tpu_torch.ops import band as tband
from lbm_tpu_torch.ops import band2 as tb2
from lbm_tpu_torch.ops import band3 as tb3
from lbm_tpu_torch.ops import deep as tdeep
from lbm_tpu_torch.ops import devspace as tdev
from lbm_tpu_torch.ops import slab as tslab
from lbm_tpu_torch.ops import step as tstep
from lbm_tpu_torch.ops import temporal as ttemp
from lbm_tpu_torch.runtime import checkpoint as tckpt
from lbm_tpu_torch.runtime import driver as tdriver
from lbm_tpu_torch.utils.geometry import write_obstacle_file, write_params_file

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
BF16 = tdev.BF16
TOL = (2, 0.01, 1e-3)  # (ulps per cell, fraction of cells differing, av rtol)
# Over 2T+3 steps (module docstring): where the flips of one pass spread.
SPREAD_TOL = (4, 0.05, 5e-3)


def make_setup(nx, ny, seed):
    """A seeded random bf16 state (as f32 numpy values, each exact in bf16)
    and an f32 not-obstacle plane."""
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 8), rng.randint(0, nx, 8)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    state = torch.as_tensor(state.astype(np.float32)).to(torch.bfloat16).float().numpy()
    return state, (obstacles == 0).astype(np.float32)


def both(state, nobst):
    """The same inputs for both packages: (torch bf16, torch f32 mask),
    (jax bf16, jax f32 mask)."""
    return ((torch.as_tensor(state).to(torch.bfloat16), torch.as_tensor(nobst)),
            (jnp.asarray(state, jnp.bfloat16), jnp.asarray(nobst)))


def ordered_bits(x):
    """bf16 values as integers in their order (sign and magnitude): two
    values are that many ulps apart."""
    u = (np.asarray(x, dtype=np.float32).view(np.uint32) >> 16).astype(np.int64)
    return np.where(u & 0x8000, -(u & 0x7FFF), u)


def assert_bf16_close(cells, av, want_cells, want_av, tol=TOL):
    """bf16 cells against the JAX package's within ``tol`` (module
    docstring), counted on the bit patterns."""
    max_ulps, max_fraction, av_rtol = tol
    assert cells.dtype == torch.bfloat16
    want = np.asarray(want_cells, dtype=np.float32)
    ulps = np.abs(ordered_bits(cells.float().numpy()) - ordered_bits(want))
    assert ulps.max() <= max_ulps, ulps.max()
    assert (ulps > 0).mean() <= max_fraction, (ulps > 0).mean()
    np.testing.assert_allclose(np.asarray(av, np.float64), np.asarray(want_av, np.float64),
                               rtol=av_rtol)


@pytest.mark.parametrize("iters", [1, 4])
def test_step_plain_bf16_matches_pallas_step(iters):
    """K1's plain version at bf16 against ``pallas_step._kernel`` with a
    bfloat16 state: one rounding per step."""
    (cells, nob), (jcells, jnob) = both(*make_setup(128, 32, seed=iters))
    tots = []
    for _ in range(iters):
        jcells, tot = lbm_step_pallas_interpret(jcells, jnob, DENSITY, ACCEL, OMEGA, paired="fused")
        tots.append(float(tot))
    assert jcells.dtype == jnp.bfloat16
    got, av = tstep.run_step(cells, nob, DENSITY, ACCEL, OMEGA, iters, 1.0, dev=BF16)
    assert_bf16_close(got, av, jcells, tots)


@pytest.mark.parametrize("iters", [2, 3, 6])
def test_aa_plain_bf16_matches_pallas_aa(iters):
    """K2's plain version at bf16 against ``pallas_aa.run_aa`` with a
    bfloat16 state, both exit parities: every stored value and every
    forcing row the JAX kernel stores rounded once."""
    (cells, nob), (jcells, jnob) = both(*make_setup(128, 16, seed=3 + iters))
    want, want_tot = jaa.run_aa(jcells, jnob, DENSITY, ACCEL, OMEGA, iters, interpret=True,
                                paired="fused")
    got, av = taa.run_aa(cells, nob, DENSITY, ACCEL, OMEGA, iters, 1.0, dev=BF16)
    assert_bf16_close(got, av, want, want_tot)


def test_aa_forcing_rounds_only_its_rows():
    """At bf16 the forcing touches one row of each of the six forced slots;
    every other value keeps its bits."""
    state, nobst = make_setup(32, 8, seed=1)
    q = torch.as_tensor(state).to(torch.bfloat16)
    w1a, w2a = tstep.forcing_weights(DENSITY, ACCEL)
    out = taa.force_even_plain(q, torch.as_tensor(nobst), w1a, w2a, BF16)
    assert out.dtype == torch.bfloat16
    changed = {(k, r) for k, r in zip(*np.nonzero((out != q).any(dim=2).numpy()))}
    forced = {(k, (8 - 2 + tstep._CYS[k]) % 8) for k, _ in tstep.force_deltas(w1a, w2a)}
    assert changed and changed <= forced


# The band family on one schedule the JAX kernels take at 16 bits (B 16,
# T 8): one pass, one pass and a K1 remainder, and 2T+3 steps (two passes
# and a remainder), full row and the panel variants (P 128, H 128 on a
# 256-column grid).
BAND_CASES = [pytest.param(128, 8, None, id="full-one-pass"),
              pytest.param(128, 11, None, id="full-T+3"),
              pytest.param(128, 19, None, id="full-2T+3"),
              pytest.param(256, 19, 128, id="panel-2T+3")]


def tol_for(n, depth):
    """The tolerance of a run of n steps at depth T (module docstring)."""
    return SPREAD_TOL if n > depth + 3 else TOL


def band_case(jrun, trun, nx, n, panel, seed):
    (cells, nob), (jcells, jnob) = both(*make_setup(nx, 64, seed=seed))
    kw = {} if panel is None else {"panel": panel, "halo": 128}
    want, want_tot = jrun(jcells, jnob, DENSITY, ACCEL, OMEGA, n, 16, 8, interpret=True,
                          paired="fused", **kw)
    assert want.dtype == jnp.bfloat16
    got, av = trun(cells, nob, DENSITY, ACCEL, OMEGA, n, 16, 8, panel=panel, dev=BF16)
    assert_bf16_close(got, av, want, want_tot, tol_for(n, 8))


@pytest.mark.parametrize("nx,n,panel", BAND_CASES)
def test_band_plain_bf16_matches_pallas_band(nx, n, panel):
    """K7 at bf16: ``mid.astype(out_dtype)`` once per pass."""
    band_case(jband.run_band, tband.run_band, nx, n, panel, seed=n + nx)


@pytest.mark.parametrize("nx,n,panel", BAND_CASES)
def test_band2_plain_bf16_matches_pallas_band2(nx, n, panel):
    """K9 at bf16 (pallas_band2.py:324, :502)."""
    band_case(jb2.run_band2, tb2.run_band2, nx, n, panel, seed=2 * n + nx)


def test_storage_selector_and_checks():
    """The entry points' storage argument says f32, c16 or bf16, never a
    null codec; the wrappers take a bfloat16 state only with ``BF16``."""
    spec = tdev.DevSpec.for_params(DENSITY, ACCEL)
    assert [_build.storage(d).kind for d in (None, spec, BF16)] == [0, 1, 2]
    assert list(_build.storage(spec).codec) == pytest.approx(spec.codec(), rel=1e-7)
    state, nobst = make_setup(32, 16, seed=2)
    q, nob = torch.as_tensor(state).to(torch.bfloat16), torch.as_tensor(nobst)
    with pytest.raises(ValueError, match="BF16"):
        tstep.run_step(q, nob, DENSITY, ACCEL, OMEGA, 2, 1.0)
    with pytest.raises(ValueError, match="bf16 storage takes a torch.bfloat16 state"):
        taa.run_aa(q.float(), nob, DENSITY, ACCEL, OMEGA, 2, 1.0, dev=BF16)
    before = (tstep.run_step.launches, tstep.run_step.launches_c16, tstep.run_step.launches_bf16)
    tstep.count_launches(tstep.run_step, 3, BF16)
    assert (tstep.run_step.launches, tstep.run_step.launches_c16,
            tstep.run_step.launches_bf16) == (before[0], before[1], before[2] + 3)
    tstep.run_step.launches_bf16 = before[2]


PARAMS = LBMParams(nx=128, ny=64, max_iters=19, reynolds_dim=10, density=DENSITY, accel=ACCEL,
                   omega=OMEGA)


def small_obstacles(seed=5, ny=64):
    rng = np.random.RandomState(seed)
    obs = np.zeros((ny, PARAMS.nx), dtype=np.int32)
    obs[0, :] = obs[-1, :] = 1
    obs[rng.randint(1, ny - 1, 6), rng.randint(0, PARAMS.nx, 6)] = 1
    return obs


def test_initial_state_matches_jax():
    """The rest state cast to bf16 on upload has the JAX package's bits."""
    got = tdev.encode_state(D2Q9.initial_state(PARAMS), BF16)
    want = JD2Q9.initial_state(JParams(**dataclasses.asdict(PARAMS)), dtype=jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("backend,ny,want", [
    ("auto", 64, "aa"), ("auto", 1024, "aa"), ("auto", 2, "pallas"), ("auto", 1, "reference"),
    ("aa", 64, "aa"), ("pallas", 64, "pallas"), ("band", 64, "band"), ("band2", 64, "band2"),
    ("band3", 64, "band3"), ("temporal", 64, "temporal"), ("deep", 64, "deep"),
    ("reference", 64, "reference"), ("resident", 64, ValueError),
])
def test_select_route_bf16(backend, ny, want):
    """auto at bf16 runs K2, as the JAX package's auto does at bf16 on the
    official decks (``select_aa``); every kernel backend takes bf16 but
    ``resident``, which raises with the JAX package's wording."""
    params = dataclasses.replace(PARAMS, ny=ny)
    if want is ValueError:
        with pytest.raises(ValueError, match=r"\(dtype bfloat16\) does not fit"):
            tdriver.select_route(params, backend, torch.bfloat16)
    else:
        assert tdriver.select_route(params, backend, torch.bfloat16) == want


@pytest.mark.parametrize("backend", ["aa", "pallas", "band"])
def test_driver_bf16_chunked_equals_unchunked(backend):
    """Chunk boundaries at multiples of 8 (band: T 4, so whole passes) give
    the unchunked run's bits; the state comes back as exact f32 values.
    (band3 splits the final pass of every chunk, as the JAX package's
    run_band3 does, so its chunked run rounds more often.)"""
    obs = small_obstacles()
    whole = tdriver.run_simulation(PARAMS, obs, device="cpu", backend=backend,
                                   dtype=torch.bfloat16)
    seen = []
    chunked = tdriver.run_simulation(PARAMS, obs, device="cpu", backend=backend,
                                     dtype=torch.bfloat16, chunk_every=8,
                                     on_chunk=lambda s, c, a: seen.append((s, c.dtype)))
    assert seen == [(8, torch.float32), (16, torch.float32), (19, torch.float32)]
    assert whole.cells.dtype == np.float32 and whole.av_vels.dtype == np.float32
    np.testing.assert_array_equal(
        whole.cells, torch.as_tensor(whole.cells).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(chunked.cells, whole.cells)
    np.testing.assert_array_equal(chunked.av_vels, whole.av_vels)


@pytest.mark.parametrize("backend", ["aa", "pallas"])
def test_bf16_resume_is_bit_identical(backend, tmp_path):
    """A bf16 checkpoint holds the exact f32 values of the bf16 state; the
    resume casts them back bit for bit, so the resumed run writes the
    uninterrupted run's bytes (unlike c16, no codec round trip)."""
    params = dataclasses.replace(PARAMS, max_iters=12)
    obs = small_obstacles(7)
    full = tdriver.run_simulation(params, obs, device="cpu", backend=backend,
                                  dtype=torch.bfloat16)
    path = tmp_path / "ck.npz"
    tdriver.run_simulation(dataclasses.replace(params, max_iters=5), obs, device="cpu",
                           backend=backend, dtype=torch.bfloat16, checkpoint_every=5,
                           checkpoint_path=str(path))
    cells, av, step = tckpt.load_checkpoint(path, dataclasses.replace(params, max_iters=5))
    assert cells.dtype == np.float32 and step == 5
    resumed = tdriver.run_simulation(params, obs, device="cpu", backend=backend,
                                     dtype=torch.bfloat16, initial_cells=cells, start_step=step,
                                     av_vels_prefix=av)
    np.testing.assert_array_equal(resumed.cells, full.cells)
    np.testing.assert_array_equal(resumed.av_vels, full.av_vels)


def test_bf16_checkpoints_cross_packages(tmp_path):
    """The port's bf16 checkpoint (exact f32 values) resumes in the JAX
    package's bf16 run to the same bits as the port's state; the JAX
    package's own bf16 checkpoint (an ml_dtypes array, which numpy saves
    as raw 2-byte records that the JAX package cannot load back) loads in
    the port to its exact values."""
    params = dataclasses.replace(PARAMS, ny=16, max_iters=9)
    jparams = JParams(**dataclasses.asdict(params))
    obs = small_obstacles(ny=16)
    tpart = tdriver.run_simulation(dataclasses.replace(params, max_iters=4), obs, device="cpu",
                                   backend="aa", dtype=torch.bfloat16)
    tckpt.save_checkpoint(tmp_path / "t.npz", params, tpart.cells, tpart.av_vels, 4)
    cells, av, step = jckpt.load_checkpoint(tmp_path / "t.npz", jparams)
    np.testing.assert_array_equal(np.asarray(jnp.asarray(cells, jnp.bfloat16), np.float32),
                                  tpart.cells)
    back = jdriver.run_simulation(jparams, obs, backend="reference", dtype=jnp.bfloat16,
                                  initial_cells=cells, start_step=step, av_vels_prefix=av)
    assert np.asarray(back.cells).dtype == jnp.bfloat16 and np.isfinite(back.av_vels).all()
    jpart = jdriver.run_simulation(dataclasses.replace(jparams, max_iters=4), obs,
                                   backend="reference", dtype=jnp.bfloat16)
    jckpt.save_checkpoint(tmp_path / "j.npz", jparams, jpart.cells, jpart.av_vels, 4)
    cells, av, step = tckpt.load_checkpoint(tmp_path / "j.npz", params)
    assert cells.dtype == np.float32 and step == 4
    np.testing.assert_array_equal(cells, np.asarray(jpart.cells, np.float32))
    got = tdriver.run_simulation(params, obs, device="cpu", backend="aa", dtype=torch.bfloat16,
                                 initial_cells=cells, start_step=step, av_vels_prefix=av)
    assert np.isfinite(got.av_vels).all() and got.av_vels.shape == (9,)


def test_reference_bf16_tracks_jax_reference():
    """``reference`` at bf16 is the plain step on bf16 tensors, as the JAX
    reference step computes in the state's dtype; held loosely (module
    docstring), over four steps."""
    params = dataclasses.replace(PARAMS, ny=32, max_iters=4)
    obs = small_obstacles(ny=32)
    got = tdriver.run_simulation(params, obs, device="cpu", backend="reference",
                                 dtype=torch.bfloat16)
    want = jdriver.run_simulation(JParams(**dataclasses.asdict(params)), obs,
                                  backend="reference", dtype=jnp.bfloat16)
    want_cells = np.asarray(want.cells, np.float32)
    assert got.route == "reference" and got.av_vels.dtype == np.float32
    np.testing.assert_array_equal(
        got.cells, torch.as_tensor(got.cells).to(torch.bfloat16).float().numpy())
    assert np.abs(got.cells - want_cells).max() <= 2.0 ** -7 * np.abs(want_cells).max()
    np.testing.assert_allclose(got.av_vels, want.av_vels, rtol=2e-2)


@pytest.fixture
def deck(tmp_path):
    write_params_file(tmp_path / "input.params", 128, 32, 50, 10, DENSITY, ACCEL, OMEGA)
    obs = np.zeros((32, 128), np.int32)
    obs[0] = obs[-1] = 1
    obs[10:14, 40] = 1
    write_obstacle_file(tmp_path / "obstacles.dat", obs)
    return str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat")


WARNING = ("warning: --precision bf16 is EXPERIMENTAL and cannot pass the 1% golden gate "
           "(av_vels drift ~100% over the official runs); use --precision c16 for accurate "
           "16-bit storage")


@pytest.mark.parametrize("backend", ["pallas", "aa"])
def test_both_clis_at_bf16(backend, deck, tmp_path, capsys):
    """``--precision bf16`` through both CLIs on the 128x32 deck of 50 steps
    (the JAX kernels in interpret mode): av_vels at rtol 1e-3 and the
    final states within 2 bf16 ulps of the pressure (the reference's
    pressure is rho / 3 of the bf16 populations), the same warning under
    each program's name, and ``--stats-json``."""
    t_out, j_out = tmp_path / "t", tmp_path / "j"
    stats = tmp_path / "stats.json"
    assert tcli.main([*deck, "--device", "cpu", "--backend", backend, "--precision", "bf16",
                      "--out-dir", str(t_out), "--stats-json", str(stats)]) == 0
    assert f"lbm_tpu_torch: {WARNING}" in capsys.readouterr().err
    assert jcli.main([*deck, "--backend", backend, "--precision", "bf16", "--out-dir",
                      str(j_out)]) == 0
    assert f"lbm_tpu: {WARNING}" in capsys.readouterr().err
    s = json.loads(stats.read_text())
    assert s["precision"] == "bf16" and s["route"] == backend and s["torch_device"] == "cpu"
    np.testing.assert_allclose(np.loadtxt(t_out / "av_vels.dat", usecols=[1]),
                               np.loadtxt(j_out / "av_vels.dat", usecols=[1]), rtol=1e-3)
    t_fs, j_fs = np.loadtxt(t_out / "final_state.dat"), np.loadtxt(j_out / "final_state.dat")
    np.testing.assert_array_equal(t_fs[:, [0, 1, 6]], j_fs[:, [0, 1, 6]])
    assert np.abs(t_fs[:, 5] - j_fs[:, 5]).max() <= 2.0 ** -6 * np.abs(j_fs[:, 5]).max()


def test_cli_bf16_resume_and_refusal(deck, tmp_path, capsys):
    """``--precision bf16`` with ``--resume`` from a mid-run checkpoint
    writes the uninterrupted run's bytes (``auto``: K2); ``resident`` at
    bf16 exits 1; ``Simulation.run(dtype=torch.bfloat16)`` gives the CLI's
    state."""
    full, part = tmp_path / "full", tmp_path / "part"
    base = [*deck, "--device", "cpu", "--precision", "bf16"]
    assert tcli.main([*base, "--out-dir", str(full)]) == 0
    sim = Simulation.from_files(*deck)
    head = tdriver.run_simulation(dataclasses.replace(sim.params, max_iters=21), sim.obstacles,
                                  device="cpu", dtype=torch.bfloat16)
    assert head.route == "aa"
    ckpt = tmp_path / "ck.npz"
    tckpt.save_checkpoint(ckpt, sim.params, head.cells, head.av_vels, 21)
    assert tcli.main([*base, "--resume", "--checkpoint-every", "10", "--checkpoint-path",
                      str(ckpt), "--out-dir", str(part)]) == 0
    for f in ("av_vels.dat", "final_state.dat"):
        assert filecmp.cmp(full / f, part / f, shallow=False)
    sim.write_outputs(sim.run(device="cpu", dtype=torch.bfloat16), out_dir=str(tmp_path / "api"))
    assert filecmp.cmp(full / "final_state.dat", tmp_path / "api" / "final_state.dat",
                       shallow=False)
    assert tcli.main([*base, "--backend", "resident"]) == 1
    assert "(dtype bfloat16) does not fit" in capsys.readouterr().err
