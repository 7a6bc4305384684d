"""c16 storage through the band2, temporal and deep routes (K9, K5, K6), and
the keywords of ``run_simulation``, against the JAX package.

The plain versions of K9 (full row and panel), K5 and K6 at c16 are held
against ``pallas_band2``, ``pallas_temporal`` and ``pallas_deep`` with
``dev=``, run in interpret mode on the CPU as tests/test_c16.py runs them.
They keep the JAX kernels' rounding points: one encode per pass of T
steps, the remainder on K1 at c16 (one encode per step). Tolerance, as
tests/test_c16.py: decoded cells within 5e-6 and per-step sums at rtol
1e-3 (the two packages' f32 arithmetic differs in the low bits, which can
move a code by one quantum at a rounding tie); a c16 run against the f32
run of the same route, cells within 1e-5 and av at rtol 2e-3.

The schedules differ between the packages (the JAX kernels need T % 8 or
16-row blocks at int16), and at c16 T sets the rounding cadence, so the
CLI comparison gives the port the JAX package's schedule.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu import cli as jcli
from lbm_tpu.models.d2q9 import LBMParams as JParams
from lbm_tpu.ops import devspace as jdev
from lbm_tpu.ops import pallas_band2 as jb2
from lbm_tpu.ops import pallas_deep as jdeep
from lbm_tpu.ops import pallas_temporal as jtemp
from lbm_tpu.runtime import driver as jdriver
import lbm_tpu_torch
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.api import Simulation
from lbm_tpu_torch.models.d2q9 import WEIGHTS, LBMParams
from lbm_tpu_torch.ops import band2 as tb2
from lbm_tpu_torch.ops import deep as tdeep
from lbm_tpu_torch.ops import devspace as tdev
from lbm_tpu_torch.ops import temporal as ttemp
from lbm_tpu_torch.runtime import checkpoint as tckpt
from lbm_tpu_torch.runtime import driver as tdriver
from lbm_tpu_torch.utils.checker import check_files
from lbm_tpu_torch.utils.geometry import write_obstacle_file, write_params_file

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
SPEC = tdev.DevSpec.for_params(DENSITY, ACCEL)
JSPEC = jdev.DevSpec.for_params(DENSITY, ACCEL)
DEV = (*JSPEC.bg, JSPEC.h)


def make_setup(nx, ny, seed):
    """A seeded random state's c16 codes and an f32 not-obstacle plane."""
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 8), rng.randint(0, nx, 8)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    codes = np.array(jdev.encode_state(jnp.asarray(state.astype(np.float32)), JSPEC))
    return codes, (obstacles == 0).astype(np.float32)


def decoded(codes):
    if isinstance(codes, torch.Tensor):
        assert codes.dtype == torch.int16
        return tdev.decode_state(codes, SPEC).numpy()
    return np.asarray(jdev.decode_state(jnp.asarray(codes), JSPEC))


def assert_c16_close(codes, av, want_codes, want_av):
    assert np.abs(decoded(codes) - decoded(want_codes)).max() < 5e-6
    np.testing.assert_allclose(np.asarray(av), np.asarray(want_av), rtol=1e-3)


@pytest.mark.parametrize("n", [8, 19], ids=["one-pass", "two-passes-rem3"])
def test_band2_plain_c16_matches_pallas_band2(n):
    """K9's plain version at c16 against ``pallas_band2._kernel2(dev=)``, the
    full-row variant (B 16, T 8: tests/test_c16.py:117-128)."""
    codes, nobst = make_setup(128, 64, seed=n)
    want, want_tot = jb2.run_band2(jnp.asarray(codes), jnp.asarray(nobst), DENSITY, ACCEL, OMEGA,
                                   n, 16, 8, interpret=True, paired="fused", dev=DEV)
    got, av = tb2.run_band2(torch.as_tensor(codes), torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA,
                            n, 16, 8, dev=SPEC)
    assert_c16_close(got, av, want, want_tot)


def test_band2_plain_c16_matches_pallas_band2_panel():
    """The panel variant ``_kernel2_panel(dev=)`` (P 128, H 128) against the
    port's 128-column tiles with their T-column halo (tests/test_c16.py:131-141)."""
    codes, nobst = make_setup(256, 64, seed=11)
    want, want_tot = jb2.run_band2(jnp.asarray(codes), jnp.asarray(nobst), DENSITY, ACCEL, OMEGA,
                                   19, 16, 8, panel=128, halo=128, interpret=True,
                                   paired="fused", dev=DEV)
    got, av = tb2.run_band2(torch.as_tensor(codes), torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA,
                            19, 16, 8, panel=128, dev=SPEC)
    assert_c16_close(got, av, want, want_tot)


@pytest.mark.parametrize("depth,n", [(2, 7), (4, 9)])
def test_temporal_plain_c16_matches_pallas_temporal(depth, n):
    """K5's plain version at c16 against ``pallas_temporal.run_temporal(dev=)``:
    packs of codes carried between passes, a K1 c16 remainder."""
    codes, nobst = make_setup(128, 32, seed=depth + n)
    want, want_tot = jtemp.run_temporal(jnp.asarray(codes), jnp.asarray(nobst), DENSITY, ACCEL,
                                        OMEGA, n, 16, depth, interpret=True, paired="fused",
                                        dev=DEV)
    got, av = ttemp.run_temporal(torch.as_tensor(codes), torch.as_tensor(nobst), DENSITY, ACCEL,
                                 OMEGA, n, 16, depth, dev=SPEC)
    assert_c16_close(got, av, want, want_tot)


def test_temporal_pass_c16_packs_copy_the_state():
    """One K5 pass at c16 from packs that are not the state's rows, so the
    halo must come from the packs: the state and both packs against
    ``step_t_pallas(dev=)``, and the output packs hold exactly the codes of
    the state rows they copy (``pallas_temporal.py:200-210`` stores its
    encoded ``val`` into both)."""
    codes, nobst = make_setup(128, 32, seed=3)
    block, depth = 16, 4
    last, first = (np.asarray(p) for p in jtemp.make_halos_t(jnp.asarray(codes), block, depth))
    rng = np.random.RandomState(4)
    last = (last + rng.randint(-40, 41, last.shape)).astype(np.int16)
    first = (first + rng.randint(-40, 41, first.shape)).astype(np.int16)
    (j_cells, j_last, j_first), j_sums = jtemp.step_t_pallas(
        (jnp.asarray(codes), jnp.asarray(last), jnp.asarray(first)),
        jtemp.nobst_ext(jnp.asarray(nobst), block, depth, jnp.int16),
        jnp.ones((1, 1), jnp.float32), DENSITY, ACCEL, OMEGA, block, depth, interpret=True,
        paired="fused", dev=DEV)
    (cells, t_last, t_first), sums = ttemp.step_t(
        (torch.as_tensor(codes), torch.as_tensor(last), torch.as_tensor(first)),
        torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA, block, depth, dev=SPEC)
    want_sums = np.stack([np.asarray(s) for s in j_sums])
    assert_c16_close(cells, sums, j_cells, want_sums)
    for got, want in ((t_last, j_last), (t_first, j_first)):  # (nblk, 9T, nx) -> (9, nblk, T, nx)
        got = got.view(2, 9, depth, 128).permute(1, 0, 2, 3)
        want = np.asarray(want).reshape(2, 9, depth, 128).transpose(1, 0, 2, 3)
        assert np.abs(decoded(got) - decoded(want)).max() < 5e-6
    own_last, own_first = ttemp.make_halos_t(cells, block, depth)
    assert torch.equal(t_last, own_last) and torch.equal(t_first, own_first)


@pytest.mark.parametrize("n", [8, 19], ids=["one-pass", "two-passes-rem3"])
def test_deep_plain_c16_matches_pallas_deep(n):
    """K6's plain version at c16 against ``pallas_deep.run_deep(dev=)``
    (B 16, T 8): the halos decoded from the input codes."""
    codes, nobst = make_setup(128, 32, seed=30 + n)
    want, want_tot = jdeep.run_deep(jnp.asarray(codes), jnp.asarray(nobst), DENSITY, ACCEL, OMEGA,
                                    n, 16, 8, interpret=True, paired="fused", dev=DEV)
    got, av = tdeep.run_deep(torch.as_tensor(codes), torch.as_tensor(nobst), DENSITY, ACCEL,
                             OMEGA, n, 16, 8, dev=SPEC)
    assert_c16_close(got, av, want, want_tot)


PARAMS = LBMParams(nx=128, ny=64, max_iters=19, reynolds_dim=10, density=DENSITY, accel=ACCEL,
                   omega=OMEGA)
PASS_ROUTES = ("band2", "temporal", "deep")


def small_obstacles(seed=5):
    rng = np.random.RandomState(seed)
    obs = np.zeros((PARAMS.ny, PARAMS.nx), dtype=np.int32)
    obs[0, :] = obs[-1, :] = 1
    obs[rng.randint(1, PARAMS.ny - 1, 6), rng.randint(0, PARAMS.nx, 6)] = 1
    return obs


@pytest.mark.parametrize("backend", PASS_ROUTES)
def test_driver_c16_pass_routes_close_to_f32(backend):
    """The driver's schedules at c16 (T 4: four passes and a K1 remainder)
    track the f32 run of the same route; the state comes back decoded."""
    obs = small_obstacles()
    f32 = tdriver.run_simulation(PARAMS, obs, device="cpu", backend=backend)
    c16 = tdriver.run_simulation(PARAMS, obs, device="cpu", backend=backend, dtype="c16")
    assert c16.route == backend and c16.cells.dtype == np.float32
    np.testing.assert_allclose(c16.cells, f32.cells, atol=1e-5)
    np.testing.assert_allclose(c16.av_vels, f32.av_vels, rtol=2e-3, atol=1e-9)


def test_pass_route_schedules_at_c16():
    """Each schedule picker gives the same schedule at c16 as at f32 (the
    window stays f32 in shared memory), none at f64; ``auto`` at c16 stays
    on K1, a deliberate deviation (ROADMAP Queue 3)."""
    for backend, config in (("band2", tb2.schedule), ("temporal", ttemp.schedule),
                            ("deep", tdeep.schedule)):
        assert config(PARAMS, "c16") == config(PARAMS, torch.float32) is not None
        assert config(PARAMS, torch.float64) is None
        assert tdriver.select_route(PARAMS, backend, "c16") == backend
    assert tdriver.select_route(PARAMS, "auto", "c16") == "pallas"
    with pytest.raises(ValueError, match="resident backend does not support c16"):
        tdriver.select_route(PARAMS, "resident", "c16")


@pytest.mark.parametrize("backend", ["auto", "pallas", "band2", "temporal", "deep"])
def test_bf16_routes_on_one_device_and_a_mesh(backend):
    """bf16 storage, experimental in the JAX package, runs on every route:
    each backend keeps its route (``auto``: K2), the state comes back as
    the exact f32 values of a bf16 state, and a 2-shard mesh runs K3's
    plain bf16 form (tests/test_torch_bf16*.py hold them to the JAX
    package)."""
    params = dataclasses.replace(PARAMS, max_iters=5)
    res = Simulation(params, small_obstacles()).run(device="cpu", backend=backend,
                                                    dtype=torch.bfloat16)
    assert res.route == ("aa" if backend == "auto" else backend)
    assert res.cells.dtype == np.float32 and np.isfinite(res.av_vels).all()
    np.testing.assert_array_equal(
        res.cells, torch.as_tensor(res.cells).to(torch.bfloat16).float().numpy())
    mesh = Simulation(params, small_obstacles()).run(device="cpu", mesh=2, backend="auto",
                                                     dtype=torch.bfloat16)
    assert mesh.route == "pallas" and mesh.shard_devices == ("cpu", "cpu")


# The JAX package's schedule of each route on the CLI deck below, through
# its env knobs, and the port's pickers set to it.
JAX_SCHEDULES = {"band2": ({"LBM_BAND_BLOCK": "16", "LBM_BAND_DEPTH": "8"}, (16, 8, None)),
                 "temporal": ({"LBM_TEMPORAL_BLOCK": "16", "LBM_TEMPORAL_DEPTH": "4"},
                              (16, 4, None)),
                 "deep": ({"LBM_DEEP_BLOCK": "16", "LBM_DEEP_DEPTH": "8"}, (16, 8, None))}


@pytest.fixture
def deck(tmp_path):
    write_params_file(tmp_path / "input.params", 128, 32, 21, 10, DENSITY, ACCEL, OMEGA)
    obs = np.zeros((32, 128), np.int32)
    obs[0] = obs[-1] = 1
    obs[10:14, 40] = 1
    write_obstacle_file(tmp_path / "obstacles.dat", obs)
    return str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat")


@pytest.mark.parametrize("backend", PASS_ROUTES)
def test_both_clis_at_c16_pass_routes(backend, deck, tmp_path, capsys, monkeypatch):
    """``--precision c16 --backend band2|temporal|deep`` through both CLIs on
    one schedule: the checker's 1% gate, av_vels at rtol 1e-3 and the
    pressure column within 5e-6."""
    env, schedule = JAX_SCHEDULES[backend]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    module = {"band2": tb2, "temporal": ttemp, "deep": tdeep}[backend]
    monkeypatch.setattr(module, "schedule", lambda params, dtype: schedule)
    t_out, j_out = tmp_path / "t", tmp_path / "j"
    assert tcli.main([*deck, "--device", "cpu", "--backend", backend, "--precision", "c16",
                      "--out-dir", str(t_out)]) == 0
    assert jcli.main([*deck, "--backend", backend, "--precision", "c16", "--out-dir",
                      str(j_out)]) == 0
    capsys.readouterr()
    files = [d / f for d in (t_out, j_out) for f in ("av_vels.dat", "final_state.dat")]
    assert check_files(*files, tolerance=1.0).passed
    np.testing.assert_allclose(np.loadtxt(files[0], usecols=[1]), np.loadtxt(files[2], usecols=[1]),
                               rtol=1e-3)
    t_fs, j_fs = np.loadtxt(files[1]), np.loadtxt(files[3])
    np.testing.assert_array_equal(t_fs[:, [0, 1, 6]], j_fs[:, [0, 1, 6]])
    assert np.abs(t_fs[:, 5] - j_fs[:, 5]).max() < 5e-6


# The run_simulation API: the JAX package's keywords and defaults.


def test_run_simulation_takes_the_jax_keywords():
    """Every keyword of ``lbm_tpu.run_simulation`` with its default, and
    ``device`` last before ``fetch_final`` as there."""
    mine = inspect.signature(lbm_tpu_torch.run_simulation).parameters
    theirs = inspect.signature(jdriver.run_simulation).parameters
    assert list(mine) == list(theirs)
    for name, p in theirs.items():
        if p.default is not inspect.Parameter.empty and name != "dtype":
            assert mine[name].default == p.default, name


def test_run_simulation_device_defaults_as_the_cli(monkeypatch):
    """``device=None`` selects as ``--device`` does: ``$LBM_DEVICE``, else the
    first card; with neither a card nor a named CPU it raises, so no CPU
    run goes unnamed."""
    params = dataclasses.replace(PARAMS, max_iters=3)
    monkeypatch.setenv("LBM_DEVICE", "cpu")
    res = lbm_tpu_torch.run_simulation(params, small_obstacles())
    assert res.device == "cpu" and res.av_vels.shape == (3,)
    monkeypatch.delenv("LBM_DEVICE")
    if torch.cuda.is_available():
        assert lbm_tpu_torch.run_simulation(params, small_obstacles()).device == "cuda:0"
    else:
        with pytest.raises(ValueError, match="no CUDA device"):
            lbm_tpu_torch.run_simulation(params, small_obstacles())


def test_checkpoint_format_on_one_device(tmp_path):
    """``checkpoint_format="npz"`` passes through ``Simulation.run`` to one
    device; orbax is refused with the sharded runner's wording."""
    params = dataclasses.replace(PARAMS, max_iters=6)
    sim = Simulation(params, small_obstacles())
    path = tmp_path / "ck.npz"
    res = sim.run(device="cpu", backend="pallas", checkpoint_format="npz", checkpoint_every=4,
                  checkpoint_path=str(path))
    cells, av, step = tckpt.load_checkpoint(path, params)
    assert step == 6
    np.testing.assert_array_equal(cells, res.cells)
    with pytest.raises(ValueError, match="orbax checkpoints are JAX-only"):
        sim.run(device="cpu", checkpoint_format="orbax")


@pytest.mark.parametrize("dtype", [None, torch.float32], ids=["None", "f32"])
def test_dtype_none_means_f32(dtype):
    """``dtype=None`` runs f32, in ``Simulation.run`` and ``run_simulation``
    (lbm_tpu/api.py:69)."""
    params = dataclasses.replace(PARAMS, max_iters=5)
    sim = Simulation(params, small_obstacles())
    want = sim.run(device="cpu", backend="pallas", dtype=torch.float32)
    for res in (sim.run(device="cpu", backend="pallas", dtype=dtype),
                tdriver.run_simulation(params, small_obstacles(), device="cpu", backend="pallas",
                                       dtype=dtype)):
        assert res.cells.dtype == np.float32
        np.testing.assert_array_equal(res.cells, want.cells)


@pytest.mark.parametrize("backend", ["pallas", "band2"])
def test_chunk_every_and_on_chunk_match_jax(backend, tmp_path):
    """``chunk_every`` adds boundaries beside ``checkpoint_every``'s, as the
    JAX driver's do, and ``on_chunk(step, cells, av_chunk)`` sees each
    chunk: at c16 the decoded f32 state (the last one the result's), and
    the chunked run's series equals the unchunked one."""
    params = dataclasses.replace(PARAMS, max_iters=19)
    obs = small_obstacles()
    seen, jseen = [], []
    res = tdriver.run_simulation(params, obs, device="cpu", backend=backend, dtype="c16",
                                 chunk_every=8, checkpoint_every=5,
                                 checkpoint_path=str(tmp_path / "ck.npz"),
                                 on_chunk=lambda s, c, a: seen.append((s, c, a)))
    jdriver.run_simulation(JParams(**dataclasses.asdict(params)), obs, backend="reference",
                           chunk_every=8, checkpoint_every=5,
                           on_chunk=lambda s, c, a: jseen.append((s, np.asarray(a).shape)))
    assert [(s, a.shape) for s, _, a in seen] == jseen
    assert [s for s, _, _ in seen] == [5, 8, 10, 15, 16, 19]
    assert all(c.dtype == torch.float32 and tuple(c.shape) == (9, 64, 128) for _, c, _ in seen)
    np.testing.assert_array_equal(seen[-1][1].numpy(), res.cells)
    np.testing.assert_array_equal(np.concatenate([a for _, _, a in seen]), res.av_vels)
    if backend == "pallas":  # one rounding per step: the chunks give the unchunked bits
        whole = tdriver.run_simulation(params, obs, device="cpu", backend=backend, dtype="c16")
        np.testing.assert_array_equal(res.cells, whole.cells)
        np.testing.assert_array_equal(res.av_vels, whole.av_vels)
