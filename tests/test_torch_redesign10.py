"""The CPU side of K5 and K6 redesigned for the H100: one shared-memory
window per tile, stepped in place in the AA arrangement on the shrinking
trapezoid (``csrc/trapezoid.cuh``).

``temporal.trapezoid_aa_plain`` is that schedule in plain PyTorch: the row
blocks' windows cut into 2-D tiles with a T-column halo, the AA slots,
step s on window rows and columns ``[s, extent - s)`` of each tile, the
store of an odd T from where the last step scattered, and every slot a
step does not write set to NaN. ``run_temporal_aa_plain`` and
``run_deep_aa_plain`` run it as K5 and K6 do (K5 with its pack loads and
stores). It is held bit for bit, state and av series, against the pull
on full rows (``trapezoid_plain``, which tests/test_torch_temporal.py and
tests/test_torch_deep.py hold against the JAX kernels) at T 1, 2, 3, 4, 5
and 8, on ragged tiles and a single tile that wraps onto itself, at f32,
c16 and bf16, and K5 from packs that differ from the state's rows; and
against the JAX kernels ``pallas_temporal`` and ``pallas_deep`` in
interpret mode (cells within 1e-5 of the state's scale, av at rtol 1e-4,
as tests/test_torch_temporal.py and tests/test_torch_deep.py). The
driver's K5 and K6 schedules fit two blocks per SM, their windows are
among those the kernels compile with constant strides, and a window beyond
a block's shared memory is refused.

The slice: ``cli.main --device cpu --precision c16`` with ``--backend
temporal`` (an odd T) and ``--backend deep`` against the JAX CLI on the
same decks, with the tolerances of tests/test_torch_c16_routes.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu import cli as jcli
from lbm_tpu.ops import pallas_deep as jd
from lbm_tpu.ops import pallas_temporal as jt
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.models.d2q9 import WEIGHTS, LBMParams
from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops import band3 as tb3
from lbm_tpu_torch.ops import band_common as BC
from lbm_tpu_torch.ops import deep as td
from lbm_tpu_torch.ops import devspace as tdev
from lbm_tpu_torch.ops import temporal as tt
from lbm_tpu_torch.runtime import driver as tdriver
from lbm_tpu_torch.utils.checker import check_files
from lbm_tpu_torch.utils.geometry import write_obstacle_file, write_params_file

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
SPEC = tdev.DevSpec.for_params(DENSITY, ACCEL)
STORAGES = {"f32": None, "c16": SPEC, "bf16": tdev.BF16}
# The shared memory of one of two blocks on an SM: the SM's 228 KB, less
# the 1 KB the card reserves per block.
TWO_PER_SM = (228 * 1024) // 2 - 1024
ROUTES = {"temporal": (tt.run_temporal_aa_plain, tt.run_temporal_plain),
          "deep": (td.run_deep_aa_plain, td.run_deep_plain)}


def make_setup(nx, ny, seed):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 10), rng.randint(0, nx, 10)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    return state.astype(np.float32), (obstacles == 0).astype(np.float32)


def storage_state(state, dev):
    cells = torch.as_tensor(state)
    return cells if dev is None else tdev.encode_state(cells, dev)


# (nx, ny, block, depth, panel, steps): T 1-5 and 8, ragged row blocks (the
# last as short as T rows) and column tiles, full rows, and single tiles
# that wrap onto themselves (ny < block).
SCHEDULES = [(50, 33, 8, 1, None, 5), (70, 98, 24, 2, 20, 9), (70, 97, 20, 3, 20, 11),
             (100, 100, 32, 4, 56, 11), (64, 45, 16, 5, 28, 17), (37, 29, 10, 8, 11, 19),
             (20, 8, 16, 3, 9, 7), (40, 12, 16, 4, None, 9)]


@pytest.mark.parametrize("storage", list(STORAGES))
@pytest.mark.parametrize("nx,ny,block,depth,panel,n", SCHEDULES)
@pytest.mark.parametrize("route", list(ROUTES))
def test_aa_trapezoid_is_the_pull(route, nx, ny, block, depth, panel, n, storage):
    """K5's and K6's AA steps on the trapezoid give the pull's state and av
    series bit for bit, over passes and a K1 remainder."""
    dev = STORAGES[storage]
    state, nobst = make_setup(nx, ny, seed=nx + depth)
    aa, pull = ROUTES[route]
    args = (storage_state(state, dev), torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA, n, block,
            depth)
    got = aa(*args, panel=panel, dev=dev)
    want = pull(*args, panel=panel, dev=dev)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("storage", list(STORAGES))
@pytest.mark.parametrize("depth,panel", [(3, 32), (4, 24), (5, None)])
def test_aa_pass_from_other_packs_is_the_pull(storage, depth, panel):
    """One K5 pass from packs that differ from the state's rows (on a ragged
    97 x 70 grid, 20-row blocks): the state, both output packs and the av
    values of the AA schedule equal the pull's bit for bit."""
    dev = STORAGES[storage]
    state, nobst = make_setup(70, 97, seed=depth)
    cells = storage_state(state, dev)
    last, first = tt.make_halos_t(cells, 20, depth)
    if storage == "c16":
        packs = (last + 3, first - 3)
    else:
        packs = ((last.float() * 1.01).to(last.dtype), (first.float() * 0.99).to(first.dtype))
    args = ((cells, *packs), torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA, 20, depth)
    got, av = tt.step_t_plain(*args, dev=dev, trap=tt.aa_trapezoid(panel))
    want, want_av = tt.step_t_plain(*args, dev=dev)
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and torch.equal(av, want_av)
    assert not torch.equal(got[1], tt.make_halos_t(cells, 20, depth)[0])


def close(got, want):
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("block,depth,steps", [(8, 2, 4), (16, 4, 4)])
def test_aa_temporal_matches_pallas_temporal(block, depth, steps):
    """128 x 32 on 40-column tiles (the last 8 columns wide), two passes
    and one: the JAX temporal kernel against K5's schedule."""
    state, nobst = make_setup(128, 32, seed=steps)
    want, want_tot = jt.run_temporal(jnp.asarray(state), jnp.asarray(nobst), DENSITY, ACCEL,
                                     OMEGA, steps, block, depth, interpret=True, paired="fused")
    cells, av = tt.run_temporal_aa_plain(torch.as_tensor(state), torch.as_tensor(nobst), DENSITY,
                                         ACCEL, OMEGA, steps, block, depth, panel=40)
    close(cells, want)
    np.testing.assert_allclose(av.numpy(), np.asarray(want_tot), rtol=1e-4)


def test_aa_deep_matches_pallas_deep():
    """128 x 16, block 16, T 8: one pass of one block that wraps onto
    itself, on 40-column tiles: the JAX deep kernel against K6's
    schedule."""
    state, nobst = make_setup(128, 16, seed=8)
    want, want_tot = jd.run_deep(jnp.asarray(state), jnp.asarray(nobst), DENSITY, ACCEL, OMEGA,
                                 8, 16, 8, interpret=True, paired="fused")
    cells, av = td.run_deep_aa_plain(torch.as_tensor(state), torch.as_tensor(nobst), DENSITY,
                                     ACCEL, OMEGA, 8, 16, 8, panel=40)
    close(cells, want)
    np.testing.assert_allclose(av.numpy(), np.asarray(want_tot), rtol=1e-4)


@pytest.mark.parametrize("storage", list(STORAGES))
@pytest.mark.parametrize("n", [100, 256, 512, 1000, 1024, 2048, 4096])
@pytest.mark.parametrize("route", list(ROUTES))
def test_schedule_fits_two_blocks_per_sm(route, n, storage):
    """The driver's K5 and K6 schedules at every storage: one window copy,
    40 B of shared memory per window cell, within the shared memory of one
    of two blocks on an SM, and a schedule the kernel takes."""
    params = LBMParams(nx=n, ny=n, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    dtype = {"f32": torch.float32, "c16": "c16", "bf16": torch.bfloat16}[storage]
    _, (block, depth, panel) = tdriver.pass_schedule(route, params, dtype)
    assert tt.PLANE_COPIES == 1
    need = BC.smem_bytes(tt.PLANE_COPIES, n, block, depth, panel)
    wh, ww = block + 2 * depth, panel + 2 * depth
    assert need == 40 * wh * ww + 4 * (wh + ww) + 4 * 16 * depth
    assert need <= TWO_PER_SM
    BC.check_smem(f"{route} kernel", tt.PLANE_COPIES, n, block, depth, panel)


def test_driver_windows_have_constant_strides(monkeypatch):
    """Every window of the driver's K5 and K6 tiers is one that the build
    gives ``csrc/trapezoid.cuh::with_layout`` to compile with constant
    strides (``#define LBM_TRAP_WINDOWS ww, wh, ...``), in one list with
    K11's (its tiers' windows and those of the T-2 and 2 steps of a split
    16-bit final pass), and the windows follow ``temporal.TRAPEZOID_TIERS``
    (chip_smoke phase 27's sweep sets it to its candidates) and
    ``band3.BAND3_TIERS``."""
    tiers = [cfg for cfg, _ in tt.TRAPEZOID_TIERS]
    band3 = [cfg for cfg, _ in tb3.BAND3_TIERS]
    name, values = _build.windows_define().split(None, 2)[1:]
    assert name == "LBM_TRAP_WINDOWS"
    pairs = [int(v) for v in values.split(",")]
    listed = set(zip(pairs[::2], pairs[1::2]))
    want = {(panel + 2 * depth, block + 2 * depth) for block, depth, panel in tiers}
    want |= {(panel + 2 * t, block + 2 * t) for block, depth, panel in band3
             for t in (depth, depth - 2, 2) if t >= 2}
    assert listed == want
    monkeypatch.setattr(tt, "TRAPEZOID_TIERS", (((36, 4, 56), 0), ((32, 4, 72), 0)))
    monkeypatch.setattr(tb3, "BAND3_TIERS", (((24, 4, 56), 0), ((16, 2, 30), 0)))
    assert _build.trap_windows() == ((34, 20), (60, 28), (64, 32), (64, 44), (80, 40))


@pytest.mark.parametrize("depth", [3, 4, 8])
def test_widest_window_and_refusal(depth):
    """At T 3, 4 and 8 (block 32), the widest panel whose one-copy window
    fits a block is held and one column more is refused."""
    panel = 1
    while BC.smem_bytes(tt.PLANE_COPIES, 4096, 32, depth, panel + 1) <= BC.SMEM_LIMIT:
        panel += 1
    BC.check_smem("temporal kernel", tt.PLANE_COPIES, 4096, 32, depth, panel)
    assert 40 * (32 + 2 * depth) * (panel + 2 * depth) <= BC.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        BC.check_smem("temporal kernel", tt.PLANE_COPIES, 4096, 32, depth, panel + 1)
    assert tt.temporal_supported(104, 4096, 32, depth, panel)
    assert td.deep_supported(104, 4096, 32, depth, panel)


# The JAX package's schedule of each route on the CLI decks below, through
# its env knobs, and the port's pickers set to it: K5 at an odd T.
CLI_SCHEDULES = {"temporal": ({"LBM_TEMPORAL_BLOCK": "16", "LBM_TEMPORAL_DEPTH": "3"},
                              (16, 3, None), 3),
                 "deep": ({"LBM_DEEP_BLOCK": "32", "LBM_DEEP_DEPTH": "8"}, (32, 8, None), 8)}


@pytest.mark.parametrize("backend", list(CLI_SCHEDULES))
def test_both_clis_at_c16(backend, tmp_path, capsys, monkeypatch):
    """``--precision c16 --backend temporal|deep`` through both CLIs on one
    schedule on a 128 x 32 deck (K5 at T 3 on 16-row blocks, K6 at T 8 on
    one 32-row block that wraps onto itself), one pass (tests/test_torch_
    c16_routes.py runs remainders): the checker's 1% gate, av_vels at rtol 1e-3 and the pressure column
    within 5e-6."""
    env, schedule, iters = CLI_SCHEDULES[backend]
    ny = 32
    write_params_file(tmp_path / "input.params", 128, ny, iters, 10, DENSITY, ACCEL, OMEGA)
    obs = np.zeros((ny, 128), np.int32)
    obs[0] = obs[-1] = 1
    obs[10:14, 40] = 1
    write_obstacle_file(tmp_path / "obstacles.dat", obs)
    deck = [str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat")]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr({"temporal": tt, "deep": td}[backend], "schedule",
                        lambda params, dtype: schedule)
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
