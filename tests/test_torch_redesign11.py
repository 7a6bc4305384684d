"""The CPU side of K7 and K8 redesigned for the H100: one shared-memory
window per tile, stepped in place in the AA arrangement at any T
(``csrc/band_common.cuh``'s one-window pass, which K9, K10 and K13 run
too), and ``auto`` above K4's states on K6.

``band_common.aa_step_plain`` is that pass in plain PyTorch: the window's
R values into the AA slots with the forcing row forced, odd steps gathering
and scattering, even ones cell-local, the store of an odd T from where the
last step scattered, and a window that does not wrap (a gather from beyond
its edge reads NaN, a slot no cell scatters to becomes NaN).
``band.run_band_aa_plain`` and ``band.run_band_sharded_aa_plain`` run it
as K7 and K8 do. It is held bit for bit, state and av series, against the
pull (``run_band_plain``, ``run_band_sharded_plain``) at T 1, 3, 4 and 5,
full row and panel, on ragged grids and on 1-D shards, at f32, and within
the kernels' tolerances at c16 (decoded cells 5e-6, av rtol 1e-3) and bf16
(2 ulps on at most 1% of the values); its NaN ring after T steps is
exactly the T cells the kernel's wrap reaches. ``run_band`` on the CPU at
odd T is held against the JAX kernel ``pallas_band.run_band`` (whose
domain is T a multiple of 8) in interpret mode over the same steps, cells
within 1e-5 of the state's scale and av at rtol 1e-4.

The route: ``select_route`` at K4's limit on both sides, and ``auto`` on
an explicit CPU running the plain version of K6 there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import pallas_band as jb
from lbm_tpu_torch.models.d2q9 import WEIGHTS, LBMParams
from lbm_tpu_torch.ops import band as tb
from lbm_tpu_torch.ops import band_common as BC
from lbm_tpu_torch.ops import deep as td
from lbm_tpu_torch.ops import devspace as tdev
from lbm_tpu_torch.ops import slab as tslab
from lbm_tpu_torch.ops import step as tstep
from lbm_tpu_torch.ops.step import forcing_weights
from lbm_tpu_torch.runtime import driver as tdriver
from lbm_tpu_torch.utils.geometry import box_with_vertical_wall

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
SPEC = tdev.DevSpec.for_params(DENSITY, ACCEL)


def make_setup(nx, ny, seed):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 10), rng.randint(0, nx, 10)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    return state.astype(np.float32), (obstacles == 0).astype(np.float32)


def tensors(nx, ny, seed):
    state, nobst = make_setup(nx, ny, seed)
    return torch.as_tensor(state), torch.as_tensor(nobst)


# (nx, ny, block, depth, panel): T 1, 3, 4 and 5, full row and panel, ragged
# tiles, a block shorter than 2T and a one-row, one-column tile.
SCHEDULES = [(45, 37, 8, 1, 11), (45, 37, 8, 1, None), (45, 37, 7, 3, 11), (45, 37, 5, 3, None),
             (45, 37, 8, 4, 10), (45, 37, 9, 4, None), (45, 37, 7, 5, 13), (45, 37, 12, 5, None),
             (21, 17, 1, 3, 1)]


@pytest.mark.parametrize("nx,ny,block,depth,panel", SCHEDULES)
def test_aa_model_is_the_pull_bit_for_bit(nx, ny, block, depth, panel):
    """Two passes and a K1 remainder: the AA model's state and av series
    are run_band_plain's bits, and the state is K1's plain step's."""
    cells, nob = tensors(nx, ny, seed=nx + depth)
    n = 2 * depth + 3
    args = (cells, nob, DENSITY, ACCEL, OMEGA, n, block, depth)
    got = tb.run_band_aa_plain(*args, panel=panel)
    want = tb.run_band_plain(*args, panel=panel)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], tstep.run_step_plain(cells, nob, DENSITY, ACCEL, OMEGA, n, 1.0)[0])


def bf16_ulps(got, want):
    def ordered(x):
        u = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u)

    return (ordered(got) - ordered(want)).abs()


@pytest.mark.parametrize("nx,ny,block,depth,panel", [SCHEDULES[2], SCHEDULES[4], SCHEDULES[7]])
@pytest.mark.parametrize("storage", ["c16", "bf16"])
def test_aa_model_16_bit(storage, nx, ny, block, depth, panel):
    """At c16 and bf16 the model decodes before each pass and encodes after
    it, as the pull does: held at the kernels' tolerances."""
    dev = SPEC if storage == "c16" else tdev.BF16
    cells, nob = tensors(nx, ny, seed=nx + depth)
    q = tdev.encode_state(cells, dev)
    n = 2 * depth + 3
    args = (q, nob, DENSITY, ACCEL, OMEGA, n, block, depth)
    (gc, ga), (wc, wa) = (tb.run_band_aa_plain(*args, panel=panel, dev=dev),
                          tb.run_band_plain(*args, panel=panel, dev=dev))
    assert gc.dtype == q.dtype
    if storage == "c16":
        assert float((tdev.decode_state(gc, dev) - tdev.decode_state(wc, dev)).abs().max()) < 5e-6
    else:
        ulps = bf16_ulps(gc, wc)
        assert int(ulps.max()) <= 2 and float((ulps > 0).float().mean()) <= 0.01
    np.testing.assert_allclose(ga.numpy(), wa.numpy(), rtol=1e-3)


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_aa_model_nan_ring_is_the_wrap_reach(depth):
    """One pass on one all-fluid window (a bounced cell would keep the one
    value it reflects): after T steps exactly the cells within T of the
    window's edge are NaN, the cells the kernel's wrapped edge values reach,
    and every cell further in is finite."""
    state, _ = make_setup(24, 20, seed=depth)
    w1a, w2a = forcing_weights(DENSITY, ACCEL)
    step = BC.aa_step_plain(OMEGA, w1a, w2a, depth)
    planes = list(torch.as_tensor(state)[:, None].unbind(0))
    nob = torch.ones((1, 20, 24))
    frow = torch.zeros((1, 20, 1))
    frow[0, 18] = 1.0
    for s in range(depth):
        planes, _ = step(s, planes, nob, frow)
    r = torch.arange(20)[:, None]
    c = torch.arange(24)[None, :]
    ring = torch.minimum(torch.minimum(r, 19 - r), torch.minimum(c, 23 - c))
    for k in range(9):
        assert torch.equal(torch.isnan(planes[k][0]), ring < depth)


@pytest.mark.parametrize("depth,panel", [(1, 7), (3, 20), (4, None), (5, None)])
def test_k8_aa_model_is_the_pull_bit_for_bit(depth, panel):
    """K8's model on 4 row shards of 25 rows (16-row tiles, a ragged last
    one), two passes and a shard-step remainder: the pull's bits, and the
    joined state K1's plain step's."""
    ny, nx = 100, 40
    cells, nob = tensors(nx, ny, seed=depth)
    shards = [[cells[:, z * 25:(z + 1) * 25].contiguous()] for z in range(4)]
    nobs = [[nob[z * 25:(z + 1) * 25].contiguous()] for z in range(4)]
    n = 2 * depth + 3
    args = (shards, nobs, DENSITY, ACCEL, OMEGA, n, 16, depth, ny)
    got = tb.run_band_sharded_aa_plain(*args, panel=panel)
    want = tb.run_band_sharded_plain(*args, panel=panel)
    joined = torch.cat([row[0] for row in got[0]], dim=1)
    assert torch.equal(joined, torch.cat([row[0] for row in want[0]], dim=1))
    assert torch.equal(got[1], want[1])
    assert torch.equal(joined, tstep.run_step_plain(cells, nob, DENSITY, ACCEL, OMEGA, n, 1.0)[0])


@pytest.mark.parametrize("storage", ["c16", "bf16"])
def test_k8_aa_model_16_bit(storage):
    """K8's model at T 3 on 4 shards at c16 and bf16: the halos carry the
    neighbours' codes (bfloat16 values), held at the kernels' tolerances."""
    dev = SPEC if storage == "c16" else tdev.BF16
    ny, nx = 100, 40
    cells, nob = tensors(nx, ny, seed=11)
    q = tdev.encode_state(cells, dev)
    shards = [[q[:, z * 25:(z + 1) * 25].contiguous()] for z in range(4)]
    nobs = [[nob[z * 25:(z + 1) * 25].contiguous()] for z in range(4)]
    args = (shards, nobs, DENSITY, ACCEL, OMEGA, 9, 16, 3, ny)
    got = tb.run_band_sharded_aa_plain(*args, panel=20, dev=dev)
    want = tb.run_band_sharded_plain(*args, panel=20, dev=dev)
    g = torch.cat([row[0] for row in got[0]], dim=1)
    w = torch.cat([row[0] for row in want[0]], dim=1)
    if storage == "c16":
        assert float((tdev.decode_state(g, dev) - tdev.decode_state(w, dev)).abs().max()) < 5e-6
    else:
        ulps = bf16_ulps(g, w)
        assert int(ulps.max()) <= 2 and float((ulps > 0).float().mean()) <= 0.01
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-3)


def test_k13_pass_on_the_aa_model_is_the_pull():
    """One K13 pass over a slab buffer (rows wrapping within it, global rows
    r0 + row for the forcing, sums of the owned rows only) in the AA model
    gives the pull's bits."""
    ny, nx, sblock, kt = 32, 30, 16, 6
    cells, nob = tensors(nx, ny, seed=13)
    r0 = sblock - kt
    rows = (torch.arange(sblock + 2 * kt) + r0) % ny
    slab, nob_slab = cells[:, rows], nob[rows]
    w1a, w2a = forcing_weights(DENSITY, ACCEL)
    kw = dict(r0=r0, ny_global=ny, own=(kt, kt + sblock))
    got = BC.creep_pass_plain(slab, nob_slab, 8, 3, 12,
                              BC.aa_step_plain(OMEGA, w1a, w2a, 3), **kw)
    want = BC.creep_pass_plain(slab, nob_slab, 8, 3, 12,
                               BC.r_step_plain(OMEGA, w1a, w2a), **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(want[0], tslab.step_band_slab(slab, nob_slab, r0, DENSITY, ACCEL, OMEGA,
                                                     8, 3, ny, (kt, kt + sblock),
                                                     panel=12)[0])


def jax_band(state, nobst, n, *, panel=None):
    kw = {} if panel is None else {"panel": panel, "halo": 128}
    want, tot = jb.run_band(jnp.asarray(state, jnp.float32), jnp.asarray(nobst, jnp.float32),
                            DENSITY, ACCEL, OMEGA, n, 16, 8, interpret=True, paired="fused",
                            **kw)
    return np.asarray(want), np.asarray(tot)


@pytest.mark.parametrize("nx,block,depth,panel,jax_panel", [(128, 16, 3, None, None),
                                                            (256, 12, 5, 40, 128)])
def test_run_band_odd_t_matches_pallas_band(nx, block, depth, panel, jax_panel):
    """19 steps of run_band (the pull on the CPU) and of its AA model at an
    odd T, against the JAX band kernel at T 8 in interpret mode (two passes
    and a K1 remainder there): the same 19 steps of the same function."""
    state, nobst = make_setup(nx, 64, seed=nx + depth)
    want, want_tot = jax_band(state, nobst, 19, panel=jax_panel)
    args = (torch.as_tensor(state), torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA, 19, block,
            depth)
    for run in (tb.run_band, tb.run_band_aa_plain):
        cells, av = run(*args, panel=panel)
        assert np.abs(cells.numpy() - want).max() < 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(av.numpy(), want_tot, rtol=1e-4)


def test_band_windows_are_bounded_by_shared_memory():
    """The one-copy window is held to a block's shared memory, not to the
    4,096 cells of the register-carried body: a 40 x 104 window (4,160
    cells, 166 KB) is taken, a 72 x 104 one (300 KB) refused."""
    BC.check_smem("band kernel", tb.PLANE_COPIES, 4096, 32, 4, 96)
    with pytest.raises(ValueError, match="shared memory"):
        BC.check_smem("band kernel", tb.PLANE_COPIES, 4096, 64, 4, 96)


@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048, 4096])
def test_band_config_fits_the_kernel(n):
    """K7's driver schedule on square grids: a schedule K7 takes whose
    window holds two blocks on an SM."""
    params = LBMParams(nx=n, ny=n, max_iters=1, reynolds_dim=10, density=DENSITY, accel=ACCEL,
                       omega=OMEGA)
    block, depth, panel = tb.schedule(params, torch.float32)
    assert tb.band_supported(n, n, block, depth, panel)
    assert 2 * (BC.smem_bytes(tb.PLANE_COPIES, n, block, depth, panel) + 1024) <= 228 * 1024


def limit_side():
    """The largest square side whose f32 state auto gives to K4."""
    side = 1
    while 9 * (side + 1) ** 2 * 4 <= tdriver._RESIDENT_AUTO_MAX_STATE:
        side += 1
    return side


@pytest.mark.parametrize("above", [False, True])
def test_select_route_at_the_limit(above):
    """K4 up to its state limit, K6 above it, on both sides of the limit."""
    side = limit_side() + above
    params = LBMParams(nx=side, ny=side, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    assert tdriver.select_route(params, "auto", torch.float32) == ("deep" if above else
                                                                   "resident")
    assert tdriver.select_route(params, "auto", "c16") == "pallas"
    assert tdriver.select_route(params, "auto", torch.bfloat16) == "aa"


def test_cpu_auto_above_the_limit_runs_k6_plain():
    """auto on an explicit CPU one cell above K4's limit runs the plain
    version of K6 at the driver's schedule: one pass and a K1 step."""
    side = limit_side() + 1
    params = LBMParams(nx=side, ny=side, max_iters=5, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    obstacles = box_with_vertical_wall(side, side)
    result = tdriver.run_simulation(params, obstacles, backend="auto", device="cpu")
    assert result.route == "deep"
    block, depth, panel = td.schedule(params, torch.float32)
    cells = tdriver.D2Q9.initial_state(params, dtype=torch.float32, device="cpu")
    nob = torch.as_tensor((obstacles == 0).astype(np.float32))
    want, av = td.run_deep_plain(cells, nob, DENSITY, ACCEL, OMEGA, 5, block, depth, panel=panel,
                                 inv_tot_cells=float(np.float32(1.0 / int(nob.sum()))))
    np.testing.assert_array_equal(result.cells, want.numpy())
    np.testing.assert_array_equal(result.av_vels, av.numpy())
