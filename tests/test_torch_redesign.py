"""The schedules of the main path's two kernels, K4 and K11, on the CPU.

K4's shared-memory form (``csrc/resident.cu``) holds slabs of whole rows
with T ghost rows in shared memory, runs T steps per pass on rows that
shrink by one at each edge per step, and exchanges edge rows by pass
parity; ``run_resident_slabs_plain`` is that schedule in plain PyTorch. It
is held against the JAX Pallas kernel ``pallas_resident._mega_kernel`` (as
tests/test_torch_resident.py runs it, ``interpret=True``) and against
``run_resident_plain``: the cells bit for bit (the same arithmetic per
cell), the av series at rtol 1e-4 (another summation order), the K4
tolerances. ``resident_smem_config`` is held against the byte formula
written out here.

K11 (``csrc/band3.cu``) updates every window cell at every step of a pass;
by AA's dependencies step j needs only the cells at inset j-1 for the
central tile. A poisoned run of ``run_band3_plain``'s step, which writes
only at those insets, stores the same tile and sums: the fact a K11 that
skips the other cells would rest on. The driver's K11 schedule fits a
block's shared memory.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbm_tpu.ops.pallas_resident as jres
from lbm_tpu_torch.models.d2q9 import WEIGHTS
from lbm_tpu_torch.ops import band3 as tb3
from lbm_tpu_torch.ops import band_common as BC
from lbm_tpu_torch.ops import resident as tres
from lbm_tpu_torch.ops.step import forcing_weights

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
INV = 1.0 / 3000.0
LIMIT = 232448 - 1024  # ops/band_common.py::SMEM_LIMIT


def make_setup(nx, ny, seed=3):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(0, ny, 8), rng.randint(0, nx, 8)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    return state.astype(np.float32), (obstacles == 0).astype(np.float32)


def test_slabs_plain_matches_jax_resident():
    """32 x 128 in slabs of 5 rows (the last 2), T 4 over 9 steps (a pass of
    1): the forcing row 30 is the last slab's first row and a ghost row of
    the slab above."""
    state, nobst = make_setup(128, 32)
    want, want_tot = jres.run_resident(jnp.asarray(state), jnp.asarray(nobst), DENSITY, ACCEL,
                                       OMEGA, 9, interpret=True, paired="fused")
    cells, av = tres.run_resident_slabs_plain(torch.as_tensor(state), torch.as_tensor(nobst),
                                              DENSITY, ACCEL, OMEGA, 9, INV, 5, 4)
    want = np.asarray(want)
    assert cells.dtype == torch.float32 and av.shape == (9,)
    assert np.abs(cells.numpy() - want).max() < 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(av.numpy(), np.asarray(want_tot, np.float32) * np.float32(INV),
                               rtol=1e-4)


@pytest.mark.parametrize("nx,ny,rows,depth,steps", [
    (12, 9, 1, 4, 254),    # slabs of 1 row: ghosts from four neighbours each side
    (10, 13, 3, 4, 255),   # B does not divide ny; 255 = 63 passes of 4 and one of 3
    (8, 11, 4, 3, 256),    # T 3; the forcing row 9 inside the last slab, a ghost above
    (6, 3, 1, 4, 13),      # a window taller than the grid: ghost rows wrap more than once
], ids=lambda v: str(v))
def test_slabs_plain_matches_resident_plain(nx, ny, rows, depth, steps):
    state, nobst = make_setup(nx, ny, seed=steps)
    cells, nob = torch.as_tensor(state), torch.as_tensor(nobst)
    want = tres.run_resident_plain(cells, nob, DENSITY, ACCEL, OMEGA, steps, INV)
    got = tres.run_resident_slabs_plain(cells, nob, DENSITY, ACCEL, OMEGA, steps, INV, rows,
                                        depth, chunk=255 if steps > 13 else 5)
    assert torch.equal(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-4)


def test_slabs_plain_rejects_bad_schedule():
    state, nobst = make_setup(8, 8)
    with pytest.raises(ValueError):
        tres.run_resident_slabs_plain(torch.as_tensor(state), torch.as_tensor(nobst), DENSITY,
                                      ACCEL, OMEGA, 4, INV, 0, 4)


def smem_formula(nx, rows, depth):
    """Two f32 copies of 9 planes and the not-obstacle plane of a (rows + 2T)
    x nx window, an int per window row, a float per warp (16) and step."""
    wh = rows + 2 * depth
    return 19 * 4 * wh * nx + 4 * wh + 16 * 4 * depth


@pytest.mark.parametrize("ny,nx,want", [
    (128, 128, (128, 1, 4)),    # the 128^2 deck
    (256, 128, (128, 2, 4)),    # 128 x 256
    (256, 256, (128, 2, 3)),    # 256^2: T 3 on 256-wide rows
    (384, 384, (128, 3, 2)),    # 384^2
    (1320, 128, (132, 10, 4)),  # ten rows per block still hold T 4
    (2640, 128, (132, 20, 1)),  # twenty: T 4, 3 and 2 do not fit
    (396, 384, (132, 3, 2)),    # three 384-wide rows per block hold T 2
    (528, 384, (132, 4, 1)),    # four: T 1
    (132, 1014, (132, 1, 1)),   # the widest rows at all
    (132, 1015, None),          # one column more: the global-memory form
    (1024, 1024, None),
])
def test_resident_smem_config_at_its_cap(ny, nx, want):
    got = tres.resident_smem_config(ny, nx, 132)
    if want is None:
        assert got is None
        assert smem_formula(nx, -(-ny // 132), 1) > LIMIT
        return
    blocks, rows, depth = want
    assert got == (blocks, rows, depth, smem_formula(nx, rows, depth))
    assert got[3] <= LIMIT
    for deeper in range(depth + 1, tres.smem_depth(nx) + 1):
        assert smem_formula(nx, rows, deeper) > LIMIT
    assert blocks * rows >= ny > (blocks - 1) * rows


@pytest.mark.parametrize("nx,depth", [(8, 4), (128, 4), (129, 4), (171, 3), (256, 3),
                                      (257, 2), (384, 2), (512, 2), (513, 1), (4096, 1)])
def test_resident_smem_depth(nx, depth):
    """One more than the rows 512 threads cover, at most 4."""
    assert tres.smem_depth(nx) == depth


def test_driver_k11_schedule_fits():
    """The driver's K11 schedule fits a block, its split final pass too."""
    from lbm_tpu_torch.models.d2q9 import LBMParams

    params = LBMParams(nx=2048, ny=2048, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    block, depth, panel = tb3.schedule(params, torch.float32)
    for t in (depth, 2):
        assert BC.smem_bytes(tb3.PLANE_COPIES, 2048, block, t, panel) <= BC.SMEM_LIMIT


def poisoned_step(omega, w1a, w2a, depth, fuse_last):
    """K11's step confined to the insets: step s (0-based) writes only what
    the cells at inset s write (even: all slots of the cell; odd: slot k of
    cell x + c_k), and every other slot is NaN after it."""
    inner = tb3.s_step_plain(omega, w1a, w2a, depth, fuse_last)

    def step(s, planes, nob, frow):
        out, u_sq = inner(s, planes, nob, frow)
        wh, ww = nob.shape[1:]
        rows, cols = torch.arange(wh)[:, None], torch.arange(ww)[None, :]

        def region(dy, dx):  # the writer cell of each slot at inset s
            r, c = rows - dy, cols - dx
            return (r >= s) & (r < wh - s) & (c >= s) & (c < ww - s)

        nan = torch.tensor(float("nan"))
        if s % 2 == 0:
            keep = region(0, 0)
            return [torch.where(keep, p, nan) for p in out], torch.where(keep, u_sq, nan)
        return ([torch.where(region(BC.CYS[k], BC.CXS[k]), out[k], nan) for k in range(9)],
                torch.where(region(0, 0), u_sq, nan))

    return step


@pytest.mark.parametrize("block,depth,panel", [(24, 4, 20), (16, 8, None)])
def test_band3_inset_steps_leave_the_tile_unchanged(block, depth, panel):
    """A pass whose steps write only at the insets (the rest NaN) stores the
    same tile and sums as the pass over whole windows."""
    state, nobst = make_setup(44, 50, seed=depth)
    w1a, w2a = forcing_weights(DENSITY, ACCEL)
    s_state = tb3.force_s(tb3.stream_planes(torch.as_tensor(state)), torch.as_tensor(nobst),
                          w1a, w2a)
    nob = torch.as_tensor(nobst)
    for fuse in (True, False):
        runs = [BC.creep_pass_plain(s_state, nob, block, depth, panel,
                                    fn(float(OMEGA), w1a, w2a, depth, fuse))
                for fn in (poisoned_step, tb3.s_step_plain)]
        (got, got_sums), (want, want_sums) = runs
        assert bool(torch.isfinite(got).all()) and torch.equal(got, want)
        assert torch.equal(got_sums, want_sums)
