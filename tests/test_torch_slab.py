"""The slab route (``lbm_tpu_torch/ops/slab.py``, kernel K13) against the
JAX package's ``pallas_slab.run_band_slab``, run in interpret mode on the
CPU at tests/test_slab.py's shapes (block 16, depth 8, ny 96), and its
quarantine, refusals and driver.

The plain K13 keeps ``_kernel_slab``'s forcing by global row (the copies
of row ny-2 in the neighbour slabs' halos included), its ownership-masked
sums and its remainder on the band route. At f32 the tolerance is
tests/test_slab.py's against the oracle: cells within 1e-5 of the state's
scale and the |u| sums at rtol 1e-4. At c16 both packages round once per
pass, and the decoded cells are held within 5e-6 with the sums at rtol
1e-3, tests/test_c16.py's (a low bit of the two packages' f32 arithmetic
can move a code by one quantum, ~1e-6 here, at a rounding tie; from rest
the sums are small enough for that to show at 1.6e-4).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.models.d2q9 import LBMParams as JParams
from lbm_tpu.ops import devspace as jdev
from lbm_tpu.ops.pallas_slab import run_band_slab as j_run_band_slab
from lbm_tpu.runtime import driver as jdriver
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.models.d2q9 import WEIGHTS, LBMParams
from lbm_tpu_torch.ops import devspace as tdev
from lbm_tpu_torch.ops import slab as tslab
from lbm_tpu_torch.ops import step as tstep
from lbm_tpu_torch.parallel import sharded as tsharded
from lbm_tpu_torch.runtime import driver as tdriver

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
NX = 128
SPEC = tdev.DevSpec.for_params(DENSITY, ACCEL)
JSPEC = jdev.DevSpec.for_params(DENSITY, ACCEL)


def make_setup(ny, seed=5):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, NX), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 10), rng.randint(0, NX, 10)] = 1
    state = ((WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, NX))).astype(np.float32)
    return state, obstacles


def assert_matches_jax(state, obstacles, n, kpasses, sblock, c16):
    nobst = (obstacles == 0).astype(np.float32)
    x = np.array(jdev.encode_state(jnp.asarray(state), JSPEC)) if c16 else state
    want, want_tot = j_run_band_slab(
        jnp.asarray(x), jnp.asarray(nobst), DENSITY, ACCEL, OMEGA, n, 16, 8, kpasses, sblock,
        interpret=True, paired="fused", dev=(*JSPEC.bg, JSPEC.h) if c16 else None)
    got, av = tslab.run_band_slab(torch.as_tensor(x), torch.as_tensor(nobst), DENSITY, ACCEL,
                                  OMEGA, n, 16, 8, kpasses, sblock, dev=SPEC if c16 else None)
    assert av.shape == (n,)
    if c16:
        assert got.dtype == torch.int16
        got = tdev.decode_state(got, SPEC).numpy()
        want = np.asarray(jdev.decode_state(want, JSPEC))
        assert np.abs(got - want).max() < 5e-6
    else:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() < 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(av.numpy(), np.asarray(want_tot), rtol=1e-3 if c16 else 1e-4)


@pytest.mark.parametrize("c16", [False, True], ids=["f32", "c16"])
@pytest.mark.parametrize("kpasses,sblock", [(1, 32), (2, 32), (2, 48)])
def test_slab_plain_matches_pallas_slab(kpasses, sblock, c16):
    """Two whole generations at ny 96: three slabs (two of 48), both edge
    slabs wrapping, the forcing row in the last slab and in slab 0's halo."""
    state, obstacles = make_setup(96)
    assert_matches_jax(state, obstacles, 2 * kpasses * 8, kpasses, sblock, c16)


@pytest.mark.parametrize("c16", [False, True], ids=["f32", "c16"])
def test_slab_forcing_from_rest(c16):
    """From rest only the forcing makes a signal: row ny-2 sits in the last
    slab's owned rows and in the first slab's wrap halo, and both copies
    must be forced (tests/test_slab.py:38-55)."""
    ny = 64
    obstacles = np.zeros((ny, NX), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    state = np.broadcast_to((WEIGHTS * DENSITY)[:, None, None], (9, ny, NX)).astype(np.float32)
    assert_matches_jax(state, obstacles, 32, 2, 32, c16)


@pytest.mark.parametrize("c16", [False, True], ids=["f32", "c16"])
def test_slab_remainder(c16):
    """43 = 2 generations of 16 + one band pass + a 3-step K1 tail."""
    state, obstacles = make_setup(96, seed=9)
    assert_matches_jax(state, obstacles, 43, 2, 32, c16)


@pytest.mark.parametrize("kpasses,sblock,panel", [(1, 8, 12), (3, 12, None), (2, 24, 20)])
def test_slab_plain_matches_step_bitwise(kpasses, sblock, panel):
    """At a ragged 48 x 40 grid under 16 x 12 tiles (T 4), where no JAX slab
    kernel goes: K1's plain state bit for bit (the genuine cells take the
    same arithmetic)."""
    state, obstacles = make_setup(48, seed=kpasses)
    state = state[:, :, :40].copy()
    nobst = torch.as_tensor((obstacles[:, :40] == 0).astype(np.float32))
    want, want_av = tstep.run_step_plain(torch.as_tensor(state), nobst, DENSITY, ACCEL, OMEGA,
                                         27, 1.0)
    got, av = tslab.run_band_slab(torch.as_tensor(state), nobst, DENSITY, ACCEL, OMEGA, 27, 16, 4,
                                  kpasses, sblock, panel=panel)
    assert torch.equal(got, want)
    np.testing.assert_allclose(av.numpy(), want_av.numpy(), rtol=1e-5)


def test_slab_supported():
    assert tslab.slab_supported(96, 128, 16, 8, 2, 32)
    assert not tslab.slab_supported(96, 128, 16, 8, 2, 96)   # one slab = the plain band pass
    assert not tslab.slab_supported(96, 128, 16, 8, 2, 40)   # ny % sblock
    assert not tslab.slab_supported(96, 128, 16, 8, 6, 32)   # K*T > sblock
    assert not tslab.slab_supported(96, 128, 16, 8, 0, 32)   # K < 1
    # The TPU's BlockSpec alignments are not kept: 2KT = 48 is no multiple
    # of block 32 (pallas_slab refuses), and (24, 4, 56) with K = 4 has
    # 2KT = 32, no multiple of 24.
    assert tslab.slab_supported(96, 128, 32, 8, 3, 32)
    assert tslab.slab_supported(1024, 1024, 24, 4, 4, 512, 56)
    state, obstacles = make_setup(96)
    with pytest.raises(ValueError, match="slab kernel unsupported"):
        tslab.run_band_slab(torch.as_tensor(state), torch.as_tensor((obstacles == 0) * 1.0).float(),
                            DENSITY, ACCEL, OMEGA, 8, 16, 8, 2, 40)


PARAMS = LBMParams(nx=NX, ny=96, max_iters=32, reynolds_dim=10, density=DENSITY, accel=ACCEL,
                   omega=OMEGA)


def test_slab_is_quarantined(monkeypatch):
    """Without LBM_ENABLE_SLAB=1 the driver raises and the CLI does not list
    the backend (lbm_tpu/cli.py:39-45, driver.py:543-548)."""
    monkeypatch.delenv("LBM_ENABLE_SLAB", raising=False)
    _, obstacles = make_setup(96)
    for dtype in (torch.float32, "c16"):
        with pytest.raises(ValueError, match="quarantined"):
            tdriver.run_simulation(PARAMS, obstacles, device="cpu", backend="slab", dtype=dtype)
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["a", "b", "--backend", "slab"])
    monkeypatch.setenv("LBM_ENABLE_SLAB", "1")
    assert tcli.build_parser().parse_args(["a", "b", "--backend", "slab"]).backend == "slab"


def test_slab_refusals(monkeypatch):
    monkeypatch.setenv("LBM_ENABLE_SLAB", "1")
    obstacles = np.zeros((31, NX), np.int32)
    with pytest.raises(ValueError, match="slab"):  # no slab of >= K*T rows divides ny
        tdriver.run_simulation(dataclasses.replace(PARAMS, ny=31), obstacles, device="cpu",
                               backend="slab")
    with pytest.raises(ValueError, match="slab backend stores f32 only"):
        tdriver.run_simulation(PARAMS, make_setup(96)[1], device="cpu", backend="slab",
                               dtype=torch.float64)
    monkeypatch.setenv("LBM_SLAB_S", "40")
    with pytest.raises(ValueError, match="slab"):
        tdriver.run_simulation(PARAMS, make_setup(96)[1], device="cpu", backend="slab")


@pytest.mark.parametrize("mesh", [2, (2, 1)], ids=["1-D", "2-D"])
def test_slab_under_a_mesh_raises(mesh, monkeypatch):
    monkeypatch.setenv("LBM_ENABLE_SLAB", "1")
    _, obstacles = make_setup(96)
    with pytest.raises(ValueError, match="slab backend is single-device only"):
        if isinstance(mesh, tuple):
            tsharded.run_simulation_sharded_2d(PARAMS, obstacles, mesh_shape=mesh,
                                               devices=["cpu"] * 2, backend="slab")
        else:
            tsharded.run_simulation_sharded(PARAMS, obstacles, devices=["cpu"] * 2, backend="slab")


@pytest.mark.parametrize("dtype", ["f32", "c16"])
def test_slab_driver_matches_jax_driver(dtype, monkeypatch):
    """``run_simulation(backend="slab")`` in both packages with the same
    ``LBM_SLAB_K``/``LBM_SLAB_S``; each package's band pass is its own
    (JAX: LBM_BAND_BLOCK/DEPTH 16/8, the port: K7's schedule, (24, 4, 24)
    on this grid), which the genuine cells do not see."""
    monkeypatch.setenv("LBM_ENABLE_SLAB", "1")
    monkeypatch.setenv("LBM_BAND_BLOCK", "16")
    monkeypatch.setenv("LBM_BAND_DEPTH", "8")
    monkeypatch.setenv("LBM_SLAB_K", "2")
    monkeypatch.setenv("LBM_SLAB_S", "32")
    _, obstacles = make_setup(96)
    assert tslab.schedule(PARAMS, torch.float32) == (24, 4, 24, 2, 32)
    jdtype = jnp.float32 if dtype == "f32" else "c16"
    want = jdriver.run_simulation(JParams(**dataclasses.asdict(PARAMS)), obstacles,
                                  backend="slab", dtype=jdtype)
    got = tdriver.run_simulation(PARAMS, obstacles, device="cpu", backend="slab",
                                 dtype=torch.float32 if dtype == "f32" else "c16")
    assert got.route == "slab" and got.cells.dtype == np.float32
    if dtype == "f32":
        np.testing.assert_allclose(got.cells, want.cells, atol=3e-7)
        np.testing.assert_allclose(got.av_vels, want.av_vels, rtol=5e-5, atol=3e-8)
    else:  # the packages' passes are 4 and 8 steps: other rounding points
        np.testing.assert_allclose(got.cells, want.cells, atol=1e-5)
        np.testing.assert_allclose(got.av_vels, want.av_vels, rtol=2e-3, atol=1e-9)


def test_slab_default_schedule(monkeypatch):
    monkeypatch.delenv("LBM_SLAB_K", raising=False)
    monkeypatch.delenv("LBM_SLAB_S", raising=False)
    cfg = tslab.schedule(dataclasses.replace(PARAMS, ny=1024, nx=1024), torch.float32)
    assert cfg[:4] == (32, 4, 56, 4) and 1024 % cfg[4] == 0 and 16 <= cfg[4] < 1024
    assert tslab.schedule(dataclasses.replace(PARAMS, ny=1024, nx=1024), "c16") == cfg
    assert tslab.schedule(PARAMS, torch.float64) is None
