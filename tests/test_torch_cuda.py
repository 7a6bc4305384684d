"""The CUDA kernels on the card: K1, K2, the band kernels K7, K9, K11, the
resident, temporal and deep kernels K4, K5, K6, the shard kernels K3,
K12, K8, K10, the slab kernel K13 and the c16 forms of K1, K2, K3, K5-K11
and K13 against their plain versions.

These tests need an NVIDIA GPU and nvcc; without a card they skip. They
import neither JAX nor the JAX package, so they run where only the port's
dependencies exist. On the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX for the other tests.)
Tolerances: cells within 1e-5 of the state's scale and the av series at
rtol 1e-4 (the kernels contract multiply-adds into FMAs and sum in another
order than PyTorch); at c16 the decoded cells within 5e-6 and the av
series at rtol 1e-3 (an FMA can move a code by one quantum at a rounding
tie).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lbm_tpu_torch.models.d2q9 import WEIGHTS  # noqa: E402
from lbm_tpu_torch.ops import aa as taa  # noqa: E402
from lbm_tpu_torch.ops import band as tband  # noqa: E402
from lbm_tpu_torch.ops import band2 as tband2  # noqa: E402
from lbm_tpu_torch.ops import band3 as tband3  # noqa: E402
from lbm_tpu_torch.ops import deep as tdeep  # noqa: E402
from lbm_tpu_torch.ops import devspace as tdev  # noqa: E402
from lbm_tpu_torch.ops import resident as tres  # noqa: E402
from lbm_tpu_torch.ops import shard_step as tshard  # noqa: E402
from lbm_tpu_torch.ops import slab as tslab  # noqa: E402
from lbm_tpu_torch.ops import step as tstep  # noqa: E402
from lbm_tpu_torch.ops import temporal as ttemp  # noqa: E402

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def make_setup(device, nx, ny, seed):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 8), rng.randint(0, nx, 8)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    cells = torch.as_tensor(state.astype(np.float32)).to(device)
    return cells, torch.as_tensor((obstacles == 0).astype(np.float32)).to(device)


def assert_close(got, want):
    (gc, ga), (wc, wa) = got, want
    assert float((gc - wc).abs().max()) < 1e-5 * float(wc.abs().max())
    np.testing.assert_allclose(ga.cpu().numpy(), wa.cpu().numpy(), rtol=1e-4)


SPEC = tdev.DevSpec.for_params(DENSITY, ACCEL)


def assert_c16_close(got, want):
    (gc, ga), (wc, wa) = got, want
    assert gc.dtype == torch.int16
    assert float((tdev.decode_state(gc, SPEC) - tdev.decode_state(wc, SPEC)).abs().max()) < 5e-6
    np.testing.assert_allclose(ga.cpu().numpy(), wa.cpu().numpy(), rtol=1e-3)


C16_KERNELS = {
    "K1": (tstep.run_step, tstep.run_step_plain, None),
    "K2": (taa.run_aa, taa.run_aa_plain, None),
    "K7": (tband.run_band, tband.run_band_plain, (24, 4, 20)),
    "K11": (tband3.run_band3, tband3.run_band3_plain, (24, 4, 20)),
    "K9": (tband2.run_band2, tband2.run_band2_plain, (24, 4, 20)),
    "K5": (ttemp.run_temporal, ttemp.run_temporal_plain, (20, 4, 20)),
    "K6": (tdeep.run_deep, tdeep.run_deep_plain, (20, 4, 20)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [8, 19])
@pytest.mark.parametrize("name", list(C16_KERNELS))
def test_c16_kernel_matches_plain_and_repeats(cuda_device, name, iters):
    """The c16 forms on a ragged 97 x 70 grid (T-step kernels under 24 x 20
    or 20 x 20 tiles, T 4: passes and a K1 remainder); the c16 counter, not
    the f32 one, counts them; a second run is bitwise equal."""
    kernel, plain, cfg = C16_KERNELS[name]
    cells, nobst = make_setup(cuda_device, 70, 97, seed=iters)
    q = tdev.encode_state(cells, SPEC)

    def run(fn):
        if cfg is None:
            return fn(q, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0, dev=SPEC)
        return fn(q, nobst, DENSITY, ACCEL, OMEGA, iters, cfg[0], cfg[1], panel=cfg[2], dev=SPEC)

    before, before_c16 = kernel.launches, kernel.launches_c16
    got = run(kernel)
    assert kernel.launches == before
    assert kernel.launches_c16 == before_c16 + (iters if cfg is None else iters // 4 * 4)
    again = run(kernel)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert_c16_close(got, run(plain))


@pytest.mark.cuda
@pytest.mark.parametrize("c16", [False, True], ids=["f32", "c16"])
@pytest.mark.parametrize("kpasses,sblock,iters", [(1, 8, 13), (2, 12, 35), (4, 16, 32)])
def test_slab_kernel_matches_plain_and_repeats(cuda_device, kpasses, sblock, iters, c16):
    """K13 on a 96 x 70 grid under 24 x 20 tiles, T 4: whole generations and
    a remainder (K7 passes and K1); at f32 K1's state bit for bit; a second
    run is bitwise equal."""
    cells, nobst = make_setup(cuda_device, 70, 96, seed=iters)
    dev = SPEC if c16 else None
    x = tdev.encode_state(cells, SPEC) if c16 else cells

    def run(fn):
        return fn(x, nobst, DENSITY, ACCEL, OMEGA, iters, 24, 4, kpasses, sblock, panel=20,
                  dev=dev)

    counter = "launches_c16" if c16 else "launches"
    before = getattr(tslab.run_band_slab, counter)
    got = run(tslab.run_band_slab)
    kt = kpasses * 4
    assert getattr(tslab.run_band_slab, counter) == before + iters // kt * kt
    again = run(tslab.run_band_slab)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = run(tslab.run_band_slab_plain)
    if c16:
        assert_c16_close(got, want)
    else:
        assert_close(got, want)
        k1 = tstep.run_step(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0)
        assert torch.equal(got[0], k1[0])


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(1000, 40), (33, 3)])
def test_step_kernel_matches_plain(cuda_device, nx, ny):
    cells, nobst = make_setup(cuda_device, nx, ny, seed=8)
    before = tstep.run_step.launches
    got = tstep.run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 7, 1.0)
    assert tstep.run_step.launches == before + 7
    assert_close(got, tstep.run_step_plain(cells, nobst, DENSITY, ACCEL, OMEGA, 7, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [6, 7])
@pytest.mark.parametrize("nx,ny", [(1000, 40), (33, 3)])
def test_aa_kernel_matches_plain_and_repeats(cuda_device, nx, ny, iters):
    cells, nobst = make_setup(cuda_device, nx, ny, seed=iters)
    before = taa.run_aa.launches
    got = taa.run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0)
    assert taa.run_aa.launches == before + iters
    again = taa.run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert_close(got, taa.run_aa_plain(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0))


BANDS = {
    "band": (tband.run_band, tband.run_band_plain),
    "band2": (tband2.run_band2, tband2.run_band2_plain),
    "band3": (tband3.run_band3, tband3.run_band3_plain),
}


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [8, 19, 25])
@pytest.mark.parametrize("route", list(BANDS))
def test_band_kernel_matches_plain_and_repeats(cuda_device, route, iters):
    """A ragged 97 x 70 grid under 24 x 20 tiles (T 4): one pass and more,
    with and without a K1 remainder; a second run is bitwise equal."""
    kernel, plain = BANDS[route]
    cells, nobst = make_setup(cuda_device, 70, 97, seed=iters)
    before = kernel.launches
    got = kernel(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 24, 4, panel=20)
    assert kernel.launches == before + iters // 4 * 4
    again = kernel(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 24, 4, panel=20)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert_close(got, plain(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 24, 4, panel=20))


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(BANDS))
def test_band_kernel_rejects_oversized_window(cuda_device, route):
    """A full-row window of a 1024-wide grid does not fit a block."""
    cells, nobst = make_setup(cuda_device, 1024, 32, seed=2)
    with pytest.raises(ValueError, match="band"):
        BANDS[route][0](cells, nobst, DENSITY, ACCEL, OMEGA, 8, 8, 4)


@pytest.mark.cuda
def test_kernels_reject_other_collision_forms(cuda_device):
    cells, nobst = make_setup(cuda_device, 64, 8, seed=1)
    for run in (tstep.run_step, taa.run_aa):
        with pytest.raises(ValueError, match="fused"):
            run(cells, nobst, DENSITY, ACCEL, OMEGA, 2, 1.0, paired=True)
    for run, _ in BANDS.values():
        with pytest.raises(ValueError, match="fused"):
            run(cells, nobst, DENSITY, ACCEL, OMEGA, 8, 16, 4, panel=16, paired=True)


@pytest.mark.cuda
@pytest.mark.parametrize("iters,chunk", [(12, 5), (13, 5), (7, 255)])
@pytest.mark.parametrize("nx,ny", [(70, 97), (33, 3)])
def test_resident_kernel_matches_plain_and_repeats(cuda_device, nx, ny, iters, chunk):
    """Chunk boundaries inside the run, both exit parities; a second run is
    bitwise equal."""
    cells, nobst = make_setup(cuda_device, nx, ny, seed=iters)
    before = tres.run_resident.launches
    got = tres.run_resident(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0, chunk=chunk)
    assert tres.run_resident.launches == before + iters
    again = tres.run_resident(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0, chunk=chunk)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert_close(got, tres.run_resident_plain(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0,
                                              chunk=chunk))


@pytest.mark.cuda
def test_resident_kernel_refuses_a_grid_the_card_cannot_hold(cuda_device):
    """One block more than occupancy x SMs: the cooperative launch is refused
    and the wrapper raises, where a plain launch of a grid-wide barrier
    would hang."""
    cells, nobst = make_setup(cuda_device, 256, 256, seed=1)
    too_many = tres.max_blocks(cuda_device) + 1
    with pytest.raises(RuntimeError, match="resident kernel"):
        tres.launch(cells, nobst, DENSITY, ACCEL, OMEGA, 4, 1.0, 4, too_many)
    torch.cuda.synchronize()  # the context is still usable
    tres.run_resident(cells, nobst, DENSITY, ACCEL, OMEGA, 2, 1.0)


TRAPEZOIDS = {
    "temporal": (ttemp.run_temporal, ttemp.run_temporal_plain, ttemp.run_temporal),
    "deep": (tdeep.run_deep, tdeep.run_deep_plain, tdeep.run_deep),
}


@pytest.mark.cuda
@pytest.mark.parametrize("iters,depth", [(8, 4), (19, 4), (25, 4), (11, 3)])
@pytest.mark.parametrize("route", list(TRAPEZOIDS))
def test_trapezoid_kernel_matches_plain_and_repeats(cuda_device, route, iters, depth):
    """A ragged 97 x 70 grid under 20 x 20 tiles (the last row block 17
    rows): one pass and more, with and without a K1 remainder, an odd T;
    a second run is bitwise equal."""
    kernel, plain, counter = TRAPEZOIDS[route]
    cells, nobst = make_setup(cuda_device, 70, 97, seed=iters)
    before = counter.launches
    got = kernel(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 20, depth, panel=20)
    assert counter.launches == before + iters // depth * depth
    again = kernel(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 20, depth, panel=20)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert_close(got, plain(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 20, depth, panel=20))


@pytest.mark.cuda
def test_temporal_pass_packs_match_plain(cuda_device):
    """One K5 pass from packs that differ from the state's rows: the state
    and both output packs, in the (cells, last, first) order."""
    cells, nobst = make_setup(cuda_device, 70, 97, seed=4)
    last, first = ttemp.make_halos_t(cells, 20, 4)
    state = (cells, last * 1.01, first * 0.99)
    got, av = ttemp.step_t(state, nobst, DENSITY, ACCEL, OMEGA, 20, 4, panel=32)
    want, want_av = ttemp.step_t_plain(state, nobst, DENSITY, ACCEL, OMEGA, 20, 4)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < 1e-5 * float(w.abs().max())
    np.testing.assert_allclose(av.cpu().numpy(), want_av.cpu().numpy(), rtol=1e-4)


@pytest.mark.cuda
def test_new_kernels_reject_other_collision_forms(cuda_device):
    cells, nobst = make_setup(cuda_device, 64, 8, seed=1)
    with pytest.raises(ValueError, match="fused"):
        tres.run_resident(cells, nobst, DENSITY, ACCEL, OMEGA, 2, 1.0, paired=True)
    for run, _, _ in TRAPEZOIDS.values():
        with pytest.raises(ValueError, match="fused"):
            run(cells, nobst, DENSITY, ACCEL, OMEGA, 8, 8, 4, panel=16, paired=True)


def mesh_setup(device, nx, ny, py, px, seed):
    """A random state and mask cut into a py x px mesh of shards on one card."""
    cells, nobst = make_setup(device, nx, ny, seed)
    ry, rx = ny // py, nx // px
    shards = [[cells[:, i * ry:(i + 1) * ry, j * rx:(j + 1) * rx].contiguous() for j in range(px)]
              for i in range(py)]
    nob = [[nobst[i * ry:(i + 1) * ry, j * rx:(j + 1) * rx].contiguous() for j in range(px)]
           for i in range(py)]
    return cells, nobst, shards, nob


def joined(shards):
    return torch.cat([torch.cat(list(row), dim=2) for row in shards], dim=1)


def assert_mesh_close(got, want):
    (gs, ga), (ws, wa) = got, want
    g, w = joined(gs), joined(ws)
    assert float((g - w).abs().max()) < 1e-5 * float(w.abs().max())
    np.testing.assert_allclose(ga.cpu().numpy(), wa.cpu().numpy(), rtol=1e-4)


SHARD_KERNELS = {"K3": tshard.run_shard_step, "K12": tshard.run_shard_overlap}


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,py,px", [(70, 96, 4, 1), (70, 96, 2, 2), (33, 6, 3, 3),
                                         (4, 4, 4, 1), (4, 4, 4, 4), (70, 97, 1, 1)])
@pytest.mark.parametrize("name", list(SHARD_KERNELS))
def test_shard_kernels_match_plain_and_k1(cuda_device, name, nx, ny, py, px):
    """K3 (any mesh) and K12 (1-D meshes) against the plain shard step, and
    their joined state bitwise K1's on the whole grid; down to 1 x 1-cell
    shards and a mesh of one; a second run is bitwise equal."""
    if name == "K12" and px > 1:
        pytest.skip("K12 runs on 1-D meshes only")
    kernel = SHARD_KERNELS[name]
    cells, nobst, shards, nob = mesh_setup(cuda_device, nx, ny, py, px, seed=py + px)
    before = kernel.launches
    got = kernel(shards, nob, DENSITY, ACCEL, OMEGA, 9, ny)
    assert kernel.launches == before + 9
    again = kernel(shards, nob, DENSITY, ACCEL, OMEGA, 9, ny)
    assert torch.equal(joined(got[0]), joined(again[0])) and torch.equal(got[1], again[1])
    assert_mesh_close(got, tshard.run_shard_step_plain(shards, nob, DENSITY, ACCEL, OMEGA, 9, ny))
    k1, _ = tstep.run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 9, 1.0)
    assert torch.equal(joined(got[0]), k1)


SHARD_BANDS = {"K8": (tband.run_band_sharded, tband.run_band_sharded_plain),
               "K10": (tband2.run_band2_sharded, tband2.run_band2_sharded_plain)}


@pytest.mark.cuda
@pytest.mark.parametrize("iters,panel", [(8, 20), (19, 20), (11, None)])
@pytest.mark.parametrize("name", list(SHARD_BANDS))
def test_sharded_band_kernels_match_plain_and_k1(cuda_device, name, iters, panel):
    """K8 and K10 on 4 row shards of a 100 x 70 grid: shards of 25 rows
    under 16-row tiles (T 4, a ragged last tile), passes with and without a
    K3 remainder; bitwise K1's joined state; a second run bitwise equal."""
    kernel, plain = SHARD_BANDS[name]
    ny, nx = 100, 70
    cells, nobst, shards, nob = mesh_setup(cuda_device, nx, ny, 4, 1, seed=iters)
    before = kernel.launches
    got = kernel(shards, nob, DENSITY, ACCEL, OMEGA, iters, 16, 4, ny, panel=panel)
    assert kernel.launches == before + iters // 4 * 4
    again = kernel(shards, nob, DENSITY, ACCEL, OMEGA, iters, 16, 4, ny, panel=panel)
    assert torch.equal(joined(got[0]), joined(again[0])) and torch.equal(got[1], again[1])
    assert_mesh_close(got, plain(shards, nob, DENSITY, ACCEL, OMEGA, iters, 16, 4, ny,
                                 panel=panel))
    k1, _ = tstep.run_step(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0)
    assert torch.equal(joined(got[0]), k1)


@pytest.mark.cuda
def test_sharded_band_forcing_row_in_halo(cuda_device):
    """4 shards of 8 rows, T 4: global row ny-2 lies in the last shard and in
    shard 0's upper halo; bitwise K1."""
    cells, nobst, shards, nob = mesh_setup(cuda_device, 40, 32, 4, 1, seed=3)
    k1, _ = tstep.run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 8, 1.0)
    for kernel, _ in SHARD_BANDS.values():
        got, _ = kernel(shards, nob, DENSITY, ACCEL, OMEGA, 8, 8, 4, 32)
        assert torch.equal(joined(got), k1)


@pytest.mark.cuda
def test_shard_kernels_refuse(cuda_device):
    cells, nobst, shards, nob = mesh_setup(cuda_device, 40, 32, 8, 1, seed=3)
    for kernel, _ in SHARD_BANDS.values():
        with pytest.raises(ValueError, match="shallower"):  # 4-row shards, depth 8
            kernel(shards, nob, DENSITY, ACCEL, OMEGA, 8, 16, 8, 32)
        with pytest.raises(ValueError, match="fused"):
            kernel(shards, nob, DENSITY, ACCEL, OMEGA, 8, 8, 4, 32, paired=True)
    for kernel in SHARD_KERNELS.values():
        with pytest.raises(ValueError, match="fused"):
            kernel(shards, nob, DENSITY, ACCEL, OMEGA, 2, 32, paired=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, "c16"], ids=["f32", "c16"])
@pytest.mark.parametrize("repeat", [1, 2], ids=["once", "twice"])
@pytest.mark.parametrize("backend,mesh", [("pallas", None), ("pallas-overlap", None),
                                          ("band", None), ("band2", None), ("auto", "2d")])
def test_mesh_across_cards(cuda_device, backend, mesh, repeat, dtype):
    """A mesh over every card (two or more; 2 x n/2 for the 2-D case), each
    card holding one shard or, ``twice``, two shards that are not
    neighbours in shard order: one call per run of shards per step (or
    pass) ordered by events, the ring fills and halo copies reading the
    neighbour cards and K12's peer stores give the single-card K1 run bit
    for bit. At c16 (K12 refuses it) the rings and halos carry codes
    across the cards: K3 gives K1 c16's bits, K8 and K10 the single-card
    K7 and K9 c16 runs', the 2-D plain step the single-card plain c16
    step's values within the c16 tolerance."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.parallel.sharded import run_simulation_sharded, run_simulation_sharded_2d
    from lbm_tpu_torch.runtime.driver import run_simulation

    n = torch.cuda.device_count()
    if n < 2 or (mesh and n % 2):
        pytest.skip("needs two or more CUDA devices (an even count for 2-D)")
    c16 = dtype == "c16"
    if c16 and backend == "pallas-overlap":
        pytest.skip("K12 takes f32 only, as the JAX package's pallas-overlap")
    devices = [f"cuda:{i}" for i in range(n)] * repeat
    params = LBMParams(nx=96, ny=32 * n * repeat, max_iters=23, reynolds_dim=10,
                       density=DENSITY, accel=ACCEL, omega=OMEGA)
    obs = np.zeros((params.ny, params.nx), np.int32)
    obs[0] = obs[-1] = 1
    obs[np.random.RandomState(2).randint(1, params.ny - 1, 20), 7] = 1
    single = {"pallas": "pallas", "band": "band", "band2": "band2", "auto": "reference"}
    want = run_simulation(params, obs, device="cuda:0", dtype=dtype,
                          backend=single[backend] if c16 else "pallas")
    if mesh:
        got = run_simulation_sharded_2d(params, obs, mesh_shape=(2, n * repeat // 2),
                                        devices=devices, backend=backend, dtype=dtype)
    else:
        got = run_simulation_sharded(params, obs, devices=devices, backend=backend, dtype=dtype)
    assert got.shard_devices == tuple(devices)
    if c16 and mesh:
        assert np.abs(got.cells - want.cells).max() < 5e-6
        np.testing.assert_allclose(got.av_vels, want.av_vels, rtol=1e-3)
        return
    np.testing.assert_array_equal(got.cells, want.cells)
    np.testing.assert_allclose(got.av_vels, want.av_vels, rtol=1e-5)


@pytest.mark.cuda
def test_c16_temporal_pass_packs_copy_the_state(cuda_device):
    """One K5 pass at c16 from packs that differ from the state's rows: the
    state and both packs against the plain pass, and the packs hold exactly
    the codes of the state rows they copy."""
    cells, nobst = make_setup(cuda_device, 70, 97, seed=5)
    q = tdev.encode_state(cells, SPEC)
    last, first = ttemp.make_halos_t(q, 20, 4)
    state = (q, last + 3, first - 3)
    got, av = ttemp.step_t(state, nobst, DENSITY, ACCEL, OMEGA, 20, 4, panel=32, dev=SPEC)
    want, want_av = ttemp.step_t_plain(state, nobst, DENSITY, ACCEL, OMEGA, 20, 4, dev=SPEC)
    assert_c16_close((got[0], av), (want[0], want_av))
    own_last, own_first = ttemp.make_halos_t(got[0], 20, 4)
    assert torch.equal(got[1], own_last) and torch.equal(got[2], own_first)


C16_MESH = {"K3": (tshard.run_shard_step, tshard.run_shard_step_plain, None),
            "K8": (tband.run_band_sharded, tband.run_band_sharded_plain, (16, 4, 20)),
            "K10": (tband2.run_band2_sharded, tband2.run_band2_sharded_plain, (16, 4, 20))}


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [8, 11])
@pytest.mark.parametrize("name", list(C16_MESH))
def test_c16_mesh_kernels_match_plain_and_repeats(cuda_device, name, iters):
    """K3, K8 and K10 at c16 on 4 row shards of a 100 x 70 grid (the band
    kernels with T 4 and a K3 remainder): against their plain c16 forms
    and, joined, against K1 at c16 (the same rounding for K3); the c16
    counter counts them; a second run is bitwise equal."""
    kernel, plain, cfg = C16_MESH[name]
    ny = 100
    cells, nobst, _, nob = mesh_setup(cuda_device, 70, ny, 4, 1, seed=iters)
    q = tdev.encode_state(cells, SPEC)
    shards = [[q[:, i * 25:(i + 1) * 25].contiguous()] for i in range(4)]

    def run(fn):
        if cfg is None:
            return fn(shards, nob, DENSITY, ACCEL, OMEGA, iters, ny, dev=SPEC)
        return fn(shards, nob, DENSITY, ACCEL, OMEGA, iters, cfg[0], cfg[1], ny, panel=cfg[2],
                  dev=SPEC)

    before, before_c16 = kernel.launches, kernel.launches_c16
    got = run(kernel)
    assert kernel.launches == before
    assert kernel.launches_c16 == before_c16 + (iters if cfg is None else iters // 4 * 4)
    again = run(kernel)
    assert torch.equal(joined(got[0]), joined(again[0])) and torch.equal(got[1], again[1])
    want = run(plain)
    assert_c16_close((joined(got[0]), got[1].sum(0)), (joined(want[0]), want[1].sum(0)))
    if cfg is None:
        k1 = tstep.run_step(q, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0, dev=SPEC)
        assert_c16_close((joined(got[0]), got[1].sum(0)), k1)


@pytest.mark.cuda
def test_overlap_kernel_refuses_c16(cuda_device):
    """K12 takes f32 only, as the JAX package's pallas-overlap."""
    _, _, shards, nob = mesh_setup(cuda_device, 40, 32, 4, 1, seed=3)
    codes = [[tdev.encode_state(s, SPEC) for s in row] for row in shards]
    with pytest.raises(ValueError, match="int16"):
        tshard.run_shard_overlap(codes, nob, DENSITY, ACCEL, OMEGA, 2, 32)
