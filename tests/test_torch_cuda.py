"""The CUDA kernels on the card: K1, K2, the band kernels K7, K9, K11, the
resident, temporal and deep kernels K4, K5, K6, the shard kernels K3,
K12, K8, K10, the slab kernel K13 and the c16 and bf16 forms of K1, K2,
K3, K5-K11 and K13 against their plain versions; K3's 16-bit forms (four
cells per thread) bitwise against K1 at odd widths and ragged rows, K9 in
one window at T 4, 8 and 16, full row and panel, and K5 and K6 in one
window (AA steps on the trapezoid) at T 3, 4 and 8, on the driver's
schedules and a window at the shared-memory limit, bitwise against K1;
K1's and K2's 16-bit word forms bitwise against their one-cell forms on
ragged, odd-height grids and over chained calls, the shape rule's route,
the c16 codec against its conversion-instruction form over every
input; and the multi-process path's kernels on one card (shards stepped
in turns, their rows handed over): K3 with its ring filled from received
rows and K8/K10 with received halos, bitwise the one-process mesh; and
K12 across 2 processes, each mapping its neighbour's shard with CUDA IPC
(tests/torch_multihost_worker.py ``ipc``), bitwise the one-process K12,
and its deadline when a neighbour stops; and the driver's counters of
bytes copied and kernel launches on K1, K6 and K4.

These tests need an NVIDIA GPU and nvcc; without a card they skip. They
import neither JAX nor the JAX package, so they run where only the port's
dependencies exist. On the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX for the other tests.)
Tolerances: cells within 1e-5 of the state's scale and the av series at
rtol 1e-4 (the kernels contract multiply-adds into FMAs and sum in another
order than PyTorch); at c16 the decoded cells within 5e-6 and the av
series at rtol 1e-3 (an FMA can move a code by one quantum at a rounding
tie); at bf16 every value within 2 ulps, at most 1% of them differing and
the av series at rtol 1e-3 over a pass and a remainder (4 ulps, 5%, 5e-3
over more steps, where a flipped value's neighbours flip in turn): held
by tolerance, never by bits, as FMA contraction can flip a rounding; two
runs of a kernel are held by bits.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lbm_tpu_torch.models.d2q9 import WEIGHTS, LBMParams  # noqa: E402
from lbm_tpu_torch.ops import _build  # noqa: E402
from lbm_tpu_torch.ops import aa as taa  # noqa: E402
from lbm_tpu_torch.ops import band as tband  # noqa: E402
from lbm_tpu_torch.ops import band2 as tband2  # noqa: E402
from lbm_tpu_torch.ops import band3 as tband3  # noqa: E402
from lbm_tpu_torch.ops import band_common as BC  # noqa: E402
from lbm_tpu_torch.ops import deep as tdeep  # noqa: E402
from lbm_tpu_torch.ops import devspace as tdev  # noqa: E402
from lbm_tpu_torch.ops import resident as tres  # noqa: E402
from lbm_tpu_torch.ops import shard_step as tshard  # noqa: E402
from lbm_tpu_torch.ops import slab as tslab  # noqa: E402
from lbm_tpu_torch.ops import step as tstep  # noqa: E402
from lbm_tpu_torch.ops import temporal as ttemp  # noqa: E402
from lbm_tpu_torch.runtime import driver as tdriver  # noqa: E402

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
@pytest.mark.parametrize("form", ["global-memory", "shared-memory"])
@pytest.mark.parametrize("iters,chunk", [(12, 5), (13, 5), (7, 255)])
@pytest.mark.parametrize("nx,ny", [(70, 97), (33, 3)])
def test_resident_kernel_matches_plain_and_repeats(cuda_device, nx, ny, iters, chunk, form):
    """Chunk boundaries inside the run, both exit parities; a second run is
    bitwise equal. Each form of K4 on its own counter: the global-memory
    form through ``launch`` (``run_resident`` picks the shared-memory form
    for both grids)."""
    cells, nobst = make_setup(cuda_device, nx, ny, seed=iters)
    if form == "global-memory":
        blocks = min(tres.max_blocks(cuda_device), -(-nx * ny // tres._THREADS))

        def run():
            return tres.launch(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0, chunk, blocks)
        counter = "launches"
    else:
        def run():
            return tres.run_resident(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0, chunk=chunk)
        counter = "launches_smem"
    before = getattr(tres.run_resident, counter)
    got = run()
    assert getattr(tres.run_resident, counter) == before + iters
    again = run()
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


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,rows,depth,iters", [
    (70, 97, 1, 4, 13), (70, 97, 5, 3, 255), (33, 3, 1, 4, 7), (128, 128, 3, 4, 256),
])
def test_resident_smem_form_schedules_match_plain(cuda_device, nx, ny, rows, depth, iters):
    """The shared-memory form at other schedules than ``resident_smem_config``'s, through
    ``launch_smem``: slabs of 1 row, B not dividing ny, T 3, a window taller
    than the grid; equal to ``run_resident_slabs_plain`` within the K4
    tolerances."""
    cells, nobst = make_setup(cuda_device, nx, ny, seed=rows)
    config = (-(-ny // rows), rows, depth, tres.resident_smem_bytes(nx, rows, depth))
    got = tres.launch_smem(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0, 5, config)
    assert_close(got, tres.run_resident_slabs_plain(cells, nobst, DENSITY, ACCEL, OMEGA, iters,
                                                    1.0, rows, depth, chunk=5))


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(128, 128), (256, 256), (130, 250)])
def test_resident_smem_form_split_run_is_bitwise_whole(cuda_device, nx, ny):
    """A run split where no pass ends gives the whole run's state and av
    series bit for bit: a resumed run writes the uninterrupted bytes."""
    cells, nobst = make_setup(cuda_device, nx, ny, seed=5)
    head = tres.run_resident(cells, nobst, DENSITY, ACCEL, OMEGA, 101, 1.0)
    tail = tres.run_resident(head[0], nobst, DENSITY, ACCEL, OMEGA, 154, 1.0)
    whole = tres.run_resident(cells, nobst, DENSITY, ACCEL, OMEGA, 255, 1.0)
    assert torch.equal(tail[0], whole[0])
    assert torch.equal(torch.cat([head[1], tail[1]]), whole[1])


@pytest.mark.cuda
def test_resident_smem_form_refuses_a_config_off_its_carve(cuda_device):
    """A blocks count or shared-memory size that does not match the grid and
    the carve is refused before any launch, and raises."""
    cells, nobst = make_setup(cuda_device, 64, 40, seed=1)
    lib = _build.library()
    assert lib.lbm_resident_smem_bytes(64, 2, 4) == tres.resident_smem_bytes(64, 2, 4)
    good = (20, 2, 4, tres.resident_smem_bytes(64, 2, 4))
    for bad in ((21, 2, 4, good[3]), (20, 2, 4, good[3] + 4), (20, 2, 3, good[3])):
        with pytest.raises(RuntimeError, match="shared-memory form"):
            tres.launch_smem(cells, nobst, DENSITY, ACCEL, OMEGA, 4, 1.0, 4, bad)
    tres.launch_smem(cells, nobst, DENSITY, ACCEL, OMEGA, 4, 1.0, 4, good)
    torch.cuda.synchronize()


TRAPEZOIDS = {
    "temporal": (ttemp.run_temporal, ttemp.run_temporal_plain, ttemp.run_temporal),
    "deep": (tdeep.run_deep, tdeep.run_deep_plain, tdeep.run_deep),
}


def widest_panel(block, depth):
    """The widest panel whose one-copy window fits the shared memory of a
    block."""
    panel = 1
    while BC.smem_bytes(ttemp.PLANE_COPIES, 4096, block, depth, panel + 1) <= BC.SMEM_LIMIT:
        panel += 1
    return panel


def driver_schedule(route, n):
    params = LBMParams(nx=n, ny=n, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    return tdriver.pass_schedule(route, params, torch.float32)[1]


# (nx, ny, iters, block, depth, panel): a ragged 97 x 70 grid under 20 x 20
# tiles (the last row block 17 rows) over one pass and more, with and
# without a K1 remainder, an odd T; the driver's schedule at 2048^2 on a
# ragged grid; T 8; a window at the shared-memory limit ("widest").
TRAPEZOID_CASES = [(70, 97, 8, 20, 4, 20), (70, 97, 19, 20, 4, 20), (70, 97, 25, 20, 4, 20),
                   (70, 97, 11, 20, 3, 20), (250, 100, 11, 0, 0, "driver"),
                   (150, 104, 19, 24, 8, 40), (300, 104, 11, 32, 4, "widest"),
                   (300, 104, 19, 32, 8, "widest")]
# Every schedule of the driver's K5 and K6 tiers, each window compiled with
# constant strides, on a grid ragged in both directions, two passes and a
# K1 remainder.
TRAPEZOID_CASES += [(2 * panel - 7, 2 * block - 5, 2 * depth + 3, block, depth, panel)
                    for block, depth, panel in tdriver.trapezoid_schedules()]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,iters,block,depth,panel", TRAPEZOID_CASES)
@pytest.mark.parametrize("route", list(TRAPEZOIDS))
def test_trapezoid_kernel_matches_plain_and_repeats(cuda_device, route, nx, ny, iters, block,
                                                    depth, panel):
    """K5 and K6 (one window, AA steps on the trapezoid) against their plain
    versions on TRAPEZOID_CASES; a second run is bitwise equal and the
    counter takes the pass steps."""
    kernel, plain, counter = TRAPEZOIDS[route]
    if panel == "driver":
        block, depth, panel = driver_schedule(route, 2048)
    elif panel == "widest":
        panel = widest_panel(block, depth)
    cells, nobst = make_setup(cuda_device, nx, ny, seed=iters)
    before = counter.launches
    got = kernel(cells, nobst, DENSITY, ACCEL, OMEGA, iters, block, depth, panel=panel)
    assert counter.launches == before + iters // depth * depth
    again = kernel(cells, nobst, DENSITY, ACCEL, OMEGA, iters, block, depth, panel=panel)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert_close(got, plain(cells, nobst, DENSITY, ACCEL, OMEGA, iters, block, depth,
                            panel=panel))


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(TRAPEZOIDS))
def test_trapezoid_kernel_is_bitwise_k1(cuda_device, route):
    """K5 and K6 at f32 on the driver's schedule over 50 steps at 1024^2 (a
    K1 remainder among them when T does not divide 50): the state is K1's
    bit for bit, the av series within rtol 1e-4 (another summation order)."""
    kernel = TRAPEZOIDS[route][0]
    block, depth, panel = driver_schedule(route, 1024)
    cells, nobst = make_setup(cuda_device, 1024, 1024, seed=50)
    got = kernel(cells, nobst, DENSITY, ACCEL, OMEGA, 50, block, depth, panel=panel)
    k1 = tstep.run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 50, 1.0)
    assert torch.equal(got[0], k1[0])
    np.testing.assert_allclose(got[1].cpu().numpy(), k1[1].cpu().numpy(), rtol=1e-4)


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
@pytest.mark.parametrize("dtype", [torch.float32, "c16", torch.bfloat16],
                         ids=["f32", "c16", "bf16"])
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
    step's values within the c16 tolerance. At bf16 the same with bf16
    values (K12 runs f32 between one cast in and one out: the single-card
    K12 bf16 run's bits), and the 2-D plain bf16 step tracks the
    single-card plain bf16 step loosely (each rounds every operation, in
    its own order)."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.parallel.sharded import run_simulation_sharded, run_simulation_sharded_2d
    from lbm_tpu_torch.runtime.driver import run_simulation

    n = torch.cuda.device_count()
    if n < 2 or (mesh and n % 2):
        pytest.skip("needs two or more CUDA devices (an even count for 2-D)")
    c16 = dtype == "c16"
    sixteen = c16 or dtype == torch.bfloat16
    if c16 and backend == "pallas-overlap":
        pytest.skip("K12 takes f32 only, as the JAX package's pallas-overlap")
    devices = [f"cuda:{i}" for i in range(n)] * repeat
    params = LBMParams(nx=96, ny=32 * n * repeat, max_iters=23, reynolds_dim=10,
                       density=DENSITY, accel=ACCEL, omega=OMEGA)
    obs = np.zeros((params.ny, params.nx), np.int32)
    obs[0] = obs[-1] = 1
    obs[np.random.RandomState(2).randint(1, params.ny - 1, 20), 7] = 1
    single = {"pallas": "pallas", "band": "band", "band2": "band2", "auto": "reference"}
    if dtype == torch.bfloat16 and backend == "pallas-overlap":
        want = run_simulation_sharded(params, obs, devices=["cuda:0"] * len(devices),
                                      backend=backend, dtype=dtype)
    else:
        want = run_simulation(params, obs, device="cuda:0", dtype=dtype,
                              backend=single[backend] if sixteen else "pallas")
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
    if sixteen and mesh:  # the plain bf16 step rounds every operation in its own order
        assert np.abs(got.cells - want.cells).max() <= 2.0 ** -7 * np.abs(want.cells).max()
        np.testing.assert_allclose(got.av_vels, want.av_vels, rtol=2e-2)
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


BF16 = tdev.BF16
# (ulps per cell, fraction of cells differing, av rtol): one pass and a
# remainder; over more steps the flips of the first roundings spread
# (tests/test_torch_bf16.py).
BF16_TOL, BF16_SPREAD_TOL = (2, 0.01, 1e-3), (4, 0.05, 5e-3)


def bf16_ulps(got, want):
    """Per-value distance of two bf16 tensors in ulps, on their bit patterns."""
    def ordered(x):
        u = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u)

    return (ordered(got) - ordered(want)).abs()


def assert_bf16_close(got, want, tol=BF16_TOL):
    (gc, ga), (wc, wa) = got, want
    assert gc.dtype == torch.bfloat16 and wc.dtype == torch.bfloat16
    ulps = bf16_ulps(gc, wc)
    assert int(ulps.max()) <= tol[0]
    assert float((ulps > 0).float().mean()) <= tol[1]
    np.testing.assert_allclose(ga.cpu().numpy(), wa.cpu().numpy(), rtol=tol[2])


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [7, 19])
@pytest.mark.parametrize("name", list(C16_KERNELS))
def test_bf16_kernel_matches_plain_and_repeats(cuda_device, name, iters):
    """The bf16 forms on a ragged 97 x 70 grid (T-step kernels under 24 x 20
    or 20 x 20 tiles, T 4: passes and a K1 remainder); the bf16 counter, not
    the f32 or c16 one, counts them; a second run is bitwise equal."""
    kernel, plain, cfg = C16_KERNELS[name]
    cells, nobst = make_setup(cuda_device, 70, 97, seed=iters)
    x = tdev.encode_state(cells, BF16)

    def run(fn):
        if cfg is None:
            return fn(x, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0, dev=BF16)
        return fn(x, nobst, DENSITY, ACCEL, OMEGA, iters, cfg[0], cfg[1], panel=cfg[2], dev=BF16)

    before = (kernel.launches, kernel.launches_c16, kernel.launches_bf16)
    got = run(kernel)
    assert (kernel.launches, kernel.launches_c16) == before[:2]
    assert kernel.launches_bf16 == before[2] + (iters if cfg is None else iters // 4 * 4)
    again = run(kernel)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert_bf16_close(got, run(plain), BF16_TOL if cfg is None or iters < 8 else BF16_SPREAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kpasses,sblock,iters", [(1, 8, 7), (2, 12, 19)])
def test_bf16_slab_kernel_matches_plain_and_repeats(cuda_device, kpasses, sblock, iters):
    """K13 at bf16 on a 96 x 70 grid under 24 x 20 tiles, T 4: a generation
    and a remainder; a second run is bitwise equal."""
    cells, nobst = make_setup(cuda_device, 70, 96, seed=iters)
    x = tdev.encode_state(cells, BF16)

    def run(fn):
        return fn(x, nobst, DENSITY, ACCEL, OMEGA, iters, 24, 4, kpasses, sblock, panel=20,
                  dev=BF16)

    before = tslab.run_band_slab.launches_bf16
    got = run(tslab.run_band_slab)
    assert tslab.run_band_slab.launches_bf16 == before + iters // (4 * kpasses) * 4 * kpasses
    again = run(tslab.run_band_slab)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert_bf16_close(got, run(tslab.run_band_slab_plain),
                      BF16_TOL if iters < 8 else BF16_SPREAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [7, 11])
@pytest.mark.parametrize("name", list(C16_MESH))
def test_bf16_mesh_kernels_match_plain_and_repeats(cuda_device, name, iters):
    """K3, K8 and K10 at bf16 on 4 row shards of a 100 x 70 grid (the band
    kernels with T 4 and a K3 remainder): against their plain bf16 forms;
    the bf16 counter counts them; a second run is bitwise equal."""
    kernel, plain, cfg = C16_MESH[name]
    ny = 100
    cells, nobst, _, nob = mesh_setup(cuda_device, 70, ny, 4, 1, seed=iters)
    x = tdev.encode_state(cells, BF16)
    shards = [[x[:, i * 25:(i + 1) * 25].contiguous()] for i in range(4)]

    def run(fn):
        if cfg is None:
            return fn(shards, nob, DENSITY, ACCEL, OMEGA, iters, ny, dev=BF16)
        return fn(shards, nob, DENSITY, ACCEL, OMEGA, iters, cfg[0], cfg[1], ny, panel=cfg[2],
                  dev=BF16)

    before = (kernel.launches, kernel.launches_bf16)
    got = run(kernel)
    assert kernel.launches == before[0]
    assert kernel.launches_bf16 == before[1] + (iters if cfg is None else iters // 4 * 4)
    again = run(kernel)
    assert torch.equal(joined(got[0]), joined(again[0])) and torch.equal(got[1], again[1])
    want = run(plain)
    assert_bf16_close((joined(got[0]), got[1].sum(0)), (joined(want[0]), want[1].sum(0)),
                      BF16_TOL if cfg is None or iters < 8 else BF16_SPREAD_TOL)


@pytest.mark.cuda
def test_bf16_temporal_pass_packs_copy_the_state(cuda_device):
    """One K5 pass at bf16 from packs that differ from the state's rows: the
    state against the plain pass, and the packs hold the bits of the state
    rows they copy."""
    cells, nobst = make_setup(cuda_device, 70, 97, seed=5)
    x = tdev.encode_state(cells, BF16)
    last, first = ttemp.make_halos_t(x, 20, 4)
    state = (x, (last.float() * 1.01).to(torch.bfloat16), (first.float() * 0.99).to(torch.bfloat16))
    got, av = ttemp.step_t(state, nobst, DENSITY, ACCEL, OMEGA, 20, 4, panel=32, dev=BF16)
    want, want_av = ttemp.step_t_plain(state, nobst, DENSITY, ACCEL, OMEGA, 20, 4, dev=BF16)
    assert_bf16_close((got[0], av), (want[0], want_av))
    own_last, own_first = ttemp.make_halos_t(got[0], 20, 4)
    assert torch.equal(got[1], own_last) and torch.equal(got[2], own_first)


@pytest.mark.cuda
def test_bf16_overlap_runs_f32_between_casts(cuda_device):
    """K12 has no bf16 form: ``pallas-overlap`` at bf16 runs the f32 kernel
    on the widened shards and rounds once at the chunk's end (f32 counter),
    and the kernel itself refuses bf16 shards."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.parallel.sharded import run_simulation_sharded

    _, _, shards, nob = mesh_setup(cuda_device, 40, 32, 4, 1, seed=3)
    with pytest.raises(ValueError, match="bfloat16"):
        tshard.run_shard_overlap([[tdev.encode_state(s, BF16) for s in row] for row in shards],
                                 nob, DENSITY, ACCEL, OMEGA, 2, 32)
    params = LBMParams(nx=64, ny=64, max_iters=9, reynolds_dim=10, density=DENSITY, accel=ACCEL,
                       omega=OMEGA)
    obs = np.zeros((64, 64), np.int32)
    obs[0] = obs[-1] = 1
    before = tshard.run_shard_overlap.launches
    got = run_simulation_sharded(params, obs, devices=["cuda:0"] * 4, backend="pallas-overlap",
                                 dtype=torch.bfloat16)
    assert tshard.run_shard_overlap.launches == before + 9
    want = run_simulation_sharded(params, obs, devices=["cpu"] * 4, backend="pallas-overlap",
                                  dtype=torch.bfloat16)
    ulps = bf16_ulps(torch.as_tensor(got.cells).to(torch.bfloat16),
                     torch.as_tensor(want.cells).to(torch.bfloat16))
    assert int(ulps.max()) <= 2 and float((ulps > 0).float().mean()) <= 0.01


# K3's 16-bit forms (four cells per thread, 64-bit words): (nx, ny, py, px)
# with an odd rx, ragged shard rows (25 of 100), a 1000^2 grid on 4 shards
# and a 2 x 1 mesh.
K3_16_MESHES = [(71, 100, 4, 1), (1000, 1000, 4, 1), (65, 64, 2, 1), (129, 30, 2, 1),
                (3, 8, 4, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,py,px", K3_16_MESHES)
@pytest.mark.parametrize("storage", ["c16", "bf16"])
def test_k3_16bit_matches_plain_and_k1(cuda_device, storage, nx, ny, py, px):
    """K3 at c16 and bf16 against its plain version, its joined state bitwise
    K1's of the same storage and its summed av within 1e-6 of K1's; a second
    run bitwise equal."""
    dev = SPEC if storage == "c16" else BF16
    cells, nobst = make_setup(cuda_device, nx, ny, seed=nx + py)
    x = tdev.encode_state(cells, dev)
    ry = ny // py
    shards = [[x[:, i * ry:(i + 1) * ry].contiguous()] for i in range(py)]
    nob = [[nobst[i * ry:(i + 1) * ry].contiguous()] for i in range(py)]
    n = 13
    got = tshard.run_shard_step(shards, nob, DENSITY, ACCEL, OMEGA, n, ny, dev=dev)
    again = tshard.run_shard_step(shards, nob, DENSITY, ACCEL, OMEGA, n, ny, dev=dev)
    assert torch.equal(joined(got[0]), joined(again[0])) and torch.equal(got[1], again[1])
    k1 = tstep.run_step(x, nobst, DENSITY, ACCEL, OMEGA, n, 1.0, dev=dev)
    assert torch.equal(joined(got[0]), k1[0])
    np.testing.assert_allclose(got[1].sum(0).double().cpu().numpy(),
                               k1[1].double().cpu().numpy(), rtol=1e-6)
    want = tshard.run_shard_step_plain(shards, nob, DENSITY, ACCEL, OMEGA, n, ny, dev=dev)
    pair = (joined(got[0]), got[1].sum(0)), (joined(want[0]), want[1].sum(0))
    if storage == "c16":
        assert_c16_close(*pair)
    else:
        assert_bf16_close(*pair, BF16_SPREAD_TOL)


# K9 in one window: (nx, ny, block, depth, panel) at T 4, 8 and 16, full row
# (panel None) and panel, on ragged grids.
K9_SCHEDULES = [(100, 97, 24, 4, 56), (100, 97, 8, 4, None), (150, 100, 16, 8, 40),
                (130, 100, 16, 8, None), (200, 150, 32, 16, 40), (40, 70, 32, 16, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,block,depth,panel", K9_SCHEDULES)
@pytest.mark.parametrize("storage", ["f32", "c16", "bf16"])
def test_k9_one_window_matches_plain(cuda_device, storage, nx, ny, block, depth, panel):
    """K9 over 2T+3 steps (two passes and a K1 remainder) against
    run_band2_plain; at f32 its state bitwise K1's; a second run bitwise
    equal."""
    dev = {"f32": None, "c16": SPEC, "bf16": BF16}[storage]
    cells, nobst = make_setup(cuda_device, nx, ny, seed=nx + depth)
    x = cells if dev is None else tdev.encode_state(cells, dev)
    n = 2 * depth + 3

    def run(fn):
        return fn(x, nobst, DENSITY, ACCEL, OMEGA, n, block, depth, panel=panel, dev=dev)

    got, again = run(tband2.run_band2), run(tband2.run_band2)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = run(tband2.run_band2_plain)
    if storage == "f32":
        assert_close(got, want)
        assert torch.equal(got[0], tstep.run_step(cells, nobst, DENSITY, ACCEL, OMEGA, n, 1.0)[0])
    elif storage == "c16":
        assert_c16_close(got, want)
    else:
        assert_bf16_close(got, want, BF16_SPREAD_TOL)


# K11 on the trapezoid, its load and store fused into its first and last
# steps: (nx, ny, block, depth, panel) at T 2, 4, 8 and 16, full row (panel
# None) and panel, on ragged grids.
K11_SCHEDULES = [(46, 37, 12, 2, 15), (100, 97, 24, 4, 56), (100, 97, 8, 4, None),
                 (150, 100, 16, 8, 40), (130, 100, 16, 8, None), (200, 150, 32, 16, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,block,depth,panel", K11_SCHEDULES)
@pytest.mark.parametrize("storage", ["f32", "c16", "bf16"])
def test_k11_trapezoid_matches_plain(cuda_device, storage, nx, ny, block, depth, panel):
    """K11 over one pass and over 2T+3 steps (two passes, the first fused
    into the second, and a K1 remainder) against run_band3_plain; a second
    run bitwise equal."""
    dev = {"f32": None, "c16": SPEC, "bf16": BF16}[storage]
    cells, nobst = make_setup(cuda_device, nx, ny, seed=nx + depth)
    x = cells if dev is None else tdev.encode_state(cells, dev)
    for n in (depth, 2 * depth + 3):
        def run(fn):
            return fn(x, nobst, DENSITY, ACCEL, OMEGA, n, block, depth, panel=panel, dev=dev)

        got, again = run(tband3.run_band3), run(tband3.run_band3)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        want = run(tband3.run_band3_plain)
        if storage == "f32":
            assert_close(got, want)
        elif storage == "c16":
            assert_c16_close(got, want)
        else:
            assert_bf16_close(got, want, BF16_TOL if n == depth else BF16_SPREAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(70, 97), (33, 3), (64, 4), (300, 257)])
@pytest.mark.parametrize("iters,chunk", [(12, 5), (13, 5), (255, 255), (256, 255)])
def test_resident_aa_form_matches_plain_and_k1(cuda_device, nx, ny, iters, chunk):
    """K4's global-memory form (one copy in the AA arrangement) over launches
    of ``chunk`` steps, both exit parities: its state bitwise K1's, its av
    series bitwise repeatable and within K4's tolerance of the plain
    version's, and a run cut between calls the whole run's bits."""
    cells, nobst = make_setup(cuda_device, nx, ny, seed=iters + nx)
    blocks = min(tres.max_blocks(cuda_device), -(-nx * ny // tres._THREADS))

    def run(c, n):
        return tres.launch(c, nobst, DENSITY, ACCEL, OMEGA, n, 1.0, chunk, blocks)

    got, again = run(cells, iters), run(cells, iters)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert torch.equal(got[0], tstep.run_step(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0)[0])
    assert_close(got, tres.run_resident_aa_plain(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0,
                                                 chunk=chunk))
    head = run(cells, 7)
    tail = run(head[0], iters - 7)
    assert torch.equal(tail[0], got[0]) and torch.equal(torch.cat([head[1], tail[1]]), got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(16, 16), (300, 257), (1024, 1024)])
def test_resident_grid_blocks(cuda_device, nx, ny):
    """``run_resident``'s grid for the global-memory form: what the card
    holds at once, at most BLOCKS_PER_SM per SM, at most one thread per
    cell."""
    blocks = tres.grid_blocks(cuda_device, ny, nx)
    assert 1 <= blocks <= tres.max_blocks(cuda_device)
    assert blocks <= tres.BLOCKS_PER_SM * tres.sm_count(cuda_device)
    assert blocks <= -(-nx * ny // tres._THREADS)
    if nx * ny >= tres._THREADS * tres.BLOCKS_PER_SM * tres.sm_count(cuda_device):
        assert blocks == min(tres.max_blocks(cuda_device),
                             tres.BLOCKS_PER_SM * tres.sm_count(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(128, 96), (300, 257)])
def test_resident_aa_form_l2_window_is_bitwise(cuda_device, monkeypatch, nx, ny):
    """The global-memory form gives the same bits with and without its
    persisting-L2 window over the state (``resident.l2_window`` set either
    way), and a run without it after one with it gives those bits again."""
    cells, nobst = make_setup(cuda_device, nx, ny, seed=2)
    blocks = min(tres.max_blocks(cuda_device), -(-nx * ny // tres._THREADS))

    def run(window):
        monkeypatch.setattr(tres, "l2_window", lambda state_bytes, device: window)
        return tres.launch(cells, nobst, DENSITY, ACCEL, OMEGA, 37, 1.0, 16, blocks)

    want, got = run(False), run(True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(run(False)[1], want[1])


# K7 in one window at any T: (nx, ny, block, depth, panel) at T 1, 3, 4, 5
# and 8, full row (panel None) and panel, on ragged grids, a tile of one row
# and one column, and a block shorter than 2T (outside K9's domain).
K7_SCHEDULES = [(45, 37, 8, 1, 11), (100, 97, 24, 3, 56), (100, 97, 5, 3, None),
                (100, 97, 24, 4, 20), (70, 97, 7, 5, 13), (40, 70, 16, 5, None),
                (150, 100, 16, 8, 40), (33, 21, 1, 3, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,block,depth,panel", K7_SCHEDULES)
@pytest.mark.parametrize("storage", ["f32", "c16", "bf16"])
def test_k7_one_window_matches_plain(cuda_device, storage, nx, ny, block, depth, panel):
    """K7 (one window, AA steps) over 2T+3 steps (two passes and a K1
    remainder) against run_band_plain and run_band_aa_plain; at f32 its
    state bitwise K1's (an odd T too, whose passes end on a scatter step);
    a second run bitwise equal."""
    dev = {"f32": None, "c16": SPEC, "bf16": BF16}[storage]
    cells, nobst = make_setup(cuda_device, nx, ny, seed=nx + depth)
    x = cells if dev is None else tdev.encode_state(cells, dev)
    n = 2 * depth + 3
    before = tband.run_band.launches if dev is None else getattr(tband.run_band,
                                                                 f"launches_{storage}")

    def run(fn):
        return fn(x, nobst, DENSITY, ACCEL, OMEGA, n, block, depth, panel=panel, dev=dev)

    got, again = run(tband.run_band), run(tband.run_band)
    after = tband.run_band.launches if dev is None else getattr(tband.run_band,
                                                                f"launches_{storage}")
    assert after == before + 2 * (n // depth * depth)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    for want in (run(tband.run_band_plain), run(tband.run_band_aa_plain)):
        if storage == "f32":
            assert_close(got, want)
        elif storage == "c16":
            assert_c16_close(got, want)
        else:
            assert_bf16_close(got, want, BF16_SPREAD_TOL)
    if storage == "f32":
        assert torch.equal(got[0], tstep.run_step(cells, nobst, DENSITY, ACCEL, OMEGA, n, 1.0)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("depth,panel", [(3, 20), (5, None), (1, 7)])
@pytest.mark.parametrize("storage", ["f32", "c16", "bf16"])
def test_k8_one_window_odd_t_matches_plain(cuda_device, storage, depth, panel):
    """K8 at an odd T on 4 row shards of a 100 x 70 grid (25-row shards,
    16-row tiles) over two passes and a K3 remainder against its plain
    version and its AA model; at f32 the joined state bitwise K1's."""
    dev = {"f32": None, "c16": SPEC, "bf16": BF16}[storage]
    ny, nx = 100, 70
    cells, nobst, shards, nob = mesh_setup(cuda_device, nx, ny, 4, 1, seed=depth)
    if dev is not None:
        shards = [[tdev.encode_state(row[0], dev)] for row in shards]
    n = 2 * depth + 3

    def run(fn):
        return fn(shards, nob, DENSITY, ACCEL, OMEGA, n, 16, depth, ny, panel=panel, dev=dev)

    got, again = run(tband.run_band_sharded), run(tband.run_band_sharded)
    assert torch.equal(joined(got[0]), joined(again[0])) and torch.equal(got[1], again[1])
    for want in (run(tband.run_band_sharded_plain), run(tband.run_band_sharded_aa_plain)):
        pair = (joined(got[0]), got[1].sum(0)), (joined(want[0]), want[1].sum(0))
        if storage == "f32":
            assert_close(*pair)
        elif storage == "c16":
            assert_c16_close(*pair)
        else:
            assert_bf16_close(*pair, BF16_SPREAD_TOL)
    if storage == "f32":
        assert torch.equal(joined(got[0]),
                           tstep.run_step(cells, nobst, DENSITY, ACCEL, OMEGA, n, 1.0)[0])


WORD_FORMS = {"K1": (tstep, tstep.run_step, tstep.run_step_plain),
              "K2": (taa, taa.run_aa, taa.run_aa_plain)}
WORD_STORAGES = {"c16": SPEC, "bf16": tdev.BF16}


def assert_16bit_close(got, want, dev):
    if dev.name == "c16":
        assert_c16_close(got, want)
    else:
        assert_bf16_close(got, want, BF16_SPREAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(64, 9), (1000, 41), (8, 3), (136, 7)])
@pytest.mark.parametrize("storage", list(WORD_STORAGES))
@pytest.mark.parametrize("name", list(WORD_FORMS))
def test_word_form_matches_one_cell(cuda_device, name, storage, nx, ny):
    """The word form by the shape rule: the one-cell form's state bit for
    bit (av at rtol 1e-4, another order of its sums), its plain version's
    within the storage's tolerance, two runs bitwise equal, counted as the
    word form."""
    mod, kernel, plain = WORD_FORMS[name]
    dev = WORD_STORAGES[storage]
    assert mod.word_form(nx, dev)
    cells, nobst = make_setup(cuda_device, nx, ny, seed=nx + ny)
    q = tdev.encode_state(cells, dev)
    counts = (getattr(kernel, f"launches_{storage}"), getattr(kernel, f"launches_word_{storage}"))
    got = kernel(q, nobst, DENSITY, ACCEL, OMEGA, 13, 1.0, dev=dev)
    assert (getattr(kernel, f"launches_{storage}"),
            getattr(kernel, f"launches_word_{storage}")) == (counts[0] + 13, counts[1] + 13)
    cell = mod.launch(q, nobst, DENSITY, ACCEL, OMEGA, 13, 1.0, False, dev)
    again = kernel(q, nobst, DENSITY, ACCEL, OMEGA, 13, 1.0, dev=dev)
    assert torch.equal(got[0], cell[0])
    np.testing.assert_allclose(got[1].cpu().numpy(), cell[1].cpu().numpy(), rtol=1e-4)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert_16bit_close(got, plain(q, nobst, DENSITY, ACCEL, OMEGA, 13, 1.0, dev=dev), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", list(WORD_STORAGES))
@pytest.mark.parametrize("name", list(WORD_FORMS))
def test_word_form_in_calls(cuda_device, name, storage):
    """Three chained calls of odd and even lengths give the one call's
    state and av bit for bit (K2: a call's last step fuses no forcing)."""
    _, kernel, _ = WORD_FORMS[name]
    dev = WORD_STORAGES[storage]
    cells, nobst = make_setup(cuda_device, 256, 33, seed=4)
    q = tdev.encode_state(cells, dev)
    want = kernel(q, nobst, DENSITY, ACCEL, OMEGA, 14, 1.0, dev=dev)
    avs = []
    for n in (5, 4, 5):
        q, av = kernel(q, nobst, DENSITY, ACCEL, OMEGA, n, 1.0, dev=dev)
        avs.append(av)
    assert torch.equal(q, want[0]) and torch.equal(torch.cat(avs), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "c16", "bf16"])
@pytest.mark.parametrize("name", list(WORD_FORMS))
def test_word_shape_rule_on_card(cuda_device, name, storage):
    """A width the words do not tile (130) and f32 run the one-cell form:
    the word counter stays; a word launch the kernels do not take raises."""
    mod, kernel, plain = WORD_FORMS[name]
    dev = None if storage == "f32" else WORD_STORAGES[storage]
    cells, nobst = make_setup(cuda_device, 130, 11, seed=6)
    x = cells if dev is None else tdev.encode_state(cells, dev)
    assert not mod.word_form(130, dev)
    words = (kernel.launches_word_c16, kernel.launches_word_bf16)
    got = kernel(x, nobst, DENSITY, ACCEL, OMEGA, 9, 1.0, dev=dev)
    assert (kernel.launches_word_c16, kernel.launches_word_bf16) == words
    want = plain(x, nobst, DENSITY, ACCEL, OMEGA, 9, 1.0, dev=dev)
    if dev is None:
        assert_close(got, want)
    else:
        assert_16bit_close(got, want, dev)
    with pytest.raises(RuntimeError, match="word form"):
        mod.launch(x, nobst, DENSITY, ACCEL, OMEGA, 9, 1.0, True, dev)


@pytest.mark.cuda
def test_c16_codec_sweep(cuda_device):
    """The c16 codec gives the codes and decoded values of its form with
    the card's conversion instructions for every input (csrc/codec_check.cu)."""
    lib = _build.library()
    bad = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    rc = lib.lbm_c16_sweep(_build.storage(SPEC), bad.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "codec sweep")
    assert bad.tolist() == [0, 0]


def rows_in_turns(shards, n):
    """``n`` steps (or passes) of row shards that stand for processes, each
    given its neighbours' edge rows on the card, as the multi-process
    path's exchange delivers them."""
    for _ in range(n):
        edges = [s.edges() for s in shards]
        for z, s in enumerate(shards):
            dn, up = s.halos()
            dn.copy_(edges[z - 1][1])
            up.copy_(edges[(z + 1) % len(shards)][0])
        for s in shards:
            s.step()


ROW_STORAGES = {"f32": None, "c16": SPEC, "bf16": tdev.BF16}


@pytest.mark.cuda
@pytest.mark.parametrize("storage", list(ROW_STORAGES))
@pytest.mark.parametrize("ry,rx,py", [(7, 9, 3), (1, 33, 4), (64, 130, 2), (5, 8, 1)])
def test_k3_ring_fill_from_rows_is_the_peer_fill(cuda_device, storage, ry, rx, py):
    """K3 with its ring filled from received rows (``RowShard``,
    ``lbm_shard_rows_run``: the multi-process path) on ragged shards, each
    shard's rows handed over on the card: state and per-step sums bitwise
    those of K3 with the ring filled through the neighbours' addresses
    (``run_shard_step``), at f32, c16 and bf16; its own launch counter."""
    dev = ROW_STORAGES[storage]
    ny, steps = py * ry, 6
    cells, nobst, shards, nob = mesh_setup(cuda_device, rx, ny, py, 1, seed=ry + rx)
    if dev is not None:
        shards = [[tdev.encode_state(s, dev) for s in row] for row in shards]
    want, want_sums = tshard.run_shard_step(shards, nob, DENSITY, ACCEL, OMEGA, steps, ny, dev=dev)
    rings = tshard.with_ring([[n[None] for n in row] for row in nob])
    name = "launches" if dev is None else f"launches_{dev.name}"
    before = getattr(tshard.RowShard, name)
    rows = [tshard.RowShard(shards[z][0], rings[z][0][0], z, py, ny, DENSITY, ACCEL, OMEGA, steps,
                            dev=dev) for z in range(py)]
    rows_in_turns(rows, steps)
    torch.cuda.synchronize()
    assert getattr(tshard.RowShard, name) == before + py * steps
    for z, s in enumerate(rows):
        assert torch.equal(s.state(), want[z][0])
        assert torch.equal(s.sums, want_sums[z])


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(SHARD_BANDS))
def test_sharded_band_halos_from_rows_are_the_peer_copy(cuda_device, name, storage):
    """K8 and K10 with their halos received (``BandRowShard``: a null table,
    no halo copy) on 4 shards of 25 rows under 16-row tiles, T 4, three
    passes: bitwise the one-call mesh (``run_band_sharded``)."""
    dev = ROW_STORAGES[storage]
    kernel = SHARD_BANDS[name][0]
    mod = tband if name == "K8" else tband2
    ny, nx, py, depth, passes = 100, 70, 4, 4, 3
    cells, nobst, shards, nob = mesh_setup(cuda_device, nx, ny, py, 1, seed=11)
    if dev is not None:
        shards = [[tdev.encode_state(s, dev) for s in row] for row in shards]
    want, want_sums = kernel(shards, nob, DENSITY, ACCEL, OMEGA, passes * depth, 16, depth, ny,
                             dev=dev)
    ry = ny // py

    def rows(lo):
        return nobst[torch.arange(lo, lo + depth, device=cuda_device) % ny]

    before = kernel.launches if dev is None else kernel.launches_bf16
    bands = [mod.row_shard(shards[z][0], nob[z][0], rows(z * ry - depth), rows((z + 1) * ry), z,
                           py, ny, DENSITY, ACCEL, OMEGA, 16, depth, None, passes, dev=dev)
             for z in range(py)]
    rows_in_turns(bands, passes)
    torch.cuda.synchronize()
    after = kernel.launches if dev is None else kernel.launches_bf16
    assert after == before + py * passes * depth
    for z, s in enumerate(bands):
        assert torch.equal(s.state(), want[z][0])
        assert torch.equal(s.sums, want_sums[z])


def spawn_ipc_ranks(tmp_path, world, *args, timeout=300):
    """``world`` processes of tests/torch_multihost_worker.py ``ipc``; every
    one gets ``timeout`` seconds, so a lost wait fails instead of hanging.
    Returns their (returncode, output) and result files."""
    import socket
    import subprocess

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = repo
    outs = [str(tmp_path / f"ipc{rank}.npz") for rank in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.join(repo, "tests", "torch_multihost_worker.py"),
                               "ipc", str(rank), str(world), str(port), outs[rank], *args],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    got = []
    try:
        for p in procs:
            got.append((p.communicate(timeout=timeout)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(rc, text) for text, rc in got], outs


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("cards", ["one card", "a card per rank"])
def test_ipc_row_shard_is_the_one_process_k12(cuda_device, tmp_path, cards, world):
    """K12 across 2 or 4 processes (``IpcRowShard``: each maps its
    neighbours' shards with CUDA IPC, the steps ordered by waits on the
    streams; with 4 the previous and the next rank differ, so each stream
    waits on both words of its inbox) on the 1024^2 deck's shards, 50
    steps, all on cuda:0 or one card each: every process's state and
    per-step sums bitwise those of ``run_shard_overlap`` on the same shards
    in one process, and 50 steps in its launch counter."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__))))
    import torch_multihost_worker as worker

    own = cards != "one card"
    if own and torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices")
    cells, nob = worker.ipc_deck()
    ny, steps = cells.shape[1], 50
    ry = ny // world
    devices = [torch.device("cuda", z if own else 0) for z in range(world)]
    shards = [[cells[:, z * ry:(z + 1) * ry].to(devices[z])] for z in range(world)]
    nobs = [[nob[z * ry:(z + 1) * ry].to(devices[z])] for z in range(world)]
    want, want_sums = tshard.run_shard_overlap(shards, nobs, worker.DENSITY, worker.ACCEL,
                                               worker.OMEGA, steps, ny)
    ranks, outs = spawn_ipc_ranks(tmp_path, world, "--steps", str(steps),
                                  *(["--own-card"] if own else []))
    for rank, (rc, text) in enumerate(ranks):
        assert rc == 0, f"rank {rank}: {text[-3000:]}"
    for z, out in enumerate(outs):
        got = np.load(out)
        assert int(got["launches"]) == steps
        assert np.array_equal(got["state"], want[z][0].cpu().numpy())
        assert np.array_equal(got["sums"], want_sums[z].cpu().numpy())


@pytest.mark.cuda
def test_ipc_row_shard_raises_when_a_neighbour_stops(cuda_device, tmp_path):
    """Rank 1 maps rank 0's shard and then steps nothing: rank 0's step 2
    waits on the stream for rank 1's step 1, and rank 0 raises within its
    deadline (5 s), naming the ranks, and exits (its stream released, the
    waits passed); no process hangs."""
    deadline = 5.0
    ranks, _ = spawn_ipc_ranks(tmp_path, 2, "--deadline", str(deadline), "--stop",
                               str(deadline + 20), timeout=120)
    (rc0, text0), (rc1, text1) = ranks
    assert rc0 == 3, text0[-3000:]
    assert "rank 0 of 2 did not finish steps 1-50" in text0 and "rank 1" in text0, text0[-3000:]
    waited = float(text0.split("after ")[1].split(" s:")[0])
    assert deadline <= waited < deadline + 2.0
    assert rc1 == 0, text1[-3000:]


@pytest.mark.cuda
@pytest.mark.parametrize("backend,storage", [("pallas", "f32"), ("pallas", "c16"),
                                             ("deep", "f32"), ("deep", "c16"),
                                             ("resident", "f32")])
def test_the_driver_counts_its_copies_and_launches(cuda_device, backend, storage, monkeypatch):
    """The driver's counters on a 96 x 64 deck of 301 steps in chunks of 200
    and 101 (``runtime/trace.py``): the bytes of the state, the mask, the av
    series and, at c16, the saturation scalar; the kernel launches the
    route's schedule implies (K1 one a step; K6 one a pass of T steps and
    K1 on the remainder; K4 one per 255 steps); and no synchronisation but
    the driver's two per chunk."""
    nx, ny, iters, chunks = 96, 64, 301, (200, 101)
    params = LBMParams(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    rng = np.random.RandomState(5)
    obstacles = np.zeros((ny, nx), np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    start = ((WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx)))
    dtype = torch.float32 if storage == "f32" else "c16"
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: (syncs.append(1), real(*a)))
    res = tdriver.run_simulation(params, obstacles, backend=backend, dtype=dtype,
                                 initial_cells=start.astype(np.float32), device=cuda_device,
                                 chunk_every=200)
    rec = res.trace
    assert len(syncs) == 2 * len(chunks) and rec.chunks == len(chunks)
    state = 9 * ny * nx * 4
    assert rec.counts["h2d_bytes"] == state + ny * nx * 4
    assert rec.counts["d2h_bytes"] == state + 4 * iters + (4 if storage == "c16" else 0)
    if backend == "pallas":
        launches = iters
    elif backend == "resident":
        launches = sum(-(-n // 255) for n in chunks)
    else:
        depth = tdriver.deep_config(params, dtype)[1]
        launches = sum(n // depth + n % depth for n in chunks)
    assert rec.counts["kernel_launches"] == launches
    assert {"library", "sync", "loop", "av", "fetch"} <= set(rec.spans)
    assert rec.elapsed == res.elapsed
