"""The CPU side of two kernel redesigns for the H100: K3's 16-bit forms
with four cells per thread, and K9 in one window stepped in the AA
arrangement.

K3 (``csrc/shard_step.cu::shard_step_pair_kernel``) reads and writes every
16-bit plane as aligned 64-bit words, four cells per thread, and rebuilds
the x-1 and x+1 pulls from a lane's words and its neighbour's.
``shard_step.pair_row_plan`` is its access plan for one row: it is held
here to its rules (every cell stored once, the right ghost column never,
whole words only when aligned and full, every read inside the padded row,
every pull covered) for aligned and ragged widths, odd ones among them.

K9 (``csrc/band2.cu``) loads the regular arrangement into the C space of
the AA arrangement and steps odd, even, ..., even in place;
``band2.run_band2_aa_plain`` is that schedule in plain PyTorch. It is
held bit for bit against ``run_band2_plain`` (the pull between two
windows, which tests/test_torch_band2.py holds against the JAX kernels) at
T 4, 8 and 16, full row and panel, f32, c16 and bf16, on ragged grids,
and once against the JAX kernel ``pallas_band2`` in interpret mode (cells
within 1e-5 of the state's scale, av at rtol 1e-4). The driver's K9
schedule fits two blocks per SM, and a window beyond a block's shared
memory is refused.

The slice: ``cli.main --device cpu`` with ``--mesh 2`` at c16 (on a deck of
odd width) and bf16 (K3's plain forms), and ``--backend band2`` at c16,
against the JAX CLI on the same decks, with the tolerances of
tests/test_torch_c16_mesh.py, tests/test_torch_bf16_mesh.py and
tests/test_torch_c16_routes.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu import cli as jcli
from lbm_tpu.ops import pallas_band2 as jb2
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.models.d2q9 import WEIGHTS, LBMParams
from lbm_tpu_torch.ops import band2 as tb2
from lbm_tpu_torch.ops import band_common as BC
from lbm_tpu_torch.ops import devspace as tdev
from lbm_tpu_torch.ops import shard_step
from lbm_tpu_torch.utils.checker import check_files
from lbm_tpu_torch.utils.geometry import write_obstacle_file, write_params_file

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
SPEC = tdev.DevSpec.for_params(DENSITY, ACCEL)
STORAGES = {"f32": None, "c16": SPEC, "bf16": tdev.BF16}
# The shared memory of one of two blocks on an SM: the SM's 228 KB, less
# the 1 KB the card reserves per block.
TWO_PER_SM = (228 * 1024) // 2 - 1024


@pytest.mark.parametrize("dtype", [torch.int16, torch.bfloat16], ids=["c16", "bf16"])
@pytest.mark.parametrize("rx", [1, 2, 3, 4, 5, 63, 64, 65, 127, 128, 129, 130, 250, 999, 1000,
                                1001, 1024])
def test_pair_row_plan(rx, dtype):
    """Every cell of the row stored once, the ghost column lead + rx never;
    64-bit stores only of four cells below rx; loads inside the padded row,
    aligned to their width; every pull of a stored cell read by its thread
    or by a neighbour lane of its warp."""
    lead, pitch = shard_step.lead_of(dtype), shard_step.pitch_of(rx, dtype)
    assert lead == 64
    plan = shard_step.pair_row_plan(rx, dtype)
    stored = [col for _, _, stores in plan for first, n in stores for col in range(first, first + n)]
    assert sorted(stored) == list(range(lead, lead + rx))
    words = {}
    for x0, loads, stores in plan:
        for first, n in stores:
            assert n == 1 or (n == 4 and first % 4 == 0 and x0 + 4 <= rx)
        for first, n in loads:
            assert 0 <= first and first + n <= pitch and first % n == 0
        words[x0] = {col for first, n in loads for col in range(first, first + n)}
    for x0, _, stores in plan:
        lane = (x0 // 4) % 32
        seen = set(words[x0])
        if lane > 0:
            seen |= words[x0 - 4]
        if lane < 31 and x0 + 4 in words:
            seen |= words[x0 + 4]
        for first, n in stores:
            for col in range(first, first + n):
                assert {col - 1, col, col + 1} <= seen


def make_setup(nx, ny, seed):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 10), rng.randint(0, nx, 10)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    return state.astype(np.float32), (obstacles == 0).astype(np.float32)


@pytest.mark.parametrize("storage", list(STORAGES))
@pytest.mark.parametrize("nx,ny,block,depth,panel,n", [
    (70, 97, 24, 4, 20, 11), (50, 33, 8, 4, None, 9), (64, 41, 16, 8, 28, 19),
    (40, 39, 16, 8, None, 16), (50, 64, 32, 16, 20, 35), (30, 70, 32, 16, None, 32)])
def test_k9_aa_schedule_is_the_pull(storage, nx, ny, block, depth, panel, n):
    """K9's AA steps give the pull's state and av series bit for bit."""
    dev = STORAGES[storage]
    state, nobst = make_setup(nx, ny, seed=nx + depth)
    cells = tdev.encode_state(torch.as_tensor(state), dev) if dev else torch.as_tensor(state)
    args = (cells, torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA, n, block, depth)
    got = tb2.run_band2_aa_plain(*args, panel=panel, dev=dev)
    want = tb2.run_band2_plain(*args, panel=panel, dev=dev)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k9_aa_schedule_matches_pallas_band2():
    """128 x 64, block 16, T 8, two passes and a remainder: the JAX kernel's
    full row against the AA schedule."""
    state, nobst = make_setup(128, 64, seed=3)
    want, want_tot = jb2.run_band2(jnp.asarray(state, jnp.float32),
                                   jnp.asarray(nobst, jnp.float32), DENSITY, ACCEL, OMEGA, 19,
                                   16, 8, interpret=True, paired="fused")
    cells, av = tb2.run_band2_aa_plain(torch.as_tensor(state), torch.as_tensor(nobst), DENSITY,
                                       ACCEL, OMEGA, 19, 16, 8)
    want = np.asarray(want)
    assert np.abs(cells.numpy() - want).max() < 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(av.numpy(), np.asarray(want_tot), rtol=1e-4)


@pytest.mark.parametrize("storage", list(STORAGES))
@pytest.mark.parametrize("n,want", [(4096, (32, 4, 56)), (1000, (32, 4, 56)),
                                    (1024, (32, 4, 56)), (512, (24, 4, 24)),
                                    (256, (24, 4, 24)), (97, (24, 4, 24))])
def test_k9_schedule_fits_two_blocks_per_sm(storage, n, want):
    """The driver's K9 schedule at every storage: one window copy of 40 x 64
    cells where its tiles fill a wave of two blocks on each of 132 SMs, of
    32 x 32 cells below; each within the shared memory of one of two blocks
    on an SM."""
    params = LBMParams(nx=n, ny=n, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    dtype = {"f32": torch.float32, "c16": "c16", "bf16": torch.bfloat16}[storage]
    block, depth, panel = tb2.schedule(params, dtype)
    assert (block, depth, panel) == want and tb2.PLANE_COPIES == 1
    assert (-(-n // 32) * -(-n // 56) >= 2 * 132) == (want == (32, 4, 56))
    assert tb2.band2_supported(params.ny, params.nx, block, depth, panel)
    need = BC.smem_bytes(tb2.PLANE_COPIES, params.nx, block, depth, panel)
    wh, ww = block + 2 * depth, panel + 2 * depth
    assert need == 40 * wh * ww + 4 * (wh + ww) + 4 * 16 * depth
    assert need <= TWO_PER_SM


@pytest.mark.parametrize("depth", [4, 8, 16])
def test_k9_widest_window_and_refusals(depth):
    """At T 4, 8 and 16 (block 2T), the widest panel whose one-copy window
    fits a block is held and one column more is refused; odd T and a block
    under 2T are refused."""
    block = 2 * depth
    panel = 1
    while BC.smem_bytes(tb2.PLANE_COPIES, 4096, block, depth, panel + 1) <= BC.SMEM_LIMIT:
        panel += 1
    BC.check_smem("band2 kernel", tb2.PLANE_COPIES, 4096, block, depth, panel)
    assert 40 * (block + 2 * depth) * (panel + 2 * depth) <= BC.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        BC.check_smem("band2 kernel", tb2.PLANE_COPIES, 4096, block, depth, panel + 1)
    assert tb2.band2_supported(100, 100, block, depth, panel)
    assert not tb2.band2_supported(100, 100, block - 1, depth, panel)
    assert not tb2.band2_supported(100, 100, block, depth + 1, panel)


def write_deck(tmp_path, nx, ny, iters, seed):
    rng = np.random.RandomState(seed)
    obs = np.zeros((ny, nx), np.int32)
    obs[0] = obs[-1] = 1
    obs[rng.randint(1, ny - 1, 8), rng.randint(0, nx, 8)] = 1
    write_params_file(tmp_path / "input.params", nx, ny, iters, 10, DENSITY, ACCEL, OMEGA)
    write_obstacle_file(tmp_path / "obstacles.dat", obs)
    return str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat")


def outputs(*dirs):
    return [d / f for d in dirs for f in ("av_vels.dat", "final_state.dat")]


def test_cli_mesh_c16_odd_width_matches_jax_cli(tmp_path, capsys):
    """``--mesh 2 --precision c16`` (``auto``: K3's plain c16 form) on a
    129 x 32 deck, an odd shard width, through both CLIs: the 1% checker,
    av_vels at rtol 1e-3, pressure within 5e-6."""
    deck = write_deck(tmp_path, 129, 32, 9, seed=21)
    out, ref = tmp_path / "port", tmp_path / "jax"
    assert tcli.main([*deck, "--device", "cpu", "--mesh", "2", "--precision", "c16",
                      "--out-dir", str(out)]) == 0
    assert jcli.main([*deck, "--mesh", "2", "--precision", "c16", "--out-dir", str(ref)]) == 0
    capsys.readouterr()
    files = outputs(out, ref)
    assert check_files(*files, tolerance=1.0).passed
    np.testing.assert_allclose(np.loadtxt(files[0], usecols=[1]),
                               np.loadtxt(files[2], usecols=[1]), rtol=1e-3)
    pressure = [np.loadtxt(f, usecols=[5]) for f in (files[1], files[3])]
    assert np.abs(pressure[0] - pressure[1]).max() < 5e-6


def test_cli_mesh_bf16_matches_jax_cli(tmp_path, capsys):
    """``--mesh 2 --precision bf16`` (``auto``: K3's plain bf16 form) on a
    256 x 32 deck of 50 steps, and the JAX CLI's ``--backend pallas`` there
    (its kernel takes widths of whole 128-lane tiles only): av_vels at rtol
    1e-3, pressure within 2 bf16 ulps of its scale."""
    deck = write_deck(tmp_path, 256, 32, 50, seed=23)
    out, ref = tmp_path / "port", tmp_path / "jax"
    assert tcli.main([*deck, "--device", "cpu", "--mesh", "2", "--precision", "bf16",
                      "--out-dir", str(out)]) == 0
    assert jcli.main([*deck, "--mesh", "2", "--backend", "pallas", "--precision", "bf16",
                      "--out-dir", str(ref)]) == 0
    capsys.readouterr()
    np.testing.assert_allclose(np.loadtxt(out / "av_vels.dat", usecols=[1]),
                               np.loadtxt(ref / "av_vels.dat", usecols=[1]), rtol=1e-3)
    pressure = [np.loadtxt(d / "final_state.dat", usecols=[5]) for d in (out, ref)]
    assert np.abs(pressure[0] - pressure[1]).max() <= 2.0 ** -6 * np.abs(pressure[1]).max()


def test_cli_band2_c16_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """``--backend band2 --precision c16`` on a 128 x 48 deck of 21 steps
    (two T-8 passes and a K1 remainder), both CLIs on block 16, T 8, full
    row: the 1% checker, av_vels at rtol 1e-3, pressure within 5e-6."""
    deck = write_deck(tmp_path, 128, 48, 21, seed=25)
    monkeypatch.setenv("LBM_BAND_BLOCK", "16")
    monkeypatch.setenv("LBM_BAND_DEPTH", "8")
    monkeypatch.setattr(tb2, "schedule", lambda params, dtype: (16, 8, None))
    out, ref = tmp_path / "port", tmp_path / "jax"
    assert tcli.main([*deck, "--device", "cpu", "--backend", "band2", "--precision", "c16",
                      "--out-dir", str(out)]) == 0
    assert jcli.main([*deck, "--backend", "band2", "--precision", "c16", "--out-dir",
                      str(ref)]) == 0
    capsys.readouterr()
    files = outputs(out, ref)
    assert check_files(*files, tolerance=1.0).passed
    np.testing.assert_allclose(np.loadtxt(files[0], usecols=[1]),
                               np.loadtxt(files[2], usecols=[1]), rtol=1e-3)
    t_fs, j_fs = np.loadtxt(files[1]), np.loadtxt(files[3])
    np.testing.assert_array_equal(t_fs[:, [0, 1, 6]], j_fs[:, [0, 1, 6]])
    assert np.abs(t_fs[:, 5] - j_fs[:, 5]).max() < 5e-6
