"""The resident route (``lbm_tpu_torch/ops/resident.py``) against the JAX
Pallas kernel ``pallas_resident._mega_kernel``, run as tests/test_resident.py
runs it (``run_resident(..., interpret=True)``) on the CPU.

``run_resident_plain`` takes the same whole-grid steps in chunks as kernel
K4; the card holds K4 against it (``chip_smoke.py`` and
tests/test_torch_cuda.py). The JAX kernel's value-carried path (states up
to 4 MB) is the default at 32x128; its tiled ping-pong path is reached by
setting ``_VALUE_CARRY_BYTES`` to 0, with 8-row tiles and 6-step chunks.
Tolerances as tests/test_resident.py: cells within 1e-5 of the state's
scale, av at rtol 1e-4 (f32, another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbm_tpu.ops.pallas_resident as jres
from lbm_tpu_torch.models.d2q9 import WEIGHTS
from lbm_tpu_torch.ops import resident as tres
from lbm_tpu_torch.ops import step as tstep

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
INV = 1.0 / 3000.0


def make_setup(nx, ny, seed=3):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 8), rng.randint(0, nx, 8)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    return state.astype(np.float32), (obstacles == 0).astype(np.float32)


def assert_matches_jax(state, nobst, n, chunk=tres.CHUNK_STEPS):
    want, want_tot = jres.run_resident(jnp.asarray(state), jnp.asarray(nobst), DENSITY, ACCEL,
                                       OMEGA, n, interpret=True, paired="fused")
    cells, av = tres.run_resident(torch.as_tensor(state), torch.as_tensor(nobst), DENSITY, ACCEL,
                                  OMEGA, n, INV, chunk=chunk)
    want = np.asarray(want)
    assert cells.dtype == torch.float32 and av.shape == (n,)
    assert np.abs(cells.numpy() - want).max() < 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(av.numpy(), np.asarray(want_tot, np.float32) * np.float32(INV),
                               rtol=1e-4)


def test_resident_plain_matches_value_carried_kernel():
    state, nobst = make_setup(128, 32)
    assert_matches_jax(state, nobst, 7)


@pytest.mark.parametrize("steps", [4, 7])
def test_resident_plain_matches_tiled_kernel(steps, monkeypatch):
    """The ref ping-pong path with 8-row tiles, 6-step chunks on both sides:
    an even step count (the JAX kernel's final copy) and an odd one."""
    monkeypatch.setattr(jres, "_VALUE_CARRY_BYTES", 0)
    monkeypatch.setattr(jres, "_CHUNK_STEPS", 6)
    monkeypatch.setattr(jres, "_pick_tile", lambda ny, nx: 8)
    jres._make_mega_call.cache_clear()
    try:
        state, nobst = make_setup(128, 32, seed=steps)
        assert_matches_jax(state, nobst, steps, chunk=6)
    finally:
        jres._make_mega_call.cache_clear()


@pytest.mark.parametrize("chunk", [1, 5, 13, 255])
def test_resident_chunks_equal_unchunked(chunk):
    """Chunk boundaries do not change a bit: the state and the av series
    equal K1's plain route, at a ragged shape the JAX kernel cannot take."""
    state, nobst = make_setup(40, 37, seed=chunk)
    cells, nob = torch.as_tensor(state), torch.as_tensor(nobst)
    want = tstep.run_step_plain(cells, nob, DENSITY, ACCEL, OMEGA, 13, INV)
    got = tres.run_resident(cells, nob, DENSITY, ACCEL, OMEGA, 13, INV, chunk=chunk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_run_resident_leaves_input_unchanged():
    state, nobst = make_setup(32, 16)
    cells = torch.as_tensor(state.copy())
    tres.run_resident(cells, torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA, 3, INV)
    np.testing.assert_array_equal(cells.numpy(), state)


def test_resident_supported():
    assert tres.resident_supported(2, 7)          # no tiling or VMEM gate
    assert tres.resident_supported(4096, 4096)
    assert not tres.resident_supported(1, 128)   # the forcing row ny-2


@pytest.mark.parametrize("bad", ["chunk", "device", "dtype", "ny"])
def test_run_resident_rejects_bad_inputs(bad):
    state, nobst = make_setup(32, 16)
    cells, nob = torch.as_tensor(state), torch.as_tensor(nobst)
    chunk = 4
    if bad == "chunk":
        chunk = 0
    elif bad == "device":
        cells, nob = cells.to("meta"), nob.to("meta")
    elif bad == "dtype":
        nob = nob.double()
    else:
        cells, nob = cells[:, :1], nob[:1]
    with pytest.raises(ValueError):
        tres.run_resident(cells, nob, DENSITY, ACCEL, OMEGA, 4, INV, chunk=chunk)
