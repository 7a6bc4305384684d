"""The in-place AA route (``lbm_tpu_torch/ops/aa.py``) against the JAX
Pallas kernel ``pallas_aa._aa_kernel``, run as tests/test_aa.py runs it
(``run_aa(..., interpret=True)``) on the CPU.

``run_aa_plain`` takes the AA steps out of place but with the same S/C
arrangements and forcing placement as the CUDA kernel K2, so holding it
against the JAX kernel checks K2's index algebra; the card holds K2 against
``run_aa_plain`` (``chip_smoke.py`` and tests/test_torch_cuda.py).
Tolerances as tests/test_aa.py: cells within 1e-5 of scale, per-step |u|
sums at rtol 1e-4 (f32, different operation order in the sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import pallas_aa as jaa
from lbm_tpu_torch.models.d2q9 import WEIGHTS
from lbm_tpu_torch.ops import aa as taa
from lbm_tpu_torch.ops import reference as tref

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85


def make_setup(nx, ny, seed=3):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 8), rng.randint(0, nx, 8)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    return state.astype(np.float32), obstacles


def nobst_of(obstacles):
    return (obstacles == 0).astype(np.float32)


@pytest.mark.parametrize("ny,tile", [(16, None), (24, 8)], ids=["128x16", "128x24-3tiles"])
@pytest.mark.parametrize("iters", [1, 2, 5, 11])
def test_aa_plain_matches_pallas_aa_kernel(iters, ny, tile):
    """Odd totals leave through the opp permutation, even ones through
    unstream: both parities must match."""
    state, obstacles = make_setup(128, ny, seed=ny * 3 + iters)
    want, want_tot = jaa.run_aa(
        jnp.asarray(state, jnp.float32), jnp.asarray(nobst_of(obstacles), jnp.float32),
        DENSITY, ACCEL, OMEGA, iters, interpret=True, paired="fused", tile=tile,
    )
    cells, av = taa.run_aa(torch.as_tensor(state), torch.as_tensor(nobst_of(obstacles)),
                           DENSITY, ACCEL, OMEGA, iters, 1.0)
    want = np.asarray(want)
    assert cells.dtype == torch.float32 and av.shape == (iters,)
    assert np.abs(cells.numpy() - want).max() < 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(av.numpy(), np.asarray(want_tot), rtol=1e-4)


@pytest.mark.parametrize("sign", [1, -1])
def test_stream_planes_matches_jax(sign):
    state, _ = make_setup(128, 16)
    want = np.asarray(jaa.stream_planes(jnp.asarray(state, jnp.float32), sign))
    np.testing.assert_array_equal(taa.stream_planes(torch.as_tensor(state), sign).numpy(), want)


def test_stream_planes_round_trip_exact():
    state, _ = make_setup(128, 24)
    t = torch.as_tensor(state)
    np.testing.assert_array_equal(taa.stream_planes(taa.stream_planes(t), -1).numpy(), state)


def test_aa_plain_matches_reference_step_f32():
    """Independent of the JAX kernel: the AA schedule against the plain
    reference step (odd total, ragged non-power-of-two width)."""
    state, obstacles = make_setup(40, 12, seed=4)
    ref, ref_tot = torch.as_tensor(state), []
    mask = torch.as_tensor(obstacles)
    for _ in range(7):
        ref, tot = tref.lbm_step_reference(ref, mask, DENSITY, ACCEL, OMEGA)
        ref_tot.append(float(tot))
    cells, av = taa.run_aa(torch.as_tensor(state), torch.as_tensor(nobst_of(obstacles)),
                           DENSITY, ACCEL, OMEGA, 7, 1.0)
    assert float((cells - ref).abs().max()) < 1e-5 * float(ref.abs().max())
    np.testing.assert_allclose(av.numpy(), ref_tot, rtol=1e-4)


def test_force_even_reads_only_what_it_writes():
    """The even forcing in S space, indexed by the pre-stream lane: lane x'
    reads slots (3, ny-2, x'-1), (6, ny-1, x'-1), (7, ny-3, x'-1) and
    writes exactly those (plus slots 1, 5, 8, which no lane reads), so K2
    may update in place with one thread per lane. Here: every changed
    address lies on the row ny-2+cy_k that speed k's delta lands on."""
    state, obstacles = make_setup(128, 16, seed=2)
    s = torch.as_tensor(state)
    out = taa.force_even_plain(s, torch.as_tensor(nobst_of(obstacles)),
                               DENSITY * ACCEL / 9.0, DENSITY * ACCEL / 36.0)
    ny = s.shape[1]
    changed = (out != s).nonzero().tolist()
    assert changed
    rows = {3: ny - 2, 6: ny - 1, 7: ny - 3, 1: ny - 2, 5: ny - 1, 8: ny - 3}
    for k, y, _ in changed:
        assert rows[k] == y


def test_run_aa_leaves_input_unchanged():
    state, obstacles = make_setup(128, 16)
    cells = torch.as_tensor(state.copy())
    taa.run_aa(cells, torch.as_tensor(nobst_of(obstacles)), DENSITY, ACCEL, OMEGA, 3, 1.0)
    np.testing.assert_array_equal(cells.numpy(), state)


@pytest.mark.parametrize("bad", ["ny", "device", "dtype"])
def test_run_aa_rejects_bad_inputs(bad):
    state, obstacles = make_setup(128, 16)
    cells, nobst = torch.as_tensor(state), torch.as_tensor(nobst_of(obstacles))
    if bad == "ny":
        cells, nobst = cells[:, :2], nobst[:2]
    elif bad == "device":
        cells, nobst = cells.to("meta"), nobst.to("meta")
    else:
        nobst = nobst.double()
    with pytest.raises(ValueError):
        taa.run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, 2, 1.0)
