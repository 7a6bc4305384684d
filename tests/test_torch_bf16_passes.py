"""bf16 storage through the pass kernels K5, K6, K11 and K13 on one
device: their plain bf16 forms against the JAX kernels with a bfloat16
state, run in interpret mode on the CPU, at the tolerances and rounding
points of tests/test_torch_bf16.py.

K11's final pass: the JAX package runs it as two calls, T-2 steps and 2
(``pallas_band3.py:669-677``), each storing the state, so at 16-bit
storage it rounds twice. The port splits it the same way at c16 and bf16;
``test_band3_c16_final_pass_rounds_twice`` holds the c16 form to that
(without the split 20% of the codes differed from the JAX kernel's after
one pass, with it 6%: codes near the rest state are fine quanta that the
packages' f32 orders move).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import devspace as jdev
from lbm_tpu.ops import pallas_band3 as jb3
from lbm_tpu.ops import pallas_deep as jdeep
from lbm_tpu.ops import pallas_temporal as jtemp
from lbm_tpu.ops.pallas_slab import run_band_slab as j_run_band_slab
from lbm_tpu_torch.ops import band3 as tb3
from lbm_tpu_torch.ops import deep as tdeep
from lbm_tpu_torch.ops import devspace as tdev
from lbm_tpu_torch.ops import slab as tslab
from lbm_tpu_torch.ops import step as tstep
from lbm_tpu_torch.ops import temporal as ttemp
from test_torch_bf16 import (ACCEL, BAND_CASES, BF16, DENSITY, OMEGA, TOL, assert_bf16_close,
                             band_case, both, make_setup, ordered_bits, tol_for)


@pytest.mark.parametrize("nx,n,panel", BAND_CASES)
def test_band3_plain_bf16_matches_pallas_band3(nx, n, panel):
    """K11 at bf16: one rounding per pass, one more after step T-2 of the
    final pass (the JAX package runs it as two calls), and the first
    forcing's rounding of rows ny-3..ny-1."""
    band_case(jb3.run_band3, tb3.run_band3, nx, n, panel, seed=3 * n + nx)


def test_force_s_bf16_matches_jax():
    """K11's first forcing at bf16, bit for bit: rows ny-3..ny-1 widened,
    forced and rounded (``_force_s_storage``, its ``dev is None`` branch)."""
    (cells, nob), (jcells, jnob) = both(*make_setup(128, 16, seed=9))
    w1a, w2a = tstep.forcing_weights(DENSITY, ACCEL)
    want = np.asarray(jb3._force_s_storage(jcells, jnob, w1a, w2a), np.float32)
    got = tb3.force_s(cells, nob, w1a, w2a, BF16)
    assert got.dtype == torch.bfloat16
    assert not np.array_equal(want, cells.float().numpy())
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("depth,n", [(4, 4), (4, 11)], ids=["one-pass", "2T+3"])
def test_temporal_plain_bf16_matches_pallas_temporal(depth, n):
    """K5 at bf16, its packs carried between passes, a K1 remainder."""
    (cells, nob), (jcells, jnob) = both(*make_setup(128, 32, seed=depth + n))
    want, want_tot = jtemp.run_temporal(jcells, jnob, DENSITY, ACCEL, OMEGA, n, 16, depth,
                                        interpret=True, paired="fused")
    got, av = ttemp.run_temporal(cells, nob, DENSITY, ACCEL, OMEGA, n, 16, depth, dev=BF16)
    assert_bf16_close(got, av, want, want_tot, tol_for(n, depth))


def test_temporal_pass_bf16_packs_copy_the_state():
    """One K5 pass at bf16 from packs that are not the state's rows: the
    state and both packs against ``step_t_pallas``, and the output packs
    hold the bits of the state rows they copy."""
    state, nobst = make_setup(128, 32, seed=3)
    block, depth = 16, 4
    q = torch.as_tensor(state).to(torch.bfloat16)
    last, first = ttemp.make_halos_t(q, block, depth)
    rng = np.random.RandomState(4)
    last = (last.float() * torch.as_tensor(1 + 0.01 * rng.rand(*last.shape), dtype=torch.float32)
            ).to(torch.bfloat16)
    first = (first.float() * torch.as_tensor(1 + 0.01 * rng.rand(*first.shape),
                                             dtype=torch.float32)).to(torch.bfloat16)
    (j_cells, j_last, j_first), j_sums = jtemp.step_t_pallas(
        tuple(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, last, first)),
        jtemp.nobst_ext(jnp.asarray(nobst), block, depth, jnp.bfloat16),
        jnp.ones((1, 1), jnp.float32), DENSITY, ACCEL, OMEGA, block, depth, interpret=True,
        paired="fused")
    (cells, t_last, t_first), sums = ttemp.step_t(
        (q, last, first), torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA, block, depth, dev=BF16)
    assert_bf16_close(cells, sums, j_cells, np.stack([np.asarray(s) for s in j_sums]))
    for got, want in ((t_last, j_last), (t_first, j_first)):  # (nblk, 9T, nx) -> (9, nblk, T, nx)
        got = got.view(2, 9, depth, 128).permute(1, 0, 2, 3)
        want = np.asarray(want, np.float32).reshape(2, 9, depth, 128).transpose(1, 0, 2, 3)
        assert np.abs(ordered_bits(got.float().numpy()) - ordered_bits(want)).max() <= TOL[0]
    own_last, own_first = ttemp.make_halos_t(cells, block, depth)
    assert torch.equal(t_last, own_last) and torch.equal(t_first, own_first)


@pytest.mark.parametrize("n", [8, 19], ids=["one-pass", "2T+3"])
def test_deep_plain_bf16_matches_pallas_deep(n):
    """K6 at bf16 (B 16, T 8): the window widened from the input state."""
    (cells, nob), (jcells, jnob) = both(*make_setup(128, 32, seed=30 + n))
    want, want_tot = jdeep.run_deep(jcells, jnob, DENSITY, ACCEL, OMEGA, n, 16, 8,
                                    interpret=True, paired="fused")
    got, av = tdeep.run_deep(cells, nob, DENSITY, ACCEL, OMEGA, n, 16, 8, dev=BF16)
    assert_bf16_close(got, av, want, want_tot, tol_for(n, 8))


@pytest.mark.parametrize("kpasses,sblock,n", [(1, 32, 11), (2, 32, 16)])
def test_slab_plain_bf16_matches_pallas_slab(kpasses, sblock, n):
    """K13 at bf16 (B 16, T 8, ny 96): the JAX slab kernel writes every
    pass's slab buffer at the storage dtype, so each of the K passes rounds
    once; one generation and a K1 remainder (K 1), one generation of two
    passes (K 2)."""
    (cells, nob), (jcells, jnob) = both(*make_setup(128, 96, seed=kpasses))
    want, want_tot = j_run_band_slab(jcells, jnob, DENSITY, ACCEL, OMEGA, n, 16, 8, kpasses,
                                     sblock, interpret=True, paired="fused")
    got, av = tslab.run_band_slab(cells, nob, DENSITY, ACCEL, OMEGA, n, 16, 8, kpasses, sblock,
                                  dev=BF16)
    assert_bf16_close(got, av, want, want_tot)


def test_band3_c16_final_pass_rounds_twice():
    """One K11 pass at c16 (its final pass, split into T-2 steps and 2) lands
    on the JAX kernel's codes but for the fine quanta near the rest state."""
    state, nobst = make_setup(128, 64, seed=152)
    spec, jspec = tdev.DevSpec.for_params(DENSITY, ACCEL), jdev.DevSpec.for_params(DENSITY, ACCEL)
    codes = np.array(jdev.encode_state(jnp.asarray(state), jspec))
    want, _ = jb3.run_band3(jnp.asarray(codes), jnp.asarray(nobst), DENSITY, ACCEL, OMEGA, 8, 16,
                            8, interpret=True, paired="fused", dev=(*jspec.bg, jspec.h))
    got, _ = tb3.run_band3(torch.as_tensor(codes), torch.as_tensor(nobst), DENSITY, ACCEL, OMEGA, 8,
                           16, 8, dev=spec)
    assert tb3.split_final(8, spec) and not tb3.split_final(8, None)
    assert (got.numpy() != np.asarray(want)).mean() <= 0.1
