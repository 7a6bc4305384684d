"""K11's pass on the trapezoid and K4's one-copy global-memory form, in
plain PyTorch, against the JAX package on the CPU.

K11 (``csrc/band3.cu``) opens its pass with the even step as the load and
closes it with the odd step as the store, and step s updates only the
window cells at least s cells from every edge. ``band3.k11_step_plain``
is that pass (NaN wherever the kernel's window is not updated), and
``run_band3_plain`` runs it: held bit for bit against the whole-window
pass that wraps at the window's edges (``s_step_plain``), and against the
JAX kernels ``pallas_band3._kernel3`` and ``_kernel3_panel`` in interpret
mode (``run_band3(..., interpret=True)``, as tests/test_torch_band3.py
runs them). The JAX kernels take T a multiple of 8, 128-column lines and
whole blocks; at f32 a run of any T is the same function, so the port's
passes of T 2, 4 and 8 on ragged tiles are held to the JAX kernel's T 8 on
its own tiles; at 16 bits the rounding per pass ties the function to T,
so the port runs T 8 there. Tolerances: f32 cells within 1e-5 of the
state's scale, av rtol 1e-4 (tests/test_torch_band3.py); c16 decoded
cells within 5e-6, av rtol 1e-3; bf16 two ulps on at most 1% of the
values (tests/test_torch_bf16.py).

K4's global-memory form (``csrc/resident.cu``) steps one copy of the
state in place in the AA arrangement; ``resident.run_resident_aa_plain``
is its schedule launch by launch, held bit for bit against
``run_resident_plain`` (K1's steps) over chunks of 1, 5, 13 and 255 steps,
at both exit parities and across a run cut between calls, and against the
JAX kernel ``pallas_resident._mega_kernel`` in interpret mode.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbm_tpu.ops.pallas_resident as jres
from lbm_tpu.ops import devspace as jdev
from lbm_tpu.ops import pallas_band3 as jb3
from lbm_tpu_torch.models.d2q9 import WEIGHTS
from lbm_tpu_torch.ops import band3 as tb3
from lbm_tpu_torch.ops import band_common as BC
from lbm_tpu_torch.ops import devspace as tdev
from lbm_tpu_torch.ops import resident as tres
from lbm_tpu_torch.ops.step import forcing_weights
from test_torch_bf16 import TOL, assert_bf16_close

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
SPEC = tdev.DevSpec.for_params(DENSITY, ACCEL)
JSPEC = jdev.DevSpec.for_params(DENSITY, ACCEL)
STORAGE = {"f32": (None, None), "c16": (SPEC, (*JSPEC.bg, JSPEC.h)), "bf16": (tdev.BF16, None)}


def make_setup(nx, ny, seed):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 10), rng.randint(0, nx, 10)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    return state.astype(np.float32), (obstacles == 0).astype(np.float32)


# (nx, ny, block, depth, panel): T 2, 4 and 8, full row (panel None) and
# panel, tiles that do not divide the grid.
K11_MODEL = [(46, 37, 12, 2, 15), (46, 37, 8, 4, None), (50, 41, 20, 4, 36),
             (60, 43, 16, 8, 28), (40, 43, 16, 8, None)]


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("nx,ny,block,depth,panel", K11_MODEL)
def test_k11_pass_is_the_wrapped_pass_bit_for_bit(nx, ny, block, depth, panel, fuse):
    """The trapezoid pass stores the tile and sums of the pass over whole
    windows bit for bit, every stored value finite: nothing it stores
    depends on a window cell it did not update."""
    state, nobst = make_setup(nx, ny, seed=nx + depth)
    w1a, w2a = forcing_weights(DENSITY, ACCEL)
    nob = torch.as_tensor(nobst)
    s_state = tb3.force_s(tb3.stream_planes(torch.as_tensor(state)), nob, w1a, w2a)
    got, want = (BC.creep_pass_plain(s_state, nob, block, depth, panel,
                                     fn(OMEGA, w1a, w2a, depth, fuse))
                 for fn in (tb3.k11_step_plain, tb3.s_step_plain))
    assert bool(torch.isfinite(got[0]).all()) and torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@functools.lru_cache(maxsize=None)
def jax_run(storage, n):
    """The JAX full-row kernel (interpret mode) at T 8 on its own tiles of
    16 rows of a 128 x 48 grid (its panel kernel: tests/test_torch_band3.py
    and tests/test_torch_bf16_passes.py). Returns the port's inputs (the
    state in its storage: f32, the JAX package's c16 codes, or bf16) and
    the JAX kernel's (state, av)."""
    state, nobst = make_setup(128, 48, seed=128)
    _, jdev_arg = STORAGE[storage]
    if storage == "c16":
        jx = jdev.encode_state(jnp.asarray(state), JSPEC)
        x = torch.as_tensor(np.array(jx))
    elif storage == "bf16":
        x = torch.as_tensor(state).to(torch.bfloat16)
        jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    else:
        jx, x = jnp.asarray(state), torch.as_tensor(state)
    want, av = jb3.run_band3(jx, jnp.asarray(nobst, jnp.float32), DENSITY, ACCEL, OMEGA, n, 16,
                             8, interpret=True, paired="fused", dev=jdev_arg)
    return (x, torch.as_tensor(nobst)), (np.asarray(jnp.asarray(want, jnp.float32)),
                                         np.asarray(av))


def port_run(inputs, storage, n, block, depth, panel):
    x, nob = inputs
    return tb3.run_band3_plain(x, nob, DENSITY, ACCEL, OMEGA, n, block, depth, panel=panel,
                               dev=STORAGE[storage][0])


@pytest.mark.parametrize("block,depth,panel", [(12, 2, 20), (12, 2, None), (20, 4, None),
                                               (20, 4, 36), (20, 8, 36), (24, 8, None)])
def test_k11_pass_matches_pallas_band3(block, depth, panel):
    """11 steps at f32: the port's passes of T 2, 4 or 8, full row and
    panel, on tiles that do not divide the grid (fused between passes but
    the last), then its K1 remainder, against the JAX kernel's pass of T 8
    (split 6 + 2) and its remainder."""
    inputs, (want, want_av) = jax_run("f32", 11)
    cells, av = port_run(inputs, "f32", 11, block, depth, panel)
    assert np.abs(cells.numpy() - want).max() < 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(av.numpy(), want_av, rtol=1e-4)


@pytest.mark.parametrize("storage,block,panel", [("c16", 20, 36), ("bf16", 20, None)])
def test_k11_pass_16_bit_matches_pallas_band3(storage, block, panel):
    """One pass at c16 and bf16, T 8, rounded after step 6 and at its end
    (a remainder's K1 steps would spread bf16's rounding flips, tests/
    test_torch_bf16.py), on the port's ragged tiles against the JAX
    kernel's."""
    inputs, (want, want_av) = jax_run(storage, 8)
    cells, av = port_run(inputs, storage, 8, block, 8, panel)
    if storage == "c16":
        got = tdev.decode_state(cells, SPEC)
        ref = tdev.decode_state(torch.as_tensor(want.astype(np.int16)), SPEC)
        assert float((got - ref).abs().max()) < 5e-6
        np.testing.assert_allclose(av.numpy(), want_av, rtol=1e-3)
    else:
        assert_bf16_close(cells, av.numpy(), want, want_av, TOL)


def test_k11_16_bit_final_pass_rounds_twice():
    """At c16 a run of one pass stores the state of a pass of T-2 steps,
    rounded, then one of 2, rounded (the JAX package's two calls), not that
    of one pass of T steps."""
    block, depth, panel = 16, 8, 20
    state, nobst = make_setup(40, 43, seed=7)
    codes = tdev.encode_state(torch.as_tensor(state), SPEC)
    nob = torch.as_tensor(nobst)
    w1a, w2a = forcing_weights(DENSITY, ACCEL)
    s_state = tb3.force_s(tb3.stream_planes(codes), nob, w1a, w2a, SPEC)

    def one_pass(x, steps, fuse):
        return BC.plain_passes(nob, 1.0, block, steps, panel, lambda p, n: tb3.k11_step_plain(
            OMEGA, w1a, w2a, steps, fuse), SPEC)(x, 1)[0]

    split = tb3.stream_planes(one_pass(one_pass(s_state, depth - 2, True), 2, False), -1)
    whole = tb3.stream_planes(one_pass(s_state, depth, False), -1)
    got, _ = tb3.run_band3_plain(codes, nob, DENSITY, ACCEL, OMEGA, depth, block, depth,
                                 panel=panel, dev=SPEC)
    assert tb3.split_final(depth, SPEC) and not tb3.split_final(depth, None)
    assert torch.equal(got, split) and not torch.equal(got, whole)


@pytest.mark.parametrize("n", [26, 27])
@pytest.mark.parametrize("chunk", [1, 5, 13, 255])
def test_resident_aa_form_is_k1_bit_for_bit(chunk, n):
    """The one-copy form's schedule over launches of ``chunk`` steps gives
    K1's state and av series bit for bit, after an even count (R in place)
    and an odd one (S, turned back as K2 turns it)."""
    state, nobst = make_setup(24, 19, seed=chunk + n)
    cells, nob = torch.as_tensor(state), torch.as_tensor(nobst)
    got = tres.run_resident_aa_plain(cells, nob, DENSITY, ACCEL, OMEGA, n, 0.01, chunk=chunk)
    want = tres.run_resident_plain(cells, nob, DENSITY, ACCEL, OMEGA, n, 0.01, chunk=chunk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_resident_aa_form_resumes_to_the_uninterrupted_bytes():
    """A run cut after 13 steps (an odd count, so the first call ends in S)
    and resumed from its R state gives the 27-step run's bytes."""
    state, nobst = make_setup(33, 3, seed=4)
    cells, nob = torch.as_tensor(state), torch.as_tensor(nobst)
    head = tres.run_resident_aa_plain(cells, nob, DENSITY, ACCEL, OMEGA, 13, 0.01, chunk=5)
    tail = tres.run_resident_aa_plain(head[0], nob, DENSITY, ACCEL, OMEGA, 14, 0.01, chunk=5)
    whole = tres.run_resident_aa_plain(cells, nob, DENSITY, ACCEL, OMEGA, 27, 0.01, chunk=5)
    assert torch.equal(tail[0], whole[0])
    assert torch.equal(torch.cat([head[1], tail[1]]), whole[1])


def test_resident_aa_form_matches_mega_kernel():
    """Against the JAX kernel (its value-carried path at 32 x 128), 7 steps."""
    state, nobst = make_setup(128, 32, seed=3)
    inv = 1.0 / 3000.0
    want, want_tot = jres.run_resident(jnp.asarray(state), jnp.asarray(nobst), DENSITY, ACCEL,
                                       OMEGA, 7, interpret=True, paired="fused")
    cells, av = tres.run_resident_aa_plain(torch.as_tensor(state), torch.as_tensor(nobst),
                                           DENSITY, ACCEL, OMEGA, 7, inv)
    want = np.asarray(want)
    assert np.abs(cells.numpy() - want).max() < 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(av.numpy(), np.asarray(want_tot, np.float32) * np.float32(inv),
                               rtol=1e-4)
