"""K1's 16-bit forms and K2's c16 form in aligned multi-cell words.

K1 (``csrc/step.cu::step_word_kernel``) and K2 (``csrc/aa.cu::
aa_word_kernel``) take ``WORD_CELLS`` cells of one row per thread at 16-bit
storage, so every access of a plane is one aligned word a thread, and
rebuild their shifted accesses from a lane's word and its neighbour
lane's, through the periodic wrap at a row's ends. ``step.word_row_plan``
and ``aa.odd_row_plan`` are their access plans for one row: they are held
here to their rules (every cell stored once, whole aligned words, every
pull covered by the thread or a neighbour lane of its warp; for K2's odd
step, every address stored by its owner's thread or by a lane of the
owner's warp inside a whole word, and every element whose owner lies in
another warp stored alone by its owner). ``word_form`` is the shape rule
that picks the word or the one-cell form.

K2's word form fuses each step's forcing into the step before it;
``aa.run_aa_fused_plain`` is that schedule in plain PyTorch. It is held
bit for bit against ``run_aa_plain`` (forcing before each step) at f32,
c16 and bf16 over odd and even step counts and split into calls, and once
against the JAX kernel ``pallas_aa`` in interpret mode, with the
tolerances of tests/test_torch_aa.py. The card holds the kernels to the
one-cell forms bit for bit (tests/test_torch_cuda.py, chip_smoke.py phase
29): the plans are specifications that the kernels do not execute, and
those card tests are what guard the kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import pallas_aa as jaa
from lbm_tpu_torch.models.d2q9 import WEIGHTS
from lbm_tpu_torch.ops import aa as taa
from lbm_tpu_torch.ops import devspace as tdev
from lbm_tpu_torch.ops import step as tstep

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
SPEC = tdev.DevSpec.for_params(DENSITY, ACCEL)
WORD = tstep.WORD_CELLS
WARP = tstep.WARP
WIDTHS = [8, 64, 128, 1000, 1024]
STORAGES = {"f32": None, "c16": SPEC, "bf16": tdev.BF16}


def columns(accesses, nx):
    return [col % nx for first, n in accesses for col in range(first, first + n)]


def warp_of(x0):
    return x0 // WORD // WARP


@pytest.mark.parametrize("dtype", [torch.int16, torch.bfloat16], ids=["c16", "bf16"])
@pytest.mark.parametrize("nx", WIDTHS)
def test_k1_word_row_plan(nx, dtype):
    """Every cell of the periodic row stored once, in whole words on word
    boundaries; loads aligned to their width inside the row; the pulls
    from x - 1, x and x + 1 of every cell (the wrap at both ends included)
    read by its thread or by a neighbour lane of its warp."""
    size = torch.empty((), dtype=dtype).element_size()
    plan = tstep.word_row_plan(nx)
    stored = columns([s for _, _, stores in plan for s in stores], nx)
    assert sorted(stored) == list(range(nx))
    words = {}
    for x0, loads, stores in plan:
        assert stores == [(x0, WORD)] and (x0 * size) % (WORD * size) == 0
        for first, n in loads:
            assert 0 <= first and first + n <= nx and (first * size) % (n * size) == 0
        words[x0] = set(columns(loads, nx))
    for x0, _, _ in plan:
        seen = set(words[x0])
        for nb in (x0 - WORD, x0 + WORD):
            if nb in words and warp_of(nb) == warp_of(x0):
                seen |= words[nb]
        for x in range(x0, x0 + WORD):
            assert {(x - 1) % nx, x, (x + 1) % nx} <= seen
    lanes = {x0: (x0 // WORD) % WARP for x0, _, _ in plan}
    assert {(x0 - 2) % nx for x0, lane in lanes.items() if lane == 0} <= set(
        first for _, loads, _ in plan for first, n in loads if n == 2)
    assert (nx - 2, 2) in plan[0][1] and (0, 2) in plan[-1][1]  # the wrap at both ends


@pytest.mark.parametrize("cx", [-1, 0, 1])
@pytest.mark.parametrize("nx", WIDTHS)
def test_k2_odd_row_plan(nx, cx):
    """The odd step in place: every address of the row stored once; by its
    owner's thread, or by another lane of the owner's warp only inside a
    whole word (the stores follow the warp barrier); an element whose
    owner lies in another warp stored alone by the owner; the gather of
    every cell (from x - cx) read by its thread or a neighbour lane of its
    warp, and only from addresses the cell owns."""
    plan = taa.odd_row_plan(nx, cx)
    by_x0 = {x0: (loads, stores) for x0, loads, stores in plan}
    stored = {}
    for x0, _, stores in plan:
        for first, n in stores:
            assert n in (1, WORD - 1, WORD) and 0 <= first and first + n <= nx
            for col in range(first, first + n):
                assert col not in stored
                stored[col] = (x0, n)
    assert sorted(stored) == list(range(nx))
    for col, (x0, n) in stored.items():
        owner = (col - cx) % nx  # the scatter's element at col belongs to cell col - cx
        owner_x0 = owner - owner % WORD
        if owner_x0 != x0:
            assert warp_of(owner_x0) == warp_of(x0) and n == WORD
        if warp_of(col - col % WORD) != warp_of(owner_x0):
            assert (x0, n) == (owner_x0, 1)
    for x0, (loads, _) in by_x0.items():
        seen = set(columns(loads, nx))
        for nb in (x0 - WORD, x0 + WORD):
            if nb in by_x0 and warp_of(nb) == warp_of(x0):
                seen |= set(columns(by_x0[nb][0], nx))
        need = {(x - cx) % nx for x in range(x0, x0 + WORD)}
        assert need <= seen
        assert {(w + cx) % nx for w in need} == set(range(x0, x0 + WORD))  # owned by the cells


@pytest.mark.parametrize("storage", list(STORAGES))
@pytest.mark.parametrize("nx", [8, 64, 128, 130, 1000, 1001, 1024])
def test_word_shape_rule(nx, storage):
    """K1 and K2 run the word form at c16 and bf16 on widths the words
    tile; the one-cell form at f32 and on ragged widths such as 130."""
    dev = STORAGES[storage]
    tiles = nx % WORD == 0
    assert tstep.word_form(nx, dev) == (tiles and dev is not None)
    assert taa.word_form is tstep.word_form
    if not tiles:
        with pytest.raises(ValueError, match="multiples"):
            tstep.word_row_plan(nx)
        with pytest.raises(ValueError, match="multiples"):
            taa.odd_row_plan(nx, 1)


def make_setup(nx, ny, seed=3):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 8), rng.randint(0, nx, 8)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    return state.astype(np.float32), (obstacles == 0).astype(np.float32)


def stored(state, dev):
    cells = torch.as_tensor(state)
    return cells if dev is None else tdev.encode_state(cells, dev)


@pytest.mark.parametrize("iters", [1, 2, 5, 6])
@pytest.mark.parametrize("storage", list(STORAGES))
def test_fused_schedule_matches_aa_plain(storage, iters):
    """The fused forcing (the next step's in the epilogue of the even step
    and in the scatter of the odd step, none after the last) gives
    run_aa_plain's state and av bit for bit on an odd-height grid."""
    dev = STORAGES[storage]
    state, nobst = make_setup(24, 9, seed=iters)
    x, nob = stored(state, dev), torch.as_tensor(nobst)
    want = taa.run_aa_plain(x, nob, DENSITY, ACCEL, OMEGA, iters, 1.0, dev=dev)
    got = taa.run_aa_fused_plain(x, nob, DENSITY, ACCEL, OMEGA, iters, 1.0, dev=dev)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("chunks", [(2, 3, 2), (3, 1, 4)])
@pytest.mark.parametrize("storage", list(STORAGES))
def test_fused_schedule_in_calls(storage, chunks):
    """Calls of odd and even lengths chained through the regular
    arrangement give the one call's state and av bit for bit: a call
    starts with the standalone forcing and its last step fuses none."""
    dev = STORAGES[storage]
    state, nobst = make_setup(16, 7, seed=len(chunks) + chunks[0])
    x, nob = stored(state, dev), torch.as_tensor(nobst)
    want = taa.run_aa_plain(x, nob, DENSITY, ACCEL, OMEGA, sum(chunks), 1.0, dev=dev)
    avs = []
    for n in chunks:
        x, av = taa.run_aa_fused_plain(x, nob, DENSITY, ACCEL, OMEGA, n, 1.0, dev=dev)
        avs.append(av)
    assert torch.equal(x, want[0]) and torch.equal(torch.cat(avs), want[1])


def test_fused_schedule_matches_pallas_aa_kernel():
    """Against the JAX kernel in interpret mode (tests/test_torch_aa.py's
    tolerances: cells within 1e-5 of scale, av at rtol 1e-4)."""
    state, nobst = make_setup(128, 16, seed=5)
    want, want_tot = jaa.run_aa(jnp.asarray(state, jnp.float32), jnp.asarray(nobst, jnp.float32),
                                DENSITY, ACCEL, OMEGA, 5, interpret=True, paired="fused")
    cells, av = taa.run_aa_fused_plain(torch.as_tensor(state), torch.as_tensor(nobst), DENSITY,
                                       ACCEL, OMEGA, 5, 1.0)
    want = np.asarray(want)
    assert np.abs(cells.numpy() - want).max() < 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(av.numpy(), np.asarray(want_tot), rtol=1e-4)


def test_word_counters():
    """The word forms' steps have counters of their own beside the
    storage's (count_launches)."""
    for fn in (tstep.run_step, taa.run_aa):
        before = (fn.launches_c16, fn.launches_word_c16, fn.launches_bf16, fn.launches_word_bf16)
        tstep.count_launches(fn, 3, SPEC, word=True)
        tstep.count_launches(fn, 2, tdev.BF16)
        assert (fn.launches_c16, fn.launches_word_c16, fn.launches_bf16,
                fn.launches_word_bf16) == (before[0] + 3, before[1] + 3, before[2] + 2, before[3])
        (fn.launches_c16, fn.launches_word_c16, fn.launches_bf16,
         fn.launches_word_bf16) = before
