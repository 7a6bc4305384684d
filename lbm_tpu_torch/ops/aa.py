"""The in-place AA route (counterpart of ``lbm_tpu/ops/pallas_aa.py``).

``run_aa`` advances a ``(9, ny, nx)`` f32 state ``n_steps`` steps with the
AA streaming pattern on ONE copy of the state and returns ``(cells, av)``,
``av[t] = inv_tot_cells * sum(nobst * |u|)`` of step t. Steps alternate
between two arrangements of the planes:

- S (before an even step): slot ``(x, i)`` holds the arrival ``t_i(x)``;
- C (before an odd step): slot ``(x, opp(i))`` holds ``f*_i(x)``.

The even step is cell-local (S -> C); the odd step gathers from
``(x - c_k, opp(k))`` and scatters to ``(x + c_k, k)`` (C -> S). The
forcing of row ny-2 is applied before each step: in S space on even steps,
in C space on odd ones. ``stream_planes`` converts R -> S once at entry;
at exit the state goes S -> R after an even total and through the ``opp``
plane permutation after an odd one, as ``pallas_aa.run_aa`` does.

On a CUDA tensor the loop runs kernel K2 (``csrc/aa.cu``): a one-row
forcing launch and a step launch per step, all issued by one C call, in
place. On a CPU tensor it runs ``run_aa_plain``, which takes the same
steps out of place with the same arrangements and forcing placement, an
independent check of K2's index algebra. Any other device raises.

The TPU kernel's gates (``aa_supported``: ``nx % 128``, the VMEM budget
``_MAX_STATE_BYTES``, ``_pick_tile`` and the 254-step ``_CHUNK_STEPS``
calls) exist for VMEM and Mosaic and are not ported: K2 needs only
``ny >= 3`` and device memory for one state.

c16 storage (``dev``): the state is int16 codes, keyed by slot
(``bg[opp(k)] == bg[k]``), and the arrangements move raw codes. Each step
decodes every slot it reads and encodes every slot it writes; the forcing
decodes, adds and re-encodes one row of each of the six forced slots,
exactly the rows the JAX kernel stores (``pallas_aa.py:297-314``), so the
rest of the state keeps its codes.

bf16 storage (``dev=devspace.BF16``): the same path with bfloat16 in place
of the codes: every value a step stores and every forcing row the forcing
stores is rounded once (``pallas_aa.py:230-236, 297-314``).

K2 has two forms, picked by K1's shape rule before any launch
(``step.word_form``): at c16 and bf16 on a grid whose width is a
multiple of ``WORD_CELLS`` the word form (``WORD_CELLS`` cells of a row
per thread, every plane access an aligned word, the odd step's shifted
accesses rebuilt from neighbour lanes: ``odd_row_plan``), elsewhere, f32
included, the one-cell form. The word form fuses each step's forcing
into the step before it (``run_aa_fused_plain`` is that schedule in
plain PyTorch); a call's first step keeps the standalone even forcing
launch and its last step fuses nothing. Both forms give the same state
bit for bit; the av series agrees to the rounding of its sums. The word
form's steps are counted in ``launches_word_c16`` or
``launches_word_bf16`` besides the storage's count.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops.collision import bgk_relax, u_mag
from lbm_tpu_torch.ops.devspace import decode_plane, decode_state, encode_plane, encode_state
from lbm_tpu_torch.ops.step import (
    _CXS, _CYS, _OPP, WARP, WORD_CELLS, aligned, check_inputs, count_launches, force_deltas,
    forcing_weights, kernel_scalars, word_form,
)

MIN_NY = 3


def stream_planes(cells, sign: int = 1):
    """R -> S (``sign=+1``): slot ``(x, i)`` <- ``f_i(x - c_i)``; ``-1`` inverts."""
    return torch.stack([
        torch.roll(cells[k], shifts=(sign * _CYS[k], sign * _CXS[k]), dims=(0, 1))
        for k in range(9)
    ])


def _mask(f3, f6, f7, nob_row, w1a, w2a):
    ok = (f3 - w1a > 0.0) & (f6 - w2a > 0.0) & (f7 - w2a > 0.0)
    return ok.to(f3.dtype) * nob_row


def _rows(state, dev):
    """``(read, write)`` of one row of one slot as f32 values: the identity
    for f32 storage, decode and encode for c16."""
    if dev is None:
        return (lambda k, r: state[k, r]), (lambda v, k: v)
    return (lambda k, r: decode_plane(state[k, r], k, dev)), (lambda v, k: encode_plane(v, k, dev))


def force_even_plain(state, nobst, w1a, w2a, dev=None):
    """Forcing in S space: the pre-stream delta of speed k on row ny-2 lands
    at row ``ny-2+cy_k``, shifted by ``cx_k``, in slot k; the mask reads
    planes 3/6/7 through the same shift."""
    ny = state.shape[1]
    r = ny - 2
    read, write = _rows(state, dev)
    m = _mask(torch.roll(read(3, r), 1), torch.roll(read(6, ny - 1), 1),
              torch.roll(read(7, ny - 3), 1), nobst[r], w1a, w2a)
    out = state.clone()
    for k, w in force_deltas(w1a, w2a):
        row = (r + _CYS[k]) % ny
        out[k, row] = write(read(k, row) + torch.roll(m, _CXS[k]) * w, k)
    return out


def force_odd_plain(state, nobst, w1a, w2a, dev=None):
    """Forcing in C space: plane i lives in slot opp(i), row ny-2."""
    r = state.shape[1] - 2
    read, write = _rows(state, dev)
    m = _mask(read(_OPP[3], r), read(_OPP[6], r), read(_OPP[7], r), nobst[r], w1a, w2a)
    out = state.clone()
    for k, w in force_deltas(w1a, w2a):
        out[_OPP[k], r] = write(read(_OPP[k], r) + m * w, _OPP[k])
    return out


def even_step_plain(state, nobst, omega):
    """S -> C: relax the 9 slots of each cell, write speed k into slot opp(k)."""
    t = list(state.unbind(0))
    relaxed, u_sq = bgk_relax(t, omega)
    fluid = nobst > 0.0
    out = [torch.where(fluid, relaxed[k], t[_OPP[k]]) for k in range(9)]
    return torch.stack([out[_OPP[j]] for j in range(9)]), torch.sum(nobst * u_mag(u_sq))


def odd_step_plain(state, nobst, omega):
    """C -> S: gather ``t_k`` from ``(x - c_k, opp(k))``, relax, scatter to
    ``(x + c_k, k)``."""
    t = [torch.roll(state[_OPP[k]], shifts=(_CYS[k], _CXS[k]), dims=(0, 1))
         for k in range(9)]
    relaxed, u_sq = bgk_relax(t, omega)
    fluid = nobst > 0.0
    out = [torch.where(fluid, relaxed[k], t[_OPP[k]]) for k in range(9)]
    new = torch.stack([torch.roll(out[k], shifts=(_CYS[k], _CXS[k]), dims=(0, 1))
                       for k in range(9)])
    return new, torch.sum(nobst * u_mag(u_sq))


def unarrange(state, n_steps: int):
    """The regular arrangement R of the state after ``n_steps`` AA steps."""
    if n_steps % 2:
        return state[torch.as_tensor(_OPP, device=state.device)].contiguous()
    return stream_planes(state, sign=-1)


def odd_row_plan(nx: int, cx: int):
    """The accesses of one periodic row by the word form's odd step
    (``csrc/aa.cu::aa_word_kernel``) for a speed k with ``cx = cx(k)``, in
    element columns: per thread, ``(x0, loads, stores)`` of its cells ``x0
    .. x0 + 3`` (``WORD_CELLS``). The gather of t_k reads slot opp(k), whose element
    at column w belongs to cell w + cx; the scatter writes slot k, whose
    element at w belongs to cell w - cx. A thread loads its word, and for
    the gather from x - 1 (x + 1) the warp's first (last) lane loads the
    32-bit half before (after) the span, through the periodic wrap. It
    stores its word, holding one element of a neighbour lane's cell when
    cx is not 0, except that an element of a cell in another warp is left
    out of the word and stored alone by the thread of that cell. ``loads``
    and ``stores`` are ``(first column, elements)``.

    A specification, not executed by the kernel: the CPU tests hold it to
    the in-place rule, and the card tests (``tests/test_torch_cuda.py``, the
    word form bitwise the one-cell form's) are what guard the kernel
    itself."""
    word = WORD_CELLS
    if nx % word:
        raise ValueError(f"the word form takes widths that are multiples of {word}, got {nx}")
    plan = []
    for x0 in range(0, nx, word):
        lane = (x0 // word) % WARP
        first, last = lane == 0, lane == WARP - 1 or x0 + word == nx
        loads = [(x0, word)]
        if cx == 1 and first:
            loads.append(((x0 - 2) % nx, 2))
        if cx == -1 and last:
            loads.append(((x0 + word) % nx, 2))
        stores = [(x0, word)]
        if cx == 1:
            stores = [(x0 + 1, word - 1)] if first else stores
            if last:
                stores.append(((x0 + word) % nx, 1))
        elif cx == -1:
            stores = [(x0, word - 1)] if last else stores
            if first:
                stores.append(((x0 - 1) % nx, 1))
        plan.append((x0, loads, stores))
    return plan


def _force_cells(q, nobst, w1a, w2a, dev, key):
    """The forcing of row ny-2 applied to a step's own outputs: ``q[k]`` is
    the stored value (f32, or codes keyed by slot ``key(k)``) of the value
    travelling k, at its cell. The mask comes from the decoded f3, f6, f7
    of each cell; each forced value is decoded, added to and re-encoded.
    Returns the new list."""
    r = nobst.shape[0] - 2
    q = list(q)

    def dec(k):
        return q[k][r] if dev is None else decode_plane(q[k][r], key(k), dev)

    m = _mask(dec(3), dec(6), dec(7), nobst[r], w1a, w2a)
    for k, w in force_deltas(w1a, w2a):
        v = dec(k) + m * w
        plane = q[k].clone()
        plane[r] = v if dev is None else encode_plane(v, key(k), dev)
        q[k] = plane
    return q


def run_aa_fused_plain(cells, nobst, density, accel, omega, n_steps, inv_tot_cells, dev=None):
    """The word form's schedule in plain PyTorch; returns ``(cells, av)``.
    The call's first step takes the standalone even forcing; after that
    each step applies the next step's forcing to its own outputs before
    they are stored (``_force_cells``): the odd step's C-space forcing in
    the even step's epilogue, the even step's S-space forcing in the odd
    step's scatter, at the cells of row ny-2 (the pre-stream lanes). The
    last step applies none. ``run_aa_plain`` forces the stored state
    instead, before each step: the two agree bit for bit."""
    check_inputs(cells, nobst, n_steps, MIN_NY, dev)
    w1a, w2a = forcing_weights(density, accel)
    inv = torch.tensor(inv_tot_cells, dtype=torch.float32, device=cells.device)
    av = torch.empty(n_steps, dtype=torch.float32, device=cells.device)
    fluid = nobst > 0.0
    state = force_even_plain(stream_planes(cells), nobst, w1a, w2a, dev)
    for t in range(n_steps):
        odd = t % 2 == 1
        full = state if dev is None else decode_state(state, dev)
        if odd:
            pulled = [torch.roll(full[_OPP[k]], shifts=(_CYS[k], _CXS[k]), dims=(0, 1))
                      for k in range(9)]
        else:
            pulled = list(full.unbind(0))
        relaxed, u_sq = bgk_relax(pulled, float(omega))
        out = [torch.where(fluid, relaxed[k], pulled[_OPP[k]]) for k in range(9)]

        def key(k, odd=odd):
            return k if odd else _OPP[k]

        q = [out[k] if dev is None else encode_plane(out[k], key(k), dev) for k in range(9)]
        if t + 1 < n_steps:
            q = _force_cells(q, nobst, w1a, w2a, dev, key)
        if odd:
            state = torch.stack([torch.roll(q[k], shifts=(_CYS[k], _CXS[k]), dims=(0, 1))
                                 for k in range(9)])
        else:
            state = torch.stack([q[_OPP[j]] for j in range(9)])
        av[t] = torch.sum(nobst * u_mag(u_sq)) * inv
    return unarrange(state, n_steps), av


def run_aa_plain(cells, nobst, density, accel, omega, n_steps, inv_tot_cells, dev=None):
    """The AA schedule in plain PyTorch; returns ``(cells, av)``. With
    ``dev`` each step decodes the whole state and encodes its result."""
    check_inputs(cells, nobst, n_steps, MIN_NY, dev)
    w1a, w2a = forcing_weights(density, accel)
    omega = float(omega)
    inv = torch.tensor(inv_tot_cells, dtype=torch.float32, device=cells.device)
    av = torch.empty(n_steps, dtype=torch.float32, device=cells.device)
    state = stream_planes(cells)
    for t in range(n_steps):
        force, step = ((force_odd_plain, odd_step_plain) if t % 2
                       else (force_even_plain, even_step_plain))
        state = force(state, nobst, w1a, w2a, dev)
        full = state if dev is None else decode_state(state, dev)
        full, tot = step(full, nobst, omega)
        state = full if dev is None else encode_state(full, dev)
        av[t] = tot * inv
    return unarrange(state, n_steps), av


def run_aa(cells, nobst, density, accel, omega, n_steps, inv_tot_cells, dev=None):
    """Run ``n_steps`` AA steps: kernel K2 on CUDA, ``run_aa_plain`` on CPU.

    ``cells`` is left unchanged. ``inv_tot_cells`` is the f32 value of
    1 / (unblocked cells). The kernel implements the fused collision form.
    ``dev``: 16-bit storage (int16 c16 codes or bf16 ``cells``).
    """
    if cells.device.type == "cpu":
        return run_aa_plain(cells, nobst, density, accel, omega, n_steps, inv_tot_cells, dev)
    if cells.device.type != "cuda":
        raise ValueError(f"no AA kernel for device {cells.device}")
    return launch(cells, nobst, density, accel, omega, n_steps, inv_tot_cells,
                  word_form(cells.shape[2], dev), dev)


def launch(cells, nobst, density, accel, omega, n_steps, inv_tot_cells, word: bool, dev=None):
    """K2 on a CUDA state in the word form (``word``; 16-bit storage
    only) or the one-cell form; returns ``(cells, av)``. ``run_aa`` picks
    the form by ``word_form``."""
    check_inputs(cells, nobst, n_steps, MIN_NY, dev)
    lib = _build.library()
    _, ny, nx = cells.shape
    state = stream_planes(cells).contiguous()  # R -> S, once per run
    nobst = aligned(nobst)
    av = torch.empty(n_steps, dtype=torch.float32, device=cells.device)
    partials = torch.empty(lib.lbm_aa_num_blocks(ny, nx), dtype=torch.float32,
                           device=cells.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=cells.device)
    with torch.cuda.device(cells.device):
        stream = torch.cuda.current_stream(cells.device).cuda_stream
        rc = lib.lbm_aa_run(
            state.data_ptr(), nobst.data_ptr(), av.data_ptr(), partials.data_ptr(),
            ticket.data_ptr(), ny, nx, n_steps,
            *kernel_scalars(density, accel, omega, inv_tot_cells), int(word),
            _build.storage(dev), stream,
        )
    _build.check(rc, f"AA kernel ({'word' if word else 'one-cell'} form)")
    count_launches(run_aa, n_steps, dev, word)
    return unarrange(state, n_steps), av


run_aa.launches = 0  # K2 steps launched in this process
run_aa.launches_c16 = 0  # K2 steps launched at c16 (either form)
run_aa.launches_bf16 = 0  # K2 steps launched at bf16 (either form)
run_aa.launches_word_c16 = 0  # of those at c16, the word form's
run_aa.launches_word_bf16 = 0  # of those at bf16, the word form's
