"""The fused one-step route (counterpart of ``lbm_tpu/ops/pallas_step.py``).

``run_step`` advances a ``(9, ny, nx)`` f32 state ``n_steps`` steps and
returns ``(cells, av)`` with ``av[t] = inv_tot_cells * sum(nobst * |u|)``
of step t. On a CUDA tensor it launches kernel K1 (``csrc/step.cu``): one
fused launch per step (forcing, pull streaming with periodic wrap,
bounce-back, BGK, |u| sum), ping-ponging between two buffers, with every
launch of the run issued by one C call. On a CPU tensor it runs
``step_plain``, the same function in plain PyTorch, which is what the CPU
tests hold against the JAX kernel. Any other device raises; a CUDA tensor
never falls back to the plain version.

The TPU kernel's tiling constraints (``nx % 128``, ``ny`` a multiple of the
row block) and its halo carry do not apply: K1 needs ``ny >= 2`` and
device memory for two states.

c16 storage (``dev``, an ``ops/devspace.py::DevSpec``): the state is int16
codes; K1 decodes each value it reads and encodes each value it writes
(``pallas_step.py:198-243``), and the plain version is decode,
``step_plain``, encode: the same rounding point, once per step.

bf16 storage (``dev=devspace.BF16``): the state is bfloat16; K1 widens
each value it reads and rounds each value it writes to nearest even, and
the plain version is widen, ``step_plain``, round: one rounding per step,
as the JAX kernel casts its results to the state's dtype.

K1 has two forms, picked by shape before any launch (``word_form``): at
16-bit storage on a grid whose width is a multiple of ``WORD_CELLS`` the
word form (``WORD_CELLS`` cells of a row per thread, every plane access an
aligned word: ``word_row_plan``), elsewhere, f32 included, the one-cell
form. Both give the same state bit for bit; the av series agrees to the
rounding of its sums, which the two forms take in another order. The
word form's steps are counted in ``launches_word_c16`` or
``launches_word_bf16`` besides the storage's count.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.models.d2q9 import W0, W1, W2
from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops.collision import bgk_relax, u_mag

# Cells per thread of the word forms of K1 and K2 (csrc/lbm_common.cuh::
# kWordCells), and the lanes of a warp.
WORD_CELLS = 4
WARP = 32

_CYS = (0, 0, 1, 0, -1, 1, 1, -1, -1)
_CXS = (0, 1, 0, -1, 0, 1, -1, -1, 1)
_OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)


def forcing_weights(density: float, accel: float):
    """``(w1a, w2a)``: the forcing added to the axis and diagonal speeds
    (kernels.cl:17-18), as Python floats."""
    return float(density * accel / 9.0), float(density * accel / 36.0)


def force_deltas(w1a: float, w2a: float):
    """``(speed, delta)`` of the six speeds the forcing changes."""
    return ((1, w1a), (3, -w1a), (5, w2a), (6, -w2a), (7, -w2a), (8, w2a))


def kernel_scalars(density: float, accel: float, omega: float, inv_tot_cells: float):
    """The float arguments of the kernels' C entry points, in order: the
    forcing weights, then the fused form's ``1 - omega`` and ``omega * w``,
    computed in double like the Python scalars of the plain version."""
    w1a, w2a = forcing_weights(density, accel)
    omega = float(omega)
    return (w1a, w2a, 1.0 - omega, omega * W0, omega * W1, omega * W2,
            float(inv_tot_cells))


def count_launches(wrapper, steps: int, dev, word: bool = False) -> None:
    """Add ``steps`` to a kernel wrapper's launch count for the storage
    ``dev``: ``launches`` at f32, ``launches_c16`` at c16, ``launches_bf16``
    at bf16; with ``word``, also to the word form's count
    (``launches_word_c16``, ``launches_word_bf16``)."""
    names = ["launches" if dev is None else f"launches_{dev.name}"]
    if word:
        names.append(f"launches_word_{dev.name}")
    for name in names:
        setattr(wrapper, name, getattr(wrapper, name) + steps)


def word_form(nx: int, dev) -> bool:
    """The shape rule of K1's and K2's forms: the word form at 16-bit
    storage when ``nx`` is a multiple of ``WORD_CELLS``, so every row starts
    on a word; the one-cell form at f32 and for widths the words cannot
    tile."""
    return dev is not None and nx % WORD_CELLS == 0


def word_row_plan(nx: int):
    """The accesses of one periodic row of a 16-bit plane by the word form
    of K1 (``csrc/step.cu::step_word_kernel``), in element columns: per
    thread, ``(x0, loads, stores)``. Thread j of the row takes cells ``x0 =
    4j .. 4j + 3`` (``WORD_CELLS``) when ``x0 < nx`` (a row's last warp may
    hold idle lanes). It loads its word; the first lane of a warp also
    loads the 32-bit half before its span and the last lane (lane 31, or
    the row's last thread) the half after it, through the periodic wrap at
    the row's ends; it stores its word. ``loads`` and ``stores`` are
    ``(first column, elements)``.

    A specification, not executed by the kernel: the CPU tests hold it to
    the in-place and coverage rules, and the card tests
    (``tests/test_torch_cuda.py``, the word form bitwise the one-cell form's)
    are what guard the kernel itself."""
    word = WORD_CELLS
    if nx % word:
        raise ValueError(f"the word form takes widths that are multiples of {word}, got {nx}")
    plan = []
    for x0 in range(0, nx, word):
        lane = (x0 // word) % WARP
        loads = [(x0, word)]
        if lane == 0:
            loads.append(((x0 - 2) % nx, 2))
        if lane == WARP - 1 or x0 + word == nx:
            loads.append(((x0 + word) % nx, 2))
        plan.append((x0, loads, [(x0, word)]))
    return plan


def check_inputs(cells: torch.Tensor, nobst: torch.Tensor, n_steps: int, min_ny: int,
                 dev=None) -> None:
    """Shapes, dtypes and devices a kernel takes: an f32 state, or with
    ``dev`` its storage's (int16 c16 codes, bfloat16), and an f32 mask."""
    if cells.dim() != 3 or cells.shape[0] != 9:
        raise ValueError(f"state must be (9, ny, nx), got {tuple(cells.shape)}")
    if dev is not None:
        if cells.dtype != dev.dtype or nobst.dtype != torch.float32:
            raise ValueError(f"{dev.name} storage takes a {dev.dtype} state and an f32 "
                             "not-obstacle plane")
    elif cells.dtype != torch.float32 or nobst.dtype != torch.float32:
        raise ValueError("the kernels take f32 state and an f32 not-obstacle plane"
                         + {torch.int16: " (int16 c16 codes need a DevSpec)",
                            torch.bfloat16: " (a bfloat16 state needs devspace.BF16)"}
                         .get(cells.dtype, ""))
    if tuple(nobst.shape) != tuple(cells.shape[1:]):
        raise ValueError(f"nobst {tuple(nobst.shape)} does not match the grid {tuple(cells.shape[1:])}")
    if nobst.device != cells.device:
        raise ValueError("state and nobst must be on one device")
    if cells.shape[1] < min_ny:
        raise ValueError(f"grid needs ny >= {min_ny}, got {cells.shape[1]}")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")


def force_row(m, nobst, w1a, w2a):
    """The forcing of row ny-2 under the joint mask on the 9 planes ``m``
    (speed k in ``m[k]``), the mask from each cell's own values 3, 6, 7;
    returns the new list."""
    r = nobst.shape[0] - 2
    m = list(m)
    ok = ((m[3][r] - w1a > 0.0) & (m[6][r] - w2a > 0.0) & (m[7][r] - w2a > 0.0))
    amask = ok.to(m[0].dtype) * nobst[r]
    for k, w in force_deltas(w1a, w2a):
        plane = m[k].clone()
        plane[r] = plane[r] + w * amask
        m[k] = plane
    return m


def step_plain(cells, nobst, w1a, w2a, omega):
    """One fused step in plain PyTorch (``pallas_step._physics``): forcing of
    row ny-2 under the joint mask, pull streaming with periodic wrap, BGK,
    bounce-back. Returns ``(new_cells, tot_u)``."""
    m = force_row(cells.unbind(0), nobst, w1a, w2a)
    t = [torch.roll(m[k], shifts=(_CYS[k], _CXS[k]), dims=(0, 1)) for k in range(9)]
    relaxed, u_sq = bgk_relax(t, omega)
    fluid = nobst > 0.0
    out = torch.stack([torch.where(fluid, relaxed[k], t[_OPP[k]]) for k in range(9)])
    return out, torch.sum(nobst * u_mag(u_sq))


def run_step_plain(cells, nobst, density, accel, omega, n_steps, inv_tot_cells, dev=None):
    """``n_steps`` of ``step_plain`` (with ``dev``, each between a decode and
    an encode); returns ``(cells, av)``."""
    from lbm_tpu_torch.ops.devspace import decode_state, encode_state

    check_inputs(cells, nobst, n_steps, 2, dev)
    w1a, w2a = forcing_weights(density, accel)
    inv = torch.tensor(inv_tot_cells, dtype=torch.float32, device=cells.device)
    av = torch.empty(n_steps, dtype=torch.float32, device=cells.device)
    for t in range(n_steps):
        full = cells if dev is None else decode_state(cells, dev)
        full, tot = step_plain(full, nobst, w1a, w2a, float(omega))
        cells = full if dev is None else encode_state(full, dev)
        av[t] = tot * inv
    return cells, av


def run_step(cells, nobst, density, accel, omega, n_steps, inv_tot_cells, dev=None):
    """Run ``n_steps`` fused steps: kernel K1 on CUDA, ``run_step_plain`` on CPU.

    ``cells`` is left unchanged. ``inv_tot_cells`` is the f32 value of
    1 / (unblocked cells). The kernel implements the fused collision form.
    ``dev``: 16-bit storage (int16 c16 codes or bf16 ``cells``).
    """
    if cells.device.type == "cpu":
        return run_step_plain(cells, nobst, density, accel, omega, n_steps, inv_tot_cells, dev)
    if cells.device.type != "cuda":
        raise ValueError(f"no step kernel for device {cells.device}")
    return launch(cells, nobst, density, accel, omega, n_steps, inv_tot_cells,
                  word_form(cells.shape[2], dev), dev)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on a 16-byte boundary, as the word forms' widest
    loads need (a copy only for a view that starts elsewhere)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(cells, nobst, density, accel, omega, n_steps, inv_tot_cells, word: bool, dev=None):
    """K1 on a CUDA state in the word form (``word``; 16-bit storage
    only) or the one-cell form; returns ``(cells, av)``. ``run_step`` picks
    the form by ``word_form``."""
    check_inputs(cells, nobst, n_steps, 2, dev)
    lib = _build.library()
    _, ny, nx = cells.shape
    a = cells.contiguous().clone()
    b = torch.empty_like(a)
    nobst = aligned(nobst)
    av = torch.empty(n_steps, dtype=torch.float32, device=cells.device)
    partials = torch.empty(lib.lbm_step_num_blocks(ny, nx), dtype=torch.float32,
                           device=cells.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=cells.device)
    with torch.cuda.device(cells.device):
        stream = torch.cuda.current_stream(cells.device).cuda_stream
        rc = lib.lbm_step_run(
            a.data_ptr(), b.data_ptr(), nobst.data_ptr(), av.data_ptr(),
            partials.data_ptr(), ticket.data_ptr(), ny, nx, n_steps,
            *kernel_scalars(density, accel, omega, inv_tot_cells), int(word),
            _build.storage(dev), stream,
        )
    _build.check(rc, f"step kernel ({'word' if word else 'one-cell'} form)")
    count_launches(run_step, n_steps, dev, word)
    return (a if n_steps % 2 == 0 else b), av


run_step.launches = 0  # K1 steps launched in this process
run_step.launches_c16 = 0  # K1 steps launched at c16 (either form)
run_step.launches_bf16 = 0  # K1 steps launched at bf16 (either form)
run_step.launches_word_c16 = 0  # of those at c16, the word form's
run_step.launches_word_bf16 = 0  # of those at bf16, the word form's
