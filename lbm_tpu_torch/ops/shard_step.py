"""The fused step of a mesh of shards: kernels K3 and K12 (counterparts of
``lbm_tpu/ops/pallas_step.py::_kernel(col_fix=True)`` and
``lbm_tpu/ops/pallas_remote.py::_kernel_overlap``).

A mesh of ``py x px`` shards is a list of rows of shards: ``shards[i][j]``
is a ``(9, ry, rx)`` f32 state holding global rows ``[i*ry, (i+1)*ry)`` and
columns ``[j*rx, (j+1)*rx)``, on the shard's device (a device may repeat);
``nob_shards[i][j]`` its ``(ry, rx)`` not-obstacle plane. ``run_shard_step``
advances every shard ``n_steps`` fused steps and returns the new shards and
the raw per-step sums ``sum(nobst * |u|)`` of each shard, ``(py*px,
n_steps)`` (shard ``i*px + j``), for the mesh to add up in shard order.

Both kernels hold each shard with a one-cell ghost ring filled from the
neighbours' cells, corners included (``with_ring``), in a ``(9, ry+2,
pitch)`` buffer whose rows of cells start at column ``lead_of(dtype)``,
128-byte aligned, so the kernels' stores are whole lines. The step pulls inside the
ring with no wrap and forces every source cell whose global row is ny-2,
the mask from that cell's own values; so the owner gate and the pre-forced edge columns and corner
splices of the TPU path are not needed, and the result is K1's on the
whole grid. A shard may be its own neighbour (``px = 1``, a mesh of one).

- K3 (``run_shard_step``, ``csrc/shard_step.cu``): the rings are refilled
  from the neighbours' cells before each step (one fill launch);
- K12 (``run_shard_overlap``, ``--backend pallas-overlap``, 1-D meshes):
  the kernel stores each shard's new edge cells straight into the rings
  that read them next step; nothing runs between steps. On one card that
  shows K12's result, not an overlap of exchange and compute.

Across processes (``parallel/multihost.py``, one row shard per process):
``RowShard`` runs K3 with its ring filled from rows the caller received
(``RowExchange`` swaps them over NCCL or gloo); ``IpcRowShard`` runs K12
with the neighbours' shards mapped into the process with CUDA IPC, the
steps ordered by waits on the streams, no row through the host.

The shards of a mesh fall into runs of consecutive shards on one device
(``device_runs``); each run's shards share one allocation and one launch.
With every shard on one device there is one run, and one C call issues a
whole chunk. Across cards (``issue``) each run takes one C call per step,
its stream first waiting for the previous step of the runs that hold its
neighbours; the fills read and K12 stores through peer addresses, which
both require (``cudaDeviceEnablePeerAccess``; without peer access they
raise). On CPU tensors both run ``run_shard_step_plain``, the same function
in plain PyTorch; any other device raises, and CUDA tensors never run the
plain version.

The TPU kernel's ``nx % 128`` and ``rows % 8`` do not carry over: any local
grid of at least 1 x 1 cells works, on a global grid of ``ny >= 2``.

c16 storage (``dev``, K3 only; the JAX package runs its per-shard fused
kernel at c16 on 1-D meshes and refuses ``pallas-overlap`` at c16): the
shards are int16 codes; K3 decodes each value it reads and encodes each it
writes, K1's rounding point once per step, and its ring fill copies codes.
``run_shard_step_plain(..., dev)`` decodes, steps and encodes every step,
the JAX package's ``make_sharded_c16_jnp_step``.

bf16 storage (``dev=devspace.BF16``, K3 only): bfloat16 shards, one
rounding per step, the ring fill copying raw bfloat16 (lead and pitch: 64
elements). K12 has no bf16 form, as in the JAX package; the sharded
runner runs it on f32 between two casts per chunk.
"""

from __future__ import annotations

import ctypes
import socket
import time

import torch

from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops.collision import bgk_relax, u_mag
from lbm_tpu_torch.ops.devspace import decode_state, encode_state
from lbm_tpu_torch.ops.step import (_CXS, _CYS, _OPP, check_inputs, count_launches,
                                    force_deltas, forcing_weights, kernel_scalars)

LINE = 128  # bytes: every ringed row of cells starts on a line


def lead_of(dtype: torch.dtype) -> int:
    """Padded column of a shard's column 0, in elements: one 128-byte line
    (32 f32 values, 64 int16 codes)."""
    return LINE // torch.empty((), dtype=dtype).element_size()


def pitch_of(rx: int, dtype: torch.dtype = torch.float32) -> int:
    """Row pitch of a ringed shard of ``rx`` columns, in elements: the
    ring's right column fits, and rows stay 128-byte aligned."""
    lead = lead_of(dtype)
    return -(-(lead + rx + 1) // lead) * lead


PAIR_CELLS = 4  # cells per thread of K3's 16-bit forms (csrc/shard_step.cu::kPairCells)
WARP = 32


def pair_row_plan(rx: int, dtype: torch.dtype = torch.int16):
    """The accesses of one row of a ringed 16-bit shard by K3's 16-bit forms
    (``shard_step_pair_kernel``), in padded element columns: per thread,
    ``(x0, loads, stores)``. Thread j of the row takes cells ``x0 = 4 j ..
    4 j + 3``. It loads the 64-bit word of its cells (every plane) when
    ``x0 <= rx`` (the word holds a cell or the right ghost column); lane 0
    of a warp loads the 32-bit word before its span and lane 31 the one
    after it when its cells reach them. It stores one 64-bit word when all
    four cells lie below ``rx``, else its cells below ``rx`` one by one:
    the right ghost column ``lead + rx`` is never written. ``loads`` and
    ``stores`` are ``(first column, elements)``."""
    lead = lead_of(dtype)
    span = WARP * PAIR_CELLS
    plan = []
    for x0 in range(0, -(-rx // span) * span, PAIR_CELLS):
        pc, lane = lead + x0, (x0 // PAIR_CELLS) % WARP
        loads, stores = [], []
        if x0 <= rx:
            loads.append((pc, PAIR_CELLS))
            if lane == 0:
                loads.append((pc - 2, 2))
            if lane == WARP - 1 and x0 + PAIR_CELLS <= rx:
                loads.append((pc + PAIR_CELLS, 2))
        if x0 + PAIR_CELLS <= rx:
            stores.append((pc, PAIR_CELLS))
        else:
            stores += [(pc + c, 1) for c in range(PAIR_CELLS) if x0 + c < rx]
        plan.append((x0, loads, stores))
    return plan


def mesh_of(shards):
    """``(py, px)`` of a mesh of shards."""
    return len(shards), len(shards[0])


def with_ring(shards):
    """Each shard ``(C, ry, rx)`` inside a one-cell ring of its neighbours'
    cells, corners included: ``(C, ry+2, rx+2)`` on the shard's device."""
    py, px = mesh_of(shards)
    out = []
    for i in range(py):
        row = []
        for j in range(px):
            dev = shards[i][j].device

            def nb(di, dj, rows, cols):
                return shards[(i + di) % py][(j + dj) % px][:, rows, cols].to(dev)

            last, first, every = slice(-1, None), slice(0, 1), slice(None)
            top = torch.cat([nb(-1, -1, last, last), nb(-1, 0, last, every),
                             nb(-1, 1, last, first)], dim=2)
            mid = torch.cat([nb(0, -1, every, last), shards[i][j], nb(0, 1, every, first)], dim=2)
            bot = torch.cat([nb(1, -1, first, last), nb(1, 0, first, every),
                             nb(1, 1, first, first)], dim=2)
            row.append(torch.cat([top, mid, bot], dim=1))
        out.append(row)
    return out


def shard_step_plain(padded, nob_padded, r0, ny, w1a, w2a, omega):
    """One fused step of one ringed shard in plain PyTorch: forcing of every
    cell on global row ny-2 (the shard's first row is global row ``r0``),
    pull streaming inside the ring, BGK, bounce-back. Returns the new
    ``(9, ry, rx)`` state and its raw sum of ``nobst * |u|``."""
    ry, rx = padded.shape[1] - 2, padded.shape[2] - 2
    grow = (torch.arange(ry + 2, device=padded.device) + (r0 - 1)) % ny
    frow = (grow == ny - 2).to(padded.dtype)[:, None]
    m = list(padded.unbind(0))
    ok = (m[3] - w1a > 0.0) & (m[6] - w2a > 0.0) & (m[7] - w2a > 0.0)
    amask = ok.to(padded.dtype) * nob_padded * frow
    for k, w in force_deltas(w1a, w2a):
        m[k] = m[k] + w * amask
    t = [m[k][1 - _CYS[k]:1 - _CYS[k] + ry, 1 - _CXS[k]:1 - _CXS[k] + rx] for k in range(9)]
    relaxed, u_sq = bgk_relax(t, omega)
    nob = nob_padded[1:-1, 1:-1]
    fluid = nob > 0.0
    out = torch.stack([torch.where(fluid, relaxed[k], t[_OPP[k]]) for k in range(9)])
    return out, torch.sum(nob * u_mag(u_sq))


def check_mesh(shards, nob_shards, n_steps, ny, dev=None) -> None:
    py, px = mesh_of(shards)
    if py < 1 or px < 1 or any(len(row) != px for row in shards) or mesh_of(nob_shards) != (py, px):
        raise ValueError("shards and nob_shards must be one py x px mesh")
    shape = tuple(shards[0][0].shape)
    for row, nob_row in zip(shards, nob_shards):
        for s, nob in zip(row, nob_row):
            if tuple(s.shape) != shape or s.dim() != 3 or s.shape[0] != 9:
                raise ValueError(f"shards must all be one (9, ry, rx), got {tuple(s.shape)} "
                                 f"and {shape}")
            check_inputs(s, nob, max(n_steps, 1), 1, dev)
    if len({s.device.type for row in shards for s in row}) != 1:
        raise ValueError("shards on more than one kind of device")
    if py * shape[1] != ny or ny < 2:
        raise ValueError(f"{py} shards of {shape[1]} rows do not make a grid of ny={ny} >= 2 rows")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")


def run_shard_step_plain(shards, nob_shards, density, accel, omega, n_steps, ny, dev=None):
    """``n_steps`` of ``shard_step_plain`` on every shard, the rings rebuilt
    from the neighbours between steps; with ``dev`` (c16 or bf16) each step between
    a decode and an encode. Returns ``(shards, sums)``."""
    check_mesh(shards, nob_shards, n_steps, ny, dev)
    py, px = mesh_of(shards)
    w1a, w2a = forcing_weights(density, accel)
    ry = shards[0][0].shape[1]
    nob_ring = with_ring([[n[None] for n in row] for row in nob_shards])
    device = shards[0][0].device
    sums = torch.empty((py * px, n_steps), dtype=torch.float32, device=device)
    for t in range(n_steps):
        padded = with_ring(shards if dev is None else
                           [[decode_state(s, dev) for s in row] for row in shards])
        new = []
        for i in range(py):
            row = []
            for j in range(px):
                cells, tot = shard_step_plain(padded[i][j], nob_ring[i][j][0], i * ry, ny, w1a,
                                              w2a, float(omega))
                sums[i * px + j, t] = tot.to(device)
                row.append(cells if dev is None else encode_state(cells, dev))
            new.append(row)
        shards = new
    return shards, sums


def device_runs(devices):
    """Maximal runs of consecutive shards on one device: ``[(s0, count,
    device)]``."""
    runs = []
    for z, d in enumerate(devices):
        if runs and runs[-1][2] == d:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1, d)
        else:
            runs.append((z, 1, d))
    return runs


def neighbour_runs(runs, py, px):
    """Per run, the runs on other devices that hold a neighbour (rows,
    columns, corners, wrapped) of one of its shards of a py x px mesh."""
    owner = [r for r, (_, count, _) in enumerate(runs) for _ in range(count)]
    near = []
    for s0, count, dev in runs:
        found = set()
        for z in range(s0, s0 + count):
            i, j = divmod(z, px)
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    q = owner[((i + di) % py) * px + (j + dj) % px]
                    if runs[q][2] != dev:
                        found.add(q)
        near.append(sorted(found))
    return near


def enable_peers(lib, runs, near):
    """Peer access from each run's card to the cards of its neighbour runs."""
    for (_, _, dev), others in zip(runs, near):
        for q in others:
            other = runs[q][2]
            if not torch.cuda.can_device_access_peer(dev, other):
                raise RuntimeError(f"the shards on {dev} read and write the shards on {other}, "
                                   "but that card has no peer access to it")
            _build.check(lib.lbm_enable_peer(dev.index, other.index), "peer access")


def sync(devices) -> None:
    """Wait for the work queued on every CUDA device of ``devices``."""
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def issue(runs, near, n, call) -> None:
    """Issue ``n`` steps (or passes) of every run: ``call(r, t, k)`` issues
    ``k`` steps of run r from step ``t`` on its device's current stream. With one
    run, one call for all ``n``. Across devices, one call per run per step,
    each run's stream first waiting for the previous step of its neighbour
    runs, which read and write its buffers; every device is synchronised
    before (the inputs are in place) and after (no card still reads or
    writes another's buffers)."""
    if len(runs) == 1:
        call(0, 0, n)
        return
    devices = [d for _, _, d in runs]
    events = [[torch.cuda.Event() for _ in runs] for _ in range(2)]
    sync(devices)
    for t in range(n):
        for r, dev in enumerate(devices):
            stream = torch.cuda.current_stream(dev)
            if t:
                for q in near[r]:
                    stream.wait_event(events[(t - 1) % 2][q])
            call(r, t, 1)
            events[t % 2][r].record(stream)
    sync(devices)


def address_table(entries, device):
    """The addresses of each shard's buffers, one row per shard, on
    ``device``."""
    return torch.tensor([[e.data_ptr() for e in row] for row in entries], dtype=torch.int64,
                        device=device)


def _run_kernel(shards, nob_shards, density, accel, omega, n_steps, ny, overlap, what, dev):
    check_mesh(shards, nob_shards, n_steps, ny, dev)
    py, px = mesh_of(shards)
    ry, rx = shards[0][0].shape[1:]
    flat = [s for row in shards for s in row]
    nobs = [n for row in nob_shards for n in row]
    lib = _build.library()
    scalars = kernel_scalars(density, accel, omega, 1.0)[:6]
    nblocks = lib.lbm_step_num_blocks(ry, rx)
    runs = device_runs([s.device for s in flat])
    near = neighbour_runs(runs, py, px)
    dtype = flat[0].dtype
    lead, pitch = lead_of(dtype), pitch_of(rx, dtype)
    cells = slice(lead, lead + rx)
    storage = _build.storage(dev)
    state = []  # per run: (buffers, padded masks, av, partials, ticket)
    for s0, count, device in runs:
        bufs = torch.empty((2, count, 9, ry + 2, pitch), dtype=dtype, device=device)
        nob = torch.empty((count, ry + 2, pitch), dtype=torch.float32, device=device)
        for z in range(count):
            bufs[0, z, :, 1:-1, cells] = flat[s0 + z]
            nob[z, 1:-1, cells] = nobs[s0 + z]
        state.append((bufs, nob, torch.empty((count, n_steps), dtype=torch.float32, device=device),
                      torch.empty(count * nblocks, dtype=torch.float32, device=device),
                      torch.zeros(count, dtype=torch.int32, device=device)))
    entries = [(bufs[0, z], bufs[1, z], nob[z])
               for (bufs, nob, *_), (_, count, _) in zip(state, runs) for z in range(count)]
    tables = {d: address_table(entries, d) for _, _, d in runs}
    if len(runs) > 1:
        enable_peers(lib, runs, near)

    def call(r, t, k):
        s0, count, device = runs[r]
        _, _, av, partials, ticket = state[r]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.lbm_shard_run(tables[device].data_ptr(), s0, count, py, px, ry, rx, ny,
                                   pitch, lead, av.data_ptr() + 4 * t, n_steps,
                                   partials.data_ptr(), ticket.data_ptr(), t % 2, k,
                                   2 if overlap else 1, int(t == 0), *scalars, storage, stream)
        _build.check(rc, what)

    issue(runs, near, n_steps, call)
    final = [bufs[n_steps % 2, z, :, 1:-1, cells] for (bufs, *_), (_, count, _) in zip(state, runs)
             for z in range(count)]
    device = flat[0].device
    sums = torch.cat([av.to(device) for _, _, av, _, _ in state])
    return [[final[i * px + j] for j in range(px)] for i in range(py)], sums


def _dispatch(shards, nob_shards, density, accel, omega, n_steps, ny, overlap, what, dev=None):
    device = shards[0][0].device
    if device.type == "cpu":
        return run_shard_step_plain(shards, nob_shards, density, accel, omega, n_steps, ny, dev)
    if device.type != "cuda":
        raise ValueError(f"no shard kernel for device {device}")
    return _run_kernel(shards, nob_shards, density, accel, omega, n_steps, ny, overlap, what, dev)


def run_shard_step(shards, nob_shards, density, accel, omega, n_steps, ny, *, dev=None):
    """``n_steps`` fused steps of a mesh of shards: kernel K3 on CUDA,
    ``run_shard_step_plain`` on CPU. Returns ``(shards, sums)``, the raw
    per-shard sums ``(py*px, n_steps)`` on the first shard's device. The
    input shards are left unchanged; the returned ones may be views of one
    buffer. ``dev``: 16-bit storage (int16 c16 codes or bf16 shards)."""
    out = _dispatch(shards, nob_shards, density, accel, omega, n_steps, ny, False,
                    "shard step kernel", dev)
    if shards[0][0].device.type == "cuda":
        count_launches(run_shard_step, n_steps, dev)
    return out


def run_shard_overlap(shards, nob_shards, density, accel, omega, n_steps, ny):
    """``run_shard_step``'s function with kernel K12 on CUDA: each shard's
    edge cells are stored into the rings that read them by the kernel
    itself. Its plain version is ``run_shard_step_plain``."""
    out = _dispatch(shards, nob_shards, density, accel, omega, n_steps, ny, True,
                    "shard overlap kernel", None)
    if shards[0][0].device.type == "cuda":
        run_shard_overlap.launches += n_steps
    return out


run_shard_step.launches = 0  # mesh steps K3 advanced in this process
run_shard_step.launches_c16 = 0  # mesh steps K3 advanced at c16
run_shard_step.launches_bf16 = 0  # mesh steps K3 advanced at bf16
run_shard_overlap.launches = 0  # mesh steps K12 advanced in this process


def ring_from_rows(shard, dn, up):
    """``with_ring``'s ring of a shard of a 1-D row mesh (px = 1) whose
    neighbour shards lie elsewhere: ``shard`` ``(C, ry, rx)`` between ``dn``,
    the previous shard's last row, and ``up``, the next shard's first row
    (each ``(C, 1, rx)``), every row's columns wrapped: ``(C, ry+2, rx+2)``."""

    def wrapped(x):
        return torch.cat([x[:, :, -1:], x, x[:, :, :1]], dim=2)

    return torch.cat([wrapped(dn), wrapped(shard), wrapped(up)], dim=1)


class RowShard:
    """Shard ``rank`` of a 1-D row mesh of ``world`` shards, one per process
    (``parallel/multihost.py``), stepped by K3 with the rows of its ring
    received from the neighbour processes: ``lbm_shard_rows_run`` (the ring
    filled from a received buffer, then K3's step) on CUDA,
    ``shard_step_plain`` on ``ring_from_rows`` on the CPU.

    A step: the caller sends ``edges()`` (the shard's first and last row,
    ``(9, 1, rx)`` in the storage's type) to the previous and the next
    process, receives theirs into ``halos()`` (``dn``, the previous shard's
    last row; ``up``, the next shard's first row), then calls ``step()``.
    ``cells`` is the shard ``(9, ry, rx)`` (``dev``: 16-bit storage, as
    ``run_shard_step``; left unchanged), ``nob_ring`` its not-obstacle plane
    inside the ring of the neighbours' ``(ry+2, rx+2)``. ``state()`` is the
    shard's state, ``sums`` its raw per-step sums ``(n_steps,)``. The ring
    and the step are ``run_shard_step``'s, so the result is bitwise the
    one-process mesh's."""

    launches = 0  # steps K3 advanced across processes in this process
    launches_c16 = 0
    launches_bf16 = 0

    def __init__(self, cells, nob_ring, rank, world, ny, density, accel, omega, n_steps, *,
                 dev=None):
        ry, rx = cells.shape[1:]
        check_inputs(cells, nob_ring[1:-1, 1:-1], n_steps, 1, dev)
        if tuple(nob_ring.shape) != (ry + 2, rx + 2):
            raise ValueError(f"nob_ring {tuple(nob_ring.shape)} is not the ring of a {ry}x{rx} "
                             "shard")
        if not 0 <= rank < world or world * ry != ny or ny < 2:
            raise ValueError(f"shard {rank} of {world} shards of {ry} rows is not a row of a "
                             f"grid of ny={ny} >= 2 rows")
        self.rank, self.world, self.ny, self.n_steps, self.dev = rank, world, ny, n_steps, dev
        self.ry, self.rx, self.device = ry, rx, cells.device
        self.t = 0
        self.rows = torch.empty((2, 9, 1, rx), dtype=cells.dtype, device=self.device)
        self.sums = torch.empty(n_steps, dtype=torch.float32, device=self.device)
        if self.device.type == "cpu":
            self.cells, self.nob_ring = cells, nob_ring
            self.plain = (*forcing_weights(density, accel), float(omega))
            return
        if self.device.type != "cuda":
            raise ValueError(f"no shard kernel for device {self.device}")
        self.lib = _build.library()
        self.lead, self.pitch = lead_of(cells.dtype), pitch_of(rx, cells.dtype)
        self.bufs = torch.empty((2, 9, ry + 2, self.pitch), dtype=cells.dtype, device=self.device)
        self.bufs[0, :, 1:-1, self.lead:self.lead + rx] = cells
        self.nob = torch.zeros((ry + 2, self.pitch), dtype=torch.float32, device=self.device)
        self.nob[:, self.lead - 1:self.lead + rx + 1] = nob_ring
        # The kernel reads the table's row of this shard alone.
        self.table = torch.zeros((world, 3), dtype=torch.int64, device=self.device)
        self.table[rank] = address_table([(self.bufs[0], self.bufs[1], self.nob)], self.device)[0]
        self.partials = torch.empty(self.lib.lbm_step_num_blocks(ry, rx), dtype=torch.float32,
                                    device=self.device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.scalars = kernel_scalars(density, accel, omega, 1.0)[:6]
        self.storage = _build.storage(dev)

    def state(self):
        if self.device.type == "cpu":
            return self.cells
        return self.bufs[self.t % 2, :, 1:-1, self.lead:self.lead + self.rx]

    def edges(self):
        cells = self.state()
        return cells[:, :1], cells[:, -1:]

    def halos(self):
        return self.rows[0], self.rows[1]

    def step(self) -> None:
        if self.t >= self.n_steps:
            raise ValueError(f"the shard was set up for {self.n_steps} steps")
        ry, rx = self.ry, self.rx
        if self.device.type == "cpu":
            dev = self.dev
            full = [x if dev is None else decode_state(x, dev)
                    for x in (self.cells, self.rows[0], self.rows[1])]
            cells, tot = shard_step_plain(ring_from_rows(*full), self.nob_ring, self.rank * ry,
                                          self.ny, *self.plain)
            self.cells = cells if dev is None else encode_state(cells, dev)
            self.sums[self.t] = tot
        else:
            with torch.cuda.device(self.device):
                stream = torch.cuda.current_stream(self.device).cuda_stream
                rc = self.lib.lbm_shard_rows_run(
                    self.table.data_ptr(), self.rank, 1, self.world, ry, rx, self.ny, self.pitch,
                    self.lead, self.rows.data_ptr(), self.sums.data_ptr() + 4 * self.t,
                    self.n_steps, self.partials.data_ptr(), self.ticket.data_ptr(), self.t % 2,
                    *self.scalars, self.storage, stream)
            _build.check(rc, "shard step kernel (rows from other processes)")
            count_launches(RowShard, 1, self.dev)
        self.t += 1



class RowExchange:
    """Swaps a shard's edge rows with the previous and the next process of
    a ring of ``world`` processes. ``__call__(first, last, dn, up)`` sends
    ``first`` (the shard's first rows) to the previous process and ``last``
    to the next, and receives into ``dn`` the previous process's last rows
    and into ``up`` the next one's first rows. ``channel``: ``nccl`` (the
    tensors stay on the card; ``group`` an NCCL group), ``gloo`` (staged
    through the host) or ``local`` (a world of one: the shard is its own
    neighbour)."""

    def __init__(self, rank: int, world_size: int, channel: str, group=None):
        self.rank, self.world, self.channel, self.group = rank, world_size, channel, group

    def __call__(self, first, last, dn, up) -> None:
        if self.channel == "local":
            dn.copy_(last)
            up.copy_(first)
            return
        import torch.distributed as dist

        staged = self.channel == "gloo"
        send_last, send_first = ((x.cpu() if staged else x).contiguous() for x in (last, first))
        got_dn, got_up = ((torch.empty(x.shape, dtype=x.dtype) if staged else x)
                          for x in (dn, up))
        prev, nxt = (self.rank - 1) % self.world, (self.rank + 1) % self.world
        # Two processes are each other's previous and next: the ops between
        # one pair are matched in the order issued, so rows going down
        # (tag 1) come before rows going up (tag 2) on both sides.
        ops = [dist.P2POp(dist.isend, send_last, nxt, self.group, tag=1),
               dist.P2POp(dist.isend, send_first, prev, self.group, tag=2),
               dist.P2POp(dist.irecv, got_dn, prev, self.group, tag=1),
               dist.P2POp(dist.irecv, got_up, nxt, self.group, tag=2)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged:
            dn.copy_(got_dn)
            up.copy_(got_up)


def gather_objects(obj, group, world: int) -> list:
    """Every process's ``obj``, in rank order, over ``group`` (gloo)."""
    if world == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * world
    dist.all_gather_object(out, obj, group=group)
    return out


IPC_HANDLE_BYTES = 64  # CUDA_IPC_HANDLE_SIZE: a cudaIpcMemHandle_t
IPC_CHUNK = 128  # steps per C call of IpcRowShard.run; at most two are queued
STALL_S = 60.0  # seconds a rank waits for a chunk of steps before it raises


class IpcRowShard:
    """Shard ``rank`` of a 1-D row mesh of ``world`` shards, one per process
    (``parallel/multihost.py``, ``--backend pallas-overlap``), stepped by
    K12 with no rows through the host: ``lbm_shard_ipc_run`` on CUDA,
    ``shard_step_plain`` on ``ring_from_rows`` with the rows swapped over
    gloo (``RowShard`` and ``RowExchange``) on the CPU. ``RowShard``'s
    arguments (f32 only: K12 stores f32, and the caller casts a bf16 shard
    once in and once out), plus ``group``, the gloo group of the processes.

    On CUDA every process allocates its shard's buffers, its padded
    not-obstacle plane and an inbox of two step counters in one
    ``cudaMalloc`` of its own, uploads the shard, and exports the allocation
    with CUDA IPC. The handles are swapped with ``all_gather_object``; each
    process maps its neighbours' allocations and builds K12's table from
    them, so the kernel stores its edge cells straight into the neighbours'
    rings. ``run(n)`` issues the steps ``IPC_CHUNK`` at a time, one C call
    each, every step ordered after the neighbours' step before it by waits
    on the stream (``csrc/shard_step.cu``); the host waits for each chunk
    with a deadline (``deadline`` seconds, ``STALL_S``) and, when a
    neighbour has stopped, releases its stream and raises, naming the
    ranks. Ranks whose memory cannot be mapped (other hosts, cards without
    peer access) raise at set-up. ``close()`` unmaps the neighbours, waits for every process at a barrier
    and only then frees the allocation. With ``world == 1`` nothing is
    mapped: the shard is its own neighbour. ``state()`` and ``sums`` as
    ``RowShard``'s; the result is bitwise ``run_shard_overlap``'s on the
    one-process mesh."""

    launches = 0  # steps K12 advanced across processes in this process

    def __init__(self, cells, nob_ring, rank, world, ny, density, accel, omega, n_steps, *,
                 group=None, deadline=STALL_S):
        ry, rx = cells.shape[1:]
        check_inputs(cells, nob_ring[1:-1, 1:-1], n_steps, 1, None)
        if tuple(nob_ring.shape) != (ry + 2, rx + 2):
            raise ValueError(f"nob_ring {tuple(nob_ring.shape)} is not the ring of a {ry}x{rx} "
                             "shard")
        if not 0 <= rank < world or world * ry != ny or ny < 2:
            raise ValueError(f"shard {rank} of {world} shards of {ry} rows is not a row of a "
                             f"grid of ny={ny} >= 2 rows")
        self.rank, self.world, self.ny, self.n_steps = rank, world, ny, n_steps
        self.ry, self.rx, self.device, self.group = ry, rx, cells.device, group
        self.prev, self.next = (rank - 1) % world, (rank + 1) % world
        self.deadline, self.t = deadline, 0
        if self.device.type == "cpu":
            self.plain = RowShard(cells, nob_ring, rank, world, ny, density, accel, omega, n_steps)
            self.exchange = RowExchange(rank, world, "gloo" if world > 1 else "local", group)
            self.sums = self.plain.sums
            return
        if self.device.type != "cuda":
            raise ValueError(f"no shard kernel for device {self.device}")
        self.lib = lib = _build.library()
        self.lead, self.pitch = lead_of(torch.float32), pitch_of(rx)
        self.sums = torch.empty(n_steps, dtype=torch.float32, device=self.device)
        self.partials = torch.empty(lib.lbm_step_num_blocks(ry, rx), dtype=torch.float32,
                                    device=self.device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.scalars = kernel_scalars(density, accel, omega, 1.0)[:6]
        layout = (ctypes.c_ulonglong * 5)()
        _build.check(lib.lbm_shard_ipc_layout(ry, self.pitch, layout), "IPC layout")
        self.offsets = tuple(layout[:4])  # buffer 0, buffer 1, padded mask, inbox
        base, handle = ctypes.c_ulonglong(), ctypes.create_string_buffer(IPC_HANDLE_BYTES)
        self.mapped = {}  # rank: its allocation mapped into this process
        with torch.cuda.device(self.device):
            _build.check(lib.lbm_shard_ipc_alloc(layout[4], ctypes.byref(base), handle),
                         "the shard's allocation (cudaMalloc, cudaIpcGetMemHandle)")
            self.base = base.value
            padded = torch.zeros((9, ry + 2, self.pitch), dtype=torch.float32, device=self.device)
            padded[:, 1:-1, self.lead:self.lead + rx] = cells
            nob = torch.zeros((ry + 2, self.pitch), dtype=torch.float32, device=self.device)
            nob[:, self.lead - 1:self.lead + rx + 1] = nob_ring
            self._copy(self.base + self.offsets[0], padded.data_ptr(), padded.nbytes)
            self._copy(self.base + self.offsets[2], nob.data_ptr(), nob.nbytes)
            torch.cuda.synchronize(self.device)  # zeroed and uploaded before the handle goes out
        props = torch.cuda.get_device_properties(self.device)
        me = {"host": socket.gethostname(), "device": self.device.index,
              "card": str(getattr(props, "uuid", self.device.index)), "handle": handle.raw}
        everyone = gather_objects(me, group, world)  # every shard is uploaded after this
        check_mappable(everyone)
        failed = []
        for q in sorted({self.prev, self.next} - {rank}):
            got = ctypes.c_ulonglong()
            with torch.cuda.device(self.device):
                rc = lib.lbm_shard_ipc_open(everyone[q]["handle"], ctypes.byref(got))
            if rc != 0:
                failed.append(f"rank {rank} cannot map rank {q}'s shard: CUDA error {rc} "
                              "(cudaIpcOpenMemHandle)")
            else:
                self.mapped[q] = got.value
        failed = [f for fs in gather_objects(failed, group, world) for f in fs]
        if failed:
            raise RuntimeError("; ".join(failed))
        bases = {**self.mapped, rank: self.base}
        table = [[0, 0, 0] for _ in range(world)]
        for q, b in bases.items():
            table[q] = [b + off for off in self.offsets[:3]]
        self.table = torch.tensor(table, dtype=torch.int64, device=self.device)
        inbox = self.offsets[3]
        self.inbox = self.base + inbox
        self.to_next = bases[self.next] + inbox  # word 0: written by the previous shard
        self.to_prev = 0 if self.prev == self.next else bases[self.prev] + inbox + 4

    def _copy(self, dst, src, nbytes):
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _build.check(self.lib.lbm_shard_ipc_copy(dst, src, nbytes, stream), "IPC shard copy")

    def state(self):
        if self.device.type == "cpu":
            return self.plain.state()
        out = torch.empty((9, self.ry + 2, self.pitch), dtype=torch.float32, device=self.device)
        with torch.cuda.device(self.device):
            self._copy(out.data_ptr(), self.base + self.offsets[self.t % 2], out.nbytes)
        return out[:, 1:-1, self.lead:self.lead + self.rx]

    def run(self, n: int) -> None:
        """Advance ``n`` steps."""
        if self.t + n > self.n_steps:
            raise ValueError(f"the shard was set up for {self.n_steps} steps")
        if self.device.type == "cpu":
            for _ in range(n):
                first, last = self.plain.edges()
                self.exchange(first, last, *self.plain.halos())
                self.plain.step()
            self.t += n
            return
        queued = []
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            for lo in range(0, n, IPC_CHUNK):
                if len(queued) == 2:
                    self._wait(*queued.pop(0))
                k = min(IPC_CHUNK, n - lo)
                first = self.t + 1
                rc = self.lib.lbm_shard_ipc_run(
                    self.table.data_ptr(), self.rank, self.world, self.ry, self.rx, self.ny,
                    self.pitch, self.lead, self.inbox, self.to_next, self.to_prev, self.t, k,
                    self.sums.data_ptr() + 4 * self.t, self.partials.data_ptr(),
                    self.ticket.data_ptr(), *self.scalars, stream.cuda_stream)
                _build.check(rc, "K12 across processes (lbm_shard_ipc_run)")
                self.t += k
                done = torch.cuda.Event()
                done.record(stream)
                queued.append((done, first, self.t))
            for item in queued:
                self._wait(*item)
        IpcRowShard.launches += n

    def _wait(self, done, first, last) -> None:
        """Wait for the event ``done`` after steps ``first``..``last``,
        polling, at most ``deadline`` seconds. When it does not come, release
        the stream (its queued steps run out, so the process can exit) and
        raise naming the ranks."""
        limit = time.monotonic() + self.deadline
        pause = 1e-5
        while not done.query():
            if time.monotonic() > limit:
                rc = self.lib.lbm_shard_ipc_release(self.inbox)
                them = " and ".join(f"rank {q}" for q in sorted({self.prev, self.next}))
                raise RuntimeError(
                    f"K12 across processes: rank {self.rank} of {self.world} did not finish steps "
                    f"{first}-{last} within {self.deadline:g} s; each step waits for the step "
                    f"before on its neighbours ({them}), so a neighbour has stopped or stalled"
                    + (f" (releasing the stream failed: CUDA error {rc})" if rc else ""))
            time.sleep(pause)
            pause = min(2 * pause, 2e-4)

    def close(self) -> None:
        """Unmap the neighbours, wait for every process, free the shard.
        Call it on every process once the steps are done and the state is
        read: a neighbour may store into this shard until its last step."""
        if self.device.type == "cpu" or self.base is None:
            return
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)  # a copy out of the shard may be queued
            for q, b in self.mapped.items():
                _build.check(self.lib.lbm_shard_ipc_close(b), f"unmapping rank {q}'s shard")
            self.mapped = {}
            if self.world > 1:
                import torch.distributed as dist

                dist.barrier(group=self.group)  # no process maps this shard any more
            _build.check(self.lib.lbm_shard_ipc_free(self.base), "freeing the shard")
        self.base = None


def check_mappable(everyone) -> None:
    """Raise unless every rank can map its previous and next rank's memory
    (``everyone``: per rank its host, card index and card id): one host,
    and the same card or a card with peer access to it."""
    world = len(everyone)
    for r, me in enumerate(everyone):
        for q in sorted({(r - 1) % world, (r + 1) % world} - {r}):
            them = everyone[q]
            if me["host"] != them["host"]:
                raise RuntimeError(f"ranks {r} and {q} run on different hosts ({me['host']}, "
                                   f"{them['host']}): CUDA IPC maps memory between the "
                                   "processes of one host only, and K12 stores into its "
                                   "neighbours' shards")
            if me["card"] != them["card"] and not torch.cuda.can_device_access_peer(
                    me["device"], them["device"]):
                raise RuntimeError(f"rank {r}'s card cuda:{me['device']} has no peer access to "
                                   f"rank {q}'s card cuda:{them['device']}: K12 stores into its "
                                   "neighbours' shards")
