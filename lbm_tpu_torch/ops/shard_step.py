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
"""

from __future__ import annotations

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


def shard_step_plain(padded, nob_padded, r0, ny, w1a, w2a, omega, paired="fused"):
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
    relaxed, u_sq = bgk_relax(t, omega, paired=paired)
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


def run_shard_step_plain(shards, nob_shards, density, accel, omega, n_steps, ny,
                         paired="fused", dev=None):
    """``n_steps`` of ``shard_step_plain`` on every shard, the rings rebuilt
    from the neighbours between steps; with ``dev`` (c16) each step between
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
                                              w2a, float(omega), paired)
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


def _run_kernel(shards, nob_shards, density, accel, omega, n_steps, ny, paired, overlap, what,
                dev):
    check_mesh(shards, nob_shards, n_steps, ny, dev)
    if not (isinstance(paired, str) and paired.startswith("fused")):
        raise ValueError("the CUDA shard kernels implement the fused collision form only")
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
    codec = _build.codec(dev)
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
                                   2 if overlap else 1, int(t == 0), *scalars, codec, stream)
        _build.check(rc, what)

    issue(runs, near, n_steps, call)
    final = [bufs[n_steps % 2, z, :, 1:-1, cells] for (bufs, *_), (_, count, _) in zip(state, runs)
             for z in range(count)]
    device = flat[0].device
    sums = torch.cat([av.to(device) for _, _, av, _, _ in state])
    return [[final[i * px + j] for j in range(px)] for i in range(py)], sums


def _dispatch(shards, nob_shards, density, accel, omega, n_steps, ny, paired, overlap, what,
              dev=None):
    device = shards[0][0].device
    if device.type == "cpu":
        return run_shard_step_plain(shards, nob_shards, density, accel, omega, n_steps, ny,
                                    paired, dev)
    if device.type != "cuda":
        raise ValueError(f"no shard kernel for device {device}")
    return _run_kernel(shards, nob_shards, density, accel, omega, n_steps, ny, paired, overlap,
                       what, dev)


def run_shard_step(shards, nob_shards, density, accel, omega, n_steps, ny, *, paired="fused",
                   dev=None):
    """``n_steps`` fused steps of a mesh of shards: kernel K3 on CUDA,
    ``run_shard_step_plain`` on CPU. Returns ``(shards, sums)``, the raw
    per-shard sums ``(py*px, n_steps)`` on the first shard's device. The
    input shards are left unchanged; the returned ones may be views of one
    buffer. ``dev``: c16 storage (int16 shards)."""
    out = _dispatch(shards, nob_shards, density, accel, omega, n_steps, ny, paired, False,
                    "shard step kernel", dev)
    if shards[0][0].device.type == "cuda":
        count_launches(run_shard_step, n_steps, dev)
    return out


def run_shard_overlap(shards, nob_shards, density, accel, omega, n_steps, ny, *,
                      paired="fused"):
    """``run_shard_step``'s function with kernel K12 on CUDA: each shard's
    edge cells are stored into the rings that read them by the kernel
    itself. Its plain version is ``run_shard_step_plain``."""
    out = _dispatch(shards, nob_shards, density, accel, omega, n_steps, ny, paired, True,
                    "shard overlap kernel", None)
    if shards[0][0].device.type == "cuda":
        run_shard_overlap.launches += n_steps
    return out


run_shard_step.launches = 0  # mesh steps K3 advanced in this process
run_shard_step.launches_c16 = 0  # mesh steps K3 advanced at c16
run_shard_overlap.launches = 0  # mesh steps K12 advanced in this process
