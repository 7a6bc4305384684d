"""A 1-D row mesh across processes (counterpart of
``lbm_tpu/parallel/multihost.py``).

The JAX package spans a pod slice with ``jax.distributed``: every process
feeds its shards and the sharded loop's halo ppermutes become
cross-process collectives. PyTorch runs one process per card
(``torchrun``), and the one-process mesh (``parallel/sharded.py``) reads
its neighbours' cells through addresses in its own process, which another
process's shard does not give until it is mapped into this one. Here each
process owns one row shard:

- ``initialize_multihost`` joins the processes in a ``torch.distributed``
  group over gloo, from explicit arguments or ``torchrun``'s variables
  (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with
  neither, the world is this process alone.
- ``run_simulation_multihost``: rank ``r`` of ``W`` owns global rows
  ``[r*ny/W, (r+1)*ny/W)`` on its device (default ``cuda:$LOCAL_RANK``).
  The route is ``pick_shard_step``'s: ``auto``/``pallas`` K3, ``band`` K8,
  ``band2`` K10 (the ``n % T`` remainder on K3), ``reference`` the plain
  step of ``lbm_step_sharded_2d``, ``pallas-overlap`` K12; on the CPU the
  plain versions. Before each step (K3, reference) or pass (K8, K10) a
  process sends its first and last rows (1 row, or T) to the previous and
  the next process and receives theirs (``RowExchange``); the shard
  objects of the ops (``shard_step.RowShard``,
  ``band_common.BandRowShard``) take them. K12 (``shard_step.IpcRowShard``)
  swaps no rows: each process maps its neighbours' shards with CUDA IPC,
  the kernel stores its edge cells into their rings, and the steps are
  ordered by waits on the streams; no row passes through the host and no
  collective runs between steps.
- Which channel carries the rows is decided by the layout and the route,
  not by a fallback: ``ipc`` for K12 on CUDA (ranks that cannot map each
  other's memory raise), ``nccl`` when every process has its own card (on
  the card's stream, no host copy), ``gloo`` staged through the host when
  processes share a card (NCCL refuses two ranks on one device) or run on
  the CPU (K12's plain version too). The start-up check (same inputs,
  devices of one kind), K12's handles and the gathers run on gloo.
- At bf16, K12 steps the f32 values between one cast in and one rounding
  out, as the one-process runner does (the JAX package's ``init_state``).
- The per-step sums: every process's raw sums are gathered to every
  process and added in rank order, then multiplied by ``inv_tot_cells``
  (``sharded.mesh_totals``), so the series is the one-process mesh's bit
  for bit; so is the state, gathered to every process. Every process
  returns the same full result.

Refused, as in the JAX package: c16 storage (every route, K12's too),
the single-device backends, checkpoints (the CLI) and a 2-D mesh (the JAX
multi-process path is 1-D only).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import socket
import time

import numpy as np
import torch

from lbm_tpu_torch.models.d2q9 import D2Q9, LBMParams
from lbm_tpu_torch.ops import devspace
from lbm_tpu_torch.ops.reference import collide
from lbm_tpu_torch.ops.shard_step import (IpcRowShard, RowExchange, RowShard, gather_objects,
                                          ring_from_rows)
from lbm_tpu_torch.parallel.sharded import (_accelerate_local, _stream_local_2d, mesh_totals,
                                            pick_shard_step)
from lbm_tpu_torch.runtime.driver import SimulationResult, is_c16, storage_spec


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Join this process to the group of a multi-process run (gloo).

    Explicit arguments first; the environment fills the gaps with
    ``torchrun``'s names: ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``. With neither, returns without a group: a one-process world. A
    configuration that lacks one of the three raises ``ValueError``, as
    does a malformed variable; a configured join that fails raises. Once
    joined, a second call does nothing."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{int(env['MASTER_PORT'])}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None and process_id is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs a coordinator address (MASTER_ADDR and "
                         "MASTER_PORT), a process count (WORLD_SIZE) and a process id (RANK)")
    dist.init_process_group(backend="gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def world() -> tuple[int, int]:
    """``(rank, world size)`` of this process: ``(0, 1)`` without a group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_device() -> torch.device:
    """The default device of this process: ``cuda:$LOCAL_RANK`` (0 when
    unset), selected as ``--device`` selects (no card raises)."""
    from lbm_tpu_torch.runtime.device import select_device

    return select_device(int(os.environ.get("LOCAL_RANK", "0")))


def _gloo_group():
    """The group of every process over gloo (None without a group): the
    default one that ``initialize_multihost`` makes, or a new one where the
    caller joined over another backend."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return None
    return dist.group.WORLD if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")


def _all_gather(x: torch.Tensor, group, world_size: int) -> list[torch.Tensor]:
    """Every process's CPU tensor ``x`` (one shape on all), in rank order,
    over gloo; 16-bit floats travel as their bits."""
    import torch.distributed as dist

    if world_size == 1:
        return [x]
    wire = x.view(torch.int16) if x.dtype in (torch.bfloat16, torch.float16) else x
    out = [torch.empty_like(wire) for _ in range(world_size)]
    dist.all_gather(out, wire.contiguous(), group=group)
    return [o.view(x.dtype) for o in out]


class ReferenceRowShard:
    """``lbm_step_sharded_2d`` on shard ``r0 // ry`` of a 1-D row mesh, one
    shard per process, in plain PyTorch on any device (the JAX package's
    jnp sharded step): ``edges()`` forces the shard (the owner of row ny-2
    only) and gives its first and last forced row; the ring takes the
    neighbours' forced rows. The protocol of ``shard_step.RowShard``;
    ``sums`` in the state's type."""

    def __init__(self, cells, obst, r0, ny, density, accel, omega, n_steps):
        self.cells, self.obst, self.r0, self.ny = cells, obst, r0, ny
        self.scalars = (density, accel, omega)
        self.rows = torch.empty((2, 9, 1, cells.shape[2]), dtype=cells.dtype, device=cells.device)
        self.sums = torch.empty(n_steps, dtype=cells.dtype, device=cells.device)
        self.t = 0
        self.forced = None

    def state(self):
        return self.cells

    def edges(self):
        density, accel, _ = self.scalars
        self.forced = _accelerate_local(self.cells, self.obst, density, accel, self.ny, self.r0)
        return self.forced[:, :1], self.forced[:, -1:]

    def halos(self):
        return self.rows[0], self.rows[1]

    def step(self) -> None:
        padded = ring_from_rows(self.forced, self.rows[0], self.rows[1])
        self.cells, tot = collide(_stream_local_2d(padded), self.obst, self.scalars[2])
        self.sums[self.t] = tot
        self.t += 1


@dataclasses.dataclass
class MultihostResult(SimulationResult):
    """A ``SimulationResult`` (the same on every process) and the process's
    place in the run: its rank, the world size and the rows' channel."""

    rank: int = 0
    world: int = 1
    channel: str = "local"


def _setup_digest(params, obstacles, backend, dtype) -> str:
    h = hashlib.sha256(repr((params, backend, str(dtype))).encode())
    h.update(np.ascontiguousarray(obstacles).tobytes())
    return h.hexdigest()


def _layout(rank, world_size, device, setup, group, ipc) -> tuple[str, list]:
    """The channel of the rows from every process's host, device and
    inputs (gathered on gloo); raises if the inputs differ or the devices
    are not all CUDA or all CPU. ``ipc``: the route is K12, whose shards
    map each other's memory on CUDA (``ipc``) and swap rows over gloo on
    the CPU."""
    me = {"rank": rank, "host": socket.gethostname(), "device": str(device), "setup": setup}
    everyone = gather_objects(me, group, world_size)
    if len({p["setup"] for p in everyone}) != 1:
        raise ValueError("the processes of a multi-process run were given different decks, "
                         "backends or precisions")
    kinds = {torch.device(p["device"]).type for p in everyone}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a multi-process mesh runs on CUDA devices or on the CPU, not on "
                         f"{sorted(kinds)}")
    if world_size == 1:
        return "local", everyone
    if ipc and kinds == {"cuda"}:
        return "ipc", everyone
    own_card = len({(p["host"], p["device"]) for p in everyone}) == world_size
    return ("nccl" if kinds == {"cuda"} and own_card else "gloo"), everyone


def run_simulation_multihost(params: LBMParams, obstacles: np.ndarray, *, backend: str = "auto",
                             dtype=None, device=None) -> MultihostResult:
    """Run ``params.max_iters`` steps over a 1-D row mesh of every process
    of the group (``initialize_multihost`` first; without a group, a mesh
    of one), one shard per process on ``device`` (default
    ``local_device()``). Every process calls it with the same params,
    obstacles, backend and dtype, and every process returns the same full
    result. ``dtype`` None is f32; c16 raises."""
    import torch.distributed as dist

    if is_c16(dtype):
        raise ValueError("c16 storage is not supported on the multi-process path yet")
    dtype = torch.float32 if dtype is None else dtype
    rank, world_size = world()
    if params.ny % world_size != 0:
        raise ValueError(f"ny={params.ny} not divisible by {world_size} processes")
    route, cfg = pick_shard_step(params, world_size, backend, dtype)
    obstacles = np.asarray(obstacles)
    if obstacles.shape != (params.ny, params.nx):
        raise ValueError(f"obstacle mask {obstacles.shape} != grid ({params.ny}, {params.nx})")
    device = local_device() if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    group = _gloo_group()
    channel, everyone = _layout(rank, world_size, device,
                                _setup_digest(params, obstacles, backend, dtype), group,
                                ipc=route == "pallas-overlap")
    rows_group = None
    if channel == "nccl":
        torch.cuda.set_device(device)
        rows_group = dist.new_group(backend="nccl")  # every process decided alike

    spec = storage_spec(params, dtype)
    full = D2Q9.initial_state(params, dtype=torch.float32 if spec is not None else dtype)
    if spec is not None:
        full = devspace.encode_state(full, spec)
    ry, ny = params.ny // world_size, params.ny
    r0 = rank * ry
    cells = full[:, r0:r0 + ry].to(device).contiguous()
    obst = torch.as_tensor((obstacles != 0).astype(np.int32))
    nob = (obst == 0).to(torch.float32)
    tot_cells = int(np.sum(obstacles == 0))
    inv_np = np.asarray(1.0 / tot_cells, dtype=np.float64 if dtype == torch.float64 else np.float32)
    scalars = (params.density, params.accel, params.omega)

    def rows(x, lo, n):
        """Rows ``[lo, lo + n)`` of a global plane, wrapped, on the device."""
        return x[torch.arange(lo, lo + n) % ny].to(device).contiguous()

    nob_ring = ring_from_rows(rows(nob, r0, ry)[None], rows(nob, r0 - 1, 1)[None],
                              rows(nob, r0 + ry, 1)[None])[0]

    def k3(state, n):
        return RowShard(state, nob_ring, rank, world_size, ny, *scalars, n, dev=spec)

    t0 = time.perf_counter()
    if route != "reference" and device.type == "cuda":
        from lbm_tpu_torch.ops import _build

        _build.library()  # build or load before the timed loop
    compile_time = time.perf_counter() - t0

    def drive(shard, n):
        for _ in range(n):
            first, last = shard.edges()
            exchange(first, last, *shard.halos())
            shard.step()
        return shard

    n_iters = params.max_iters
    ipc = None
    if route == "pallas-overlap":
        # K12 stores f32: at bf16 the run steps the f32 values between one
        # cast in and one rounding out, as the one-process runner does.
        # Set-up (the allocation, the handles swapped and mapped) is not timed.
        ipc = IpcRowShard(cells if spec is None else devspace.decode_state(cells, spec),
                          nob_ring, rank, world_size, ny, *scalars, n_iters, group=group)
    else:
        exchange = RowExchange(rank, world_size, channel,
                               rows_group if channel == "nccl" else group)
        # One swap outside the timed loop: NCCL builds its communicator at
        # the first operation (seconds), gloo its pair connections.
        probe = torch.zeros((4, 9, 1, params.nx), dtype=cells.dtype, device=device)
        exchange(*probe)
    if group is not None:
        dist.barrier(group=group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.profiler.record_function("lbm_tpu_torch.loop"):
        if ipc is not None:
            ipc.run(n_iters)
            shards = [ipc]
        elif route == "reference":
            shards = [drive(ReferenceRowShard(cells, rows(obst, r0, ry), r0, ny, *scalars,
                                              n_iters), n_iters)]
        elif route == "pallas":
            shards = [drive(k3(cells, n_iters), n_iters)]
        else:
            from lbm_tpu_torch.ops import band, band2

            block, depth, panel = cfg
            npasses, rem = divmod(n_iters, depth)
            shards = []
            if npasses:
                make = band.row_shard if route == "band" else band2.row_shard
                shards.append(drive(make(cells, rows(nob, r0, ry), rows(nob, r0 - depth, depth),
                                         rows(nob, r0 + ry, depth), rank, world_size, ny,
                                         *scalars, block, depth, panel, npasses, dev=spec),
                                    npasses))
                cells = shards[-1].state()
            if rem:
                shards.append(drive(k3(cells, rem), rem))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0

    if rows_group is not None:
        dist.destroy_process_group(rows_group)
    sums = torch.cat([s.sums for s in shards]).cpu()
    av = mesh_totals(torch.stack(_all_gather(sums, group, world_size)), inv_np)
    state = shards[-1].state()
    if ipc is not None:
        ipc.close()  # after the state is read: every process takes part
        state = state if spec is None else devspace.encode_state(state, spec)
    state = state if spec is None else devspace.decode_state(state, spec)
    cells_np = torch.cat(_all_gather(state.cpu().contiguous(), group, world_size), dim=1).numpy()
    return MultihostResult(
        cells=cells_np,
        av_vels=av.numpy(),
        elapsed=elapsed,
        compile_time=compile_time,
        route=route,
        device=str(device),
        shard_devices=tuple(p["device"] for p in everyone),
        rank=rank,
        world=world_size,
        channel=channel,
    )


def rank_reports(result: MultihostResult) -> list[dict]:
    """What every process ran (a collective: every process calls it): its
    rank, device, channel, the launch counts of the kernels of this
    process and a digest of its result. Equal digests show that every
    process holds the same result."""
    from lbm_tpu_torch.ops.band import run_band_sharded
    from lbm_tpu_torch.ops.band2 import run_band2_sharded

    h = hashlib.sha256(np.ascontiguousarray(result.av_vels).tobytes())
    h.update(np.ascontiguousarray(result.cells).tobytes())
    launches = {}
    for name, fn in (("K3 rows", RowShard), ("K8", run_band_sharded), ("K10", run_band2_sharded)):
        for suffix in ("", "_bf16"):
            launches[name + suffix.replace("_", " ")] = getattr(fn, "launches" + suffix)
    launches["K12 ipc"] = IpcRowShard.launches  # f32 steps, at bf16 too
    me = {"rank": result.rank, "device": result.device, "channel": result.channel,
          "launches": launches, "result_sha256": h.hexdigest()}
    return gather_objects(me, _gloo_group(), result.world)
