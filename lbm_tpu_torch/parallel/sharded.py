"""Domain decomposition over a mesh of devices (counterpart of
``lbm_tpu/parallel/sharded.py``).

The JAX package drives every shard from one process through ``shard_map``
over a mesh of devices. So does the port, with no collective library: a
mesh is a ``py x px`` grid of ``torch.device``s in one process, and one
device may repeat. ``--mesh 4 --device 0`` puts four shards on one card,
``--mesh 4 --device cpu`` four on the host, and ``--mesh 4`` alone takes
the first four cards.

- Shard ``(i, j)`` owns global rows ``[i*ry, (i+1)*ry)`` and columns
  ``[j*rx, (j+1)*rx)`` of all 9 planes (``split``, ``gather``); ``ny % py``
  and ``nx % px`` must be 0.
- ``--backend reference`` runs ``lbm_step_sharded_2d`` (a 1-D mesh is its
  ``px = 1`` case, x wrapping within each shard): the forcing by
  the owner of global row ny-2 through a global-row mask, streaming that
  splices in the neighbours' edge rows, columns and corners, the BGK
  collision of ``ops/reference.py``.
- ``pallas`` and ``auto`` run the shard step K3 (``ops/shard_step.py``),
  ``pallas-overlap`` K12 (1-D meshes), ``band`` and ``band2`` K8 and K10
  (``ops/band.py``, ``ops/band2.py``; 1-D meshes, T steps per pass, the
  neighbours' T edge rows exchanged once per pass, the ``n % T`` remainder
  on K3). On an explicit CPU each runs its plain version.
- The loop is a Python loop over chunks (``compute_chunk_sizes``); each
  chunk runs every shard's steps and the exchanges. The per-step total is
  the sum of the shards' raw per-step sums in shard-index order, then
  multiplied by ``inv_tot_cells`` in the state's float type, as JAX's
  ``psum`` and multiply; no float atomics, so two runs give equal bits.
- The state is gathered to the host and saved with
  ``runtime/checkpoint.py`` after each chunk when checkpointing.
- ``dtype="c16"`` (``ops/devspace.py``, the JAX package's
  ``run_simulation_sharded(_2d)(dtype="c16")``): the state is encoded on
  upload and every shard holds int16 codes; checkpoints and the result
  hold the decoded f32 state, and one saturation check covers the largest
  code of every shard. On a 1-D mesh ``auto``/``pallas`` run K3 at c16,
  ``band``/``band2`` K8/K10 at c16 and ``reference`` the plain c16 step
  (``lbm_step_sharded_c16``); on a 2-D mesh ``auto`` and ``reference`` run
  that plain step and ``pallas`` raises, as the JAX package's 2-D mesh
  has no c16 kernel; ``pallas-overlap`` raises at c16.

A backend that names a kernel never runs something else. The JAX package
quietly runs its jnp step for ``band3`` under a 1-D mesh and for ``band2``
or ``band3`` on a 2-D mesh; the port raises instead.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from lbm_tpu_torch.models.d2q9 import CX, CY, D2Q9, LBMParams
from lbm_tpu_torch.ops import devspace
from lbm_tpu_torch.ops.collision import paired_default
from lbm_tpu_torch.ops.reference import collide
from lbm_tpu_torch.ops.shard_step import sync, with_ring
from lbm_tpu_torch.runtime.device import list_devices
from lbm_tpu_torch.runtime.driver import (SimulationResult, compute_chunk_sizes, is_c16,
                                          warn_saturation)

# Backends the single-device driver runs and a mesh refuses.
SINGLE_DEVICE_BACKENDS = ("resident", "aa", "temporal", "deep", "slab")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``py x px`` grid of devices, ``devices[i][j]`` holding shard (i, j)."""

    devices: tuple

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def flat(self) -> list[torch.device]:
        return [d for row in self.devices for d in row]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the row axis: the given ``devices`` (a device may
    repeat), else the first ``n_devices`` cards (all of them for None)."""
    if devices is None:
        devices = list_devices()
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"requested {n_devices} devices, only {len(devices)} available")
            devices = devices[:n_devices]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple((d,) for d in devices))


def make_mesh_2d(py: int, px: int, devices=None) -> Mesh:
    """A ``py x px`` mesh, rows over ``py`` devices and columns over ``px``:
    the first ``py * px`` of ``devices`` (default: the cards)."""
    devices = list_devices() if devices is None else [torch.device(d) for d in devices]
    if py < 1 or px < 1:
        raise ValueError(f"bad mesh {py}x{px}")
    if py * px > len(devices):
        raise ValueError(f"requested {py}x{px} mesh, only {len(devices)} devices")
    return Mesh(tuple(tuple(devices[i * px:(i + 1) * px]) for i in range(py)))


def split(x: torch.Tensor, mesh: Mesh):
    """A ``(C, ny, nx)`` or ``(ny, nx)`` tensor cut into the mesh's shards,
    each contiguous on its device."""
    py, px = mesh.shape
    ry, rx = x.shape[-2] // py, x.shape[-1] // px
    return [[x[..., i * ry:(i + 1) * ry, j * rx:(j + 1) * rx].to(mesh.devices[i][j]).contiguous()
             for j in range(px)] for i in range(py)]


def gather(shards) -> torch.Tensor:
    """The full tensor of a mesh of shards, on the host."""
    return torch.cat([torch.cat([s.cpu() for s in row], dim=-1) for row in shards], dim=-2)


def _accelerate_local(cells, obstacles, density, accel, ny_global, row_offset):
    """Row-(ny-2) forcing (kernels.cl:7-42) applied by whichever shard owns
    that global row, through a global-row mask."""
    dtype = cells.dtype
    rows = torch.arange(cells.shape[1], device=cells.device)[:, None] + row_offset
    row_mask = (rows == ny_global - 2).to(dtype)
    w1 = torch.tensor(density * accel / 9.0, dtype=dtype, device=cells.device)
    w2 = torch.tensor(density * accel / 36.0, dtype=dtype, device=cells.device)
    free = (obstacles == 0).to(dtype)
    ok = ((cells[3] - w1 > 0.0) & (cells[6] - w2 > 0.0) & (cells[7] - w2 > 0.0)).to(dtype)
    m = free * ok * row_mask
    zero = torch.zeros_like(m)
    return cells + torch.stack([zero, w1 * m, zero, -w1 * m, zero, w2 * m, -w2 * m, -w2 * m,
                                w2 * m])


def _stream_local_2d(padded):
    """Pull streaming of one shard from its forced state inside a ring of
    its neighbours' forced edge cells (``(9, ry+2, rx+2)``)."""
    ry, rx = padded.shape[1] - 2, padded.shape[2] - 2
    return torch.stack([padded[k, 1 - CY[k]:1 - CY[k] + ry, 1 - CX[k]:1 - CX[k] + rx]
                        for k in range(9)])


def lbm_step_sharded_2d(shards, obst_shards, density, accel, omega, ny_global):
    """One timestep of every shard of a mesh (1-D: ``px = 1``): forcing by the owner of
    global row ny-2, streaming across the shard edges, collision. Returns
    the new shards and the raw per-shard sums of ``nobst * |u|`` as one
    ``(py*px,)`` tensor on the first shard's device."""
    py, px = len(shards), len(shards[0])
    ry = shards[0][0].shape[1]
    forced = [[_accelerate_local(shards[i][j], obst_shards[i][j], density, accel, ny_global,
                                 i * ry) for j in range(px)] for i in range(py)]
    padded = with_ring(forced)
    new, sums = [], []
    for i in range(py):
        row = []
        for j in range(px):
            cells, tot = collide(_stream_local_2d(padded[i][j]), obst_shards[i][j], omega)
            row.append(cells)
            sums.append(tot.to(shards[0][0].device))
        new.append(row)
    return new, torch.stack(sums)


def lbm_step_sharded_c16(shards, obst_shards, density, accel, omega, ny_global, spec):
    """``lbm_step_sharded_2d`` on c16 shards: decode, step, encode (one
    rounding per step), the JAX package's ``make_sharded_c16_jnp_step`` and
    ``make_sharded_c16_jnp_step_2d``. It is plain PyTorch on every device by
    design: the JAX package computes this step outside any Pallas kernel
    (its 2-D mesh has no c16 kernel), so plain torch ops are its
    counterpart, not a kernel's plain version standing in for a kernel."""
    full = [[devspace.decode_state(s, spec) for s in row] for row in shards]
    new, sums = lbm_step_sharded_2d(full, obst_shards, density, accel, omega, ny_global)
    return [[devspace.encode_state(c, spec) for c in row] for row in new], sums


def mesh_totals(sums: torch.Tensor, inv_tot_cells) -> torch.Tensor:
    """Per-step totals of the raw per-shard sums ``(nshards, n)``: added in
    shard-index order, then multiplied by ``inv_tot_cells`` in their type."""
    tot = sums[0]
    for z in range(1, sums.shape[0]):
        tot = tot + sums[z]
    return tot * torch.as_tensor(inv_tot_cells, dtype=sums.dtype, device=sums.device)


def _storage(dtype):
    """The storage of a run (a torch dtype or ``"c16"``), or raise for one
    not ported."""
    if dtype is None:
        return torch.float32
    if is_c16(dtype):
        return dtype
    if dtype in (torch.bfloat16, torch.int16):
        raise ValueError(f"{dtype} storage under a mesh is not yet ported; use f32, f64 or "
                         "c16")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}; use float32, float64 or 'c16'")
    return dtype


def pick_shard_step(params: LBMParams, mesh, backend: str, dtype):
    """Resolve ``backend`` on a mesh (an int: a 1-D mesh of that many row
    shards; a ``(py, px)`` pair: a 2-D mesh) to ``(route, schedule)``: route
    ``reference``, ``pallas`` (K3), ``pallas-overlap`` (K12), ``band`` (K8)
    or ``band2`` (K10), schedule ``(block, depth, panel)`` of the band
    routes from the single-device picker. Refusals raise ``ValueError``
    with the JAX package's wording. At c16 every route but
    ``pallas-overlap`` takes the codes on a 1-D mesh; a 2-D mesh runs the
    plain c16 step (``reference``)."""
    from lbm_tpu_torch.runtime.driver import BACKENDS, band2_config, band_config

    two_d = isinstance(mesh, tuple)
    py, px = mesh if two_d else (mesh, 1)
    dtype = _storage(dtype)
    if backend not in BACKENDS + ("pallas-overlap",):
        raise ValueError(f"unknown backend {backend!r}")
    if backend in SINGLE_DEVICE_BACKENDS:
        if two_d:
            raise ValueError(f"{backend} backend is single-device only; use --backend "
                             "auto/pallas/reference with a 2-D mesh")
        raise ValueError(f"{backend} backend is single-device only; use --backend "
                         "auto/pallas/pallas-overlap/band/band2/reference with --mesh")
    if two_d and backend == "pallas-overlap":
        raise ValueError("pallas-overlap (in-kernel RDMA halo exchange) is 1-D-mesh only")
    if two_d and backend == "band":
        raise ValueError("band backend is single-device or 1-D-mesh only; use --backend "
                         "auto/pallas/reference with a 2-D mesh")
    if two_d and backend in ("band2", "band3"):
        raise ValueError(f"{backend} backend has no 2-D-mesh kernel; use --backend "
                         "auto/pallas/reference with a 2-D mesh")
    if backend == "band3":
        raise ValueError("band3 backend has no sharded kernel; use --backend "
                         "auto/pallas/pallas-overlap/band/band2/reference with --mesh")
    if is_c16(dtype):
        if backend == "pallas-overlap":
            raise ValueError("pallas-overlap does not support c16 storage yet")
        if two_d:
            if backend == "pallas":
                raise ValueError("2-D-mesh pallas backend is f32-only")
            return "reference", None
    if backend == "reference" or (backend == "auto" and dtype == torch.float64):
        return "reference", None
    rows, cols = params.ny // py, params.nx // px
    if dtype == torch.float64:
        if two_d:
            raise ValueError("2-D-mesh pallas backend is f32-only")
        raise ValueError(f"sharded {backend} backend stores f32/bf16/c16 only; use "
                         "--precision f32/bf16/c16" + (" or the jnp step for f64"
                                                       if backend.startswith("pallas") else ""))
    if backend in ("auto", "pallas", "pallas-overlap"):
        if params.ny < 2:
            raise ValueError(f"local grid {rows}x{cols} does not fit the pallas kernel's "
                             "tiling constraints")
        return ("pallas" if backend == "auto" else backend), None
    from lbm_tpu_torch.ops.band import band_supported
    from lbm_tpu_torch.ops.band2 import band2_supported

    supported = band_supported if backend == "band" else band2_supported
    cfg = (band_config if backend == "band" else band2_config)(params, dtype)
    if not (cfg[1] <= rows and supported(rows, cols, *cfg)):
        alt = "pallas" if backend == "band" else "band/pallas"
        raise ValueError(f"local grid {rows}x{cols} unsupported by the {backend} kernel; use "
                         f"--backend {alt} or fewer shards")
    return backend, tuple(cfg)


def _run(params, obstacles, mesh, two_d, backend, dtype, initial_cells, start_step,
         av_vels_prefix, checkpoint_every, checkpoint_path, checkpoint_format):
    route, cfg = pick_shard_step(params, mesh.shape if two_d else mesh.size, backend, dtype)
    if checkpoint_format != "npz":
        raise ValueError("orbax checkpoints are JAX-only (lbm_tpu); use checkpoint_format='npz'")
    kinds = {d.type for d in mesh.flat}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh runs on CUDA devices or on the CPU, not on {sorted(kinds)}")
    obstacles = np.asarray(obstacles)
    if obstacles.shape != (params.ny, params.nx):
        raise ValueError(f"obstacle mask {obstacles.shape} != grid ({params.ny}, {params.nx})")
    if start_step >= params.max_iters:
        raise ValueError("start_step is beyond max_iters")
    dtype = _storage(dtype)
    spec = devspace.DevSpec.for_params(params.density, params.accel) if is_c16(dtype) else None
    full_dtype = torch.float32 if spec is not None else dtype
    if initial_cells is None:
        full = D2Q9.initial_state(params, dtype=full_dtype)
    else:
        full = torch.as_tensor(np.asarray(initial_cells)).to(full_dtype)
    if spec is not None:
        full = devspace.encode_state(full, spec)  # the rest state encodes to 0
    obst = torch.as_tensor((obstacles != 0).astype(np.int32))
    shards = split(full, mesh)
    obst_shards = split(obst, mesh)
    nob_shards = split((obst == 0).to(torch.float32), mesh)
    tot_cells = int(np.sum(obstacles == 0))
    inv_np = np.asarray(1.0 / tot_cells, dtype=np.float64 if dtype == torch.float64 else np.float32)
    paired = paired_default()
    scalars = (params.density, params.accel, params.omega)
    kw = dict(paired=paired) if spec is None else dict(paired=paired, dev=spec)

    def advance(shards, n):
        if route == "reference":
            sums = []
            for _ in range(n):
                if spec is None:
                    shards, s = lbm_step_sharded_2d(shards, obst_shards, *scalars, params.ny)
                else:
                    shards, s = lbm_step_sharded_c16(shards, obst_shards, *scalars, params.ny,
                                                     spec)
                sums.append(s)
            return shards, torch.stack(sums, dim=1)
        if route in ("band", "band2"):
            from lbm_tpu_torch.ops.band import run_band_sharded
            from lbm_tpu_torch.ops.band2 import run_band2_sharded

            run = run_band_sharded if route == "band" else run_band2_sharded
            block, depth, panel = cfg
            return run(shards, nob_shards, *scalars, n, block, depth, params.ny, panel=panel,
                       **kw)
        from lbm_tpu_torch.ops.shard_step import run_shard_overlap, run_shard_step

        run = run_shard_overlap if route == "pallas-overlap" else run_shard_step
        return run(shards, nob_shards, *scalars, n, params.ny, **kw)

    def as_full(shards):
        """The host's view of the state: c16 codes decode to f32."""
        if spec is not None:
            shards = [[devspace.decode_state(s, spec) for s in row] for row in shards]
        return gather(shards).numpy()

    t0 = time.perf_counter()
    if route != "reference" and "cuda" in kinds:
        from lbm_tpu_torch.ops import _build

        _build.library()  # build or load before the timed loop
    compile_time = time.perf_counter() - t0

    av_chunks = [] if av_vels_prefix is None else [np.asarray(av_vels_prefix)]
    elapsed = 0.0
    step = start_step
    for n in compute_chunk_sizes(start_step, params.max_iters, checkpoint_every):
        sync(mesh.flat)
        t0 = time.perf_counter()
        shards, sums = advance(shards, n)
        av = mesh_totals(sums, inv_np)
        sync(mesh.flat)
        elapsed += time.perf_counter() - t0
        av_chunks.append(av.cpu().numpy())
        step += n
        if checkpoint_path is not None and checkpoint_every:
            from lbm_tpu_torch.runtime.checkpoint import save_checkpoint

            # c16 checkpoints hold the decoded f32 state, as on one device.
            save_checkpoint(checkpoint_path, params, as_full(shards), np.concatenate(av_chunks),
                            step)
    if spec is not None:
        warn_saturation(max(devspace.max_abs_code(s) for row in shards for s in row), spec)
    devices = [str(d) for d in mesh.flat]
    return SimulationResult(
        cells=as_full(shards),
        av_vels=np.concatenate(av_chunks),
        elapsed=elapsed,
        compile_time=compile_time,
        route=route,
        device=",".join(dict.fromkeys(devices)),
        shard_devices=tuple(devices),
    )


def run_simulation_sharded(
    params: LBMParams,
    obstacles: np.ndarray,
    *,
    n_devices: int | None = None,
    devices=None,
    backend: str = "auto",
    dtype=torch.float32,
    initial_cells: np.ndarray | None = None,
    start_step: int = 0,
    av_vels_prefix: np.ndarray | None = None,
    checkpoint_every: int = 0,
    checkpoint_path: str | None = None,
    checkpoint_format: str = "npz",
) -> SimulationResult:
    """Run steps ``start_step .. params.max_iters`` over a 1-D row mesh
    (``make_mesh(n_devices, devices)``); ``ny`` must divide by its size.
    Checkpoint and resume as ``runtime/driver.py::run_simulation``."""
    mesh = make_mesh(n_devices, devices)
    if params.ny % mesh.size != 0:
        raise ValueError(f"ny={params.ny} not divisible by {mesh.size} devices")
    return _run(params, obstacles, mesh, False, backend, dtype, initial_cells, start_step,
                av_vels_prefix, checkpoint_every, checkpoint_path, checkpoint_format)


def run_simulation_sharded_2d(
    params: LBMParams,
    obstacles: np.ndarray,
    *,
    mesh_shape: tuple[int, int],
    devices=None,
    backend: str = "auto",
    dtype=torch.float32,
    initial_cells: np.ndarray | None = None,
    start_step: int = 0,
    av_vels_prefix: np.ndarray | None = None,
    checkpoint_every: int = 0,
    checkpoint_path: str | None = None,
    checkpoint_format: str = "npz",
) -> SimulationResult:
    """``run_simulation_sharded`` over a 2-D ``(py, px)`` mesh
    (``make_mesh_2d``); ``ny % py`` and ``nx % px`` must be 0."""
    py, px = mesh_shape
    mesh = make_mesh_2d(py, px, devices)
    if params.ny % py != 0 or params.nx % px != 0:
        raise ValueError(f"grid {params.ny}x{params.nx} not divisible by mesh {py}x{px}")
    return _run(params, obstacles, mesh, True, backend, dtype, initial_cells, start_step,
                av_vels_prefix, checkpoint_every, checkpoint_path, checkpoint_format)
