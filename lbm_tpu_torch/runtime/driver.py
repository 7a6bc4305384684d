"""Simulation driver (counterpart of ``lbm_tpu/runtime/driver.py``).

The reference launches two kernels per step, syncs, and reads the whole
``tot_us`` buffer back to sum it on the host (d2q9-bgk.c:206-228,
408-420). Here the whole run stays on the device: the kernel routes issue
every step of the run from one C call, the per-step mean |u| is written
into an on-device ``(max_iters,)`` tensor, and nothing returns to the host
until the loop ends. The final state is the true last state.

Routes (``select_route``), as in the JAX package:

- ``auto`` at f32 -> ``resident`` (kernel K4) up to a state of
  ``_RESIDENT_AUTO_MAX_STATE`` bytes (448^2 cells), ``deep`` (kernel K6)
  above; on an explicitly chosen CPU the same routes run their plain
  versions, so the CPU tests drive the card's route;
- ``pallas`` -> the fused one-step route (kernel K1 / its plain version);
- ``band``, ``band2``, ``band3`` -> the band family (kernels K7, K9, K11 /
  their plain versions), T steps per pass on the schedule of
  ``band_config``, ``band2_config`` and ``band3_config``, the remainder on K1;
- ``resident`` -> whole-grid steps in persistent launches of
  ``resident_config`` steps (kernel K4 / its plain version);
- ``temporal``, ``deep`` -> T steps per pass on the shrinking trapezoid with
  carried row packs or halos read from the state (kernels K5, K6 / their
  plain versions), on the schedules of ``temporal_config`` and
  ``deep_config``, the remainder on K1;
- ``reference`` -> the plain step of ``ops/reference.py``;
- ``slab`` -> K*T steps per generation over y-slabs (kernel K13 / its plain
  version), the remainder on K7 and K1; quarantined as in the JAX package:
  it runs only with ``LBM_ENABLE_SLAB=1``;
- f64 -> ``reference``; an explicit kernel backend with f64 raises.

``dtype="c16"`` stores the state as int16 companded deviations
(``ops/devspace.py``; driver.py:1309-1372 of the JAX package): the state is
encoded on upload, the kernels decode and encode at their loads and
stores, checkpoints and ``result.cells`` hold the decoded f32 state, and
every c16 run ends with the saturation check (one on-device max of |code|
and one scalar fetched). ``auto`` at c16 runs ``pallas`` (K1), as the JAX
package's auto does on the official decks (its band and temporal routes
start at 1536 columns, and the resident kernel never takes c16): K1 and K2
round the codes every step and pass the 1% gate, while the T-step kernels
(K5, K6, K7, K9, K11, K13) round once per pass of T steps, as the JAX
kernels do, and that cadence drifts (1.68% on the 256^2 deck with K11 on
an H100, PERF.md; the JAX package's study of T-step rounding,
BENCHMARKS.md round 3). Every other backend takes c16 when named but
``resident``, which raises as in the JAX package: a backend that names a
kernel never runs another.

``dtype=torch.bfloat16`` stores the state as bfloat16 (``devspace.BF16``:
no codec), experimental as in the JAX package: a raw bf16 state drifts far
past the 1% gate. The state is cast on upload; the kernels widen each
value they load and round each value they store, where the JAX kernels
do (per step: K1, K2; per pass: K5-K11, K13; K11 once more after step
T-2 of its final pass, ``ops/band3.py``); the av series and
``inv_tot_cells`` stay f32; checkpoints and ``result.cells`` hold the f32
values of the bf16 state, which are exact, so a resume casts them back bit
for bit and writes the uninterrupted run's bytes. ``auto`` at bf16 runs
``aa`` (K2), as the JAX package's auto does at bf16 on the official decks
(``select_aa``); its move of states of 1 GB and up to the temporal kernel
(driver.py:924-935) is not taken: K5 rounds once per pass, another
function, and K2 has no size cap on the card (on an H100 K2 bf16 also took
21-29% less time per step than K1 bf16 at 1024^2 and 2048^2, PERF.md).
``reference`` at bf16 is the plain step on bf16 tensors, every operation
rounding in bf16 as the JAX reference step computes in the state's dtype.
Every other backend takes bf16 but ``resident``, which raises with the JAX
package's wording.

``run_simulation`` runs ``[start_step, max_iters)`` in chunks whose
boundaries fall on every multiple of ``checkpoint_every`` and of
``chunk_every``, writing a checkpoint (``runtime/checkpoint.py``) at each
multiple of ``checkpoint_every`` and calling ``on_chunk`` after every
chunk; ``elapsed`` sums the chunks' compute time only.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings

import numpy as np
import torch

from lbm_tpu_torch.models.d2q9 import D2Q9, LBMParams, obstacles_from_numpy
from lbm_tpu_torch.ops.aa import MIN_NY as AA_MIN_NY
from lbm_tpu_torch.ops import devspace
from lbm_tpu_torch.ops.collision import paired_default
from lbm_tpu_torch.ops.reference import lbm_step_reference
from lbm_tpu_torch.ops.resident import resident_supported
from lbm_tpu_torch.runtime import trace

BACKENDS = ("auto", "aa", "pallas", "reference", "band", "band2", "band3", "resident",
            "temporal", "deep", "slab")
# Routes of T steps per pass with the remainder on K1, run by ``pass_schedule``.
PASS_BACKENDS = ("band", "band2", "band3", "temporal", "deep")
KERNEL_BACKENDS = ("aa", "pallas", "resident", "slab") + PASS_BACKENDS
# The storage that names c16 (int16 companded deviations, ops/devspace.py).
C16 = "c16"


def is_c16(dtype) -> bool:
    return isinstance(dtype, str) and dtype == C16


def stored_16(dtype) -> bool:
    """Whether ``dtype`` names a 16-bit storage mode (c16 or bf16)."""
    return is_c16(dtype) or dtype == torch.bfloat16


def storage_spec(params: LBMParams, dtype):
    """The ``dev`` of a run's storage (``ops/devspace.py``): None for f32
    and f64, a ``DevSpec`` from the params for c16, ``BF16`` for bf16."""
    if is_c16(dtype):
        return devspace.DevSpec.for_params(params.density, params.accel)
    return devspace.BF16 if dtype == torch.bfloat16 else None


def _kernel_dtype(dtype) -> bool:
    """Whether the T-step kernels store ``dtype``: f32, c16 or bf16."""
    return stored_16(dtype) or dtype == torch.float32


@dataclasses.dataclass
class SimulationResult:
    cells: np.ndarray | None  # (9, ny, nx) final state (None: fetch_final=False)
    av_vels: np.ndarray  # (max_iters,) per-step mean |u| over unblocked cells
    elapsed: float  # seconds of the compute loop (kernel build excluded)
    compile_time: float  # seconds spent building or loading the kernels
    route: str = "reference"  # the route that ran: a BACKENDS name other than "auto"
    device: str = "cpu"  # the torch device the loop ran on (a mesh: its devices, comma-joined)
    shard_devices: tuple = ()  # a mesh run: the device of each shard, in shard order
    trace: trace.CallRecord | None = None  # the call's spans and counters (runtime/trace.py)

    def mlups(self, params: LBMParams) -> float:
        return params.nx * params.ny * params.max_iters / self.elapsed / 1e6

    def reynolds(self, params: LBMParams, obstacles: np.ndarray) -> float:
        """Reynolds number from the final state (d2q9-bgk.c:815-819)."""
        from lbm_tpu_torch.ops.reference import velocity_field

        obstacles = np.asarray(obstacles)
        _, _, speed, _ = velocity_field(torch.as_tensor(self.cells),
                                        torch.as_tensor(obstacles))
        free = obstacles == 0
        av = float(torch.sum(speed * torch.as_tensor(free, dtype=speed.dtype)))
        return params.reynolds(av / int(free.sum()))


# Band schedules ``(block, depth, panel)``: the tile is block rows by panel
# columns with a depth-cell halo. Tiers ((block, depth, panel), fewest
# tiles), in order: the first that the kernel takes and that cuts the grid
# into at least that many tiles (else the last the kernel takes;
# ``_tiered``).
# K7 and K9, one table for both (the same one-window body; K7 takes any T):
# a 40 x 64 window, one copy, 102 KB of shared memory; on a grid that
# gives it fewer tiles than one wave of blocks (two on each of an H100's
# 132 SMs), a 32 x 32 window. At 256^2 and 512^2 the small tiles took 33%
# and 3% less time than the large ones, at 1024^2 16% more (chip_smoke
# phase 26's K9 sweep); K7's sweep of T 3, 4, 5 and 8 (phase 28) found
# (32, 4, 56) the fastest or within 1.1% of it at 1024^2-4096^2, T 3 about
# 15% slower at 2048^2 and T 5 within 2.1% either way (PERF.md section 6).
_BAND_TIERS = (((32, 4, 56), 2 * 132), ((24, 4, 24), 0))
# K11 (its load fused into its first step, its store into its last, the
# steps between on K6's trapezoid), a window of one copy at constant
# strides. On an H100 (chip_smoke phase 32's sweep of T 4, 8 and 16 at
# 512^2-4096^2 and every storage, each candidate at constant strides,
# and the two tiers in turns in one process, PERF.md section 6): (36, 4,
# 56), a 44 x 64 window, took 4-14% less time than (24, 4, 56) at 4096^2
# (8,436 tiles) in every storage; (24, 4, 56), a 32 x 64 window, took 4-28%
# less at 1024^2 and 512^2, and at 2048^2 (3,182 tiles) was within 1% at
# f32 and 4-7% faster at c16, 3% slower at bf16.
_BAND3_TIERS = (((36, 4, 56), 4000), ((24, 4, 56), 0))
# K5 and K6 in one window copy, one table for both. On an H100 (chip_smoke
# phase 27's sweep, every candidate's window with constant strides, two
# runs, PERF.md section 6): (36, 4, 56), a 44 x 64 window of 113 KB, two
# blocks per SM, was the fastest or within 2.3% of it for both kernels
# from 1024^2 (551 tiles, two waves of two blocks on each of 132 SMs) to
# 4096^2, and took 7-9% less time than (32, 4, 40) at 1024^2; at 512^2
# (150 tiles) it took 26-27% more, and (32, 4, 40) was the fastest; at
# 256^2, where that makes under half a wave, the 32 x 32 window of
# (24, 4, 24) took 15-19% less time. The kernels are compiled with these
# windows' strides as constants (``trapezoid_schedules``, ops/_build.py).
_TRAPEZOID_TIERS = (((36, 4, 56), 2 * 2 * 132), ((32, 4, 40), 132), ((24, 4, 24), 0))
# K4: steps per cooperative launch, the JAX package's 255; 1023 measured
# 12% slower at 128^2 and within 2% at 256^2-1024^2.
_RESIDENT_CHUNK = 255


# auto at f32: K4 (resident) up to this state size, K6 (deep) above. On an
# H100 (chip_smoke phase 25: K4, K6, K7, K9 and K11 in turns, each at its
# schedule, PERF.md section 6), K4 took the least time per step at 128x256
# and every square from 256^2 to 448^2 (its shared-memory form), K6 the
# least from 512^2 (where K4 takes its global-memory form) to 1024^2.
# With K4's global-memory form in one copy and K11 on the trapezoid
# (phases 25 and 32, four runs) K6 stayed the fastest from 512^2 to 768^2
# (K11 within 1% at 768^2; K4 once 3.5% faster at 640^2, 9-10% slower in
# the final tree's two runs) and K11 took 1-3% less at 1024^2, but K11
# is not the same bits when a run is cut and resumed (its S state carries
# the forcing, re-applied on the host), so neither limit moved.
_RESIDENT_AUTO_MAX_STATE = 9 * 448 * 448 * 4


def band_config(params: LBMParams, dtype) -> tuple[int, int, int] | None:
    """The band kernel's schedule ``(block, depth, panel)`` (driver.py:468-498
    of the JAX package), or None for a dtype it does not store (f32, c16
    and bf16 take one schedule: the window is f32 in shared memory)."""
    from lbm_tpu_torch.ops.band import band_supported

    return _tiered(params, _BAND_TIERS, band_supported) if _kernel_dtype(dtype) else None


def band2_config(params: LBMParams, dtype) -> tuple[int, int, int] | None:
    """The band2 kernel's schedule ``(block, depth, panel)`` (driver.py:590-610),
    or None for a dtype it does not store (f32, c16 and bf16): the large
    tiles where they fill a wave of blocks, the small ones below."""
    from lbm_tpu_torch.ops.band2 import band2_supported

    return _tiered(params, _BAND_TIERS, band2_supported) if _kernel_dtype(dtype) else None


def band3_config(params: LBMParams, dtype) -> tuple[int, int, int] | None:
    """The band3 kernel's schedule ``(block, depth, panel)`` (driver.py:691-720),
    or None for a dtype it does not store (f32, c16 and bf16)."""
    from lbm_tpu_torch.ops.band3 import band3_supported

    return _tiered(params, _BAND3_TIERS, band3_supported) if _kernel_dtype(dtype) else None


def band3_schedules() -> tuple[tuple[int, int, int], ...]:
    """Every schedule of K11's tiers. The build compiles their windows, and
    those of their split 16-bit final passes, with constant strides
    (ops/_build.py, csrc/band3.cu)."""
    return tuple(cfg for cfg, _ in _BAND3_TIERS)


# K13: passes per slab visit (the JAX package's default).
_SLAB_K = 4


def slab_config(params: LBMParams, dtype) -> tuple[int, int, int | None, int, int] | None:
    """The slab kernel's schedule ``(block, depth, panel, kpasses, sblock)``
    (driver.py:501-529 of the JAX package), or None. The pass is K7's
    (``band_config``); ``LBM_SLAB_K`` sets the passes per slab visit
    (default 4) and ``LBM_SLAB_S`` the slab rows. The default S is the
    largest divisor of ny below ny: on an H100 the sweep (PERF.md, K13) ran
    fastest at S = ny/2 at 2048^2 and 4096^2 for every K, the larger the
    slab the faster (not the TPU's 4,194,304-cell slab, nor a slab whose
    two buffers fit the 50 MB L2: those ran 1.3-1.5x slower)."""
    from lbm_tpu_torch.ops.slab import slab_supported

    cfg = band_config(params, dtype)
    if cfg is None:
        return None
    block, depth, panel = cfg
    k = int(os.environ.get("LBM_SLAB_K", str(_SLAB_K)))
    ov_s = os.environ.get("LBM_SLAB_S")
    if ov_s:
        s = int(ov_s)
        ok = slab_supported(params.ny, params.nx, block, depth, k, s, panel)
        return (block, depth, panel, k, s) if ok else None
    best = None
    for s in range(1, params.ny):
        if slab_supported(params.ny, params.nx, block, depth, k, s, panel):
            best = s
    return None if best is None else (block, depth, panel, k, best)


def resident_config(params: LBMParams, dtype) -> int | None:
    """Steps per K4 launch (driver.py:1070-1080 of the JAX package runs
    ``pallas_resident._CHUNK_STEPS``), or None for a dtype it does not store."""
    del params
    return _RESIDENT_CHUNK if dtype == torch.float32 else None


def _tiered(params: LBMParams, tiers, supported) -> tuple[int, int, int]:
    """The first schedule of ``tiers`` that ``supported(ny, nx, *schedule)``
    takes and that cuts the grid into at least its number of tiles; else
    the last one it takes (else the first)."""
    fits = [cfg for cfg, _ in tiers if supported(params.ny, params.nx, *cfg)]
    for (block, depth, panel), fewest in tiers:
        tiles = -(-params.ny // block) * -(-params.nx // panel)
        if (block, depth, panel) in fits and tiles >= fewest:
            return block, depth, panel
    return fits[-1] if fits else tiers[0][0]


def temporal_config(params: LBMParams, dtype) -> tuple[int, int, int] | None:
    """The temporal kernel's schedule ``(block, depth, panel)``
    (``pick_block``/``pick_depth`` of the JAX package), or None for a dtype
    it does not store (f32, c16 and bf16)."""
    from lbm_tpu_torch.ops.temporal import temporal_supported

    return _tiered(params, _TRAPEZOID_TIERS, temporal_supported) if _kernel_dtype(dtype) else None


def deep_config(params: LBMParams, dtype) -> tuple[int, int, int] | None:
    """The deep kernel's schedule ``(block, depth, panel)``
    (``pallas_deep.pick_config``), or None for a dtype it does not store
    (f32, c16 and bf16)."""
    from lbm_tpu_torch.ops.deep import deep_supported

    return _tiered(params, _TRAPEZOID_TIERS, deep_supported) if _kernel_dtype(dtype) else None


def trapezoid_schedules() -> tuple[tuple[int, int, int], ...]:
    """Every schedule of K5's and K6's tiers. The build compiles their
    windows with constant strides (ops/_build.py, csrc/trapezoid.cuh)."""
    return tuple(cfg for cfg, _ in _TRAPEZOID_TIERS)


def pass_schedule(route: str, params: LBMParams, dtype):
    """``(run, (block, depth, panel))`` of a route of ``PASS_BACKENDS``;
    raises for a grid or dtype its kernel cannot take."""
    if route == "band":
        from lbm_tpu_torch.ops.band import band_supported as supported, run_band as run
        cfg, need = band_config(params, dtype), "ny >= 2"
    elif route == "band2":
        from lbm_tpu_torch.ops.band2 import band2_supported as supported, run_band2 as run
        cfg, need = band2_config(params, dtype), "ny >= 2"
    elif route == "band3":
        from lbm_tpu_torch.ops.band3 import band3_supported as supported, run_band3 as run
        cfg, need = band3_config(params, dtype), "ny >= 2"
    elif route == "temporal":
        from lbm_tpu_torch.ops.temporal import run_temporal as run
        from lbm_tpu_torch.ops.temporal import temporal_supported as supported
        cfg, need = temporal_config(params, dtype), "ny >= 2 and every row block >= depth rows"
    else:
        from lbm_tpu_torch.ops.deep import deep_supported as supported, run_deep as run
        cfg, need = deep_config(params, dtype), "ny >= 2"
    if cfg is None or not supported(params.ny, params.nx, *cfg):
        raise ValueError(f"grid {params.ny}x{params.nx} unsupported by the {route} kernel "
                         f"(schedule {cfg}; it needs f32, c16 or bf16 and {need})")
    return run, cfg


def select_slab(params: LBMParams, dtype):
    """The slab schedule for ``--backend slab`` (driver.py:532-559); raises
    for a grid the schedule cannot cut into slabs."""
    cfg = slab_config(params, dtype)
    if cfg is None:
        raise ValueError(
            f"grid {params.ny}x{params.nx} unsupported by the slab kernel (needs ny divisible "
            "into >1 slabs of at least LBM_SLAB_K * depth rows; tune LBM_SLAB_S / LBM_SLAB_K)")
    return cfg


def select_route(params: LBMParams, backend: str, dtype) -> str:
    """Resolve ``backend`` and ``dtype`` to a route: a ``BACKENDS`` name other
    than ``"auto"`` (driver.py:96-118, :365-430, :613-1007 of the JAX
    package). An explicit kernel backend raises on a grid or dtype its
    kernel cannot take; it never routes elsewhere."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    c16 = is_c16(dtype)
    if not c16 and dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise ValueError(f"unsupported dtype {dtype}; use float32, float64, bfloat16 or 'c16'")
    if backend == "slab" and os.environ.get("LBM_ENABLE_SLAB") != "1":
        raise ValueError(
            "slab backend is quarantined (a documented negative result on the TPU, where "
            "it loses to band/band2 everywhere, BENCHMARKS.md); set LBM_ENABLE_SLAB=1 to "
            "run it anyway")
    if backend == "reference":
        return "reference"
    if c16 and backend == "resident":
        raise ValueError("resident backend does not support c16 storage (use "
                         "auto/pallas/temporal/deep/band/aa)")
    if dtype == torch.bfloat16 and backend == "resident":
        raise ValueError(f"grid {params.ny}x{params.nx} (dtype bfloat16) does not fit the "
                         "resident kernel, which stores f32 only (use auto/aa/pallas/band/"
                         "band2/band3/temporal/deep)")
    if dtype == torch.float64:
        if backend in KERNEL_BACKENDS:
            raise ValueError(
                f"{backend} backend stores f32 only; use --precision f32 or "
                "--backend reference for f64"
            )
        return "reference"
    if backend == "aa" and params.ny < AA_MIN_NY:
        raise ValueError(f"grid {params.ny}x{params.nx} unsupported by the AA kernel (ny < 3)")
    if backend == "pallas" and params.ny < 2:
        raise ValueError(f"grid {params.ny}x{params.nx} unsupported by the step kernel (ny < 2)")
    if backend == "resident" and not resident_supported(params.ny, params.nx):
        raise ValueError(f"grid {params.ny}x{params.nx} unsupported by the resident kernel "
                         "(ny < 2)")
    if backend in PASS_BACKENDS:
        pass_schedule(backend, params, dtype)  # raises with the reason
    if backend == "slab":
        select_slab(params, dtype)
    if backend == "auto":
        if not resident_supported(params.ny, params.nx):
            return "reference"
        if c16:
            return "pallas"
        if dtype == torch.bfloat16:
            return "aa" if params.ny >= AA_MIN_NY else "pallas"
        return "resident" if 9 * params.ny * params.nx * 4 <= _RESIDENT_AUTO_MAX_STATE else "deep"
    return backend


def compute_chunk_sizes(
    start_step: int, max_iters: int, checkpoint_every: int = 0, chunk_every: int = 0
) -> list[int]:
    """Split ``[start_step, max_iters)`` so a boundary falls on every
    multiple of ``checkpoint_every`` and of ``chunk_every`` (each ignored
    when <= 0)."""
    strides = [s for s in (checkpoint_every, chunk_every) if s and s > 0]
    if not strides:
        return [max_iters - start_step]
    sizes = []
    step = start_step
    while step < max_iters:
        nxt = min([max_iters] + [(step // s + 1) * s for s in strides])
        sizes.append(nxt - step)
        step = nxt
    return sizes


def warn_saturation(maxq: int, spec) -> None:
    """The c16 saturation check of every c16 run (driver.py:1585-1605): H
    leaves about 4x headroom over the deviations the decks reach, so a
    state whose largest code decodes above H/2 may have been clamped."""
    md = devspace.saturation(maxq, spec)
    if md > 0.5 * spec.h:
        warnings.warn(
            f"c16 deviations reached {md:.3g} (companding range H={spec.h:.3g}) — results "
            "may have saturated; rerun with f32 or a larger LBM_C16_H", stacklevel=3)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array; its bytes count as ``d2h_bytes`` when it
    leaves a card."""
    if t.device.type == "cuda":
        trace.count("d2h_bytes", t.nbytes)
    return t.cpu().numpy()


def run_simulation(
    params: LBMParams,
    obstacles: np.ndarray,
    *,
    backend: str = "auto",
    dtype: torch.dtype | str | None = torch.float32,
    initial_cells: np.ndarray | None = None,
    start_step: int = 0,
    av_vels_prefix: np.ndarray | None = None,
    checkpoint_every: int = 0,
    checkpoint_path: str | None = None,
    checkpoint_format: str = "npz",
    chunk_every: int = 0,
    on_chunk=None,
    device: torch.device | str | None = None,
    fetch_final: bool = True,
) -> SimulationResult:
    """Run steps ``start_step .. params.max_iters`` on ``device`` and return
    the result (driver.py:1272-1611 of the JAX package, whose keywords it
    takes).

    ``device`` None selects as ``--device`` does (``runtime/device.py``:
    ``$LBM_DEVICE``, else ``cuda:0``; the CPU only when named, and no card
    raises). ``dtype`` None is f32. ``initial_cells`` replaces the
    equilibrium-at-rest start state; ``start_step`` and ``av_vels_prefix``
    resume from a checkpoint, whose av series the result's begins with.
    ``checkpoint_every`` > 0 splits the run into chunks ending on its
    multiples, and with ``checkpoint_path`` each of them (and the run's
    end) writes a checkpoint there in ``checkpoint_format`` (npz: orbax is
    the JAX package's and is refused). ``chunk_every`` > 0 adds chunk
    boundaries on its multiples, and ``on_chunk(step, cells, av_chunk)``
    is called after every chunk with the step reached, the state as a
    tensor where it lies (decoded f32 at c16) and the chunk's av values.
    ``fetch_final=False`` leaves ``result.cells`` None. ``dtype="c16"``
    runs on c16 storage, ``torch.bfloat16`` on bf16 (module docstring).
    """
    with trace.call() as record:
        if checkpoint_format != "npz":
            raise ValueError("orbax checkpoints are JAX-only (lbm_tpu); use "
                             "checkpoint_format='npz'")
        if device is None:
            from lbm_tpu_torch.runtime.device import select_device

            device = select_device(None)
        device = torch.device(device)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")
        cuda = device.type == "cuda"
        dtype = torch.float32 if dtype is None else dtype
        route = select_route(params, backend, dtype)
        obstacles = np.asarray(obstacles)
        if obstacles.shape != (params.ny, params.nx):
            raise ValueError(f"obstacle mask {obstacles.shape} != grid ({params.ny}, {params.nx})")
        if start_step >= params.max_iters:
            raise ValueError("start_step is beyond max_iters")
        spec = storage_spec(params, dtype)
        full_dtype = torch.float32 if spec is not None else dtype
        with trace.span("upload"):
            if initial_cells is None:
                cells = D2Q9.initial_state(params, dtype=full_dtype, device=device)
                up = D2Q9.NSPEEDS * cells.element_size()  # the 9 weights, expanded there
            else:
                cells = torch.as_tensor(np.asarray(initial_cells)).to(device=device,
                                                                      dtype=full_dtype)
                up = cells.nbytes
            if cuda:
                trace.count("h2d_bytes", up)
        if spec is not None:
            with trace.span("encode"):
                cells = devspace.encode_state(cells, spec)  # c16: the rest state encodes to 0
        with trace.span("mask"):
            obst = obstacles_from_numpy(obstacles, device)
            if cuda:
                trace.count("h2d_bytes", obst.nbytes)
            tot_cells = int(np.sum(obstacles == 0))  # d2q9-bgk.c:146-152
            nobst = (obst == 0).to(torch.float32)
        # The f32 (or f64) value of 1/tot_cells multiplies each step's sum, so
        # the series rounds as the JAX driver's does (driver.py:1366-1368).
        inv_np = np.asarray(1.0 / tot_cells,
                            dtype=np.float64 if dtype == torch.float64 else np.float32)
        paired = paired_default()  # read once, outside the loop
        scalars = (params.density, params.accel, params.omega)
        # Every route but K4's takes ``dev`` (select_route refused K4 at 16 bits).
        kw = dict(paired=paired) if spec is None else dict(paired=paired, dev=spec)

        def advance(cells, n):
            """``n`` steps of the route; returns ``(cells, av)``."""
            if route == "reference":
                inv = torch.tensor(inv_np, device=device)
                if cuda:
                    trace.count("h2d_bytes", inv.nbytes)
                av = torch.empty(n, dtype=full_dtype, device=device)
                for t in range(n):
                    if not is_c16(dtype):  # bf16: the step computes in bf16
                        cells, tot_u = lbm_step_reference(cells, obst, *scalars)
                    else:
                        cells, tot_u = devspace.lbm_step_reference_c16(cells, obst, *scalars,
                                                                       spec)
                    av[t] = tot_u * inv
                return cells, av
            if route in PASS_BACKENDS:
                run, (block, depth, panel) = pass_schedule(route, params, dtype)
                return run(cells, nobst, *scalars, n, block, depth, panel=panel,
                           inv_tot_cells=float(inv_np), **kw)
            if route == "slab":
                from lbm_tpu_torch.ops.slab import run_band_slab

                block, depth, panel, kpasses, sblock = select_slab(params, dtype)
                return run_band_slab(cells, nobst, *scalars, n, block, depth, kpasses, sblock,
                                     panel=panel, inv_tot_cells=float(inv_np), **kw)
            if route == "resident":
                from lbm_tpu_torch.ops.resident import run_resident

                return run_resident(cells, nobst, *scalars, n, float(inv_np),
                                    chunk=resident_config(params, dtype), paired=paired)
            if route == "aa":
                from lbm_tpu_torch.ops.aa import run_aa as run
            else:
                from lbm_tpu_torch.ops.step import run_step as run
            return run(cells, nobst, *scalars, n, float(inv_np), **kw)

        def as_full(cells):
            """The observer's view of the state: c16 codes decode to f32, bf16
            widens to f32 exactly."""
            return cells if spec is None else devspace.decode_state(cells, spec)

        lib = None
        t0 = time.perf_counter()
        if route != "reference" and cuda:
            from lbm_tpu_torch.ops import _build

            with trace.span("library"):
                lib = _build.library()  # build or load before the timed loop
        compile_time = time.perf_counter() - t0

        av_chunks = [] if av_vels_prefix is None else [np.asarray(av_vels_prefix)]
        elapsed = 0.0
        step = start_step
        for n in compute_chunk_sizes(start_step, params.max_iters, checkpoint_every,
                                     chunk_every):
            record.chunks += 1
            with trace.span("sync"):
                _sync(device)
            launched = 0 if lib is None else lib.lbm_launch_count()
            t0 = time.perf_counter()
            # The chunk's span, lbm_tpu_torch.loop in a torch.profiler trace.
            with trace.span("loop"):
                cells, av = advance(cells, n)
                _sync(device)
            elapsed += time.perf_counter() - t0
            if lib is not None:
                trace.count("kernel_launches", lib.lbm_launch_count() - launched)
            with trace.span("av"):
                av_chunks.append(_to_host(av))
            step += n
            if on_chunk is not None:
                with trace.span("on_chunk"):
                    on_chunk(step, as_full(cells), av_chunks[-1])
            if checkpoint_path is not None and checkpoint_every and (
                    step % checkpoint_every == 0 or step == params.max_iters):
                from lbm_tpu_torch.runtime.checkpoint import save_checkpoint

                # 16-bit checkpoints hold the decoded f32 state, the format of
                # either package; a resume re-encodes it to the same values
                # (bf16: to the same bits).
                with trace.span("checkpoint"):
                    save_checkpoint(checkpoint_path, params, _to_host(as_full(cells)),
                                    np.concatenate(av_chunks), step)

        final = None
        if fetch_final:
            full = cells
            if spec is not None:
                with trace.span("decode"):
                    full = as_full(cells)
            with trace.span("fetch"):
                final = _to_host(full)
            del full  # the decoded copy goes before the saturation check allocates
        if is_c16(dtype):
            with trace.span("saturation"):
                maxq = devspace.max_abs_code(cells)
                if cuda:
                    trace.count("d2h_bytes", 4)  # max_abs_code's int32 scalar
                warn_saturation(maxq, spec)
        record.elapsed = elapsed
        return SimulationResult(
            cells=final,
            av_vels=np.concatenate(av_chunks),
            elapsed=elapsed,
            compile_time=compile_time,
            route=route,
            device=str(cells.device),
            trace=record,
        )
