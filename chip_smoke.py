#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each printing what it found:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: nvcc builds the kernels of ``lbm_tpu_torch/csrc`` for sm_90a
   (one process per source), and ``make -C native`` the C++ writers that
   the big decks of phase 8 need to write their outputs in seconds;
3. K1 (``csrc/step.cu``) against ``step_plain`` on the card, 1024^2 and
   1000^2, 200 steps; time per step of each at 1024^2 and 128^2;
4. K2 (``csrc/aa.cu``) against ``run_aa_plain``, 200 and 201 steps (both
   exit parities) at 1024^2 and 1000^2; K2 against K1 over 1000 steps;
   two K2 runs must give bitwise-equal results;
5. the K2 and K1 path: the four official decks, generated with
   ``utils/geometry``, through ``lbm_tpu_torch.cli.main`` (what
   ``python -m lbm_tpu_torch`` runs) with ``--backend aa`` at f32, and
   the 1024^2 deck once more with ``--backend pallas``. The launch counters,
   zeroed just before, must show that aa ran K2 and pallas ran K1 for
   every step; the 1024^2 and 256^2 results must pass the 1% gate against
   ``tests/golden/*.golden.npz``;
6. the band kernels K7 (``csrc/band.cu``), K9 (``csrc/band2.cu``) and K11
   (``csrc/band3.cu``) against their plain versions at 1024^2 and 1000^2,
   over one pass, two passes and a K1 remainder, and for K11 three and four
   passes; time per step of each kernel, its plain version and K2 at
   2048^2 and 4096^2;
7. each band kernel against K1 over 1000 steps at 2048^2 (bitwise equal or
   not, and the max difference), and two runs of each bitwise equal;
8. the band path through ``cli.main``: the four official decks with
   ``--backend auto`` (K4 on 128^2, 128x256 and 256^2, K11 on 1024^2),
   the 256^2 and 1024^2 decks with
   ``band``, ``band2`` and ``band3`` through the 1% gate, and the 1000^2 x
   1001 (ragged tiles, a K1 remainder), 2048^2 x 2048 and 4096^2 x 1024
   "walls" decks (rows 0 and ny-1 blocked) with
   ``aa``, each band backend and ``auto`` (on 4096^2 ``aa`` and ``band3``,
   auto's route there, only); each of the latter is held
   against the ``aa`` run through ``utils/checker.check_files`` at 1% and
   directly (av series at rtol 1e-4, final_state identical bytes or within
   the kernel tolerances). The counters, zeroed just before, must account
   for every step: the band steps in their kernels, the remainders in K1;
9. the resident, temporal and deep kernels K4 (``csrc/resident.cu``), K5
   (``csrc/temporal.cu``) and K6 (``csrc/deep.cu``) against their plain
   versions at 1024^2 and 1000^2, over T and 2T+3 steps (K4: 254, 255, 256
   and 511, around its 255-step launches); time per step of each kernel,
   its plain version and K11 at 128^2, 1024^2, 2048^2 and 4096^2;
10. each of them against K1 over 1000 steps at 2048^2 (bitwise equal or not,
   and the max difference), and two runs of each bitwise equal;
11. their path through ``cli.main``: the 256^2 and 1024^2 decks with
   ``resident``, ``temporal`` and ``deep`` through the 1% gate, the 2048^2 x
   2048 walls deck with each held against phase 8's ``aa`` run, and a 256^2 run
   resumed with ``--resume --checkpoint-every`` from a step-30,001
   checkpoint, whose files must be the bytes of the uninterrupted resident
   run. The counters, zeroed just before, must account for every step.
12. the shard kernels, every shard on ``cuda:0``: K3 (``csrc/shard_step.cu``)
   on a 1-D mesh of 4 and on 2x2, K12 (same source) on 4, K8
   (``csrc/band.cu``) and K10 (``csrc/band2.cu``) on 4, against their plain
   versions at 1024^2 and 1000^2 (K3 and K12 over 50 steps, K8 and K10 over
   T and 2T+3); time per step of each at 2048^2 and 4096^2 beside the
   single-device kernel of its family (K1, K7, K9), the plain version's at
   2048^2;
13. each of them against K1 over 1000 steps on the 2048^2 walls mask: the
   joined final state bitwise equal to K1's single-device run, and two runs
   of each bitwise equal;
14. the sharded path through ``cli.main``: the 1024^2 deck with ``--mesh 4
   --device 0`` under ``auto``, ``pallas``, ``pallas-overlap``, ``band`` and
   ``band2``, and ``--mesh 2x2 --device 0`` under ``auto``, each through the
   1% gate; a 256^2 ``--mesh 4`` run resumed from a step-30,001 checkpoint
   with ``--checkpoint-every``, whose files must be the bytes of the
   uninterrupted run. The counters, zeroed just before, must account for
   every step;
15. the c16 forms (int16 companded storage, ``ops/devspace.py``) of K1, K2,
   K11 and K7 against their plain versions at 1024^2 and 1000^2 (K2 both
   exit parities; K11 and K7 one pass, two passes and a K1 remainder, K11
   three and four passes), two K2 c16 runs bitwise equal; time per step of
   each beside its f32 form (K1, K2 at 1024^2, K11 at 2048^2 and 4096^2);
16. the slab kernel K13 (``csrc/band.cu``, slab mode) at f32 and c16
   against its plain version at 1024^2 and 1024 x 1000 over one generation,
   two and a remainder (K7 passes and K1); at f32 against K1 over 1000
   steps on the 2048^2 walls mask (bitwise), two runs of each form bitwise
   equal; the (K, S) sweep, K in {1, 2, 4} and S in {128, 256, 512, 1024}
   (and 2048 at 4096^2), per step at 2048^2 and 4096^2 on the walls mask
   beside K7 and K11 in the same loop, and the default (K, S) at c16;
17. the c16 and slab path through ``cli.main``: the 256^2 and 1024^2 decks
   with ``--precision c16`` under ``auto`` (K1), ``aa`` (K2) and ``pallas``
   (K1) through the 1% gate, and under ``band3`` (K11); the 1024^2 deck
   with ``band`` (K7) at c16 and, with ``LBM_ENABLE_SLAB=1``, ``slab``
   (K13) at f32 through the 1% gate and at c16. The band kernels round
   their codes once per pass, so their c16 runs print the 1% verdict and
   are held at ``PASS_GATE_C16`` (5%); ``slab`` at f32 on phase 8's 2048^2
   walls deck held against its ``aa`` run; a 256^2 ``aa`` c16 run resumed from a step-30,001
   checkpoint, whose files must be the bytes of the uninterrupted c16 run. The counters, f32
   and c16 apart, zeroed just before, must account for every step;
18. the c16 forms of K9, K5, K6 (``csrc/band2.cu``,
   ``temporal.cu``, ``deep.cu``) at 1024^2 and on the ragged 1000^2 walls
   mask, and K3, K8, K10 with 4 row shards on ``cuda:0``, against their
   plain versions over T and 2T+3 steps (K3 50); time per step of each
   beside its f32 form in the same loop at 2048^2; two runs of K9 c16 and
   of K3 c16 bitwise equal;
19. the c16 path through ``cli.main``: ``--precision c16`` with ``band2``,
   ``temporal`` and ``deep`` on the 256^2 and 1024^2 decks, ``--mesh 4
   --device 0`` on 1024^2 under ``auto``, ``pallas`` (K3), ``band`` (K8)
   and ``band2`` (K10) and on 256^2 under ``auto``, a 256^2 ``--mesh 4`` c16
   run resumed from a step-30,001 checkpoint (the uninterrupted bytes),
   and ``--mesh 2x2 --device 0`` (its plain-torch c16 step) on a 128^2 box
   cut to ``MESH_2D_ITERS`` steps, held against the one-device K1 c16 run of
   that deck through the checker at 1%. K3 and the 2-D step round every
   step and are held at 1%; the pass routes print the 1% verdict and are
   held at ``PASS_GATE_C16``. The c16 counters, zeroed just before, must
   account for every step;
20. the gate per T: K9 and K11 at c16 with T 4, 8 and 16 on the 256^2 and
   1024^2 decks, called with explicit schedules (T 16 with 32-row tiles and
   the widest panel that fits shared memory), through the checker against
   ``tests/golden/``: a measurement, printed, held only to finite output.

Tolerances: kernel against plain version, cells within 1e-5 of the
state's scale and av series at rtol 1e-4 (f32 with FMA contraction in the
kernels and another summation order); at c16 the decoded cells within
5e-6 and the av series at rtol 1e-3 (FMA contraction can move a code by
one quantum at a rounding tie, and a moved code feeds the next steps);
golden gate 1% (the reference's checker; the pass routes at c16:
``PASS_GATE_C16``). Any failure exits non-zero
before the last line. The last two lines are the kernel report and
``{"ok": true, "device": {...}}``. In the report ``ms``/``plain_ms`` are
per step (K1, K2 and K4 at 1024^2, the c16 forms of K1 and K2 too, the
others at 2048^2, the shard kernels with 4 shards); ``bound_ms`` is the
least time of that step on an H100 at this run's shape: the larger of its
bytes over 3.35 TB/s and its f32
operations (``FLOPS_PER_CELL_STEP``) over 67 TFLOP/s. The bytes: 76 B per
cell (9 f32 planes read and written and the f32 mask, each once) or 40 B
at c16 (9 int16 planes), per launch of a one-step kernel and per pass of a
T-step one; for K13 those bytes times (S + 2KT) / S per generation of K*T
steps, the HBM traffic when a slab's inner passes stay in L2.
``library_ms`` is null, as no single PyTorch call computes these steps.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_CELLS = 1e-5
TOL_AV = 1e-4
TOL_C16_CELLS = 5e-6  # absolute, on decoded cells
TOL_C16_AV = 1e-3
# The checker's limit (percent) for the band kernels at c16, which round
# once per pass (phases 17 and 19); the 1% verdict is printed beside it.
PASS_GATE_C16 = 5.0
# Steps of phase 19's 2-D mesh c16 deck: its step is plain PyTorch, one
# launch per operation.
MESH_2D_ITERS = 1000
DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
# An H100 SXM's peaks (NVIDIA's data sheet): HBM3 bytes/s and f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
BYTES_PER_CELL = 76  # 9 f32 planes read, 9 written, the f32 mask read
BYTES_PER_CELL_C16 = 40  # 9 int16 planes read, 9 written, the f32 mask read
# f32 operations of one cell-step of collide_fused (lbm_common.cuh: 9-value
# moments, the four paired relaxations, the select) with the forcing test
# and the |u| sum: counted from the source, about 70.
FLOPS_PER_CELL_STEP = 70

# (nx, ny, maxIters, reynolds_dim, density, accel, omega) and geometry of the
# four official decks (examples/generate_inputs.py, which imports the JAX
# package and so cannot be used here).
DECKS = {
    "128x128": ((128, 128, 40000, 10, 0.1, 0.005, 1.85), "box", {}),
    "128x256": ((128, 256, 40000, 10, 0.1, 0.005, 1.85), "channel_with_divider", {}),
    "256x256": ((256, 256, 80000, 10, 0.1, 0.005, 1.85), "box", {}),
    "1024x1024": ((1024, 1024, 20000, 10, 0.1, 0.01, 1.85), "box_with_vertical_wall",
                  {"wall_col": 341}),
}


T_START = time.time()


def log(*args):
    print(*args, flush=True)


def phase(title):
    log(f"== {title} (at {time.time() - T_START:.1f} s)")


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0 and proc.stdout.strip(), f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def random_setup(torch, nx, ny, seed):
    import numpy as np

    from lbm_tpu_torch.models.d2q9 import WEIGHTS
    from lbm_tpu_torch.utils.geometry import box

    rng = np.random.RandomState(seed)
    mask = box(nx, ny)
    mask[rng.randint(1, ny - 1, ny // 4), rng.randint(1, nx - 1, ny // 4)] = 1
    state = ((WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx)))
    dev = torch.device("cuda", 0)
    cells = torch.as_tensor(state.astype(np.float32)).to(dev)
    nobst = torch.as_tensor((mask == 0).astype(np.float32)).to(dev)
    return cells, nobst


def timed(torch, fn):
    """(result, ms) of one call, timed with CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare(torch, name, got, want, spec=None):
    """Kernel against plain version; ``spec``: c16 codes, compared decoded."""
    (gc, ga), (wc, wa) = got, want
    torch.cuda.synchronize()
    if spec is not None:
        from lbm_tpu_torch.ops.devspace import decode_state

        check(gc.dtype == torch.int16, f"{name}: c16 output is {gc.dtype}")
        gc, wc = decode_state(gc, spec), decode_state(wc, spec)
    check(bool(torch.isfinite(gc).all()) and bool(torch.isfinite(ga).all()),
          f"{name}: non-finite output")
    err = float((gc - wc).abs().max())
    scale = float(wc.abs().max())
    lim_cells = TOL_CELLS * scale if spec is None else TOL_C16_CELLS
    lim_av = TOL_AV if spec is None else TOL_C16_AV
    av_rel = float(((ga.double() - wa.double()).abs() / wa.double().abs()).max())
    log(f"  {name}: max|cells diff| {err:.3e} (limit {lim_cells:.3e}), "
        f"max av rel diff {av_rel:.3e} (limit {lim_av})")
    check(err <= lim_cells, f"{name}: cells differ by {err}")
    check(av_rel <= lim_av, f"{name}: av series differs by {av_rel}")
    return err


def kernel_phase(torch, label, kernel, plain, parity_steps):
    """Kernel against its plain version; returns (max_abs_err, ms, plain_ms)
    per step at 1024^2."""
    errs = []
    for (nx, ny) in ((1024, 1024), (1000, 1000)):
        cells, nobst = random_setup(torch, nx, ny, seed=nx)
        for n in parity_steps:
            got = kernel(cells, nobst, DENSITY, ACCEL, OMEGA, n, 1.0)
            want = plain(cells, nobst, DENSITY, ACCEL, OMEGA, n, 1.0)
            errs.append(compare(torch, f"{label} {nx}x{ny} {n} steps", got, want))
    per_step = {}
    for (nx, n_kernel, n_plain) in ((1024, 1000, 100), (128, 2000, 200)):
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        kernel(cells, nobst, DENSITY, ACCEL, OMEGA, 10, 1.0)  # warm up
        plain(cells, nobst, DENSITY, ACCEL, OMEGA, 5, 1.0)
        _, k_ms = timed(torch, lambda: kernel(cells, nobst, DENSITY, ACCEL, OMEGA, n_kernel, 1.0))
        _, p_ms = timed(torch, lambda: plain(cells, nobst, DENSITY, ACCEL, OMEGA, n_plain, 1.0))
        per_step[nx] = (k_ms / n_kernel, p_ms / n_plain)
        log(f"  {label} {nx}x{nx}: kernel {1e3 * k_ms / n_kernel:.2f} us/step "
            f"({nx * nx * n_kernel / k_ms / 1e3:.1f} MLUPS), plain "
            f"{1e3 * p_ms / n_plain:.2f} us/step")
    return max(errs), per_step[1024][0], per_step[1024][1]


def bound(cells, depth=1, bytes_per_cell=BYTES_PER_CELL):
    """``(bound_ms, bound_by)`` of one step over ``cells`` cells on an H100:
    a one-step kernel (depth 1) moves ``bytes_per_cell`` (76 at f32, 40 at
    c16), a T-step pass that many per cell per T steps."""
    bytes_ms = 1e3 * cells * bytes_per_cell / depth / HBM_BYTES_S
    ops_ms = 1e3 * cells * FLOPS_PER_CELL_STEP / F32_FLOPS
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def write_gold(npz_path, out_dir):
    """The committed f64 gold (tests/golden/*.npz) in the reference's file
    formats, the way tests/test_golden.py materialises it: av_vels as
    written by the solver, final_state with the pressure column only (the
    checker reads columns 0, 1 and 5)."""
    import numpy as np

    from lbm_tpu_torch.io import write_av_vels

    data = np.load(npz_path)
    av_path = os.path.join(out_dir, "gold_av_vels.dat")
    fs_path = os.path.join(out_dir, "gold_final_state.dat")
    write_av_vels(av_path, data["av_vels"])
    pressure = data["pressure"]
    ny, nx = pressure.shape
    with open(fs_path, "w") as f:
        f.write("".join("%d %d 0 0 0 %.12E 0\n" % (jj, ii, pressure[ii, jj])
                        for ii in range(ny) for jj in range(nx)))
    return av_path, fs_path


def run_deck(cli, tag, backend, work, gpu_line, mesh=None, precision="f32", gate=1.0):
    """One official deck through ``cli.main``; ``mesh`` adds ``--mesh mesh
    --device 0``, ``precision`` ``--precision`` (f32 adds nothing). Where
    there is a gold, the run must pass the checker at ``gate`` percent (the
    reference's 1% unless stated); the 1% verdict is printed either way."""
    import numpy as np

    from lbm_tpu_torch.utils import geometry
    from lbm_tpu_torch.utils.checker import check_files

    fields, geo, kw = DECKS[tag]
    extra = [] if mesh is None else ["--mesh", mesh, "--device", "0"]
    if precision != "f32":
        extra += ["--precision", precision]
    deck_dir = os.path.join(work, f"{tag}-{backend}" + ("" if mesh is None else f"-mesh{mesh}")
                            + ("" if precision == "f32" else f"-{precision}"))
    os.makedirs(deck_dir)
    params_path = os.path.join(deck_dir, f"input_{tag}.params")
    obst_path = os.path.join(deck_dir, f"obstacles_{tag}.dat")
    geometry.write_params_file(params_path, *fields)
    geometry.write_obstacle_file(obst_path, getattr(geometry, geo)(fields[0], fields[1], **kw))
    stats_path = os.path.join(deck_dir, "stats.json")
    rc = cli.main([params_path, obst_path, "--backend", backend, "--out-dir", deck_dir,
                   "--stats-json", stats_path, *extra])
    backend = " ".join([backend, *extra])
    check(rc == 0, f"{tag} --backend {backend}: cli.main returned {rc}")
    with open(stats_path) as f:
        stats = json.load(f)
    check(stats["torch_device"].startswith("cuda"), f"{tag}: ran on {stats['torch_device']}")
    av = np.loadtxt(os.path.join(deck_dir, "av_vels.dat"), usecols=[1])
    check(av.shape == (fields[2],) and np.isfinite(av).all(), f"{tag}: bad av_vels")
    line = (f"  {tag} --backend {backend}: route {stats['route']} on {stats['torch_device']}, "
            f"loop {stats['loop_s']:.4f} s, {stats['mlups']:.1f} MLUPS, "
            f"Reynolds {stats['reynolds']:.12E} [{gpu_line}]")
    gold = os.path.join(ROOT, "tests", "golden", f"{tag}.golden.npz")
    if os.path.exists(gold):
        gav, gfs = write_gold(gold, deck_dir)
        res = check_files(os.path.join(deck_dir, "av_vels.dat"),
                          os.path.join(deck_dir, "final_state.dat"), gav, gfs, tolerance=gate)
        at_1 = max(abs(res.av_vels.max_diff_pcnt), abs(res.final_state.max_diff_pcnt)) <= 1.0
        line += (f"\n    golden gate (1%): av_vels max diff {res.av_vels.max_diff_pcnt:.4g}% "
                 f"at step {res.av_vels.max_index}, pressure max diff "
                 f"{res.final_state.max_diff_pcnt:.4g}% at ({res.final_state.coord_x},"
                 f"{res.final_state.coord_y}): {'PASS' if at_1 else 'FAIL'}"
                 + ("" if gate == 1.0 else f" (held at {gate}%: {'PASS' if res.passed else 'FAIL'})"))
        log(line)
        check(res.passed, f"{tag} --backend {backend} fails the golden gate at {gate}%")
    else:
        log(line)
    return stats


# The band kernels: route -> (name in the report, source, the TPU kernel it
# replaces).
BANDS = {
    "band": ("K7 band (values in registers)", "lbm_tpu_torch/csrc/band.cu",
             "lbm_tpu/ops/pallas_band.py:172"),
    "band2": ("K9 band2 (two ping-pong windows)", "lbm_tpu_torch/csrc/band2.cu",
              "lbm_tpu/ops/pallas_band2.py:90"),
    "band3": ("K11 band3 (one in-place AA window)", "lbm_tpu_torch/csrc/band3.cu",
              "lbm_tpu/ops/pallas_band3.py:306"),
}
# The route auto takes on each official deck (runtime/driver.py:
# select_route): K4 up to a 384^2 state, K11 above.
AUTO_ROUTES = {"128x128": "resident", "128x256": "resident", "256x256": "resident",
               "1024x1024": "band3"}
# (n, iters) of the n x n "walls" decks: a ragged grid whose iterations
# leave a K1 remainder, then the JAX package's HBM-regime rows.
WALLS_DECKS = ((1000, 1001), (2048, 2048), (4096, 1024))


def band_routes():
    """route -> (label, kernel, plain, (block, depth, panel)) with the
    driver's schedules."""
    import torch

    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band, band2, band3
    from lbm_tpu_torch.runtime.driver import pass_schedule

    params = LBMParams(nx=1024, ny=1024, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    plains = {"band": band.run_band_plain, "band2": band2.run_band2_plain,
              "band3": band3.run_band3_plain}
    out = {}
    for route in BANDS:
        run, cfg = pass_schedule(route, params, torch.float32)
        out[route] = (BANDS[route][0].split()[0], run, plains[route], cfg)
    return out


def band_phase(torch, label, kernel, plain, cfg, step_counts, aa_us):
    """Band kernel against its plain version at 1024^2 and 1000^2; returns
    (max_abs_err, {n: (kernel ms, plain ms)} per step at 2048^2 and 4096^2)."""
    block, depth, panel = cfg

    def run(fn, cells, nobst, n):
        return fn(cells, nobst, DENSITY, ACCEL, OMEGA, n, block, depth, panel=panel)

    errs = []
    for (nx, ny) in ((1024, 1024), (1000, 1000)):
        cells, nobst = random_setup(torch, nx, ny, seed=nx + depth)
        for n in step_counts:
            errs.append(compare(torch, f"{label} {nx}x{ny} {n} steps",
                                run(kernel, cells, nobst, n), run(plain, cells, nobst, n)))
    per_step = {}
    for nx, n_kernel in ((2048, 800), (4096, 200)):
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        n_plain = 2 * depth
        run(kernel, cells, nobst, 2 * depth)  # warm up, the allocator included
        run(plain, cells, nobst, n_plain)
        _, k_ms = timed(torch, lambda: run(kernel, cells, nobst, n_kernel))
        _, p_ms = timed(torch, lambda: run(plain, cells, nobst, n_plain))
        per_step[nx] = (k_ms / n_kernel, p_ms / n_plain)
        log(f"  {label} {nx}x{nx} (block {block}, depth {depth}, panel {panel}): kernel "
            f"{1e3 * k_ms / n_kernel:.2f} us/step ({nx * nx * n_kernel / k_ms / 1e3:.1f} MLUPS), "
            f"plain {1e3 * p_ms / n_plain:.2f} us/step, K2 {aa_us[nx]:.2f} us/step")
    return max(errs), per_step


def write_walls_deck(work, n, iters):
    """The JAX package's HBM-regime rows (scripts/r5_headline_session.py):
    an n x n channel with rows 0 and ny-1 blocked."""
    import numpy as np

    from lbm_tpu_torch.utils import geometry

    deck = os.path.join(work, f"walls{n}")
    os.makedirs(deck)
    params_path = os.path.join(deck, "input.params")
    obst_path = os.path.join(deck, "obstacles.dat")
    geometry.write_params_file(params_path, n, n, iters, 10, DENSITY, ACCEL, OMEGA)
    mask = np.zeros((n, n), np.int32)
    mask[0, :] = mask[-1, :] = 1
    geometry.write_obstacle_file(obst_path, mask)
    return params_path, obst_path


def run_walls(cli, deck, backend, work, n, gpu_line):
    out = os.path.join(work, f"walls{n}-{backend}")
    os.makedirs(out)
    stats_path = os.path.join(out, "stats.json")
    rc = cli.main([*deck, "--backend", backend, "--out-dir", out, "--stats-json", stats_path])
    check(rc == 0, f"walls {n}^2 --backend {backend}: cli.main returned {rc}")
    with open(stats_path) as f:
        stats = json.load(f)
    check(stats["torch_device"].startswith("cuda"), f"walls {n}^2: ran on {stats['torch_device']}")
    log(f"  walls {n}x{n} x {stats['max_iters']} --backend {backend}: route {stats['route']}, "
        f"loop {stats['loop_s']:.4f} s, {stats['mlups']:.1f} MLUPS [{gpu_line}]")
    return out, stats


def hold_against(out, ref, what):
    """A run's files against the K2 run's: the 1% checker, then directly."""
    import numpy as np

    from lbm_tpu_torch.utils.checker import check_files

    files = [os.path.join(d, f) for d in (out, ref) for f in ("av_vels.dat", "final_state.dat")]
    res = check_files(*files, tolerance=1.0)
    av, av_ref = (np.loadtxt(f, usecols=[1]) for f in (files[0], files[2]))
    check(bool(np.isfinite(av).all()), f"{what}: non-finite av_vels")
    av_rel = float((np.abs(av - av_ref) / np.abs(av_ref)).max())
    same = filecmp.cmp(files[1], files[3], shallow=False)
    line = (f"    vs K2: checker av_vels {res.av_vels.max_diff_pcnt:.4g}%, pressure "
            f"{res.final_state.max_diff_pcnt:.4g}%: {'PASS' if res.passed else 'FAIL'}; "
            f"av max rel diff {av_rel:.3e} (limit {TOL_AV}); final_state "
            f"{'byte-identical' if same else 'differs'}")
    if not same:
        fs, fs_ref = (np.loadtxt(f, usecols=[2, 3, 4, 5]) for f in (files[1], files[3]))
        p_err = float(np.abs(fs[:, 3] - fs_ref[:, 3]).max())
        u_err = float(np.abs(fs[:, :3] - fs_ref[:, :3]).max())
        p_lim = TOL_CELLS * float(np.abs(fs_ref[:, 3]).max())
        u_lim = TOL_AV * float(np.abs(fs_ref[:, :3]).max())
        line += (f", pressure max diff {p_err:.3e} (limit {p_lim:.3e}), velocity "
                 f"{u_err:.3e} (limit {u_lim:.3e})")
        check(p_err <= p_lim and u_err <= u_lim, f"{what}: final state differs from K2's")
    log(line)
    check(res.passed, f"{what} fails the 1% checker against K2")
    check(av_rel <= TOL_AV, f"{what}: av series differs from K2's by {av_rel}")


def build_native_io():
    """``make -C native``: the C++ writers of io/native.py (byte-identical
    to the Python ones, which stay the fallback)."""
    t0 = time.time()
    proc = subprocess.run(["make", "-C", os.path.join(ROOT, "native")], capture_output=True,
                          text=True, timeout=300)
    from lbm_tpu_torch.io import native

    native._lib.cache_clear()
    ok = proc.returncode == 0 and native.available()
    log(f"  native IO library: {'built' if ok else 'NOT built (Python writers)'} in "
        f"{time.time() - t0:.1f} s{'' if ok else ': ' + proc.stderr.strip()[-300:]}")


# The resident, temporal and deep kernels: route -> (name in the report,
# source, the TPU kernel it replaces).
SCHEDULED = {
    "resident": ("K4 resident (persistent cooperative grid)", "lbm_tpu_torch/csrc/resident.cu",
                 "lbm_tpu/ops/pallas_resident.py:66"),
    "temporal": ("K5 temporal (trapezoid, carried row packs)", "lbm_tpu_torch/csrc/temporal.cu",
                 "lbm_tpu/ops/pallas_temporal.py:76"),
    "deep": ("K6 deep (trapezoid, halos from the state)", "lbm_tpu_torch/csrc/deep.cu",
             "lbm_tpu/ops/pallas_deep.py:68"),
}


def scheduled_routes():
    """route -> (label, kernel, plain, depth) with the driver's schedules;
    kernel and plain take (cells, nobst, n_steps). K4's "depth" is 1: it
    has no remainder."""
    import torch

    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import deep, resident, temporal
    from lbm_tpu_torch.runtime.driver import pass_schedule, resident_config

    params = LBMParams(nx=1024, ny=1024, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    chunk = resident_config(params, torch.float32)

    def res(fn):
        return lambda c, o, n: fn(c, o, DENSITY, ACCEL, OMEGA, n, 1.0, chunk=chunk)

    out = {"resident": ("K4", res(resident.run_resident), res(resident.run_resident_plain), 1)}
    for route, plain in (("temporal", temporal.run_temporal_plain), ("deep", deep.run_deep_plain)):
        run, (block, depth, panel) = pass_schedule(route, params, torch.float32)

        def bind(fn, block=block, depth=depth, panel=panel):
            return lambda c, o, n: fn(c, o, DENSITY, ACCEL, OMEGA, n, block, depth, panel=panel)

        out[route] = (SCHEDULED[route][0].split()[0], bind(run), bind(plain), depth)
    return out


def scheduled_phase(torch, label, kernel, plain, step_counts, depth, k11):
    """K4, K5 or K6 against its plain version at 1024^2 and 1000^2; returns
    (max_abs_err, {n: (kernel ms, plain ms)} per step at 128^2-4096^2)."""
    errs = []
    for (nx, ny) in ((1024, 1024), (1000, 1000)):
        cells, nobst = random_setup(torch, nx, ny, seed=nx + depth)
        for n in step_counts:
            errs.append(compare(torch, f"{label} {nx}x{ny} {n} steps",
                                kernel(cells, nobst, n), plain(cells, nobst, n)))
    per_step = {}
    for nx, n_kernel, n_plain in ((128, 2040, 6), (1024, 480, 6), (2048, 240, 2), (4096, 96, 2)):
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        n_plain *= depth  # whole passes: no K1 remainder in the plain time
        kernel(cells, nobst, n_plain)  # warm up, the allocator included
        k11(cells, nobst, 24)
        plain(cells, nobst, n_plain)
        _, k_ms = timed(torch, lambda: kernel(cells, nobst, n_kernel))
        _, b_ms = timed(torch, lambda: k11(cells, nobst, n_kernel))
        _, p_ms = timed(torch, lambda: plain(cells, nobst, n_plain))
        per_step[nx] = (k_ms / n_kernel, p_ms / n_plain)
        log(f"  {label} {nx}x{nx}: kernel {1e3 * k_ms / n_kernel:.2f} us/step "
            f"({nx * nx * n_kernel / k_ms / 1e3:.1f} MLUPS), plain {1e3 * p_ms / n_plain:.2f} "
            f"us/step, K11 {1e3 * b_ms / n_kernel:.2f} us/step")
    return max(errs), per_step


def resume_run(cli, work, gpu_line, backend="resident", mesh=None, precision="f32"):
    """The 256^2 deck from a checkpoint at step 30,001 of 80,000 (taken by
    run_simulation, or run_simulation_sharded on ``mesh`` shards of
    ``cuda:0``) through ``cli.main --resume --checkpoint-every 25000``: its
    files must be the bytes of the uninterrupted run of ``backend`` at
    ``precision`` in ``work`` (run_deck's directory). Returns the step
    counts of the runs made: the head run's, then each resumed chunk's."""
    import dataclasses

    import torch

    from lbm_tpu_torch.io import read_obstacles, read_params
    from lbm_tpu_torch.parallel.sharded import run_simulation_sharded
    from lbm_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
    from lbm_tpu_torch.runtime.driver import compute_chunk_sizes, run_simulation

    tail = ("" if mesh is None else f"-mesh{mesh}") + ("" if precision == "f32" else f"-{precision}")
    full = os.path.join(work, f"256x256-{backend}{tail}")
    params_path = os.path.join(full, "input_256x256.params")
    obst_path = os.path.join(full, "obstacles_256x256.dat")
    params = read_params(params_path)
    obstacles = read_obstacles(obst_path, params)
    start, every = params.max_iters * 3 // 8 + 1, params.max_iters * 5 // 16
    head = dataclasses.replace(params, max_iters=start)
    dtype = "c16" if precision == "c16" else torch.float32
    if mesh is None:
        part = run_simulation(head, obstacles, device="cuda:0", backend=backend, dtype=dtype)
    else:
        part = run_simulation_sharded(head, obstacles, devices=["cuda:0"] * int(mesh),
                                      backend=backend, dtype=dtype)
    out = os.path.join(work, f"256x256-resumed{tail}")
    ckpt = os.path.join(out, "checkpoint.npz")
    save_checkpoint(ckpt, params, part.cells, part.av_vels, start)
    extra = [] if mesh is None else ["--mesh", mesh, "--device", "0"]
    if precision != "f32":
        extra += ["--precision", precision]
    rc = cli.main([params_path, obst_path, "--backend", backend, "--resume", "--checkpoint-every",
                   str(every), "--checkpoint-path", ckpt, "--out-dir", out, *extra])
    check(rc == 0, f"resumed 256^2 run: cli.main returned {rc}")
    same = [filecmp.cmp(os.path.join(out, f), os.path.join(full, f), shallow=False)
            for f in ("av_vels.dat", "final_state.dat")]
    step = load_checkpoint(ckpt, params)[2]
    log(f"  256x256 --backend {backend} {' '.join(extra)} resumed at step {start} with "
        f"--checkpoint-every {every}: av_vels.dat {'identical' if same[0] else 'DIFFERS'}, "
        f"final_state.dat {'identical' if same[1] else 'DIFFERS'} to the uninterrupted run; "
        f"last checkpoint at step {step} [{gpu_line}]")
    check(all(same), "the resumed 256^2 run's files differ from the uninterrupted run's")
    check(step == params.max_iters, f"the last checkpoint is at step {step}")
    return [start] + compute_chunk_sizes(start, params.max_iters, every)


# The shard kernels: name -> (name in the report, source, the TPU kernel it
# replaces).
SHARDED = {
    "K3": ("K3 shard step (ghost ring, refilled between steps)",
           "lbm_tpu_torch/csrc/shard_step.cu", "lbm_tpu/ops/pallas_step.py:164"),
    "K12": ("K12 shard step storing its edges into the neighbours' rings",
            "lbm_tpu_torch/csrc/shard_step.cu", "lbm_tpu/ops/pallas_remote.py:49"),
    "K8": ("K8 sharded band (values in registers)", "lbm_tpu_torch/csrc/band.cu",
           "lbm_tpu/ops/pallas_band.py:574"),
    "K10": ("K10 sharded band2 (two ping-pong windows)", "lbm_tpu_torch/csrc/band2.cu",
            "lbm_tpu/ops/pallas_band2.py:584"),
}


def shard_routes():
    """name -> (kernel, plain, meshes, family, depth) with the driver's
    schedules: kernel and plain take (shards, nob_shards, n_steps, ny),
    family (the single-device kernel of the same family) (cells, nobst,
    n_steps)."""
    import torch

    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band, band2, shard_step, step
    from lbm_tpu_torch.runtime.driver import band2_config, band_config

    params = LBMParams(nx=1024, ny=1024, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)

    def steps(fn):
        return lambda s, o, n, ny: fn(s, o, DENSITY, ACCEL, OMEGA, n, ny)

    def k1(c, o, n):
        return step.run_step(c, o, DENSITY, ACCEL, OMEGA, n, 1.0)

    out = {"K3": (steps(shard_step.run_shard_step), steps(shard_step.run_shard_step_plain),
                  ((4, 1), (2, 2)), k1, 1),
           "K12": (steps(shard_step.run_shard_overlap), steps(shard_step.run_shard_step_plain),
                   ((4, 1),), k1, 1)}
    for name, mod, run, cfg in (("K8", band, "run_band", band_config(params, torch.float32)),
                                ("K10", band2, "run_band2", band2_config(params, torch.float32))):
        block, depth, panel = cfg

        def bind(fn, block=block, depth=depth, panel=panel):
            return lambda s, o, n, ny: fn(s, o, DENSITY, ACCEL, OMEGA, n, block, depth, ny,
                                          panel=panel)

        def family(c, o, n, fn=getattr(mod, run), block=block, depth=depth, panel=panel):
            return fn(c, o, DENSITY, ACCEL, OMEGA, n, block, depth, panel=panel)

        out[name] = (bind(getattr(mod, run + "_sharded")),
                     bind(getattr(mod, run + "_sharded_plain")), ((4, 1),), family, depth)
    return out


def on_mesh(cells, nobst, py, px):
    """A state and mask cut into a py x px mesh of shards, all on cuda:0."""
    from lbm_tpu_torch.parallel.sharded import make_mesh_2d, split

    mesh = make_mesh_2d(py, px, ["cuda:0"] * (py * px))
    return split(cells, mesh), split(nobst, mesh)


def joined(torch, out):
    """(state, av) of a mesh run: the shards joined on the card, the raw
    per-shard sums added in shard order."""
    from lbm_tpu_torch.parallel.sharded import mesh_totals

    shards, sums = out
    return torch.cat([torch.cat(list(row), dim=2) for row in shards], dim=1), mesh_totals(sums, 1.0)


def shard_phase(torch, name, kernel, plain, meshes, family, depth):
    """A shard kernel against its plain version at 1024^2 and 1000^2; returns
    (max_abs_err, {(mesh, n): (kernel ms, plain ms or None, family ms)} per
    step at 2048^2 and 4096^2)."""
    errs = []
    counts = (50,) if depth == 1 else (depth, 2 * depth + 3)
    for (nx, ny) in ((1024, 1024), (1000, 1000)):
        cells, nobst = random_setup(torch, nx, ny, seed=nx + depth)
        for py, px in meshes:
            s, o = on_mesh(cells, nobst, py, px)
            for n in counts:
                errs.append(compare(torch, f"{name} {py}x{px} {nx}x{ny} {n} steps",
                                    joined(torch, kernel(s, o, n, ny)),
                                    joined(torch, plain(s, o, n, ny))))
    per_step = {}
    for nx, n_kernel in ((2048, 400), (4096, 100)):
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        family(cells, nobst, 2 * depth)  # warm up, the allocator included
        _, f_ms = timed(torch, lambda: family(cells, nobst, n_kernel))
        for py, px in meshes:
            s, o = on_mesh(cells, nobst, py, px)
            kernel(s, o, 2 * depth, nx)
            _, k_ms = timed(torch, lambda: kernel(s, o, n_kernel, nx))
            p_ms = None
            if nx == 2048:
                n_plain = 2 * depth
                plain(s, o, n_plain, nx)
                _, p_ms = timed(torch, lambda: plain(s, o, n_plain, nx))
                p_ms /= n_plain
            per_step[(py, px), nx] = (k_ms / n_kernel, p_ms, f_ms / n_kernel)
            log(f"  {name} {py}x{px} shards of {nx}x{nx}: kernel {1e3 * k_ms / n_kernel:.2f} "
                f"us/step ({nx * nx * n_kernel / k_ms / 1e3:.1f} MLUPS), "
                + (f"plain {1e3 * p_ms:.2f} us/step, " if p_ms else "")
                + f"single-device {1e3 * f_ms / n_kernel:.2f} us/step")
        del cells, nobst
    return max(errs), per_step


def mesh_phases(torch, cli, run_step, gpu_line):
    """Phases 12-14; returns (shard_routes(), {name: phase-12 result},
    {route: launches in phase 14})."""
    phase("12. shard kernels K3, K12, K8, K10 vs their plain versions (shards on cuda:0)")
    shard = shard_routes()
    shard_res = {}
    for name, (kernel, plain, meshes, family, depth) in shard.items():
        shard_res[name] = shard_phase(torch, name, kernel, plain, meshes, family, depth)

    phase("13. shard kernels vs K1 over 1000 steps on the 2048^2 walls mask, and repeatability")
    cells, nobst = random_setup(torch, 2048, 2048, seed=19)
    nobst.fill_(1.0)
    nobst[0].zero_()
    nobst[-1].zero_()
    k1 = run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, 1.0)
    for name, (kernel, _, meshes, _, _) in shard.items():
        for py, px in meshes:
            s, o = on_mesh(cells, nobst, py, px)
            (c1, a1), (c2, a2) = (joined(torch, kernel(s, o, 1000, 2048)) for _ in range(2))
            torch.cuda.synchronize()
            log(f"  {name} {py}x{px} vs K1: final state bitwise equal: {torch.equal(c1, k1[0])}, "
                f"max diff {float((c1 - k1[0]).abs().max()):.3e}")
            compare(torch, f"{name} {py}x{px} vs K1 2048x2048 1000 steps", (c1, a1), k1)
            check(torch.equal(c1, k1[0]), f"{name} {py}x{px}: final state differs from K1's")
            check(torch.equal(c1, c2) and torch.equal(a1, a2),
                  f"{name} {py}x{px} is not run-to-run deterministic")
            log(f"  {name} {py}x{px} determinism: two 1000-step runs give bitwise-equal av "
                "series and state")
            del s, o, c1, c2
    del cells, nobst, k1

    phase("14. the sharded path: lbm_tpu_torch.cli.main --mesh 4 / 2x2 --device 0, and --resume")
    from lbm_tpu_torch.ops import band, band2, shard_step

    mesh_counters = {"pallas": shard_step.run_shard_step, "pallas-overlap":
                     shard_step.run_shard_overlap, "band": band.run_band_sharded,
                     "band2": band2.run_band2_sharded}
    for fn in mesh_counters.values():
        fn.launches = 0
    want_mesh = dict.fromkeys(mesh_counters, 0)

    def account_mesh(stats):
        route, n = stats["route"], stats["max_iters"]
        check(route in mesh_counters, f"unexpected route {route}")
        check(len(stats["shards"]) == 4 and all(sh["device"] == "cuda:0" for sh in stats["shards"]),
              f"shards not all on cuda:0: {stats['shards']}")
        depth = shard["K8" if route == "band" else "K10"][4] if route.startswith("band") else 1
        want_mesh[route] += n // depth * depth
        want_mesh["pallas"] += n % depth

    with tempfile.TemporaryDirectory() as work:
        for backend, mesh in (("auto", "4"), ("pallas", "4"), ("pallas-overlap", "4"),
                              ("band", "4"), ("band2", "4"), ("auto", "2x2")):
            stats = run_deck(cli, "1024x1024", backend, work, gpu_line, mesh=mesh)
            check(backend != "auto" or stats["route"] == "pallas",
                  f"--mesh {mesh} auto routed {stats['route']}, not pallas (K3)")
            account_mesh(stats)
        account_mesh(run_deck(cli, "256x256", "auto", work, gpu_line, mesh="4"))
        want_mesh["pallas"] += sum(resume_run(cli, work, gpu_line, backend="auto", mesh="4"))
    got_mesh = {route: fn.launches for route, fn in mesh_counters.items()}
    log(f"  launch counters: K3 {got_mesh['pallas']} mesh steps (want {want_mesh['pallas']}), "
        f"K12 {got_mesh['pallas-overlap']} (want {want_mesh['pallas-overlap']}), K8 "
        f"{got_mesh['band']} (want {want_mesh['band']}), K10 {got_mesh['band2']} (want "
        f"{want_mesh['band2']})")
    for route in mesh_counters:
        check(got_mesh[route] == want_mesh[route], f"--mesh --backend {route}: not every step "
              "ran in its kernel")

    return shard, shard_res, got_mesh


# The c16 forms and the slab kernel: name -> (name in the report, source,
# the TPU kernel it replaces).
C16_KERNELS = {
    "K1": ("K1 fused step, c16", "lbm_tpu_torch/csrc/step.cu", "lbm_tpu/ops/pallas_step.py:164"),
    "K2": ("K2 in-place AA, c16", "lbm_tpu_torch/csrc/aa.cu", "lbm_tpu/ops/pallas_aa.py:163"),
    "K11": ("K11 band3 (one in-place AA window), c16", "lbm_tpu_torch/csrc/band3.cu",
            "lbm_tpu/ops/pallas_band3.py:306"),
    "K7": ("K7 band (values in registers), c16", "lbm_tpu_torch/csrc/band.cu",
           "lbm_tpu/ops/pallas_band.py:172"),
}
SLAB = ("K13 slab (band passes over y-slabs)", "lbm_tpu_torch/csrc/band.cu",
        "lbm_tpu/ops/pallas_slab.py:76")


def walls_setup(torch, n, seed):
    """A random state on the n x n walls mask (rows 0 and n-1 blocked)."""
    cells, nobst = random_setup(torch, n, n, seed=seed)
    nobst.fill_(1.0)
    nobst[0].zero_()
    nobst[-1].zero_()
    return cells, nobst


def c16_phase(torch, spec, routes):
    """Phase 15; returns {name: (max_abs_err, ms, plain_ms, f32 ms)} at the
    report's shape (K1, K2 1024^2; K11, K7 2048^2)."""
    from lbm_tpu_torch.ops import devspace
    from lbm_tpu_torch.ops.aa import run_aa, run_aa_plain
    from lbm_tpu_torch.ops.step import run_step, run_step_plain

    def steps(fn):
        return lambda c, o, n, dev=None: fn(c, o, DENSITY, ACCEL, OMEGA, n, 1.0, dev=dev)

    def passes(fn, cfg):
        block, depth, panel = cfg
        return lambda c, o, n, dev=None: fn(c, o, DENSITY, ACCEL, OMEGA, n, block, depth,
                                            panel=panel, dev=dev)

    k11, k7 = routes["band3"], routes["band"]
    t11, t7 = k11[3][1], k7[3][1]
    kernels = {"K1": (steps(run_step), steps(run_step_plain), (50,)),
               "K2": (steps(run_aa), steps(run_aa_plain), (50, 51)),
               "K11": (passes(k11[1], k11[3]), passes(k11[2], k11[3]),
                       (t11, 2 * t11 + 3, 3 * t11, 4 * t11)),
               "K7": (passes(k7[1], k7[3]), passes(k7[2], k7[3]), (t7, 2 * t7 + 3))}
    out = {}
    for name, (kernel, plain, counts) in kernels.items():
        errs = []
        for (nx, ny) in ((1024, 1024), (1000, 1000)):
            cells, nobst = random_setup(torch, nx, ny, seed=nx + 3)
            q = devspace.encode_state(cells, spec)
            for n in counts:
                errs.append(compare(torch, f"{name} c16 {nx}x{ny} {n} steps",
                                    kernel(q, nobst, n, spec), plain(q, nobst, n, spec), spec))
        out[name] = [max(errs)]
    cells, nobst = random_setup(torch, 1024, 1024, seed=23)
    q = devspace.encode_state(cells, spec)
    (c1, a1), (c2, a2) = (run_aa(q, nobst, DENSITY, ACCEL, OMEGA, 301, 1.0, dev=spec)
                          for _ in range(2))
    torch.cuda.synchronize()
    check(torch.equal(c1, c2) and torch.equal(a1, a2), "K2 c16 is not run-to-run deterministic")
    log("  K2 c16 determinism: two 301-step runs give bitwise-equal av series and codes")
    for name, (kernel, plain, counts) in kernels.items():
        for nx, n_kernel in (((1024, 1000),) if name in ("K1", "K2") else ((2048, 800), (4096, 200))):
            cells, nobst = random_setup(torch, nx, nx, seed=7)
            q = devspace.encode_state(cells, spec)
            n_plain = 50 if name in ("K1", "K2") else 2 * counts[0]
            kernel(cells, nobst, 10 * counts[0])  # warm up, the allocator included
            kernel(q, nobst, 10 * counts[0], spec)
            _, f_ms = timed(torch, lambda: kernel(cells, nobst, n_kernel))
            _, k_ms = timed(torch, lambda: kernel(q, nobst, n_kernel, spec))
            p_ms = None
            if nx <= 2048:
                plain(q, nobst, counts[0], spec)
                _, p_ms = timed(torch, lambda: plain(q, nobst, n_plain, spec))
                p_ms /= n_plain
            log(f"  {name} c16 {nx}x{nx}: kernel {1e3 * k_ms / n_kernel:.2f} us/step "
                f"({nx * nx * n_kernel / k_ms / 1e3:.1f} MLUPS), f32 form {1e3 * f_ms / n_kernel:.2f}"
                f" us/step" + (f", plain {1e3 * p_ms:.2f} us/step" if p_ms else ""))
            if nx in (1024, 2048):
                out[name] += [k_ms / n_kernel, p_ms, f_ms / n_kernel]
        del cells, nobst, q
    return out


def slab_phase(torch, spec, routes):
    """Phase 16; returns (the default schedule at 2048^2, err, c16 err,
    {(n, K, S): ms}, plain ms and c16 plain ms at 2048^2, {n: (K7, K11, K13
    c16, K7 c16) ms})."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import devspace, slab
    from lbm_tpu_torch.ops.step import run_step
    from lbm_tpu_torch.runtime.driver import slab_config

    def cfg_for(n):
        return slab_config(LBMParams(nx=n, ny=n, max_iters=1, reynolds_dim=10, density=DENSITY,
                                     accel=ACCEL, omega=OMEGA), torch.float32)

    def k13(c, o, n, cfg, dev=None, fn=slab.run_band_slab):
        block, depth, panel, kp, sb = cfg
        return fn(c, o, DENSITY, ACCEL, OMEGA, n, block, depth, kp, sb, panel=panel, dev=dev)

    cfg = cfg_for(1024)
    kt, depth = cfg[3] * cfg[1], cfg[1]
    log(f"  default schedule at 1024^2: block {cfg[0]}, depth {depth}, panel {cfg[2]}, K "
        f"{cfg[3]}, S {cfg[4]}; at 2048^2 S {cfg_for(2048)[4]}, at 4096^2 S {cfg_for(4096)[4]}")
    errs = {None: [], "c16": []}
    for (nx, ny) in ((1024, 1024), (1000, 1024)):
        cells, nobst = random_setup(torch, nx, ny, seed=nx + 5)
        for dev in (None, spec):
            x = cells if dev is None else devspace.encode_state(cells, spec)
            for n in (kt, 2 * kt, 2 * kt + depth + 3):
                errs[None if dev is None else "c16"].append(compare(
                    torch, f"K13 {'c16' if dev else 'f32'} {nx} cols x {ny} rows {n} steps",
                    k13(x, nobst, n, cfg, dev), k13(x, nobst, n, cfg, dev, slab.run_band_slab_plain),
                    dev))
    cells, nobst = walls_setup(torch, 2048, 29)
    cfg2 = cfg_for(2048)
    k1 = run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, 1.0)
    (c1, a1), (c2, a2) = (k13(cells, nobst, 1000, cfg2) for _ in range(2))
    torch.cuda.synchronize()
    log(f"  K13 vs K1: final state bitwise equal: {torch.equal(c1, k1[0])}, max diff "
        f"{float((c1 - k1[0]).abs().max()):.3e}")
    compare(torch, "K13 vs K1 2048x2048 walls 1000 steps", (c1, a1), k1)
    check(torch.equal(c1, k1[0]), "K13: final state differs from K1's")
    check(torch.equal(c1, c2) and torch.equal(a1, a2), "K13 is not run-to-run deterministic")
    q = devspace.encode_state(cells, spec)
    (c1, a1), (c2, a2) = (k13(q, nobst, 1000, cfg2, spec) for _ in range(2))
    torch.cuda.synchronize()
    check(torch.equal(c1, c2) and torch.equal(a1, a2), "K13 c16 is not run-to-run deterministic")
    log("  K13 determinism: two 1000-step runs of each form give bitwise-equal av series and "
        "state")
    del cells, nobst, k1, c1, c2, q
    band_run, band_cfg = routes["band"][1], routes["band"][3]
    b3_run, b3_cfg = routes["band3"][1], routes["band3"][3]

    def band(fn, cfg, c, o, n, dev=None):
        return fn(c, o, DENSITY, ACCEL, OMEGA, n, cfg[0], cfg[1], panel=cfg[2], dev=dev)

    sweep, beside = {}, {}
    plain_ms = plain_c16_ms = None
    for n, steps in ((2048, 512), (4096, 128)):
        cells, nobst = walls_setup(torch, n, 7)
        q = devspace.encode_state(cells, spec)
        base = cfg_for(n)
        band(band_run, band_cfg, cells, nobst, 16)
        band(b3_run, b3_cfg, cells, nobst, 16)
        _, k7_ms = timed(torch, lambda: band(band_run, band_cfg, cells, nobst, steps))
        _, k11_ms = timed(torch, lambda: band(b3_run, b3_cfg, cells, nobst, steps))
        for kp in (1, 2, 4):
            for sb in (128, 256, 512, 1024) + ((2048,) if n == 4096 else ()):
                c = base[:3] + (kp, sb)
                k13(cells, nobst, 16, c)
                _, ms = timed(torch, lambda: k13(cells, nobst, steps, c))
                sweep[n, kp, sb] = ms / steps
                log(f"  K13 {n}x{n} walls K {kp} S {sb}: {1e3 * ms / steps:.2f} us/step "
                    f"({n * n * steps / ms / 1e3:.1f} MLUPS)")
        k13(q, nobst, 16, base, spec)
        band(band_run, band_cfg, q, nobst, 16, spec)
        _, c16_ms = timed(torch, lambda: k13(q, nobst, steps, base, spec))
        _, k7c_ms = timed(torch, lambda: band(band_run, band_cfg, q, nobst, steps, spec))
        beside[n] = (k7_ms / steps, k11_ms / steps, c16_ms / steps, k7c_ms / steps)
        log(f"  {n}x{n} walls, same loop: K7 {1e3 * k7_ms / steps:.2f}, K11 "
            f"{1e3 * k11_ms / steps:.2f}, K13 default (K {base[3]}, S {base[4]}) "
            f"{1e3 * sweep[n, base[3], base[4]]:.2f}, K13 c16 {1e3 * c16_ms / steps:.2f}, K7 c16 "
            f"{1e3 * k7c_ms / steps:.2f} us/step")
        if n == 2048:
            n_plain = base[3] * base[1]
            k13(cells, nobst, n_plain, base, fn=slab.run_band_slab_plain)
            _, plain_ms = timed(torch, lambda: k13(cells, nobst, n_plain, base,
                                                   fn=slab.run_band_slab_plain))
            _, plain_c16_ms = timed(torch, lambda: k13(q, nobst, n_plain, base, spec,
                                                       slab.run_band_slab_plain))
            plain_ms, plain_c16_ms = plain_ms / n_plain, plain_c16_ms / n_plain
            log(f"  K13 plain 2048x2048: {1e3 * plain_ms:.2f} us/step, c16 "
                f"{1e3 * plain_c16_ms:.2f} us/step")
        del cells, nobst, q
    ranked = sorted(sweep, key=lambda key: (key[0], sweep[key]))
    for n in (2048, 4096):
        top = [key for key in ranked if key[0] == n][:3]
        log(f"  K13 sweep {n}^2, fastest first: " + ", ".join(
            f"K {kp} S {sb} {1e3 * sweep[n, kp, sb]:.2f}" for _, kp, sb in top))
    return cfg2, max(errs[None]), max(errs["c16"]), sweep, plain_ms, plain_c16_ms, beside


def c16_path_phase(torch, cli, gpu_line, walls_ref):
    """Phase 17; returns {counter name: launches}."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import aa, band, band3, slab, step
    from lbm_tpu_torch.runtime.driver import band_config, slab_config

    fns = {"K1": step.run_step, "K2": aa.run_aa, "K11": band3.run_band3, "K7": band.run_band,
           "K13": slab.run_band_slab}
    for fn in fns.values():
        fn.launches = fn.launches_c16 = 0
    want = {f"{name}{tail}": 0 for name in fns for tail in ("", " c16")}
    depth = band_config(None, torch.float32)[1]

    def split(route, n, tail, ny):
        if route == "slab":
            params = LBMParams(nx=ny, ny=ny, max_iters=1, reynolds_dim=10, density=DENSITY,
                               accel=ACCEL, omega=OMEGA)
            kt = slab_config(params, torch.float32)[3] * depth
            want["K13" + tail] += n // kt * kt
            n %= kt
            route = "band"
        name = {"band3": "K11", "band": "K7", "aa": "K2", "pallas": "K1"}[route]
        if route.startswith("band"):
            want[name + tail] += n // depth * depth
            want["K1" + tail] += n % depth
        else:
            want[name + tail] += n

    def account(stats, chunks=None):
        tail = " c16" if stats["precision"] == "c16" else ""
        for n in chunks or (stats["max_iters"],):
            split(stats["route"], n, tail, stats["ny"])

    with tempfile.TemporaryDirectory() as work:
        for tag in ("256x256", "1024x1024"):
            for backend in ("auto", "aa", "pallas"):
                stats = run_deck(cli, tag, backend, work, gpu_line, precision="c16")
                check(backend != "auto" or stats["route"] == "pallas",
                      f"{tag} c16: auto routed {stats['route']}, not pallas (K1)")
                account(stats)
            # The band kernels round once per pass (T steps), as the JAX
            # package's do: that cadence drifts past the 1% gate on the
            # 256^2 deck, so these runs are held at PASS_GATE_C16 percent,
            # which a saturated or broken run exceeds many times over.
            account(run_deck(cli, tag, "band3", work, gpu_line, precision="c16",
                             gate=PASS_GATE_C16))
        account(run_deck(cli, "1024x1024", "band", work, gpu_line, precision="c16",
                         gate=PASS_GATE_C16))
        os.environ["LBM_ENABLE_SLAB"] = "1"  # the quarantined route
        try:
            for precision in ("f32", "c16"):
                account(run_deck(cli, "1024x1024", "slab", work, gpu_line, precision=precision,
                                 gate=1.0 if precision == "f32" else PASS_GATE_C16))
            deck, ref = walls_ref
            out, stats = run_walls(cli, deck, "slab", work, 2048, gpu_line)
            account(stats)
            hold_against(out, ref, "walls 2048^2 --backend slab")
            shutil.rmtree(out)
        finally:
            del os.environ["LBM_ENABLE_SLAB"]
        # K2 rounds its codes every step, so chunk boundaries anywhere give
        # the same bits; the band kernels round once per pass.
        for n in resume_run(cli, work, gpu_line, backend="aa", precision="c16"):
            split("aa", n, " c16", 256)
    got = {f"{name}{tail}": getattr(fn, "launches" if not tail else "launches_c16")
           for name, fn in fns.items() for tail in ("", " c16")}
    log("  launch counters: " + ", ".join(f"{k} {got[k]} steps (want {want[k]})" for k in got))
    for k in got:
        check(got[k] == want[k], f"{k}: not every step of the c16 and slab path ran in its kernel")
    check(all(got[k] > 0 for k in ("K1 c16", "K2 c16", "K11 c16", "K7 c16", "K13", "K13 c16")),
          "a kernel of the c16 and slab path was never launched")
    return got


# The c16 forms of K9, K5, K6, K3, K8 and K10: name -> (name in the report,
# source, the TPU kernel it replaces).
C16_MORE = {
    "K9": (BANDS["band2"][0] + ", c16", *BANDS["band2"][1:]),
    "K5": (SCHEDULED["temporal"][0] + ", c16", *SCHEDULED["temporal"][1:]),
    "K6": (SCHEDULED["deep"][0] + ", c16", *SCHEDULED["deep"][1:]),
    "K3": (SHARDED["K3"][0] + ", c16 (1-D mesh)", *SHARDED["K3"][1:]),
    "K8": (SHARDED["K8"][0] + ", c16", *SHARDED["K8"][1:]),
    "K10": (SHARDED["K10"][0] + ", c16", *SHARDED["K10"][1:]),
}
C16_MORE_ROUTES = {"K9": "band2", "K5": "temporal", "K6": "deep"}


def c16_more_forms():
    """name -> (kernel, plain, depth, on shards): single-device forms take
    (cells, nobst, n, dev), the mesh forms (shards, nob_shards, n, ny, dev),
    with the driver's schedules."""
    import torch

    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band, band2, deep, shard_step, temporal
    from lbm_tpu_torch.runtime.driver import band2_config, band_config, pass_schedule

    params = LBMParams(nx=1024, ny=1024, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    plains = {"band2": band2.run_band2_plain, "temporal": temporal.run_temporal_plain,
              "deep": deep.run_deep_plain}
    out = {}
    for name, route in C16_MORE_ROUTES.items():
        run, (block, depth, panel) = pass_schedule(route, params, "c16")

        def bind(fn, block=block, depth=depth, panel=panel):
            return lambda c, o, n, dev=None: fn(c, o, DENSITY, ACCEL, OMEGA, n, block, depth,
                                                panel=panel, dev=dev)

        out[name] = (bind(run), bind(plains[route]), depth, False)

    def steps(fn):
        return lambda s, o, n, ny, dev=None: fn(s, o, DENSITY, ACCEL, OMEGA, n, ny, dev=dev)

    out["K3"] = (steps(shard_step.run_shard_step), steps(shard_step.run_shard_step_plain), 1,
                 True)
    for name, mod, run, cfg in (("K8", band, "run_band_sharded", band_config(params, "c16")),
                                ("K10", band2, "run_band2_sharded",
                                 band2_config(params, "c16"))):
        block, depth, panel = cfg

        def bind(fn, block=block, depth=depth, panel=panel):
            return lambda s, o, n, ny, dev=None: fn(s, o, DENSITY, ACCEL, OMEGA, n, block, depth,
                                                    ny, panel=panel, dev=dev)

        out[name] = (bind(getattr(mod, run)), bind(getattr(mod, run + "_plain")), depth, True)
    return out


def c16_more_phase(torch, spec, forms):
    """Phase 18; returns {name: (max_abs_err, ms, plain_ms, f32 ms)} per step
    at 2048^2 (the mesh forms with 4 row shards on cuda:0)."""
    from lbm_tpu_torch.ops import devspace
    from lbm_tpu_torch.ops.step import run_step

    def call(fn, on_shards, x, o, n, dev=None):
        """fn on a grid, or on its 4 row shards joined (state, av)."""
        if not on_shards:
            return fn(x, o, n, dev)
        return joined(torch, fn(x, o, n, x[0][0].shape[1] * 4, dev))

    out = {}
    for name, (kernel, plain, depth, on_shards) in forms.items():
        errs = []
        for nx, ny in ((1024, 1024), (1000, 1000)):
            cells, nobst = (random_setup(torch, nx, ny, seed=nx + 31) if nx == 1024
                            else walls_setup(torch, nx, 41))
            x, o = devspace.encode_state(cells, spec), nobst
            if on_shards:
                x, o = on_mesh(x, o, 4, 1)
            for n in ((50,) if depth == 1 else (depth, 2 * depth + 3)):
                errs.append(compare(torch, f"{name} c16 {nx}x{ny} {n} steps",
                                    call(kernel, on_shards, x, o, n, spec),
                                    call(plain, on_shards, x, o, n, spec), spec))
        out[name] = [max(errs)]
    cells, nobst = random_setup(torch, 1024, 1024, seed=37)
    q = devspace.encode_state(cells, spec)
    for name in ("K9", "K3"):
        kernel, _, _, on_shards = forms[name]
        x, o = on_mesh(q, nobst, 4, 1) if on_shards else (q, nobst)
        (c1, a1), (c2, a2) = (call(kernel, on_shards, x, o, 301, spec) for _ in range(2))
        torch.cuda.synchronize()
        check(torch.equal(c1, c2) and torch.equal(a1, a2),
              f"{name} c16 is not run-to-run deterministic")
        log(f"  {name} c16 determinism: two 301-step runs give bitwise-equal av series and codes")
    s, o = on_mesh(q, nobst, 4, 1)
    k3 = call(forms["K3"][0], True, s, o, 50, spec)
    k1 = run_step(q, nobst, DENSITY, ACCEL, OMEGA, 50, 1.0, dev=spec)
    log(f"  K3 c16 (4 shards) vs K1 c16 over 50 steps: codes bitwise equal: "
        f"{torch.equal(k3[0], k1[0])}")
    compare(torch, "K3 c16 vs K1 c16 1024x1024 50 steps", k3, k1, spec)
    del cells, nobst, q, s, o, k3, k1
    cells, nobst = random_setup(torch, 2048, 2048, seed=7)
    q = devspace.encode_state(cells, spec)
    for name, (kernel, plain, depth, on_shards) in forms.items():
        n = 400 if on_shards else 800
        xf, xq, o = cells, q, nobst
        if on_shards:
            (xf, o), (xq, _) = on_mesh(cells, nobst, 4, 1), on_mesh(q, nobst, 4, 1)
        call(kernel, on_shards, xf, o, 2 * depth)  # warm up, the allocator included
        call(kernel, on_shards, xq, o, 2 * depth, spec)
        _, f_ms = timed(torch, lambda: call(kernel, on_shards, xf, o, n))
        _, k_ms = timed(torch, lambda: call(kernel, on_shards, xq, o, n, spec))
        n_plain = 2 * depth
        call(plain, on_shards, xq, o, depth, spec)
        _, p_ms = timed(torch, lambda: call(plain, on_shards, xq, o, n_plain, spec))
        out[name] += [k_ms / n, p_ms / n_plain, f_ms / n]
        log(f"  {name} c16 2048x2048{' (4 shards)' if on_shards else ''}: kernel "
            f"{1e3 * k_ms / n:.2f} us/step ({2048 * 2048 * n / k_ms / 1e3:.1f} MLUPS), f32 form "
            f"{1e3 * f_ms / n:.2f} us/step, plain {1e3 * p_ms / n_plain:.2f} us/step")
        del xf, xq, o
    del cells, nobst, q
    return out


def mesh_2d_c16_run(cli, work, gpu_line):
    """``--mesh 2x2 --device 0 --precision c16`` (auto: the plain-torch c16
    step) on a 128^2 box cut to MESH_2D_ITERS steps, held against the
    one-device ``pallas`` (K1) c16 run of the same deck through the checker
    at 1%. Returns the two stats."""
    import numpy as np

    from lbm_tpu_torch.utils import geometry
    from lbm_tpu_torch.utils.checker import check_files

    deck = os.path.join(work, "box128-c16")
    os.makedirs(deck)
    params_path = os.path.join(deck, "input.params")
    obst_path = os.path.join(deck, "obstacles.dat")
    geometry.write_params_file(params_path, 128, 128, MESH_2D_ITERS, 10, DENSITY, ACCEL, OMEGA)
    geometry.write_obstacle_file(obst_path, geometry.box(128, 128))
    stats, outs = [], []
    for extra in (["--mesh", "2x2", "--backend", "auto"], ["--backend", "pallas"]):
        out = os.path.join(deck, extra[1])
        stats_path = os.path.join(out, "stats.json")
        os.makedirs(out)
        rc = cli.main([params_path, obst_path, "--device", "0", "--precision", "c16",
                       "--out-dir", out, "--stats-json", stats_path, *extra])
        check(rc == 0, f"128^2 c16 {' '.join(extra)}: cli.main returned {rc}")
        with open(stats_path) as f:
            stats.append(json.load(f))
        outs.append(out)
        log(f"  box 128x128 x {MESH_2D_ITERS} c16 {' '.join(extra)} --device 0: route "
            f"{stats[-1]['route']}, loop {stats[-1]['loop_s']:.4f} s, {stats[-1]['mlups']:.1f} "
            f"MLUPS [{gpu_line}]")
    check(stats[0]["route"] == "reference" and stats[1]["route"] == "pallas",
          f"2-D c16 routes {stats[0]['route']}, {stats[1]['route']}")
    files = [os.path.join(d, f) for d in outs for f in ("av_vels.dat", "final_state.dat")]
    res = check_files(*files, tolerance=1.0)
    av, av_ref = (np.loadtxt(f, usecols=[1]) for f in (files[0], files[2]))
    log(f"    2x2 vs K1 c16: checker av_vels {res.av_vels.max_diff_pcnt:.4g}%, pressure "
        f"{res.final_state.max_diff_pcnt:.4g}%: {'PASS' if res.passed else 'FAIL'}; av max rel "
        f"diff {float((np.abs(av - av_ref) / np.abs(av_ref)).max()):.3e}")
    check(bool(np.isfinite(av).all()) and res.passed, "the 2x2 c16 run fails the 1% checker")
    return stats


def c16_mesh_path_phase(torch, cli, gpu_line, forms):
    """Phase 19; returns {counter name: launches}."""
    from lbm_tpu_torch.ops import band, band2, deep, shard_step, step, temporal

    fns = {"K9": band2.run_band2, "K5": temporal.run_temporal, "K6": deep.run_deep,
           "K1": step.run_step, "K3": shard_step.run_shard_step, "K8": band.run_band_sharded,
           "K10": band2.run_band2_sharded}
    for fn in fns.values():
        fn.launches = fn.launches_c16 = 0
    want = dict.fromkeys(fns, 0)
    kernel_of = {"band2": "K9", "temporal": "K5", "deep": "K6"}
    mesh_kernel_of = {"pallas": "K3", "band": "K8", "band2": "K10"}

    def account(stats):
        route, n = stats["route"], stats["max_iters"]
        if stats["mesh"] == "0":
            check(route in kernel_of or route == "pallas", f"unexpected c16 route {route}")
            name, rem = kernel_of.get(route, "K1"), "K1"
        elif "x" in stats["mesh"]:
            check(route == "reference", f"--mesh {stats['mesh']} c16 routed {route}")
            return
        else:
            check(all(sh["device"] == "cuda:0" for sh in stats["shards"]),
                  f"shards not all on cuda:0: {stats['shards']}")
            name, rem = mesh_kernel_of[route], "K3"
        depth = forms[name][2] if name in forms else 1
        want[name] += n // depth * depth
        want[rem] += n % depth

    with tempfile.TemporaryDirectory() as work:
        for tag in ("256x256", "1024x1024"):
            for backend in ("band2", "temporal", "deep"):
                account(run_deck(cli, tag, backend, work, gpu_line, precision="c16",
                                 gate=PASS_GATE_C16))
        for backend in ("auto", "pallas", "band", "band2"):
            stats = run_deck(cli, "1024x1024", backend, work, gpu_line, mesh="4", precision="c16",
                             gate=1.0 if backend in ("auto", "pallas") else PASS_GATE_C16)
            check(backend != "auto" or stats["route"] == "pallas",
                  f"--mesh 4 c16 auto routed {stats['route']}, not pallas (K3)")
            account(stats)
        account(run_deck(cli, "256x256", "auto", work, gpu_line, mesh="4", precision="c16"))
        # K3 rounds its codes every step, so the resumed run gives the bits.
        want["K3"] += sum(resume_run(cli, work, gpu_line, backend="auto", mesh="4",
                                     precision="c16"))
        for stats in mesh_2d_c16_run(cli, work, gpu_line):
            account(stats)
    got = {f"{name} c16": fn.launches_c16 for name, fn in fns.items()}
    got_f32 = {name: fn.launches for name, fn in fns.items()}
    log("  launch counters: " + ", ".join(f"{k} {got[k]} steps (want {want[k.split()[0]]})"
                                          for k in got))
    for k, n in got.items():
        check(n == want[k.split()[0]], f"{k}: not every step of the c16 path ran in its kernel")
        check(n > 0, f"{k}: a kernel of the c16 path was never launched")
    check(not any(got_f32.values()), f"an f32 counter moved on the c16 path: {got_f32}")
    return got


def t16_panel(plane_copies, block, depth):
    """The widest panel whose window fits the shared memory of a block."""
    from lbm_tpu_torch.ops.band_common import SMEM_LIMIT, smem_bytes

    panel = 1
    while smem_bytes(plane_copies, 4096, block, depth, panel + 1) <= SMEM_LIMIT:
        panel += 1
    return panel


def gate_per_t_phase(torch, gpu_line):
    """Phase 20; returns {(kernel, T, deck): (av %, pressure %, loop s)}."""
    import numpy as np

    from lbm_tpu_torch.io import write_av_vels, write_final_state
    from lbm_tpu_torch.models.d2q9 import D2Q9, LBMParams
    from lbm_tpu_torch.ops import band2, band3, devspace
    from lbm_tpu_torch.utils import geometry
    from lbm_tpu_torch.utils.checker import check_files

    kernels = {"K9": (band2.run_band2, band2.PLANE_COPIES, (24, 24)),
               "K11": (band3.run_band3, band3.PLANE_COPIES, (24, 56))}
    out = {}
    with tempfile.TemporaryDirectory() as work:
        for tag in ("256x256", "1024x1024"):
            fields, geo, kw = DECKS[tag]
            params = LBMParams(*fields)
            obstacles = getattr(geometry, geo)(fields[0], fields[1], **kw)
            gold = write_gold(os.path.join(ROOT, "tests", "golden", f"{tag}.golden.npz"), work)
            dev = torch.device("cuda", 0)
            spec = devspace.DevSpec.for_params(params.density, params.accel)  # the deck's H
            nobst = torch.as_tensor((obstacles == 0).astype(np.float32)).to(dev)
            q0 = devspace.encode_state(D2Q9.initial_state(params, dtype=torch.float32,
                                                          device=dev), spec)
            inv = float(np.float32(1.0 / int(np.sum(obstacles == 0))))
            for name, (run, copies, (block, panel)) in kernels.items():
                for depth in (4, 8, 16):
                    b, p = (block, panel) if depth < 16 else (2 * depth, t16_panel(copies, 32, 16))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    cells, av = run(q0, nobst, params.density, params.accel, params.omega,
                                    params.max_iters, b, depth, panel=p, inv_tot_cells=inv,
                                    dev=spec)
                    torch.cuda.synchronize()
                    loop = time.perf_counter() - t0
                    d = os.path.join(work, f"{tag}-{name}-T{depth}")
                    os.makedirs(d)
                    write_av_vels(os.path.join(d, "av_vels.dat"), av.cpu().numpy())
                    write_final_state(os.path.join(d, "final_state.dat"), params,
                                      devspace.decode_state(cells, spec).cpu().numpy(), obstacles)
                    res = check_files(os.path.join(d, "av_vels.dat"),
                                      os.path.join(d, "final_state.dat"), *gold, tolerance=1.0)
                    check(bool(torch.isfinite(av).all()), f"{name} T {depth} {tag}: non-finite av")
                    out[name, depth, tag] = (res.av_vels.max_diff_pcnt,
                                             res.final_state.max_diff_pcnt, loop)
                    log(f"  {name} c16 T {depth} (block {b}, panel {p}) {tag} x "
                        f"{params.max_iters}: av_vels {res.av_vels.max_diff_pcnt:.4g}% at step "
                        f"{res.av_vels.max_index}, pressure {res.final_state.max_diff_pcnt:.4g}%:"
                        f" 1% gate {'PASS' if res.passed else 'FAIL'}; loop {loop:.3f} s "
                        f"[{gpu_line}]")
                    shutil.rmtree(d)
    return out


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on a GPU")
    sys.path.insert(0, ROOT)
    try:
        from lbm_tpu_torch import cli
        from lbm_tpu_torch.ops import _build
        from lbm_tpu_torch.ops.aa import run_aa, run_aa_plain
        from lbm_tpu_torch.ops.step import run_step, run_step_plain
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")

    phase("1. environment")
    gpu_line = nvidia_smi()
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  {gpu_line}")
    log(f"  torch.cuda: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    phase("2. build")
    b = _build.library().build_info
    check("sm_90a" in b["flags"], "kernels not built for sm_90a")
    log(f"  {'built' if b['built'] else 'loaded'} {os.path.relpath(b['path'], ROOT)} "
        f"in {b['seconds']:.1f} s with nvcc {b['flags']} from {', '.join(b['sources'])}")
    build_native_io()

    phase("3. K1 step kernel vs step_plain")
    k1_err, k1_ms, k1_plain_ms = kernel_phase(torch, "K1", run_step, run_step_plain, (200,))

    phase("4. K2 AA kernel vs run_aa_plain")
    k2_err, k2_ms, k2_plain_ms = kernel_phase(torch, "K2", run_aa, run_aa_plain, (200, 201))
    cells, nobst = random_setup(torch, 1024, 1024, seed=11)
    compare(torch, "K2 vs K1 1024x1024 1000 steps",
            run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, 1.0),
            run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, 1.0))
    c1, a1 = run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, 301, 1.0)
    c2, a2 = run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, 301, 1.0)
    check(torch.equal(a1, a2) and torch.equal(c1, c2), "K2 is not run-to-run deterministic")
    log("  K2 determinism: two 301-step runs give bitwise-equal av series and state")

    phase("5. the K2 and K1 path: lbm_tpu_torch.cli.main on the official decks")
    run_aa.launches = 0
    run_step.launches = 0
    with tempfile.TemporaryDirectory() as work:
        for tag in DECKS:
            run_deck(cli, tag, "aa", work, gpu_line)
        run_deck(cli, "1024x1024", "pallas", work, gpu_line)
    aa_launches, step_launches = run_aa.launches, run_step.launches
    want_aa = sum(fields[2] for fields, _, _ in DECKS.values())
    want_step = DECKS["1024x1024"][0][2]
    log(f"  launch counters: K2 {aa_launches} steps (want {want_aa}), "
        f"K1 {step_launches} steps (want {want_step})")
    check(aa_launches == want_aa, "--backend aa did not run every step through K2")
    check(step_launches == want_step, "--backend pallas did not run every step through K1")

    phase("6. band kernels K7, K9, K11 vs their plain versions")
    routes = band_routes()
    aa_us = {}
    for nx, n_aa in ((2048, 800), (4096, 200)):
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, 10, 1.0)
        _, ms = timed(torch, lambda: run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, n_aa, 1.0))
        aa_us[nx] = 1e3 * ms / n_aa
    band_res = {}
    for route, (label, kernel, plain, cfg) in routes.items():
        depth = cfg[1]
        counts = (depth, 2 * depth + 3) + ((3 * depth, 4 * depth) if route == "band3" else ())
        band_res[route] = band_phase(torch, label, kernel, plain, cfg, counts, aa_us)

    phase("7. band kernels vs K1 over 1000 steps at 2048x2048, and repeatability")
    cells, nobst = random_setup(torch, 2048, 2048, seed=13)
    k1 = run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, 1.0)
    for route, (label, kernel, _, (block, depth, panel)) in routes.items():
        def go():
            return kernel(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, block, depth, panel=panel)

        (c1, a1), (c2, a2) = go(), go()
        torch.cuda.synchronize()
        log(f"  {label} vs K1: final state bitwise equal: {torch.equal(c1, k1[0])}, max diff "
            f"{float((c1 - k1[0]).abs().max()):.3e}")
        compare(torch, f"{label} vs K1 2048x2048 1000 steps", (c1, a1), k1)
        check(torch.equal(c1, c2) and torch.equal(a1, a2), f"{label} is not run-to-run deterministic")
        log(f"  {label} determinism: two 1000-step runs give bitwise-equal av series and state")
    del cells, nobst, k1

    phase("8. the band path: lbm_tpu_torch.cli.main with band, band2, band3 and auto")
    from lbm_tpu_torch.ops import band, band2, band3, resident

    counters = {"band": band.run_band, "band2": band2.run_band2, "band3": band3.run_band3}
    for fn in (*counters.values(), run_step, run_aa, resident.run_resident):
        fn.launches = 0
    want = dict.fromkeys(counters, 0)
    want_k1 = want_k2 = want_k4 = 0

    def account(stats):
        nonlocal want_k1, want_k2, want_k4
        route, n = stats["route"], stats["max_iters"]
        if route in counters:
            depth = routes[route][3][1]
            want[route] += n // depth * depth
            want_k1 += n % depth
        elif route == "resident":
            want_k4 += n
        else:
            check(route == "aa", f"unexpected route {route}")
            want_k2 += n

    # The 2048^2 walls deck and its K2 run stay for phase 11, in ``keep``.
    keep = tempfile.mkdtemp()
    walls_ref = {}
    with tempfile.TemporaryDirectory() as work:
        for tag in DECKS:
            stats = run_deck(cli, tag, "auto", work, gpu_line)
            check(stats["route"] == AUTO_ROUTES[tag],
                  f"{tag}: auto routed {stats['route']}, not {AUTO_ROUTES[tag]}")
            account(stats)
        for tag in ("256x256", "1024x1024"):
            for route in counters:
                account(run_deck(cli, tag, route, work, gpu_line))
        for n, iters in WALLS_DECKS:
            deck = write_walls_deck(keep if n == 2048 else work, n, iters)
            ref, stats = run_walls(cli, deck, "aa", keep if n == 2048 else work, n, gpu_line)
            account(stats)
            # On 4096^2 only band3, the route auto takes there as on 2048^2:
            # K7 and K9 ran that size in phase 6, and writing and checking the
            # deck's 16.7M-line outputs is most of this phase's time.
            for backend in (*counters, "auto") if n < 4096 else ("band3",):
                out, stats = run_walls(cli, deck, backend, work, n, gpu_line)
                account(stats)
                check(backend != "auto" or stats["route"] == "band3",
                      f"walls {n}^2: auto routed {stats['route']}, not band3")
                hold_against(out, ref, f"walls {n}^2 --backend {backend}")
                shutil.rmtree(out)
            if n == 2048:
                walls_ref[n] = (deck, ref)
            else:
                shutil.rmtree(ref)
    got = {route: fn.launches for route, fn in counters.items()}
    log(f"  launch counters: K7 {got['band']} steps (want {want['band']}), K9 {got['band2']} "
        f"(want {want['band2']}), K11 {got['band3']} (want {want['band3']}), K1 "
        f"{run_step.launches} (want {want_k1}), K2 {run_aa.launches} (want {want_k2}), K4 "
        f"{resident.run_resident.launches} (want {want_k4})")
    for route in counters:
        check(got[route] == want[route], f"--backend {route}: not every band step ran in its kernel")
    check(run_step.launches == want_k1, "not every remainder step ran in K1")
    check(resident.run_resident.launches == want_k4, "auto did not run every K4 step in K4")
    check(run_aa.launches == want_k2, "--backend aa did not run every step through K2")

    phase("9. K4, K5, K6 vs their plain versions")
    sched = scheduled_routes()
    _, k11_run, _, k11_cfg = routes["band3"]

    def k11(c, o, n):
        return k11_run(c, o, DENSITY, ACCEL, OMEGA, n, k11_cfg[0], k11_cfg[1], panel=k11_cfg[2])

    sched_res = {}
    for route, (label, kernel, plain, depth) in sched.items():
        counts = (254, 255, 256, 511) if route == "resident" else (depth, 2 * depth + 3)
        sched_res[route] = scheduled_phase(torch, label, kernel, plain, counts, depth, k11)

    phase("10. K4, K5, K6 vs K1 over 1000 steps at 2048x2048, and repeatability")
    cells, nobst = random_setup(torch, 2048, 2048, seed=17)
    k1 = run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, 1.0)
    for route, (label, kernel, _, _) in sched.items():
        (c1, a1), (c2, a2) = kernel(cells, nobst, 1000), kernel(cells, nobst, 1000)
        torch.cuda.synchronize()
        log(f"  {label} vs K1: final state bitwise equal: {torch.equal(c1, k1[0])}, max diff "
            f"{float((c1 - k1[0]).abs().max()):.3e}")
        compare(torch, f"{label} vs K1 2048x2048 1000 steps", (c1, a1), k1)
        check(torch.equal(c1, c2) and torch.equal(a1, a2), f"{label} is not run-to-run deterministic")
        log(f"  {label} determinism: two 1000-step runs give bitwise-equal av series and state")
    del cells, nobst, k1, c1, c2

    phase("11. the resident, temporal and deep path: lbm_tpu_torch.cli.main, and --resume")
    from lbm_tpu_torch.ops import deep, resident, temporal

    sched_counters = {"resident": resident.run_resident, "temporal": temporal.run_temporal,
                      "deep": deep.run_deep}
    for fn in (*sched_counters.values(), run_step):
        fn.launches = 0
    want = dict.fromkeys(sched_counters, 0)
    want_k1 = 0

    def account_sched(stats):
        nonlocal want_k1
        route, n = stats["route"], stats["max_iters"]
        check(route in sched_counters, f"unexpected route {route}")
        depth = sched[route][3]
        want[route] += n // depth * depth
        want_k1 += n % depth

    with tempfile.TemporaryDirectory() as work:
        for tag in ("256x256", "1024x1024"):
            for route in sched_counters:
                account_sched(run_deck(cli, tag, route, work, gpu_line))
        want["resident"] += sum(resume_run(cli, work, gpu_line))
        deck, ref = walls_ref[2048]  # phase 8's deck and K2 run
        for route in sched_counters:
            out, stats = run_walls(cli, deck, route, work, 2048, gpu_line)
            account_sched(stats)
            hold_against(out, ref, f"walls 2048^2 --backend {route}")
            shutil.rmtree(out)
    got_sched = {route: fn.launches for route, fn in sched_counters.items()}
    log(f"  launch counters: K4 {got_sched['resident']} steps (want {want['resident']}), K5 "
        f"{got_sched['temporal']} (want {want['temporal']}), K6 {got_sched['deep']} (want "
        f"{want['deep']}), K1 {run_step.launches} (want {want_k1})")
    for route in sched_counters:
        check(got_sched[route] == want[route], f"--backend {route}: not every step ran in its kernel")
    check(run_step.launches == want_k1, "not every remainder step ran in K1")

    shard, shard_res, got_mesh = mesh_phases(torch, cli, run_step, gpu_line)

    from lbm_tpu_torch.ops.devspace import DevSpec

    spec = DevSpec.for_params(DENSITY, ACCEL)
    phase("15. c16 kernels K1, K2, K11, K7 vs their plain versions")
    c16_res = c16_phase(torch, spec, routes)
    phase("16. K13 slab kernel at f32 and c16: vs its plain version, vs K1, the (K, S) sweep")
    slab_cfg, slab_err, slab_c16_err, sweep, slab_plain, slab_plain_c16, beside = slab_phase(
        torch, spec, routes)
    phase("17. the c16 and slab path: lbm_tpu_torch.cli.main --precision c16, "
          "LBM_ENABLE_SLAB=1 --backend slab, and --resume")
    got_c16 = c16_path_phase(torch, cli, gpu_line, walls_ref[2048])
    shutil.rmtree(keep)
    phase("18. c16 forms K9, K5, K6, K3, K8, K10 vs their plain versions and f32 forms")
    more = c16_more_forms()
    more_res = c16_more_phase(torch, spec, more)
    phase("19. the c16 path: lbm_tpu_torch.cli.main --precision c16 with band2, temporal, deep, "
          "--mesh 4 and 2x2 --device 0, and --resume")
    got_more = c16_mesh_path_phase(torch, cli, gpu_line, more)
    phase("20. the gate per T: K9 and K11 at c16 with T 4, 8 and 16 on the 256^2 and 1024^2 decks")
    gate_per_t_phase(torch, gpu_line)

    def entry(name, source, replaces, launches, err, ms, plain_ms, cells, depth=1,
              bytes_per_cell=BYTES_PER_CELL):
        bound_ms, bound_by = bound(cells, depth, bytes_per_cell)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}

    from lbm_tpu_torch.runtime.driver import resident_config

    shard_launches = {"K3": got_mesh["pallas"], "K12": got_mesh["pallas-overlap"],
                      "K8": got_mesh["band"], "K10": got_mesh["band2"]}
    band_depth = {route: routes[route][3][1] for route in BANDS}
    kt, sb = slab_cfg[3] * slab_cfg[1], slab_cfg[4]
    slab_bytes = (sb + 2 * kt) / sb
    slab_ms = sweep[2048, slab_cfg[3], sb]
    report = {"kernels": [
        entry("K1 fused step", "lbm_tpu_torch/csrc/step.cu", "lbm_tpu/ops/pallas_step.py:164",
              step_launches, k1_err, k1_ms, k1_plain_ms, 1024 * 1024),
        entry("K2 in-place AA", "lbm_tpu_torch/csrc/aa.cu", "lbm_tpu/ops/pallas_aa.py:163",
              aa_launches, k2_err, k2_ms, k2_plain_ms, 1024 * 1024),
    ] + [
        entry(*BANDS[route], got[route], band_res[route][0], band_res[route][1][2048][0],
              band_res[route][1][2048][1], 2048 * 2048, band_depth[route])
        for route in BANDS
    ] + [
        entry(*SCHEDULED[route], got_sched[route], sched_res[route][0],
              *sched_res[route][1][1024 if route == "resident" else 2048],
              (1024 if route == "resident" else 2048) ** 2,
              resident_config(None, torch.float32) if route == "resident" else sched[route][3])
        for route in SCHEDULED
    ] + [
        entry(*SHARDED[name], shard_launches[name], shard_res[name][0],
              *shard_res[name][1][(4, 1), 2048][:2], 2048 * 2048, shard[name][4])
        for name in SHARDED
    ] + [
        entry(*C16_KERNELS[name], got_c16[name + " c16"], c16_res[name][0], c16_res[name][1],
              c16_res[name][2], (1024 if name in ("K1", "K2") else 2048) ** 2,
              1 if name in ("K1", "K2") else band_depth["band3" if name == "K11" else "band"],
              BYTES_PER_CELL_C16)
        for name in C16_KERNELS
    ] + [
        entry(*SLAB, got_c16["K13"], slab_err, slab_ms, slab_plain, 2048 * 2048, kt,
              BYTES_PER_CELL * slab_bytes),
        entry(SLAB[0] + ", c16", *SLAB[1:], got_c16["K13 c16"], slab_c16_err, beside[2048][2],
              slab_plain_c16, 2048 * 2048, kt, BYTES_PER_CELL_C16 * slab_bytes),
    ] + [
        entry(*C16_MORE[name], got_more[name + " c16"], *more_res[name][:3], 2048 * 2048,
              more[name][2], BYTES_PER_CELL_C16)
        for name in C16_MORE
    ]}
    log(gpu_line)
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.time()
    rc = main()
    print(f"chip_smoke: done in {time.time() - t0:.1f} s", file=sys.stderr)
    raise SystemExit(rc)
