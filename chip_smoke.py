#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each printing what it found:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: nvcc builds the kernels of ``lbm_tpu_torch/csrc`` for sm_90a;
3. K1 (``csrc/step.cu``) against ``step_plain`` on the card, 1024^2 and
   1000^2, 200 steps; time per step of each at 1024^2 and 128^2;
4. K2 (``csrc/aa.cu``) against ``run_aa_plain``, 200 and 201 steps (both
   exit parities) at 1024^2 and 1000^2; K2 against K1 over 1000 steps;
   two K2 runs must give bitwise-equal results;
5. the main path: the four official decks, generated with
   ``utils/geometry``, through ``lbm_tpu_torch.cli.main`` (what
   ``python -m lbm_tpu_torch`` runs) with ``--backend auto`` at f32, and
   the 1024^2 deck once more with ``--backend pallas``. The launch counters,
   zeroed just before, must show that auto ran K2 and pallas ran K1 for
   every step; the 1024^2 and 256^2 results must pass the 1% gate against
   ``tests/golden/*.golden.npz``.

Tolerances: kernel against plain version, cells within 1e-5 of the
state's scale and av series at rtol 1e-4 (f32 with FMA contraction in the
kernels and another summation order); golden gate 1% (the reference's
checker). Any failure exits non-zero before the last line. The last two
lines are the kernel report and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_CELLS = 1e-5
TOL_AV = 1e-4
DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85

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


def log(*args):
    print(*args, flush=True)


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


def compare(torch, name, got, want):
    (gc, ga), (wc, wa) = got, want
    torch.cuda.synchronize()
    check(bool(torch.isfinite(gc).all()) and bool(torch.isfinite(ga).all()),
          f"{name}: non-finite output")
    err = float((gc - wc).abs().max())
    scale = float(wc.abs().max())
    av_rel = float(((ga.double() - wa.double()).abs() / wa.double().abs()).max())
    log(f"  {name}: max|cells diff| {err:.3e} (limit {TOL_CELLS * scale:.3e}), "
        f"max av rel diff {av_rel:.3e} (limit {TOL_AV})")
    check(err <= TOL_CELLS * scale, f"{name}: cells differ by {err}")
    check(av_rel <= TOL_AV, f"{name}: av series differs by {av_rel}")
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


def run_deck(cli, tag, backend, work, gpu_line):
    import numpy as np

    from lbm_tpu_torch.utils import geometry
    from lbm_tpu_torch.utils.checker import check_files

    fields, geo, kw = DECKS[tag]
    deck_dir = os.path.join(work, f"{tag}-{backend}")
    os.makedirs(deck_dir)
    params_path = os.path.join(deck_dir, f"input_{tag}.params")
    obst_path = os.path.join(deck_dir, f"obstacles_{tag}.dat")
    geometry.write_params_file(params_path, *fields)
    geometry.write_obstacle_file(obst_path, getattr(geometry, geo)(fields[0], fields[1], **kw))
    stats_path = os.path.join(deck_dir, "stats.json")
    rc = cli.main([params_path, obst_path, "--backend", backend, "--out-dir", deck_dir,
                   "--stats-json", stats_path])
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
                          os.path.join(deck_dir, "final_state.dat"), gav, gfs, tolerance=1.0)
        line += (f"\n    golden gate (1%): av_vels max diff {res.av_vels.max_diff_pcnt:.4g}% "
                 f"at step {res.av_vels.max_index}, pressure max diff "
                 f"{res.final_state.max_diff_pcnt:.4g}% at ({res.final_state.coord_x},"
                 f"{res.final_state.coord_y}): {'PASS' if res.passed else 'FAIL'}")
        log(line)
        check(res.passed, f"{tag} --backend {backend} fails the golden gate")
    else:
        log(line)
    return stats


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

    log("== 1. environment")
    gpu_line = nvidia_smi()
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  {gpu_line}")
    log(f"  torch.cuda: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    log("== 2. build")
    b = _build.library().build_info
    check("sm_90a" in b["flags"], "kernels not built for sm_90a")
    log(f"  {'built' if b['built'] else 'loaded'} {os.path.relpath(b['path'], ROOT)} "
        f"in {b['seconds']:.1f} s with nvcc {b['flags']} from {', '.join(b['sources'])}")

    log("== 3. K1 step kernel vs step_plain")
    k1_err, k1_ms, k1_plain_ms = kernel_phase(torch, "K1", run_step, run_step_plain, (200,))

    log("== 4. K2 AA kernel vs run_aa_plain")
    k2_err, k2_ms, k2_plain_ms = kernel_phase(torch, "K2", run_aa, run_aa_plain, (200, 201))
    cells, nobst = random_setup(torch, 1024, 1024, seed=11)
    compare(torch, "K2 vs K1 1024x1024 1000 steps",
            run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, 1.0),
            run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, 1.0))
    c1, a1 = run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, 301, 1.0)
    c2, a2 = run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, 301, 1.0)
    check(torch.equal(a1, a2) and torch.equal(c1, c2), "K2 is not run-to-run deterministic")
    log("  K2 determinism: two 301-step runs give bitwise-equal av series and state")

    log("== 5. main path: lbm_tpu_torch.cli.main on the official decks")
    run_aa.launches = 0
    run_step.launches = 0
    with tempfile.TemporaryDirectory() as work:
        for tag in DECKS:
            run_deck(cli, tag, "auto", work, gpu_line)
        run_deck(cli, "1024x1024", "pallas", work, gpu_line)
    aa_launches, step_launches = run_aa.launches, run_step.launches
    want_aa = sum(fields[2] for fields, _, _ in DECKS.values())
    want_step = DECKS["1024x1024"][0][2]
    log(f"  launch counters: K2 {aa_launches} steps (want {want_aa}), "
        f"K1 {step_launches} steps (want {want_step})")
    check(aa_launches == want_aa, "auto did not run every step through K2")
    check(step_launches == want_step, "--backend pallas did not run every step through K1")

    report = {"kernels": [
        {"name": "K1 fused step", "route": "cuda", "source": "lbm_tpu_torch/csrc/step.cu",
         "replaces": "lbm_tpu/ops/pallas_step.py:164", "launches": step_launches,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "K2 in-place AA", "route": "cuda", "source": "lbm_tpu_torch/csrc/aa.cu",
         "replaces": "lbm_tpu/ops/pallas_aa.py:163", "launches": aa_launches,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms},
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
