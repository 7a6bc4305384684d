"""The port's throughput on the reference's largest deck.

    python -m lbm_tpu_torch.bench [--iters N] [--size N] [--device N|cpu]

Builds the 1024x1024 deck in-process (``utils/geometry.py``: the box with a
vertical wall at column 341 and the params of ``input_1024x1024.params``,
as ``examples/generate_inputs.py`` writes them), runs
``runtime.driver.run_simulation(..., backend="auto")`` at f32 once as a
warm-up (the kernels' build included), then three times, and prints ONE
JSON line from the best of the three compute loops, as the JAX package's
``bench.py`` does:

    {"metric": "mlups_1024x1024", "value": ..., "unit": "MLUPS", "vs_baseline": ...}

``vs_baseline`` is relative to the reference's best published number: its
final OpenCL version runs 128x128 x 40k iterations in 4.5 s on a BCP3 GPU
node = 145.6 MLUPS. The loop's time is ``SimulationResult.elapsed``, between
two ``torch.cuda.synchronize()`` calls, without the build. The device's
name and power limit (``nvidia-smi``) and the three loop times go to
stderr. ``--size`` runs an n x n deck of the same family (the wall at
column n // 3) under the metric ``mlups_<n>x<n>``; ``--device cpu`` runs the
plain versions, whose rate says nothing of a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

BASELINE_MLUPS = 128 * 128 * 40000 / 4.5 / 1e6  # the reference's best: ~145.6


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the device."""
    if device.type != "cuda":
        return str(device)
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", f"--id={device.index or 0}"],
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{device} (nvidia-smi: {e})"
    return proc.stdout.strip() or f"{device} (nvidia-smi: {proc.stderr.strip()})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="MLUPS of the 1024x1024 deck under backend auto.")
    ap.add_argument("--iters", type=int, default=20000, help="steps of each run (default 20000)")
    ap.add_argument("--size", type=int, default=1024, help="the deck's nx = ny (default 1024)")
    ap.add_argument("--device", default=None, help="CUDA device index or 'cpu' (default cuda:0)")
    args = ap.parse_args(argv)

    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.runtime.device import select_device
    from lbm_tpu_torch.runtime.driver import run_simulation
    from lbm_tpu_torch.utils.geometry import box_with_vertical_wall

    n = args.size
    params = LBMParams(nx=n, ny=n, max_iters=args.iters, reynolds_dim=10, density=0.1,
                       accel=0.01, omega=1.85)
    obstacles = box_with_vertical_wall(n, n, wall_col=n // 3)
    device = select_device(args.device)

    def run():
        return run_simulation(params, obstacles, backend="auto", device=device,
                              fetch_final=False)

    run()
    passes = [run() for _ in range(3)]
    best = min(passes, key=lambda r: r.elapsed)
    mlups = best.mlups(params)
    print(json.dumps({"metric": f"mlups_{n}x{n}", "value": round(mlups, 1), "unit": "MLUPS",
                      "vs_baseline": round(mlups / BASELINE_MLUPS, 2)}), flush=True)
    print(f"# {card_line(device)}; {args.iters} iters, route {best.route}, best loop "
          f"{best.elapsed:.4f} s of {[round(r.elapsed, 4) for r in passes]}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
