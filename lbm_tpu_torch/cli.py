"""Command-line interface (counterpart of ``lbm_tpu/cli.py``).

    python -m lbm_tpu_torch <paramfile> <obstaclefile> [options]

Writes ``final_state.dat`` and ``av_vels.dat`` in the output directory and
prints the reference's stdout block (d2q9-bgk.c:283-287):

    ==done==
    Reynolds number:\t\t%.12E
    Elapsed time:\t\t\t%.6f (s)
    Elapsed user CPU time:\t\t%.6f (s)
    Elapsed system CPU time:\t%.6f (s)

``--backend`` takes the JAX package's names, so one command line drives
both packages. Bad inputs end with ``lbm_tpu_torch: error: ...`` on stderr
and exit code 1, never a traceback.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    from lbm_tpu_torch.runtime.driver import BACKENDS

    p = argparse.ArgumentParser(
        prog="lbm_tpu_torch",
        description="D2Q9 BGK lattice-Boltzmann solver on PyTorch and CUDA",
    )
    p.add_argument("paramfile", help="7-field params file (nx ny maxIters reynolds_dim density accel omega)")
    p.add_argument("obstaclefile", help="obstacle list file ('x y 1' per line)")
    p.add_argument(
        "--backend",
        choices=list(BACKENDS),
        default="auto",
        help="aa: in-place AA kernel on one state copy (auto's route at f32); "
        "pallas: fused one-step kernel; reference: plain PyTorch step",
    )
    p.add_argument("--precision", choices=["f32", "f64"], default="f32",
                   help="state dtype (f64 runs the reference step)")
    p.add_argument("--out-dir", default=".", help="directory for output .dat files")
    p.add_argument(
        "--device",
        default=None,
        metavar="N|cpu",
        help="CUDA device index (default: $LBM_DEVICE or 0); 'cpu' runs on the "
        "host, which happens only when named",
    )
    p.add_argument("--list-devices", action="store_true",
                   help="print the device table and exit")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="write run metrics (MLUPS, timings, Reynolds, route) as JSON")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="log configuration and timings")
    return p


def _error(msg) -> int:
    print(f"lbm_tpu_torch: error: {msg}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from lbm_tpu_torch.io import read_obstacles, read_params, write_av_vels, write_final_state
    from lbm_tpu_torch.io.files import InputError
    from lbm_tpu_torch.runtime.device import (
        device_name, format_device_list, format_selected, print_devices, select_device,
    )
    from lbm_tpu_torch.runtime.driver import run_simulation

    if args.list_devices:
        print_devices(file=sys.stdout)
        return 0
    try:
        device = select_device(args.device)
    except (IndexError, ValueError) as e:
        return _error(e)
    print(format_device_list())
    print(format_selected(device))

    try:
        params = read_params(args.paramfile)
        obstacles = read_obstacles(args.obstaclefile, params)
    except (InputError, OSError) as e:
        return _error(e)
    dtype = {"f32": torch.float32, "f64": torch.float64}[args.precision]
    if args.verbose:
        print(
            f"[lbm_tpu_torch] grid {params.nx}x{params.ny}, {params.max_iters} iters, "
            f"backend={args.backend}, precision={args.precision}, "
            f"device={device_name(device)} ({device})",
            file=sys.stderr,
        )

    tic = time.time()
    try:
        result = run_simulation(params, obstacles, backend=args.backend, dtype=dtype,
                                device=device)
    except ValueError as e:
        return _error(e)
    toc = time.time()
    ru = resource.getrusage(resource.RUSAGE_SELF)
    reynolds = result.reynolds(params, obstacles)

    # The reference's stdout block (d2q9-bgk.c:283-287).
    print("==done==")
    print("Reynolds number:\t\t%.12E" % reynolds)
    print("Elapsed time:\t\t\t%.6f (s)" % (toc - tic))
    print("Elapsed user CPU time:\t\t%.6f (s)" % ru.ru_utime)
    print("Elapsed system CPU time:\t%.6f (s)" % ru.ru_stime)
    if args.verbose:
        print(
            f"[lbm_tpu_torch] route {result.route}, compute loop {result.elapsed:.6f} s "
            f"({result.mlups(params):.1f} MLUPS), kernel build {result.compile_time:.3f} s",
            file=sys.stderr,
        )
    if args.stats_json:
        stats = {
            "nx": params.nx,
            "ny": params.ny,
            "max_iters": params.max_iters,
            "backend": args.backend,
            "route": result.route,
            "precision": args.precision,
            "device": f"{device_name(device)} ({result.device})",
            "torch_device": result.device,
            "elapsed_wall_s": toc - tic,
            "loop_s": result.elapsed,
            "compile_s": result.compile_time,
            "mlups": result.mlups(params),
            "reynolds": reynolds,
        }
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=2)
            f.write("\n")

    os.makedirs(args.out_dir, exist_ok=True)
    write_final_state(os.path.join(args.out_dir, "final_state.dat"), params,
                      result.cells, obstacles)
    write_av_vels(os.path.join(args.out_dir, "av_vels.dat"), result.av_vels)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
