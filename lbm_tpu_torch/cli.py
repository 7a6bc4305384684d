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
both packages; so do ``--mesh N|PYxPX`` (shards over a mesh of devices in
this process; with ``--device`` or ``$LBM_DEVICE`` every shard goes to
that device, else the mesh is the first N cards) and
``--checkpoint-every``/``--checkpoint-path``/``--resume``, whose npz
checkpoints either package resumes; ``--debug`` (the reference's per-step
report), ``--check-nan``, ``--profile-dir`` (a ``torch.profiler`` trace)
and ``--multihost`` (one row shard per process, ``parallel/multihost.py``:
``torchrun --nproc-per-node 2 -m lbm_tpu_torch ... --multihost``, with
``--backend pallas-overlap`` the neighbours' shards mapped with CUDA IPC;
rank 0 alone writes the output files and prints the block). Bad inputs end
with ``lbm_tpu_torch: error: ...`` on stderr and exit code 1, never a
traceback.
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

    # The slab route is quarantined as in the JAX package: it is a choice
    # only with LBM_ENABLE_SLAB=1 (lbm_tpu/cli.py:39-45).
    backends = [b for b in BACKENDS if b != "slab" or os.environ.get("LBM_ENABLE_SLAB") == "1"]
    p = argparse.ArgumentParser(
        prog="lbm_tpu_torch",
        description="D2Q9 BGK lattice-Boltzmann solver on PyTorch and CUDA",
    )
    p.add_argument("paramfile", help="7-field params file (nx ny maxIters reynolds_dim density accel omega)")
    p.add_argument("obstaclefile", help="obstacle list file ('x y 1' per line)")
    p.add_argument(
        "--backend",
        choices=backends + ["pallas-overlap"],
        default="auto",
        help="auto: resident up to 448x448 cells, deep above (f32), "
        "reference (f64); aa: in-place AA kernel on one state copy; pallas: fused "
        "one-step kernel; band, band2, band3: T steps per pass on windows in "
        "shared memory (one in-place AA window each), remainder on the step "
        "kernel; resident: 255 "
        "whole-grid steps per launch of one persistent grid, a grid-wide "
        "barrier between steps; temporal, deep: T steps per pass on a "
        "shrinking trapezoid in shared memory, halo rows from carried row "
        "packs or straight from the state, remainder on the step kernel; "
        "reference: plain PyTorch step; pallas-overlap (--mesh N or --multihost): "
        "the shard step kernel storing its edge rows into the neighbour shards "
        "(across processes mapped with CUDA IPC)"
        + ("; slab (quarantined, LBM_ENABLE_SLAB=1): band passes over y-slabs, "
           "K per slab visit" if "slab" in backends else ""),
    )
    p.add_argument("--precision", choices=["f32", "f64", "bf16", "c16"], default="f32",
                   help="state storage: f32; f64 (runs the reference step); c16 (int16 "
                   "companded deviations from the rest state: 40 B per cell per step "
                   "instead of 76, the physics at f32; auto runs pallas, every other "
                   "backend but resident takes it, with --mesh too but pallas-overlap "
                   "and 2-D pallas; the T-step routes round once per pass and may miss "
                   "the 1%% gate); bf16 (EXPERIMENTAL: raw bfloat16 state CANNOT pass "
                   "the 1%% gate; auto runs aa, every backend but resident takes it, "
                   "with --mesh too but 2-D pallas)")
    p.add_argument(
        "--mesh",
        default="0",
        metavar="N|PYxPX",
        help="shard the lattice over N devices (1-D row mesh), or a 2-D PYxPX mesh "
        "like 2x4 (0 = single device); with --device every shard goes to that "
        "device, else to the first N cards",
    )
    p.add_argument("--out-dir", default=".", help="directory for output .dat files")
    p.add_argument(
        "--device",
        default=None,
        metavar="N|cpu",
        help="CUDA device index (default: $LBM_DEVICE or 0); 'cpu' runs on the "
        "host, which happens only when named",
    )
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                   help="snapshot resumable state every K steps")
    p.add_argument("--checkpoint-path", default=None,
                   help="checkpoint file (default: <out-dir>/checkpoint.npz when enabled)")
    p.add_argument("--checkpoint-format", choices=["npz", "orbax"], default="npz",
                   help="npz: one atomic .npz file, readable by both packages; orbax is "
                   "JAX-only (lbm_tpu) and is refused here")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint-path if it exists")
    p.add_argument("--list-devices", action="store_true",
                   help="print the device table and exit")
    p.add_argument("--debug", action="store_true",
                   help="per-step av-velocity + total-density report (the reference's -DDEBUG "
                   "mode)")
    p.add_argument("--check-nan", action="store_true",
                   help="fail if the run ends with a non-finite mean velocity or state")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run (*.pt.trace.json: Chrome, "
                   "TensorBoard) into this directory")
    p.add_argument("--multihost", action="store_true",
                   help="one row shard per process of a torch.distributed group (reads "
                   "MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK as torchrun sets "
                   "them); --mesh defaults to the world size")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="write run metrics (MLUPS, timings, Reynolds, route) as JSON")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="log configuration and timings")
    return p


def _error(msg) -> int:
    print(f"lbm_tpu_torch: error: {msg}", file=sys.stderr)
    return 1


def _mesh(text):
    """``(mesh_2d, mesh_n)`` of a ``--mesh`` value; raises ValueError."""
    if "x" in text:
        mesh_2d = tuple(int(v) for v in text.split("x"))
        if len(mesh_2d) != 2:
            raise ValueError
        return mesh_2d, 0
    return None, int(text)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from lbm_tpu_torch.io import read_obstacles, read_params, write_av_vels, write_final_state
    from lbm_tpu_torch.io.files import InputError
    from lbm_tpu_torch.runtime.device import (
        device_name, format_device_list, format_selected, print_devices, select_device,
    )
    from lbm_tpu_torch.runtime.driver import run_simulation

    rank, world_size = 0, 1
    if args.multihost:
        # Before the device is chosen, as the JAX CLI does (lbm_tpu/cli.py:168-171).
        from lbm_tpu_torch.parallel import multihost

        joined = not torch.distributed.is_initialized()
        try:
            multihost.initialize_multihost()
        except ValueError as e:
            return _error(e)
        rank, world_size = multihost.world()
        if joined and torch.distributed.is_initialized():
            # Leave the group on every way out: a process that exits with
            # its gloo threads still running may abort.
            import atexit

            atexit.register(torch.distributed.destroy_process_group)
    lead = rank == 0  # rank 0 alone prints the reference's block and writes the files

    if args.list_devices:
        print_devices(file=sys.stdout)
        return 0
    try:
        if args.multihost and args.device is None and os.environ.get("LBM_DEVICE") is None:
            device = multihost.local_device()
        else:
            device = select_device(args.device)
    except (IndexError, ValueError) as e:
        return _error(e)
    if lead:
        print(format_device_list())
        print(format_selected(device))

    try:
        params = read_params(args.paramfile)
        obstacles = read_obstacles(args.obstaclefile, params)
    except (InputError, OSError) as e:
        return _error(e)
    dtype = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16,
             "c16": "c16"}[args.precision]
    if args.precision == "bf16":
        # As the JAX CLI warns (lbm_tpu/cli.py:208-217): a raw bf16 state
        # drifts far past the checker's 1% tolerance over the official runs.
        print("lbm_tpu_torch: warning: --precision bf16 is EXPERIMENTAL and cannot pass the "
              "1% golden gate (av_vels drift ~100% over the official runs); use --precision "
              "c16 for accurate 16-bit storage", file=sys.stderr)
    if args.verbose:
        print(
            f"[lbm_tpu_torch] grid {params.nx}x{params.ny}, {params.max_iters} iters, "
            f"backend={args.backend}, precision={args.precision}, "
            f"device={device_name(device)} ({device})",
            file=sys.stderr,
        )

    if args.checkpoint_format == "orbax":
        return _error("orbax checkpoints are JAX-only (lbm_tpu); use --checkpoint-format npz")
    if args.checkpoint_every < 0:
        return _error(f"--checkpoint-every must be >= 0, got {args.checkpoint_every}")
    try:
        mesh_2d, mesh_n = _mesh(args.mesh)
    except ValueError:
        return _error(f"bad --mesh {args.mesh!r}")
    if args.multihost:
        if mesh_2d is not None:
            return _error("--multihost runs a 1-D row mesh; a 2-D mesh across processes is not "
                          "supported (nor is it in the JAX package)")
        if mesh_n not in (0, world_size):
            return _error(f"--multihost shards over the {world_size} processes; --mesh "
                          f"{args.mesh} does not match")
        if args.checkpoint_every or args.resume:
            return _error("checkpoint/resume stays single-controller-only; drop --multihost or "
                          "the checkpoint options")
    if args.debug and (args.multihost or mesh_2d is not None or mesh_n > 1):
        return _error("--debug (per-step report) is not supported with --mesh or --multihost; "
                      "run single-device")
    checkpoint_path = args.checkpoint_path
    if checkpoint_path is None and (args.checkpoint_every or args.resume):
        checkpoint_path = os.path.join(args.out_dir, "checkpoint.npz")
    resumed = {}
    if args.resume and checkpoint_path and os.path.exists(checkpoint_path):
        from lbm_tpu_torch.runtime.checkpoint import load_checkpoint

        try:
            cells, av_prefix, start_step = load_checkpoint(checkpoint_path, params)
        except (OSError, KeyError, ValueError) as e:
            return _error(f"cannot resume from {checkpoint_path}: {e}")
        if start_step >= params.max_iters:
            return _error(f"checkpoint already at step {start_step} of {params.max_iters}; "
                          "nothing to resume")
        if args.verbose:
            print(f"[lbm_tpu_torch] resuming from step {start_step}", file=sys.stderr)
        resumed = dict(initial_cells=cells, start_step=start_step, av_vels_prefix=av_prefix)

    on_chunk, chunk_every = None, 0
    if args.debug:
        # The reference's -DDEBUG per-step report (d2q9-bgk.c:229-233).
        from lbm_tpu_torch.utils.diagnostics import debug_report

        chunk_every = 1

        def on_chunk(step, cells, av_chunk):
            print(debug_report(step - 1, float(av_chunk[-1]), cells))

    profiler = None
    if args.profile_dir is not None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(args.profile_dir))
        profiler.start()
    # A named device takes every shard; otherwise the mesh is the first cards.
    named = args.device is not None or os.environ.get("LBM_DEVICE") is not None
    run_kw = dict(backend=args.backend, dtype=dtype, checkpoint_every=args.checkpoint_every,
                  checkpoint_path=checkpoint_path if args.checkpoint_every else None, **resumed)
    tic = time.time()
    try:
        if args.multihost:
            result = multihost.run_simulation_multihost(params, obstacles, backend=args.backend,
                                                        dtype=dtype, device=device)
            if args.verbose:
                print(f"[lbm_tpu_torch] rank {rank} of {world_size} on {device}, halo rows over "
                      f"{result.channel}", file=sys.stderr)
        elif mesh_2d is not None:
            from lbm_tpu_torch.parallel.sharded import run_simulation_sharded_2d

            result = run_simulation_sharded_2d(
                params, obstacles, mesh_shape=mesh_2d,
                devices=[device] * (mesh_2d[0] * mesh_2d[1]) if named else None, **run_kw)
        elif mesh_n > 1:
            from lbm_tpu_torch.parallel.sharded import run_simulation_sharded

            result = run_simulation_sharded(params, obstacles, n_devices=mesh_n,
                                            devices=[device] * mesh_n if named else None,
                                            **run_kw)
        else:
            result = run_simulation(params, obstacles, device=device, chunk_every=chunk_every,
                                    on_chunk=on_chunk, **run_kw)
        if args.check_nan:
            from lbm_tpu_torch.utils.diagnostics import NaNError, check_finite

            try:
                check_finite(result.av_vels, result.cells, context="end of run")
            except NaNError as e:
                return _error(e)
    except ValueError as e:
        return _error(e)
    finally:
        if profiler is not None:
            profiler.stop()
    toc = time.time()
    ru = resource.getrusage(resource.RUSAGE_SELF)
    reynolds = result.reynolds(params, obstacles)
    ranks = None
    if args.multihost:
        ranks = multihost.rank_reports(result)  # every process takes part
    if not lead:
        return 0

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
            "mesh": args.mesh,
            "shards": [{"device": d, "route": result.route}
                       for d in result.shard_devices or (result.device,)],
            "device": f"{device_name(device)} ({result.device})",
            "torch_device": result.device,
            "elapsed_wall_s": toc - tic,
            "loop_s": result.elapsed,
            "compile_s": result.compile_time,
            "mlups": result.mlups(params),
            "reynolds": reynolds,
        }
        if ranks is not None:
            stats["multihost"] = {"world": world_size, "channel": result.channel,
                                  "ranks": ranks}
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
