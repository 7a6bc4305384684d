"""Worker process of the port's real 2-process runs (``torch.distributed``
over gloo).

Spawned by tests/test_torch_multihost.py (not collected by pytest): process
``argv[1]`` of ``argv[2]``, coordinator on localhost:``argv[3]``, results
written to ``argv[4]`` (an npz: per case, the state, the av series, and
the route and channel that ran). Each process owns one row shard of the
16 x 16 deck of tests/multihost_worker.py, on the CPU.

``ipc RANK WORLD PORT OUT [--steps N] [--own-card] [--deadline S] [--stop S]
[--timed N]`` (tests/test_torch_cuda.py, chip_smoke.py phase 30; on the
card): shard RANK of the 1024^2 deck's grid (``ipc_deck``) stepped by K12
across processes (``shard_step.IpcRowShard``) on cuda:0 (``--own-card``:
cuda:RANK) for N steps; OUT gets its state, per-step sums, launches and,
with ``--timed``, the seconds of a second run of that many steps. With
``--stop S`` the last rank sets up, steps nothing and sleeps S seconds,
and the others report the error their wait raises (exit code 3).
"""

import json
import os
import sys

# The cases: (backend, precision) of the port's multi-process path.
CASES = (("reference", "f32"), ("pallas", "f32"), ("band", "f32"), ("band2", "f32"),
         ("pallas", "bf16"), ("band", "bf16"), ("pallas-overlap", "f32"),
         ("pallas-overlap", "bf16"))


def deck():
    """The params and obstacles of tests/multihost_worker.py, for the port."""
    import numpy as np

    from lbm_tpu_torch.models.d2q9 import LBMParams

    params = LBMParams(nx=16, ny=16, max_iters=5, reynolds_dim=10, density=0.1, accel=0.005,
                       omega=1.85)
    rng = np.random.RandomState(3)
    obs = np.zeros((params.ny, params.nx), dtype=np.int32)
    obs[0, :] = obs[-1, :] = 1
    obs[rng.randint(1, params.ny - 1, 6), rng.randint(0, params.nx, 6)] = 1
    return params, obs


DENSITY, ACCEL, OMEGA = 0.1, 0.01, 1.85  # the 1024^2 deck's


def ipc_deck(n=1024, seed=30):
    """The 1024^2 deck's obstacles (a box with a wall at column 341) under a
    state near rest drawn from ``seed``: ``(cells (9, n, n), nob (n, n))``,
    f32 on the CPU."""
    import numpy as np
    import torch

    from lbm_tpu_torch.models.d2q9 import WEIGHTS
    from lbm_tpu_torch.utils.geometry import box_with_vertical_wall

    rng = np.random.RandomState(seed)
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, n, n))
    mask = box_with_vertical_wall(n, n, wall_col=341)
    return (torch.as_tensor(state.astype(np.float32)),
            torch.as_tensor((mask == 0).astype(np.float32)))


def ipc_main(argv) -> None:
    import argparse
    import time

    import numpy as np
    import torch

    from lbm_tpu_torch.ops.shard_step import STALL_S, IpcRowShard, with_ring
    from lbm_tpu_torch.parallel.multihost import initialize_multihost

    ap = argparse.ArgumentParser()
    for name in ("rank", "world", "port"):
        ap.add_argument(name, type=int)
    ap.add_argument("out")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--own-card", action="store_true")
    ap.add_argument("--deadline", type=float, default=STALL_S)
    ap.add_argument("--stop", type=float, default=0.0)
    ap.add_argument("--timed", type=int, default=0)
    a = ap.parse_args(argv)
    initialize_multihost(f"localhost:{a.port}", a.world, a.rank)
    group = torch.distributed.group.WORLD
    device = torch.device("cuda", a.rank if a.own_card else 0)
    cells, nob = ipc_deck()
    ny = cells.shape[1]
    ry = ny // a.world
    rows = slice(a.rank * ry, (a.rank + 1) * ry)
    nob_ring = with_ring([[nob[None, z * ry:(z + 1) * ry]] for z in range(a.world)])[a.rank][0][0]

    def shard(n):
        return IpcRowShard(cells[:, rows].to(device), nob_ring.to(device), a.rank, a.world, ny,
                           DENSITY, ACCEL, OMEGA, n, group=group, deadline=a.deadline)

    s = shard(a.steps)
    if a.stop:
        if a.rank == a.world - 1:  # the neighbour that stops
            time.sleep(a.stop)
            torch.distributed.destroy_process_group()
            return
        t0 = time.monotonic()
        try:
            s.run(a.steps)
        except RuntimeError as e:
            print(f"after {time.monotonic() - t0:.2f} s: {e}", flush=True)
            torch.distributed.destroy_process_group()
            raise SystemExit(3)
        raise SystemExit("the run ended although its neighbour stopped")
    s.run(a.steps)
    result = dict(state=s.state().cpu().numpy(), sums=s.sums.cpu().numpy())
    s.close()
    result["launches"] = IpcRowShard.launches
    if a.timed:
        s = shard(a.timed)
        torch.distributed.barrier(group=group)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        s.run(a.timed)
        result["seconds"] = time.perf_counter() - t0
        s.close()
    np.savez(a.out, **result)
    torch.distributed.destroy_process_group()


def main() -> None:
    if sys.argv[1] == "ipc":
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        ipc_main(sys.argv[2:])
        return
    rank, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch

    from lbm_tpu_torch.parallel.multihost import (initialize_multihost, run_simulation_multihost,
                                                  world)

    initialize_multihost(f"localhost:{port}", nproc, rank)
    if world() != (rank, nproc):
        raise SystemExit(f"joined as {world()}, not ({rank}, {nproc})")
    params, obs = deck()
    arrays, meta = {}, {}
    for backend, precision in CASES:
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
        res = run_simulation_multihost(params, obs, backend=backend, dtype=dtype, device="cpu")
        key = f"{backend}_{precision}"
        arrays[key + "_cells"] = res.cells
        arrays[key + "_av"] = res.av_vels
        meta[key] = {"route": res.route, "channel": res.channel, "world": res.world,
                     "rank": res.rank, "devices": list(res.shard_devices)}
    np.savez(out, meta=json.dumps(meta), **arrays)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
