"""Worker process of the port's real 2-process run (``torch.distributed``
over gloo, on the CPU).

Spawned by tests/test_torch_multihost.py (not collected by pytest): process
``argv[1]`` of ``argv[2]``, coordinator on localhost:``argv[3]``, results
written to ``argv[4]`` (an npz: per case, the state, the av series, and
the route and channel that ran). Each process owns one row shard of the
16 x 16 deck of tests/multihost_worker.py.
"""

import json
import os
import sys

# The cases: (backend, precision) of the port's multi-process path.
CASES = (("reference", "f32"), ("pallas", "f32"), ("band", "f32"), ("band2", "f32"),
         ("pallas", "bf16"), ("band", "bf16"))


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


def main() -> None:
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
