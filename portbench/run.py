"""Run one cell of the benchmark of ``lbm_tpu_torch`` on the card.

    python -m portbench.run --workload bristol_1024.f32 --seed 7 --seconds 51 --trace 0

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, every number compared
beside its limit); the last lines of standard error are those numbers
again. Without a CUDA card, or with fewer cards than the cell asks for,
it exits 2 and prints no result; with JAX or the JAX package loaded once
the window has closed, it exits 3. ``portbench/harness.py`` says what a
run does.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every cache of the run at a fixed place inside the checkout.
CACHE = os.path.join(ROOT, ".portbench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    import torch

    from portbench import harness

    cell = harness.find_cell(harness.load_bench(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    found = harness.foreign_modules()
    if found:
        print(f"portbench: the process holds {found} once the window has closed",
              file=sys.stderr)
        return 3
    for line in out["info"]:
        print(line, file=sys.stderr)
    for c in out["checks"]:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
