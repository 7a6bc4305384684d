"""The readings that the correctness limits (``limits/<workload>.json``) are
set from, on the card: the program's gaps to the reference on many seeds,
and its controls' on as many.

    python -m portbench.control --workloads bristol_1024.f32,bristol_1024.c16 \\
        --seeds 12 --control-seeds 12 [--first-seed N] [--out FILE]

The workloads share one configuration and start, so one reference deck per
seed serves them all. For each seed and workload it runs one whole deck
through the program's timed entry (``harness.Deck.call``, the window's
call) and prints its gaps (``check.py``); on the first ``--control-seeds``
seeds it also runs the workload's controls through the same call and
prints their gaps and whether the cell's limits pass them. The controls
are the program's own narrower storages (``CONTROLS``): at f32 its c16
(about 15 bits of each value's deviation from rest) and its bf16 (8 bits
of each value); at c16 its bf16. One JSON line per seed and workload on
standard output, and in ``--out``. The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# The program's storages below each cell's storage.
CONTROLS = {"f32": ("c16", "bf16"), "c16": ("bf16",)}


def gaps(av, cells, av_ref, cells_ref, free, device) -> dict:
    from portbench import check

    return {"av_gap_pct": check.av_gap_pct(av, av_ref),
            **check.state_gaps(cells, cells_ref, free, device)}


def readings(workloads, seed: int, with_control: bool, device, root=None, bench=None):
    """One record per workload of ``seed``: the program's gaps and, with
    ``with_control``, each control's and its verdict under the limits."""
    from portbench import check, harness
    from portbench.reference import Deck as ReferenceDeck

    root = root or harness.HERE
    bench = bench or harness.load_bench()
    decks = []
    for w in workloads:
        cell = harness.find_cell(bench, w)
        config = harness.load_named(root, "configs", cell["config"])
        traffic = harness.load_named(root, "traffic", cell["traffic"])
        decks.append((w, harness.build_deck(config, traffic, seed, device)))
    first = decks[0][1]
    if any(not np.array_equal(d.start, first.start) or d.config != first.config
           for _, d in decks):
        raise ValueError("the workloads do not share one deck and start")
    c = first.config
    t0 = time.perf_counter()
    ref = ReferenceDeck(first.obstacles, c["density"], c["accel"], c["omega"], device)
    av_ref, cells_ref = ref.run(first.start, first.steps)
    ref_s = time.perf_counter() - t0
    free = first.obstacles == 0
    out = []
    for w, deck in decks:
        res = deck.call()
        rec = {"workload": w, "seed": seed, "route": res.route, "reference_s": ref_s,
               "program": gaps(res.av_vels, res.cells, av_ref, cells_ref, free, device)}
        if with_control:
            limits = check.load_limits(root, w)
            rec["control"], rec["control_correct"] = {}, {}
            for storage in CONTROLS[deck.traffic["storage"]]:
                res = deck.call(storage=storage)
                rec["control"][storage] = g = gaps(res.av_vels, res.cells, av_ref, cells_ref,
                                                   free, device)
                rec["control_correct"][storage] = all(ok for *_, ok in check.verdict(g, limits))
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings for the correctness limits.")
    ap.add_argument("--workloads", required=True, help="comma-separated, one configuration")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for i in range(args.seeds):
        for rec in readings(args.workloads.split(","), args.first_seed + i,
                            i < args.control_seeds, device):
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
