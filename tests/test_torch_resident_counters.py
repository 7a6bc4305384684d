"""K4's schedule counters (``ops/resident.py::schedule_counts``) on the CPU:
the official 256^2 deck's schedule and counts on an H100's 132 SMs, the
closed form against a step-by-step walk of the plain versions' launches,
passes and exchanges, the shared-memory form's schedule against the
benchmark's plain reference on a scaled box deck, and the benchmark's
readers of the counters (``portbench/metrics/pass_us.py``,
``ghost_share.py``) on synthetic run records and traces."""

import itertools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lbm_tpu_torch.models.d2q9 import LBMParams  # noqa: E402
from lbm_tpu_torch.ops import resident  # noqa: E402
from lbm_tpu_torch.runtime import driver, trace  # noqa: E402
from portbench import check, harness  # noqa: E402
from portbench.reference import Deck as ReferenceDeck  # noqa: E402
from portbench.trace import kernel_us, trace_from_events  # noqa: E402

PORTBENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "portbench")
H100_SMS = 132
BOX = {"rows": [0, -1], "cols": [0, -1]}
K4_COUNTERS = ("grid_barriers", "ghost_updates", "exchange_bytes")


def test_the_256_deck_runs_k4s_shared_memory_form_at_two_rows_a_block():
    assert resident.resident_smem_config(256, 256, H100_SMS) == (128, 2, 3, 155872)


def test_the_256_deck_counts():
    config = resident.resident_smem_config(256, 256, H100_SMS)
    counts = resident.schedule_counts(256, 256, 80000, resident.CHUNK_STEPS, config)
    assert counts == {"grid_barriers": 26667, "ghost_updates": 5242814464,
                      "exchange_bytes": 248698109952}
    # The global-memory form: a barrier a step and the call's entry barrier.
    assert resident.schedule_counts(256, 256, 80000, resident.CHUNK_STEPS) == {
        "grid_barriers": 80001, "ghost_updates": 0, "exchange_bytes": 0}


def small_deck(ny, nx, seed=5):
    gen = torch.Generator().manual_seed(seed)
    w = torch.tensor([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4).view(9, 1, 1) * 0.1
    cells = w * (1 + 0.01 * (2 * torch.rand((9, ny, nx), generator=gen) - 1))
    nobst = torch.ones((ny, nx))
    nobst[0] = nobst[-1] = 0.0
    return cells.float(), nobst


def walk_smem(monkeypatch, ny, nx, rows, depth, n_iters, chunk):
    """Run ``run_resident_slabs_plain`` and count what its launches do: the
    rows each window step computes beyond the block's own, the passes (one
    window step a block ends each on exactly its own rows), and the rows
    each exchange writes to its buffer and reads back into the windows."""
    seen = {"launches": 0, "passes": 0, "ghost": 0, "exchanges": 0, "rows_out": 0,
            "rows_in": 0}
    step, exchange, launch = resident._window_step, resident._exchange, resident._slabs_launch

    def counted_step(win, nob, frow, r0, r1, own, *args):
        seen["ghost"] += (r1 - r0 - (own[1] - own[0])) * nx
        seen["passes"] += (r0, r1) == tuple(own)
        return step(win, nob, frow, r0, r1, own, *args)

    def counted_exchange(ex, blocks, t):
        ex.fill_(float("nan"))
        exchange(ex, blocks, t)
        seen["exchanges"] += 1
        seen["rows_out"] += int(torch.isfinite(ex).all(dim=2).all(dim=0).sum())
        for _, bi, grow, win, _, _ in blocks:
            ghost = list(range(t)) + list(range(t + bi, bi + 2 * t))
            assert torch.equal(win[:, ghost], ex[:, grow[ghost]])
            seen["rows_in"] += len(ghost)

    def counted_launch(*args):
        seen["launches"] += 1
        return launch(*args)

    monkeypatch.setattr(resident, "_window_step", counted_step)
    monkeypatch.setattr(resident, "_exchange", counted_exchange)
    monkeypatch.setattr(resident, "_slabs_launch", counted_launch)
    cells, nobst = small_deck(ny, nx)
    resident.run_resident_slabs_plain(cells, nobst, 0.1, 0.005, 1.85, n_iters, 0.01, rows, depth,
                                      chunk=chunk)
    blocks = -(-ny // rows)
    assert seen["passes"] % blocks == 0
    barriers = seen["passes"] // blocks  # each pass ends at the exchange's or the final one
    assert barriers == seen["exchanges"] + seen["launches"]
    return {"grid_barriers": barriers, "ghost_updates": seen["ghost"],
            "exchange_bytes": 36 * nx * (seen["rows_out"] + seen["rows_in"])}


# (ny, nx, rows, depth, n_iters, chunk): chunks that end mid-pass, a last
# block shorter than the others and than 2 depth, T 1, and windows taller
# than the grid.
SMEM_CASES = [(12, 8, 3, 2, 23, 7), (10, 6, 4, 3, 20, 8), (16, 8, 4, 1, 9, 4),
              (9, 5, 7, 3, 11, 5), (8, 4, 2, 3, 14, 14)]


@pytest.mark.parametrize("ny, nx, rows, depth, n_iters, chunk", SMEM_CASES)
def test_the_shared_memory_forms_counts_are_those_of_its_walk(monkeypatch, ny, nx, rows,
                                                               depth, n_iters, chunk):
    config = (-(-ny // rows), rows, depth, resident.resident_smem_bytes(nx, rows, depth))
    assert resident.schedule_counts(ny, nx, n_iters, chunk, config) == walk_smem(
        monkeypatch, ny, nx, rows, depth, n_iters, chunk)


@pytest.mark.parametrize("n_iters, chunk", [(1, 3), (7, 3), (9, 3), (12, 255)])
def test_the_global_memory_forms_counts_are_those_of_its_walk(monkeypatch, n_iters, chunk):
    """A launch meets a barrier after each step and, when it starts the
    call (step 0: the first forcing and the byte plane), one before them."""
    seen = []
    launch = resident._aa_launch_plain

    def counted(state, nobst, w1a, w2a, omega, first, steps, *args):
        seen.append(steps + (first == 0))
        return launch(state, nobst, w1a, w2a, omega, first, steps, *args)

    monkeypatch.setattr(resident, "_aa_launch_plain", counted)
    cells, nobst = small_deck(6, 5)
    resident.run_resident_aa_plain(cells, nobst, 0.1, 0.005, 1.85, n_iters, 0.01, chunk=chunk)
    assert len(seen) == -(-n_iters // chunk)
    assert resident.schedule_counts(6, 5, n_iters, chunk) == {
        "grid_barriers": sum(seen), "ghost_updates": 0, "exchange_bytes": 0}


def test_the_cpu_route_counts_nothing():
    params = LBMParams(nx=10, ny=8, max_iters=9, reynolds_dim=4, density=0.1, accel=0.005,
                       omega=1.85)
    res = driver.run_simulation(params, harness.blocked_mask({"nx": 10, "ny": 8,
                                                              "blocked": BOX}),
                                backend="resident", device="cpu")
    assert res.route == "resident"
    assert {k: res.trace.counts[k] for k in K4_COUNTERS} == dict.fromkeys(K4_COUNTERS, 0)


# The 256^2 deck's physics on a grid the CPU runs in seconds: its density,
# accel and omega, its closed box, the benchmark's seeded start.
SCALED = {"name": "bristol_256_scaled", "nx": 24, "ny": 32, "max_iters": 300,
          "reynolds_dim": 10, "density": 0.1, "accel": 0.005, "omega": 1.85, "blocked": BOX}
# Tolerances of the benchmark's comparison (portbench/check.py, percent),
# f32 against f32 in another order of operations. Each value differs by a
# few f32 roundings (6e-8 relative each), but the momenta are differences
# of values that agree to about 1% (the start's perturbation), so |u| and
# the av series carry ~1e-5 relative: readings on three seeds and both
# orientations were at most 0.0015 (av), 0.00064 (pressure) and 0.0023
# (velocity). Each tolerance is ~4x that. The same deck stored at bf16 (8
# bits of each value) reads 41-52, 0.38-0.58 and 11.6-17.5.
SCALED_LIMITS = {"av_gap_pct": 0.006, "pressure_gap_pct": 0.003, "velocity_gap_pct": 0.01}


def scaled_gaps(av, cells, av_ref, cells_ref, free):
    return {"av_gap_pct": check.av_gap_pct(av, av_ref),
            **check.state_gaps(cells, cells_ref, free, "cpu")}


def test_the_decks_schedule_holds_to_the_benchmarks_reference():
    """Slabs of 2 rows with T 3, as the 256^2 deck runs on an H100, in
    launches of 7 steps (the last pass of each launch one step), against
    ``portbench/reference.py`` from the same seeded start."""
    c = SCALED
    mask = harness.blocked_mask(c)
    free = mask == 0
    start = harness.seeded_start(c, 2 ** 31 + 17, "cpu")
    steps = c["max_iters"]
    av_ref, cells_ref = ReferenceDeck(mask, c["density"], c["accel"], c["omega"],
                                      "cpu").run(start, steps)
    inv = float(np.float32(1.0 / free.sum()))
    cells, av = resident.run_resident_slabs_plain(
        torch.tensor(start), torch.tensor(free.astype(np.float32)), c["density"], c["accel"],
        c["omega"], steps, inv, 2, 3, chunk=7)
    gaps = scaled_gaps(av.numpy(), cells.numpy(), av_ref, cells_ref, free)
    assert all(gaps[n] <= SCALED_LIMITS[n] for n in check.NUMBERS), gaps
    # The same run stored at bf16 fails every tolerance.
    params = LBMParams(nx=c["nx"], ny=c["ny"], max_iters=steps, reynolds_dim=c["reynolds_dim"],
                       density=c["density"], accel=c["accel"], omega=c["omega"])
    res = driver.run_simulation(params, mask, backend="pallas", dtype=torch.bfloat16,
                                initial_cells=start, device="cpu")
    gaps = scaled_gaps(res.av_vels, res.cells, av_ref, cells_ref, free)
    assert all(gaps[n] > SCALED_LIMITS[n] for n in check.NUMBERS), gaps


# ---------------------------------------------------------------- the readers

CONFIG_256 = {"nx": 256, "ny": 256, "max_iters": 80000}
_elapsed = itertools.count(1)


def window(counts_of_deck, decks=4, drop=()):
    """``decks`` records of the program with these counters, and without
    the counters ``drop``, each matched to a window deck by a loop time of
    its own."""
    out = []
    for _ in range(decks):
        with trace.call() as rec:
            for name, n in counts_of_deck.items():
                trace.count(name, n)
        for name in drop:
            del rec.counts[name]
        rec.elapsed = 0.2 + next(_elapsed) * 1e-9
        out.append(harness.DeckTime(rec.elapsed + 0.01, rec.elapsed))
    return out


def kernels_trace(decks=3, kernel_us_a_deck=150_000.0):
    """``decks`` traced decks of 200 ms, each a kernel of its length."""
    def x(name, cat, ts, dur):
        return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}

    events = []
    for i in range(decks):
        t0 = i * 200_000.0
        events += [x("portbench.deck", "user_annotation", t0, 200_000.0),
                   x("resident_smem_kernel", "kernel", t0 + 10_000.0, kernel_us_a_deck)]
    return trace_from_events(events, decks)


def run_record(decks, traced):
    return harness.RunRecord(setup_s=9.0, window_s=51.0, decks=decks, config=CONFIG_256,
                             traffic={"storage": "f32"}, free_cells=254 * 254, peaks=None,
                             trace=traced)


def reader(name):
    return harness.metric_reader(PORTBENCH, name)


def test_pass_us_and_ghost_share_read_a_k4_record():
    counts = resident.schedule_counts(256, 256, 80000, resident.CHUNK_STEPS,
                                      resident.resident_smem_config(256, 256, H100_SMS))
    traced = kernels_trace()
    run = run_record(window(dict(counts, kernel_launches=314)), traced)
    assert kernel_us(traced) == 3 * 150_000.0
    assert reader("pass_us")(run) == pytest.approx(150_000.0 / 26667)
    own = 256 * 256 * 80000
    share = reader("ghost_share")(run)
    assert share == pytest.approx(100.0 * 5242814464 / (5242814464 + own))
    assert round(share, 4) == 49.9997
    # Without a trace the pass has no device time; the share needs none.
    assert reader("pass_us")(run_record(run.decks, None)) is None
    assert reader("ghost_share")(run_record(run.decks, None)) == share
    # The global-memory form meets barriers and recomputes nothing.
    flat = run_record(window(resident.schedule_counts(256, 256, 80000, 255)), traced)
    assert reader("ghost_share")(flat) == 0.0
    assert reader("pass_us")(flat) == pytest.approx(150_000.0 / 80001)


@pytest.mark.parametrize("counts, drop", [
    ({"kernel_launches": 5000}, ()),  # K6, 1024^2
    ({"kernel_launches": 20000}, ()),  # K1's c16 word form
    ({"kernel_launches": 314}, K4_COUNTERS),  # a program without K4's counters
])
def test_pass_us_and_ghost_share_read_nothing_without_barriers(counts, drop):
    run = run_record(window(counts, drop=drop), kernels_trace())
    assert reader("pass_us")(run) is None
    assert reader("ghost_share")(run) is None


def test_pass_us_and_ghost_share_read_nothing_without_the_windows_records():
    run = run_record([harness.DeckTime(0.3, -1.0)], kernels_trace())
    assert reader("pass_us")(run) is None
    assert reader("ghost_share")(run) is None
