"""The harness's arithmetic on synthetic inputs, its files found by name, and
whole CPU runs of a tiny cell (the card's look skipped)."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import PORTBENCH, REPO, TINY
from portbench import harness, run
from portbench.trace import busy_us, idle_gaps, kernel_us, label, trace_from_events

CONFIG = {"nx": 1024, "ny": 1024, "max_iters": 20000}


def reader(name):
    return harness.metric_reader(PORTBENCH, name)


def record(decks, window_s, **kw):
    return harness.RunRecord(setup_s=kw.pop("setup_s", 9.0), window_s=window_s, decks=decks,
                             config=kw.pop("config", CONFIG),
                             traffic=kw.pop("traffic", {"storage": "f32"}),
                             free_cells=kw.pop("free_cells", 1024 * 1024), peaks=None, **kw)


def test_mlups_is_the_rate_over_the_whole_window():
    decks = [harness.DeckTime(0.30, 0.28)] * 10
    # 1 s of the window lies between decks: it counts.
    rate = reader("mlups")(record(decks, window_s=4.0))
    assert rate == pytest.approx(10 * 1024 * 1024 * 20000 / 4.0 / 1e6)
    assert reader("loop_mlups")(record(decks, 4.0)) == pytest.approx(
        10 * 1024 * 1024 * 20000 / 2.8 / 1e6)
    assert reader("host_ms")(record(decks, 4.0)) == pytest.approx(20.0)


def test_p90_is_over_all_decks_not_over_chunks():
    rng = np.random.default_rng(3)
    walls = np.concatenate([rng.uniform(0.35, 0.36, 90), rng.uniform(0.5, 0.6, 10)])
    rng.shuffle(walls)
    decks = [harness.DeckTime(w, 0.3) for w in walls]
    p90 = reader("deck_s.p90")(record(decks, float(walls.sum())))
    assert p90 == float(np.percentile(walls, 90))
    by_chunks = np.mean([np.percentile(walls[i:i + 10], 90) for i in range(0, 100, 10)])
    assert p90 != pytest.approx(by_chunks, rel=1e-3)


def synthetic_trace():
    """Two decks, [0, 100) and [110, 200) µs, each with a loop inside."""
    def x(name, cat, ts, end):
        return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": end - ts}

    events = [x("portbench.deck", "user_annotation", 0, 100),
              x("portbench.deck", "user_annotation", 110, 200),
              x("lbm_tpu_torch.loop", "user_annotation", 10, 90),
              x("lbm_tpu_torch.loop", "user_annotation", 120, 190),
              x("k", "kernel", 10, 40), x("k", "kernel", 30, 50), x("k", "kernel", 60, 90),
              x("Memcpy HtoD", "gpu_memcpy", 95, 99), x("k", "kernel", 120, 190),
              x("cudaLaunchKernel", "cuda_runtime", 0, 300),
              x("k", "kernel", 300, 400)]  # outside the window
    return trace_from_events(events, decks=2)


def test_union_of_device_operations_and_idle_gaps():
    tr = synthetic_trace()
    assert (tr.lo, tr.hi) == (0, 200)
    assert busy_us(tr) == 40 + 30 + 4 + 70
    assert kernel_us(tr) == 40 + 30 + 70
    gaps = idle_gaps(tr)
    assert gaps == [(0, 10), (50, 60), (90, 95), (99, 120), (190, 200)]
    assert sum(b - a for a, b in gaps) + busy_us(tr) == 200
    assert [label(tr, (a + b) / 2) for a, b in gaps] == [
        "deck call outside the loop", "lbm_tpu_torch.loop", "deck call outside the loop",
        "between decks", "deck call outside the loop"]
    idle = reader("device_idle")(record([], 1.0, trace=tr))
    assert idle == pytest.approx(100 * 56 / 200)


def test_breakdown_lists_operations_and_gaps_in_seconds():
    from portbench.trace import breakdown

    b = breakdown(synthetic_trace())
    # By name the operations' own times add up, overlaps counted in each.
    assert b["device_ops"][0] == ["k", pytest.approx(150e-6)]
    assert b["idle_gaps"][0] == ["between decks", pytest.approx(21e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


@pytest.mark.parametrize("storage", ["f32", "c16"])
def test_kernel_roofline_stays_under_100_percent(storage):
    """Any kernel time above the least time reads under 100%; the least
    time itself reads 100%."""
    from portbench.metrics import kernel_roofline as kr

    peaks = {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    read = reader("kernel_roofline")
    rng = np.random.default_rng(11)
    for _ in range(200):
        n = int(rng.integers(8, 5000))
        config = {"nx": n, "ny": int(rng.integers(8, 5000)),
                  "max_iters": int(rng.integers(1, 10**5))}
        free = int(rng.integers(1, config["nx"] * config["ny"] + 1))
        decks = int(rng.integers(1, 5))
        least = kr.least_seconds(config, storage, free, decks, peaks)
        for factor in (1.0, 1.0 + rng.uniform(0, 1e-3), rng.uniform(1, 100)):
            tr = trace_from_events([
                {"name": "portbench.deck", "cat": "user_annotation", "ts": 0.0,
                 "dur": least * factor * 1e6 * 2},
                {"name": "k", "cat": "kernel", "ts": 0.0, "dur": least * factor * 1e6}], decks)
            rec = record([], 1.0, config=config, traffic={"storage": storage}, free_cells=free,
                         trace=tr)
            rec.peaks = peaks
            share = read(rec)
            assert share <= 100.0 * (1 + 1e-9)
            assert share == pytest.approx(100.0 / factor)


def test_kernel_roofline_counts_are_fixed():
    from portbench.metrics import kernel_roofline as kr

    peaks = {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    cfg = {"nx": 1024, "ny": 1024, "max_iters": 20000}
    free = 1024 * 1024 - 5 * 1024 + 12
    assert kr.F == 83
    assert kr.least_seconds(cfg, "f32", free, 1, peaks) == pytest.approx(
        83 * free * 20000 / 67e12)
    # The bytes bound: tiny against the operations at these decks.
    assert (2 * 9 * 1024 * 1024 * 4 + 1024 * 1024 + 4 * 20000) / 3.35e12 < 1e-4


def test_nothing_to_read_without_a_trace():
    rec = record([harness.DeckTime(0.3, 0.29)], 0.3)
    assert reader("kernel_roofline")(rec) is None
    assert reader("device_idle")(rec) is None
    assert reader("mlups")(record([], 1.0)) is None


def tree_digest(root):
    h = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                h[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return h


def tree_digest_of_repo():
    return {k: v for k, v in tree_digest(PORTBENCH).items()
            if not k.startswith("tests") and "__pycache__" not in k}


def test_new_config_traffic_and_metric_are_found_by_name(tiny, tmp_path):
    """One more configuration, traffic mix and per-layer metric, each added
    as a file (with the cell's limits), run with no file of the benchmark
    changed."""
    root, bench = tiny
    before = tree_digest(root)
    assert {k: v for k, v in before.items() if "tiny" not in k} == tree_digest_of_repo()
    from conftest import add_cell

    with open(os.path.join(root, "traffic", "f32_again.json"), "w") as f:
        json.dump({"name": "f32_again", "storage": "f32"}, f)
    with open(os.path.join(root, "metrics", "decks_done.py"), "w") as f:
        f.write("def read(run):\n    return len(run.decks)\n")
    narrow = dict(TINY, name="narrow", nx=24, ny=56, blocked={"rows": [7], "cols": [-3]})
    name = add_cell(root, bench, narrow, "f32_again", "bristol_1024.f32")
    bench["per_layer"].append({"name": "decks_done", "unit": "decks", "better": "higher",
                               "source": "program_counter", "layer": "runtime.driver loop",
                               "moves": "mlups"})
    out = harness.run_cell(name, 5, 0.2, True, "cpu", time.perf_counter(), bench=bench,
                           root=root)["result"]
    assert out["correct"], out
    assert out["metrics"]["decks_done"]["value"] >= 1
    after = tree_digest(root)
    assert {k: after[k] for k in before} == before


@pytest.mark.parametrize("trace", [False, True])
def test_a_cpu_run_of_a_tiny_cell(tiny, trace):
    root, bench = tiny
    out = harness.run_cell("tiny.c16", 2 ** 31 + 5, 0.3, trace, "cpu", time.perf_counter(),
                           bench=bench, root=root)
    res = out["result"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    want = {m["name"] for m in harness.cell_metrics(bench, trace)}
    got = set(res["metrics"])
    if trace:
        # No device on the CPU: the device's readings find nothing to read.
        assert got == want - {"kernel_roofline", "device_idle"}
        assert res["device"]["busy_s"] == 0.0 and "breakdown" in res
    else:
        assert got == want == {"mlups", "deck_s.p90", "setup_s"}
    assert set(res["checks"]) == {"av_gap_pct", "pressure_gap_pct", "velocity_gap_pct"}
    assert any("route pallas" in line for line in out["info"])


def test_the_same_seed_gives_the_same_start():
    from portbench.reference import WEIGHTS

    a = harness.seeded_start(TINY, 2 ** 31 + 11, "cpu")
    b = harness.seeded_start(TINY, 2 ** 31 + 11, "cpu")
    c = harness.seeded_start(TINY, 2 ** 31 + 12, "cpu")
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    rest = np.float32(WEIGHTS).reshape(9, 1, 1) * np.float32(TINY["density"])
    assert np.max(np.abs(a / rest - 1)) <= harness.START_PERTURBATION * (1 + 1e-6)


def test_the_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "bristol_1024.f32", "--seed", "1", "--seconds", "1"]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "needs 1 CUDA card" in captured.err


def test_the_harness_alone_cannot_run(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/: no program,
    so a run fails and prints no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    code = ("import time\nfrom portbench import harness\n"
            "harness.run_cell('bristol_1024.f32', 1, 0.1, False, 'cpu', time.perf_counter())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode != 0
    assert "No module named 'lbm_tpu_torch'" in out.stderr
    assert out.stdout == ""
