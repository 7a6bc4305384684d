"""The driver's spans and counters (``lbm_tpu_torch/runtime/trace.py``) on the
CPU: each ``run_simulation`` call's record (its spans under ``call``, one
call id, the result's ``elapsed``, every counter but K6's tiles 0 without
a card), the
spans that only 16-bit storage, ``on_chunk``, checkpoints and
``fetch_final`` open, the bounded deque of records, and the same spans as
``user_annotation`` events of a ``torch.profiler`` trace, where the
benchmark's reduction (``portbench/trace.py``) still finds the loop."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lbm_tpu_torch.models.d2q9 import WEIGHTS, LBMParams  # noqa: E402
from lbm_tpu_torch.runtime import driver, trace  # noqa: E402

STORAGES = {"f32": torch.float32, "c16": "c16", "bf16": torch.bfloat16}
ROUTES = ("auto", "pallas", "deep", "reference")
BASE = {"call", "upload", "mask", "sync", "loop", "av", "fetch"}


def deck(max_iters=10):
    params = LBMParams(nx=16, ny=12, max_iters=max_iters, reynolds_dim=4, density=0.1,
                       accel=0.005, omega=1.85)
    obstacles = np.zeros((12, 16), np.int32)
    obstacles[0] = obstacles[-1] = 1
    obstacles[5, 7] = 1
    return params, obstacles


def expected_spans(storage):
    spans = set(BASE)
    if storage != "f32":
        spans |= {"encode", "decode"}
    if storage == "c16":
        spans.add("saturation")
    return spans


@pytest.mark.parametrize("storage", list(STORAGES))
@pytest.mark.parametrize("backend", ROUTES)
def test_a_call_records_its_spans_and_counters(backend, storage):
    params, obstacles = deck()
    res = driver.run_simulation(params, obstacles, backend=backend, dtype=STORAGES[storage],
                                device="cpu", chunk_every=4)
    rec = res.trace
    assert isinstance(rec, trace.CallRecord) and rec is trace.RECORDS[-1]
    assert set(rec.spans) == expected_spans(storage)
    assert rec.parents == {name: (None if name == "call" else "call") for name in rec.spans}
    assert rec.elapsed == res.elapsed and rec.chunks == 3
    # The chunks' spans are summed, and the spans inside ``call`` take no
    # more than its seconds (``untraced_ms``, its self time, is never < 0).
    assert all(seconds >= 0 for seconds in rec.spans.values())
    assert sum(s for name, s in rec.spans.items() if name != "call") <= rec.spans["call"]
    assert rec.spans["loop"] <= rec.elapsed  # the span lies inside the timed window
    # No card: nothing crosses, and the kernel library is not loaded.
    assert rec.counts == {"h2d_bytes": 0, "d2h_bytes": 0, "kernel_launches": 0,
                          "grid_barriers": 0, "ghost_updates": 0, "exchange_bytes": 0}


def test_each_call_has_its_own_id():
    params, obstacles = deck(4)
    ids = [driver.run_simulation(params, obstacles, device="cpu").trace.call_id
           for _ in range(3)]
    assert len(set(ids)) == 3 and ids == sorted(ids)


@pytest.mark.parametrize("use", ["on_chunk", "checkpoint", "no_fetch"])
def test_spans_of_the_options_appear_only_when_used(use, tmp_path):
    params, obstacles = deck()
    seen = []
    kw = {"on_chunk": lambda step, cells, av: seen.append(step)} if use == "on_chunk" else {}
    if use == "checkpoint":
        kw = {"checkpoint_every": 5, "checkpoint_path": str(tmp_path / "ck.npz")}
    res = driver.run_simulation(params, obstacles, dtype="c16", device="cpu",
                                fetch_final=use != "no_fetch", **kw)
    spans = expected_spans("c16")
    if use == "no_fetch":
        spans -= {"fetch", "decode"}
        assert res.cells is None
    else:
        spans.add(use)
    assert set(res.trace.spans) == spans
    assert res.trace.parents.get(use, "call") == "call"
    if use == "on_chunk":
        assert seen == [10]


def test_a_failed_call_closes_its_record():
    params, obstacles = deck()
    with pytest.raises(ValueError, match="orbax"):
        driver.run_simulation(params, obstacles, device="cpu", checkpoint_format="orbax")
    assert set(trace.RECORDS[-1].spans) == {"call"}
    trace.count("h2d_bytes", 5)  # outside a call: dropped
    with trace.span("upload"):  # outside a call: timed nowhere
        pass
    res = driver.run_simulation(params, obstacles, device="cpu")
    assert res.trace.parents["call"] is None and res.trace.counts["h2d_bytes"] == 0


def test_the_deque_keeps_the_newest_records():
    first = None
    for i in range(trace.MAX_RECORDS + 7):
        with trace.call() as rec:
            trace.count("h2d_bytes", i)
        first = rec.call_id if first is None else first
    assert trace.RECORDS.maxlen == trace.MAX_RECORDS == 4096
    assert len(trace.RECORDS) == trace.MAX_RECORDS
    assert trace.RECORDS[-1] is rec and trace.RECORDS[-1].counts["h2d_bytes"] == 4096 + 6
    assert trace.RECORDS[0].call_id == first + 7


@pytest.mark.parametrize("storage", ["f32", "c16"])
def test_the_spans_sit_in_a_profiler_trace(storage, tmp_path):
    from portbench.trace import LOOP, trace_from_events

    params, obstacles = deck()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("portbench.deck"):
            res = driver.run_simulation(params, obstacles, dtype=STORAGES[storage],
                                        device="cpu", chunk_every=4)
    path = str(tmp_path / "t.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(trace.PREFIX)]
    assert {e["name"][len(trace.PREFIX):] for e in ours} == set(res.trace.spans)
    (call,) = [e for e in ours if e["name"] == "lbm_tpu_torch.call"]
    for e in ours:
        assert call["ts"] <= e["ts"] and e["ts"] + e["dur"] <= call["ts"] + call["dur"]
    assert sum(e["name"] == LOOP for e in ours) == 3
    reduced = trace_from_events(events, 1)
    assert len(reduced.loop_spans) == 3
    assert all(call["ts"] <= a <= b <= call["ts"] + call["dur"] for a, b in reduced.loop_spans)


@pytest.mark.parametrize("start", ["rest", "f32", "f64", "strided"])
def test_the_cpu_path_copies_nothing_and_keeps_its_bytes(start):
    """On the CPU no byte crosses, whatever the start; an f64 or a strided
    start gives the f32 start's bytes, and the caller's start is not
    written."""
    params, obstacles = deck()
    rng = np.random.RandomState(3)
    f32 = (WEIGHTS * params.density)[:, None, None] * (
        1 + 0.05 * rng.rand(9, params.ny, params.nx))
    f32 = f32.astype(np.float32)
    cells = {"rest": None, "f32": f32, "f64": f32.astype(np.float64)}
    if start == "strided":
        cells["strided"] = np.zeros((9, params.ny, 2 * params.nx), np.float32)[:, :, ::2]
        cells["strided"][...] = f32
    given = None if cells[start] is None else cells[start].copy()
    res = driver.run_simulation(params, obstacles, device="cpu", initial_cells=cells[start])
    assert {k: res.trace.counts[k] for k in ("h2d_bytes", "d2h_bytes")} == \
        {"h2d_bytes": 0, "d2h_bytes": 0}
    if given is not None:
        assert cells[start].tobytes() == given.tobytes()
        want = driver.run_simulation(params, obstacles, device="cpu", initial_cells=f32)
        assert res.cells.tobytes() == want.cells.tobytes()
        assert res.av_vels.tobytes() == want.av_vels.tobytes()
    assert type(res.cells) is np.ndarray and res.cells.flags.c_contiguous
    assert res.cells.dtype == np.float32 and res.cells.shape == (9, params.ny, params.nx)


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int16])
def test_the_cpu_fetch_is_the_tensors_own_array(dtype, pinned):
    """``_to_host`` of a CPU tensor is ``t.cpu().numpy()``, pinned or not:
    the tensor's own bytes, shared, with its dtype and shape, and no byte
    counted."""
    t = torch.arange(24, dtype=dtype).reshape(2, 3, 4)
    with trace.call() as rec:
        a = driver._to_host(t, pinned=pinned)
    assert type(a) is np.ndarray and a.shape == (2, 3, 4) and a.dtype == t.numpy().dtype
    assert a.tobytes() == t.numpy().tobytes() and np.shares_memory(a, t.numpy())
    assert rec.counts["d2h_bytes"] == 0


def test_the_copy_bound_needs_a_card(capsys):
    """``scripts/copy_bound.py`` measures the card's host and link only: with
    no card it prints why and exits 2, with no number."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "copy_bound.py")
    spec = importlib.util.spec_from_file_location("copy_bound", path)
    copy_bound = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy_bound)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bound would run")
    assert copy_bound.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
