"""The readers of the program's own spans and counters (``spans.py``,
``metrics/{upload,fetch,codec,untraced}_ms.py``, ``copy_gbps.py``,
``launch_gap_us.py``) on a synthetic ``RunRecord`` and fake call records."""

import collections
import sys

import pytest

from conftest import PORTBENCH
from portbench import harness
from portbench.trace import trace_from_events

trace = pytest.importorskip("lbm_tpu_torch.runtime.trace")

CONFIG = {"nx": 1024, "ny": 1024, "max_iters": 20000}


def reader(name):
    return harness.metric_reader(PORTBENCH, name)


def call_record(elapsed, spans, counts=None):
    """A record of one call whose spans (seconds) all sit under ``call``."""
    rec = trace.CallRecord(call_id=0, elapsed=elapsed)
    rec.spans = dict(spans)
    rec.parents = {n: (None if n == "call" else "call") for n in spans}
    rec.counts.update(counts or {})
    return rec


def run_of(loops, trace_=None):
    decks = [harness.DeckTime(loop + 0.04, loop) for loop in loops]
    return harness.RunRecord(setup_s=9.0, window_s=sum(d.wall_s for d in decks), decks=decks,
                             config=CONFIG, traffic={"storage": "f32"},
                             free_cells=1024 * 1024, peaks=None, trace=trace_)


F32 = {"call": 0.40, "upload": 0.008, "mask": 0.002, "library": 0.0001, "sync": 0.003,
       "loop": 0.35, "av": 0.001, "fetch": 0.02}
C16 = dict(F32, encode=0.0005, decode=0.0004, saturation=0.0006)
BYTES = {"h2d_bytes": 41943040, "d2h_bytes": 37828736, "kernel_launches": 5000}


@pytest.fixture
def records(monkeypatch):
    """A fresh deque of records in place of the program's."""
    fresh = collections.deque(maxlen=trace.MAX_RECORDS)
    monkeypatch.setattr(trace, "RECORDS", fresh)
    return fresh


def test_the_window_decks_are_selected_by_elapsed(records):
    # A warm-up call, two window decks with other spans, a traced deck after.
    records.append(call_record(0.0001, dict(F32, upload=9.0)))
    records.append(call_record(0.31, F32, BYTES))
    records.append(call_record(0.32, dict(F32, upload=0.010, mask=0.004, fetch=0.03), BYTES))
    records.append(call_record(0.33, dict(F32, fetch=5.0), BYTES))
    run = run_of([0.31, 0.32])
    assert reader("upload_ms")(run) == pytest.approx(1e3 * (0.010 + 0.014) / 2)
    assert reader("fetch_ms")(run) == pytest.approx(1e3 * (0.021 + 0.031) / 2)
    children = sum(v for k, v in F32.items() if k != "call")
    assert reader("untraced_ms")(run) == pytest.approx(
        1e3 * (0.40 - children + 0.40 - (children + 0.002 + 0.002 + 0.010)) / 2)
    seconds = (0.008 + 0.002 + 0.001 + 0.02) + (0.010 + 0.004 + 0.001 + 0.03)
    assert reader("copy_gbps")(run) == pytest.approx(2 * (41943040 + 37828736) / seconds / 1e9)


@pytest.mark.parametrize("name", ["upload_ms", "fetch_ms", "codec_ms", "untraced_ms",
                                  "copy_gbps", "launch_gap_us"])
def test_nothing_to_read_when_a_window_deck_has_no_record(records, name):
    records.append(call_record(0.31, C16, BYTES))
    events = [{"name": "portbench.deck", "cat": "user_annotation", "ts": 0, "dur": 10}]
    run = run_of([0.31, 0.32], trace_from_events(events, 1))
    assert reader(name)(run) is None
    assert reader(name)(run_of([])) is None


@pytest.mark.parametrize("name", ["upload_ms", "untraced_ms", "copy_gbps"])
def test_nothing_to_read_from_a_program_without_the_spans(records, monkeypatch, name):
    records.append(call_record(0.31, F32, BYTES))
    monkeypatch.setitem(sys.modules, "lbm_tpu_torch.runtime.trace", None)
    assert reader(name)(run_of([0.31])) is None


def test_codec_ms_reads_only_where_a_codec_ran(records):
    records.append(call_record(0.31, F32, BYTES))
    records.append(call_record(0.41, C16, BYTES))
    records.append(call_record(0.42, C16, BYTES))
    assert reader("codec_ms")(run_of([0.31])) is None
    assert reader("codec_ms")(run_of([0.41, 0.42])) == pytest.approx(1e3 * 0.0015)


def test_copy_gbps_reads_zero_bytes_as_zero(records):
    records.append(call_record(0.31, F32))
    assert reader("copy_gbps")(run_of([0.31])) == 0.0


def loop_trace(decks):
    """``decks`` traced decks of 1000 µs, each with a loop [100, 900) in
    which 4 kernels of 150 µs leave 5 gaps of 40 µs, a copy before the
    loop and one after it (idle outside the loop: 50 + 50 + 50 µs)."""
    def x(name, cat, ts, dur):
        return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}

    events = []
    for d in range(decks):
        t = 1000 * d
        events += [x("portbench.deck", "user_annotation", t, 1000),
                   x("lbm_tpu_torch.loop", "user_annotation", t + 100, 800),
                   x("up", "gpu_memcpy", t + 50, 50), x("down", "gpu_memcpy", t + 900, 50)]
        events += [x("deep_kernel", "kernel", t + 140 + 190 * k, 150) for k in range(4)]
    return trace_from_events(events, decks)


def test_launch_gap_divides_the_loop_idle_by_launches_times_traced_decks(records):
    records.append(call_record(0.31, F32, dict(BYTES, kernel_launches=4)))
    records.append(call_record(0.32, F32, dict(BYTES, kernel_launches=6)))
    # Loop idle a deck: 40 before the first kernel, 3 x 40 between, 40 after.
    gap = reader("launch_gap_us")(run_of([0.31, 0.32], loop_trace(3)))
    assert gap == pytest.approx(3 * 200 / (5 * 3))
    assert reader("launch_gap_us")(run_of([0.31, 0.32])) is None  # no trace


def test_launch_gap_has_nothing_to_read_without_launches(records):
    records.append(call_record(0.31, F32))
    assert reader("launch_gap_us")(run_of([0.31], loop_trace(1))) is None
