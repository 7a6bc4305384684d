"""The reduction of a torch.profiler trace (Chrome JSON) to what the
per-layer metrics and the result's ``breakdown`` read.

The traced window runs from the start of the first ``portbench.deck``
span to the end of the last. A device operation is a kernel, a copy or a
set (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``); the device is
busy where one runs (``reference.union_us``) and idle elsewhere. Each idle
gap is labelled by what the host was doing at its middle: inside the
program's loop (``lbm_tpu_torch.loop``), inside a deck call outside the
loop (the driver's upload, set-up and fetch), or between decks.
"""

from __future__ import annotations

import dataclasses
import json

from portbench.reference import union_us

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LOOP = "lbm_tpu_torch.loop"
DECK = "portbench.deck"
LABELS = (LOOP, "deck call outside the loop", "between decks")


@dataclasses.dataclass
class Trace:
    """What the reduction keeps of a trace, in µs of the trace's clock."""

    lo: float
    hi: float
    device_ops: list  # (start, end, name): kernels, copies and sets
    kernels: list  # (start, end, name): kernels only
    deck_spans: list  # (start, end) of portbench.deck
    loop_spans: list  # (start, end) of lbm_tpu_torch.loop
    decks: int


def read_trace(path: str, decks: int) -> Trace:
    with open(path) as f:
        return trace_from_events(json.load(f)["traceEvents"], decks)


def trace_from_events(events, decks: int) -> Trace:
    """The ``Trace`` of a list of Chrome trace events."""
    def spans(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("name") == name and e.get("cat") == "user_annotation")

    deck_spans = spans(DECK)
    if not deck_spans:
        raise ValueError("the trace holds no portbench.deck span")
    lo, hi = deck_spans[0][0], max(b for _, b in deck_spans)

    def ops(cats):
        return sorted((e["ts"], e["ts"] + e["dur"], e.get("name", "")) for e in events
                      if e.get("cat") in cats and "dur" in e
                      and e["ts"] < hi and e["ts"] + e["dur"] > lo)

    return Trace(lo=lo, hi=hi, device_ops=ops(DEVICE_CATS), kernels=ops(("kernel",)),
               deck_spans=deck_spans, loop_spans=spans(LOOP), decks=decks)


def busy_us(trace) -> float:
    """Microseconds of the window in which a device operation ran."""
    return union_us([(a, b) for a, b, _ in trace.device_ops], trace.lo, trace.hi)


def kernel_us(trace) -> float:
    """Microseconds of the window in which a kernel ran."""
    return union_us([(a, b) for a, b, _ in trace.kernels], trace.lo, trace.hi)


def idle_gaps(trace) -> list[tuple[float, float]]:
    """The intervals of the window in which no device operation ran."""
    gaps, end = [], trace.lo
    for a, b in sorted((max(a, trace.lo), min(b, trace.hi)) for a, b, _ in trace.device_ops):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if trace.hi > end:
        gaps.append((end, trace.hi))
    return gaps


def label(trace, t: float) -> str:
    """What the host was doing at ``t``."""
    if any(a <= t < b for a, b in trace.loop_spans):
        return LABELS[0]
    if any(a <= t < b for a, b in trace.deck_spans):
        return LABELS[1]
    return LABELS[2]


def breakdown(trace, totals: bool = False):
    """The result's ``breakdown``: the ten device operations that took the
    most time, by name, and the ten longest idle gaps, each labelled; in
    seconds. With ``totals`` the idle seconds summed by label instead, as
    lines for standard error."""
    gaps = [(b - a, label(trace, (a + b) / 2)) for a, b in idle_gaps(trace)]
    if totals:
        sums = {name: 0.0 for name in LABELS}
        counts = dict.fromkeys(LABELS, 0)
        for dur, name in gaps:
            sums[name] += dur
            counts[name] += 1
        return [f"{name}: {sums[name] / 1e6} s in {counts[name]} gaps" for name in LABELS]
    by_name = {}
    for a, b, name in trace.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (min(b, trace.hi) - max(a, trace.lo))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps, key=lambda g: -g[0])[:10]
    return {"device_ops": [[name, us / 1e6] for name, us in top],
            "idle_gaps": [[name, dur / 1e6] for dur, name in longest]}
