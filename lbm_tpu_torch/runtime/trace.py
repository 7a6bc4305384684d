"""Spans and counters of the driver: where a ``run_simulation`` call spends
its host time, and what it moves and launches.

Each ``run_simulation`` call opens one ``CallRecord`` (``call``). Inside
it, ``span(name)`` times a phase on the host clock (``time.perf_counter``)
into the record, under the span that encloses it, and, while a
``torch.profiler`` is active (``--profile-dir``, a benchmark's traced
decks), also opens ``torch.profiler.record_function("lbm_tpu_torch." +
name)``, so the phase sits in the trace on the clock of the kernels and
copies it enqueued. ``count(name, n)`` adds ``n`` to a counter of the
record. Spans are host time: a phase that enqueues device work ends when
the work is enqueued, and the next phase that waits for the device
(``sync``, a fetch) holds the wait.

Nothing here synchronises the device, fetches a value or copies a tensor,
and no span or count sits inside a loop over steps or passes. The closed
record is the result's ``SimulationResult.trace`` and is also appended to
``RECORDS``, which keeps the newest ``MAX_RECORDS`` of the process in
memory for readers that do not hold the result; nothing is written out.

Spans of the driver (``runtime/driver.py``), each under ``call``:
``upload``, ``encode`` (16-bit storage), ``mask``, ``library`` (CUDA
routes), and per chunk ``sync``, ``loop``, ``av``, ``on_chunk`` and
``checkpoint`` (when used); then ``decode`` (16-bit storage), ``fetch``
(``fetch_final``) and ``saturation`` (c16). Counters: ``h2d_bytes`` and
``d2h_bytes`` (the driver's copies to and from a card) and
``kernel_launches`` (the kernel library's own count of its launches over
the chunks' loops, ``lbm_launch_count``); all three read 0 on the CPU.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time

import torch

PREFIX = "lbm_tpu_torch."
MAX_RECORDS = 4096
COUNTERS = ("h2d_bytes", "d2h_bytes", "kernel_launches")


@dataclasses.dataclass
class CallRecord:
    """The spans and counters of one ``run_simulation`` call."""

    call_id: int  # shared by every span of the call
    spans: dict = dataclasses.field(default_factory=dict)  # name -> host seconds, summed
    parents: dict = dataclasses.field(default_factory=dict)  # name -> enclosing span (None)
    counts: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(COUNTERS, 0))
    elapsed: float = 0.0  # SimulationResult.elapsed of the call
    chunks: int = 0


RECORDS: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()  # .record: the open CallRecord; .stack: open span names


class span:
    """Time the block as the phase ``name`` of the open call (no-op
    outside a call, but for the profiler's span)."""

    __slots__ = ("name", "parent", "t0", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(PREFIX + self.name)
            self.annotation.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _local.stack.pop()
        record = getattr(_local, "record", None)
        if record is not None:
            record.spans[self.name] = record.spans.get(self.name, 0.0) + (t1 - self.t0)
            record.parents.setdefault(self.name, self.parent)
        return False


class call:
    """Open a ``CallRecord`` and its outermost span, ``call``; on exit the
    record goes to ``RECORDS``. ``with call() as record: ...``"""

    def __enter__(self) -> CallRecord:
        self.record = CallRecord(next(_ids))
        self.outer = getattr(_local, "record", None)
        _local.record = self.record
        self.span = span("call").__enter__()
        return self.record

    def __exit__(self, *exc):
        try:
            self.span.__exit__(*exc)
        finally:
            _local.record = self.outer
            RECORDS.append(self.record)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open call (no-op outside one)."""
    record = getattr(_local, "record", None)
    if record is not None:
        record.counts[name] = record.counts.get(name, 0) + n
