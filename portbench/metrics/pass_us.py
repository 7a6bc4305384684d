"""``pass_us`` (layer: the csrc kernels; moves ``mlups``): the traced decks'
kernel time (``portbench/trace.py``: ``kernel_us``) over the grid barriers
they met (the mean ``grid_barriers`` counter of the window's decks times
the traced decks), in microseconds. In K4's shared-memory form a barrier
closes each pass of up to T steps, so this is its device time a pass.
Nothing to read without a trace or without barriers (the routes other
than K4, the CPU's plain versions, a program without the counter)."""

from portbench.spans import window_records
from portbench.trace import kernel_us


def read(run):
    records = window_records(run)
    if run.trace is None or records is None:
        return None
    barriers = sum(r.counts.get("grid_barriers", 0) for r in records) / len(records)
    if barriers <= 0:
        return None
    return kernel_us(run.trace) / (barriers * run.trace.decks)
