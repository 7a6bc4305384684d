"""``launch_gap_us`` (layer: runtime.driver loop and the ops C calls; moves
``mlups``): the device's idle time inside the traced decks'
``lbm_tpu_torch.loop`` spans (``portbench/trace.py``: ``idle_gaps``, each
gap placed by ``label``), over the kernel library's launches in them (the
mean ``kernel_launches`` counter of the window's decks times the traced
decks), in microseconds: the idle the device shows per kernel launch of
the loop. Nothing to read without a trace or without launches (the CPU's
plain versions launch none)."""

from portbench.spans import window_records
from portbench.trace import LOOP, idle_gaps, label


def read(run):
    records = window_records(run)
    if run.trace is None or records is None:
        return None
    launches = sum(r.counts.get("kernel_launches", 0) for r in records) / len(records)
    if launches <= 0:
        return None
    idle = sum(b - a for a, b in idle_gaps(run.trace) if label(run.trace, (a + b) / 2) == LOOP)
    return idle / (launches * run.trace.decks)
