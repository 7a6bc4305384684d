"""The program's own spans and counters of the window's decks, for the
per-layer readers of the driver's host path.

``lbm_tpu_torch.runtime.trace`` keeps a record of each ``run_simulation``
call in ``RECORDS``: host seconds by span (``upload``, ``mask``, ``encode``,
``sync``, ``loop``, ``av``, ``decode``, ``fetch``, ``saturation``, ...,
each with its parent span, all inside ``call``) and counters
(``h2d_bytes``, ``d2h_bytes``, ``kernel_launches``). A record
belongs to the window when its ``elapsed`` is one of the window's
``DeckTime.loop_s``, the same float as the deck's
``SimulationResult.elapsed``. A program without that module, or a window
deck without a record, gives nothing to read.
"""

from __future__ import annotations


def window_records(run) -> list | None:
    """The record of every deck of the window, in order, or None."""
    try:
        from lbm_tpu_torch.runtime.trace import RECORDS
    except ImportError:
        return None
    if not run.decks:
        return None
    by_elapsed = {r.elapsed: r for r in list(RECORDS)}
    found = [by_elapsed.get(d.loop_s) for d in run.decks]
    return None if any(r is None for r in found) else found


def mean_ms(records: list, names) -> float:
    """The mean over ``records`` of their summed spans ``names``, in ms."""
    return 1e3 * sum(r.spans.get(n, 0.0) for r in records for n in names) / len(records)
