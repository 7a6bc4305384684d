"""``copy_gbps`` (layer: runtime.driver outside the loop; moves
``deck_s.p90``): the bytes the driver copied to and from the card over
the window's decks (the ``h2d_bytes`` and ``d2h_bytes`` counters) over the
seconds of their ``upload``, ``mask``, ``av`` and ``fetch`` spans, in GB/s
(``portbench/spans.py``). A run on the CPU copies nothing and reads 0."""

from portbench.spans import window_records

SPANS = ("upload", "mask", "av", "fetch")


def read(run):
    records = window_records(run)
    if records is None:
        return None
    moved = sum(r.counts.get("h2d_bytes", 0) + r.counts.get("d2h_bytes", 0) for r in records)
    seconds = sum(r.spans.get(n, 0.0) for r in records for n in SPANS)
    return moved / seconds / 1e9 if seconds > 0 else None
