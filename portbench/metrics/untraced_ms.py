"""``untraced_ms`` (layer: runtime.driver outside the loop; moves
``deck_s.p90``): the mean over the window's decks of the self time of the
driver's ``call`` span, its seconds less those of the spans directly
inside it, in milliseconds of the host clock: the part of the call that
no phase accounts for (``portbench/spans.py``)."""

from portbench.spans import window_records


def read(run):
    records = window_records(run)
    if records is None:
        return None
    self_s = [r.spans.get("call", 0.0)
              - sum(s for n, s in r.spans.items() if r.parents.get(n) == "call")
              for r in records]
    return 1e3 * sum(self_s) / len(records)
