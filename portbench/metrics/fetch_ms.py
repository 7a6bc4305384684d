"""``fetch_ms`` (layer: runtime.driver outside the loop; moves
``deck_s.p90``): the mean over the window's decks of the driver's ``av``
spans (each chunk's av series to the host) and ``fetch`` span (the final
state to the host, which waits for what was enqueued before it), in
milliseconds of the host clock (``portbench/spans.py``)."""

from portbench.spans import mean_ms, window_records


def read(run):
    records = window_records(run)
    return None if records is None else mean_ms(records, ("av", "fetch"))
