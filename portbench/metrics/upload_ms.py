"""``upload_ms`` (layer: runtime.driver outside the loop; moves
``deck_s.p90``): the mean over the window's decks of the driver's
``upload`` span (the start state to the card) and ``mask`` span (the
obstacle mask to the card, its count of free cells and the not-obstacle
plane), in milliseconds of the host clock (``portbench/spans.py``)."""

from portbench.spans import mean_ms, window_records


def read(run):
    records = window_records(run)
    return None if records is None else mean_ms(records, ("upload", "mask"))
