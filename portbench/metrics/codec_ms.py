"""``codec_ms`` (layer: runtime.driver outside the loop; moves
``deck_s.p90``): the mean over the window's decks of the driver's
``encode``, ``decode`` and ``saturation`` spans (the 16-bit storage's
codec on the card and the c16 saturation check, which fetches one
scalar), in milliseconds of the host clock (``portbench/spans.py``).
Nothing to read where no deck runs a codec (f32)."""

from portbench.spans import mean_ms, window_records

CODEC = ("encode", "decode", "saturation")


def read(run):
    records = window_records(run)
    if records is None or not any(n in r.spans for r in records for n in CODEC):
        return None
    return mean_ms(records, CODEC)
