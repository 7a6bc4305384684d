"""``setup_s`` (end to end, host clock): from the harness's first line to
the window's start: importing torch, loading (or, in a new checkout,
building) the program's kernel library, building the deck and its seeded
start, and one warm-up deck cut short at the deck's shape."""


def read(run):
    return run.setup_s
