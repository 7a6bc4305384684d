"""``mlups`` (end to end, host clock): every lattice update of every deck
the window completed, divided by the window's seconds, in millions per
second. A deck updates every cell of the grid once per step
(``nx * ny * max_iters``), blocked ones included, as the reference solver
counts its MLUPS. The window runs from its start to the end of its last
deck, so the time between decks counts."""


def read(run):
    if not run.decks:
        return None
    c = run.config
    return len(run.decks) * c["nx"] * c["ny"] * c["max_iters"] / run.window_s / 1e6
