"""``ghost_share`` (layer: the csrc kernels; moves ``mlups``): the cell
updates K4's shared-memory form computes on ghost rows (the window's decks'
``ghost_updates`` counter) over those and the decks' own updates (``nx *
ny * max_iters`` a deck), in percent: the share of the computed updates
that are recomputed so that a block meets the grid once a pass rather than
once a step. Nothing to read where no deck met a grid barrier (the routes
other than K4, the CPU's plain versions, a program without the counter)."""

from portbench.spans import window_records


def read(run):
    records = window_records(run)
    if records is None or sum(r.counts.get("grid_barriers", 0) for r in records) <= 0:
        return None
    ghost = sum(r.counts.get("ghost_updates", 0) for r in records)
    c = run.config
    own = len(records) * c["nx"] * c["ny"] * c["max_iters"]
    return 100.0 * ghost / (ghost + own)
