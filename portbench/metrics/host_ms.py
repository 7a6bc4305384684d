"""``host_ms`` (layer: runtime.driver outside the loop: upload, initial
state, the c16 encode and decode, the final fetch; moves ``deck_s.p90``):
the mean over the window's decks of the deck's wall time less the
program's loop time (``SimulationResult.elapsed``), in milliseconds."""


def read(run):
    if not run.decks:
        return None
    return 1e3 * sum(d.wall_s - d.loop_s for d in run.decks) / len(run.decks)
