"""``loop_mlups`` (layer: runtime.driver loop and the ops' C calls; moves
``mlups``): the window's lattice updates over the sum of the program's own
loop times (``SimulationResult.elapsed``: the compute loop between two
``torch.cuda.synchronize()`` calls), in millions per second."""


def read(run):
    loop_s = sum(d.loop_s for d in run.decks)
    if not run.decks or loop_s <= 0:
        return None
    c = run.config
    return len(run.decks) * c["nx"] * c["ny"] * c["max_iters"] / loop_s / 1e6
