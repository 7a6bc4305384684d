"""``deck_s.p90`` (end to end, host clock): the 90th percentile, over every
deck of the window, of one whole ``run_simulation`` call: the upload, the
loop and the fetch of the av series and the final state. Linear
interpolation between the closest ranks (numpy's default)."""

import numpy as np


def read(run):
    if not run.decks:
        return None
    return float(np.percentile([d.wall_s for d in run.decks], 90))
