"""``kernel_roofline`` (layer: the csrc kernels; moves ``mlups``): the least
time the traced decks could take on this card, over the time in which a
kernel ran during them, in percent.

The least time is the larger of two bounds, both fixed here and the same
whatever route, T or schedule the program picks:

- operations: ``F`` f32 operations per update of an unblocked cell, times
  the unblocked cells, the steps and the decks, over the card's f32 peak
  (``peaks.json``: 67 TFLOP/s on an H100 SXM, a fused multiply-add counted
  as two);
- bytes: per deck, the state read once and written once at the storage's
  width (9 values of 4 B at f32, 2 B at c16 and bf16), the obstacle flags
  at 1 B per cell and the f32 av series (4 B per step), over the card's
  HBM bandwidth (3.35 TB/s).

``F = 83``, counted by hand from the reference's step (``reference.py``)
as the least arithmetic that computes it, each of add, subtract, multiply,
divide and square root one operation and a fused multiply-add two:

    density, the sum of 9 streamed values                      8
    momentum x and y, (f1+f5+f8)-(f3+f6+f7) and its like       10
    velocity, the momenta over the density                     2
    u^2 = ux*ux + uy*uy                                        3
    base = 1 - 1.5 u^2                                         2
    diagonal projections ux+uy, ux-uy                          2
    omega * w * density for the 3 weights (omega folded in)    3
    per pair of opposite speeds with projection p:
      base + 4.5 p^2 (3), 3p (1), sum and difference (2),
      times omega w density (2); 4 pairs                       32
    rest speed: omega w0 density * base                        1
    relaxation (1 - omega) f + omega feq, one FMA, 9 speeds    18
    |u| = sqrt(u^2) and its add to the step's sum              2
                                                    total     83

The reference as written does 136 (it multiplies every speed's c_k by the
velocity and keeps omega apart); a kernel may skip what 83 skips, so 83
keeps the share a true bound. The forcing touches one row and the
bounce-back copies, so neither adds. The c16 codec's operations are not
counted. Nothing to read without a trace, a kernel in it, or this card in
``peaks.json``.
"""

from portbench.trace import kernel_us

F = 83


def least_seconds(config: dict, storage: str, free_cells: int, decks: int, peaks: dict) -> float:
    cells = config["nx"] * config["ny"]
    steps = config["max_iters"]
    width = 4 if storage == "f32" else 2
    ops = F * free_cells * steps * decks
    moved = decks * (2 * 9 * cells * width + cells + 4 * steps)
    return max(ops / peaks["f32_flops"], moved / peaks["hbm_bytes_per_s"])


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    busy = kernel_us(run.trace)
    if busy <= 0:
        return None
    least = least_seconds(run.config, run.traffic["storage"], run.free_cells, run.trace.decks,
                          run.peaks)
    return 100.0 * least / (busy / 1e6)
