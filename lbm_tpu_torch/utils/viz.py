"""Heat map of the velocity magnitude field (counterpart of
``lbm_tpu/utils/viz.py``).

The reference ships a gnuplot script (final_state.plt:1-13) that renders
``final_state.dat``'s columns (x, y, |u|) to ``final_state.png``. This
module renders the same picture on the host: with matplotlib where it is
installed, else as a grayscale binary PPM (``final_state.ppm`` in place
of a ``.png`` name). Host code, numpy throughout.

Usage: ``python -m lbm_tpu_torch.utils.viz final_state.dat final_state.png``
"""

from __future__ import annotations

import sys

import numpy as np


def load_speed_field(final_state_path) -> np.ndarray:
    """Read final_state.dat into a (ny, nx) |u| array (columns x y ... |u|,
    |u| at index 4, d2q9-bgk.c:900)."""
    data = np.loadtxt(final_state_path, usecols=[0, 1, 4])
    nx = int(data[:, 0].max()) + 1
    ny = int(data[:, 1].max()) + 1
    field = np.zeros((ny, nx))
    field[data[:, 1].astype(int), data[:, 0].astype(int)] = data[:, 2]
    return field


def render_png(field: np.ndarray, out_path) -> None:
    """Write the heat map of ``field`` (origin at the bottom left, as
    gnuplot draws it); without matplotlib, the PPM of ``write_ppm``."""
    try:
        import matplotlib
    except ImportError:
        write_ppm(field, out_path)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6 * field.shape[0] / field.shape[1]))
    im = ax.imshow(field, origin="lower", cmap="inferno", interpolation="nearest")
    fig.colorbar(im, ax=ax, label="|u|")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def write_ppm(field: np.ndarray, out_path) -> str:
    """Grayscale binary PPM (P6) of ``field``, one pixel per cell, row 0 at
    the bottom; a ``.png`` name becomes ``.ppm``. Returns the path written."""
    lo, hi = float(field.min()), float(field.max())
    norm = (field - lo) / (hi - lo) if hi > lo else np.zeros_like(field)
    gray = (norm[::-1] * 255).astype(np.uint8)
    rgb = np.repeat(gray[:, :, None], 3, axis=2)
    out_path = str(out_path)
    if out_path.endswith(".png"):
        out_path = out_path[:-4] + ".ppm"
    with open(out_path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (field.shape[1], field.shape[0]))
        f.write(rgb.tobytes())
    return out_path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    src = argv[0] if argv else "final_state.dat"
    dst = argv[1] if len(argv) > 1 else "final_state.png"
    render_png(load_speed_field(src), dst)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
