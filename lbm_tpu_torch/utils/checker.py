"""Python-3 mirror of the reference result checker (check/check.py),
counterpart of ``lbm_tpu/utils/checker.py``.

The reference checker is python2-only (check.py:6-10). This module
re-implements its exact semantics so the gate can run in-tree:

- av_vels: column 1 of each ``"%d:\\t%.12E"`` line (check.py:65);
- final_state: columns 0, 1, 5 = x, y, PRESSURE (check.py:66);
- guards: identical coordinate order (check.py:75-77) and equal step counts
  (check.py:80-82);
- per-element percent diff ``100*(ref-sim)/sim`` (check.py:86-87);
- FAIL if the max |percent diff| exceeds the tolerance (default 1%) or is
  non-finite, for either series (check.py:134-135);
- process exit code 0/1 is the pass/fail contract (check.py:143-147).

The unmodified upstream ``check/check.py`` remains the acceptance gate; this
mirror exists for py3-only environments and in-process testing.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SeriesDiff:
    total: float
    max_diff: float
    max_diff_pcnt: float
    max_index: int
    sim_val: float
    ref_val: float
    # Grid coordinates of the max diff (final_state series only,
    # check.py:124-127: taken from the SIM file's columns 0, 1).
    coord_x: int | None = None
    coord_y: int | None = None

    def failed(self, tolerance: float) -> bool:
        # check.py:134-135
        return (not np.isfinite(self.max_diff_pcnt)) or (
            abs(self.max_diff_pcnt) > tolerance
        )


@dataclasses.dataclass
class CheckResult:
    av_vels: SeriesDiff
    final_state: SeriesDiff
    tolerance: float

    @property
    def passed(self) -> bool:
        return not (
            self.av_vels.failed(self.tolerance)
            or self.final_state.failed(self.tolerance)
        )


def _series_diff(ref: np.ndarray, sim: np.ndarray) -> SeriesDiff:
    # check.py:84-100 — percent diff is relative to the SIMULATED value,
    # computed in upstream's exact algebraic form 100*diff/(ref - diff)
    # (check.py:87; identical to 100*diff/sim except for float rounding in
    # pathological magnitude gaps — kept literal so the mirror is
    # bit-faithful).
    diff = ref - sim
    with np.errstate(divide="ignore", invalid="ignore"):
        diff_pcnt = 100.0 * (diff / (ref - diff))
    idx = int(np.argmax(np.abs(diff_pcnt)))
    return SeriesDiff(
        total=float(np.sum(np.abs(diff))),
        max_diff=float(diff[idx]),
        max_diff_pcnt=float(diff_pcnt[idx]),
        max_index=idx,
        sim_val=float(sim[idx]),
        ref_val=float(ref[idx]),
    )


def load_av_vels(path) -> np.ndarray:
    return np.loadtxt(path, usecols=[1], ndmin=1)


def load_final_state(path) -> np.ndarray:
    return np.loadtxt(path, usecols=[0, 1, 5], ndmin=2)


def check_files(
    av_vels_file,
    final_state_file,
    ref_av_vels_file,
    ref_final_state_file,
    tolerance: float = 1.0,
) -> CheckResult:
    av_ref = load_av_vels(ref_av_vels_file)
    fs_ref = load_final_state(ref_final_state_file)
    av_sim = load_av_vels(av_vels_file)
    fs_sim = load_final_state(final_state_file)

    if np.any(fs_ref[:, 0:2] != fs_sim[:, 0:2]):  # check.py:75-77
        raise ValueError("Final state files coordinates were not the same")
    if av_ref.size != av_sim.size:  # check.py:80-82
        raise ValueError("Different number of steps in av_vels files")

    fs = _series_diff(fs_ref[:, 2], fs_sim[:, 2])
    # check.py:124-127: the reported location comes from the SIM file.
    fs.coord_x = int(fs_sim[fs.max_index, 0])
    fs.coord_y = int(fs_sim[fs.max_index, 1])
    return CheckResult(
        av_vels=_series_diff(av_ref, av_sim),
        final_state=fs,
        tolerance=tolerance,
    )


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Result checker (py3 mirror of check/check.py)")
    p.add_argument("--tolerance", type=float, default=1.0)
    p.add_argument("--ref-av-vels-file", required=True)
    p.add_argument("--ref-final-state-file", required=True)
    p.add_argument("--av-vels-file", required=True)
    p.add_argument("--final-state-file", required=True)
    args = p.parse_args(argv)

    try:
        result = check_files(
            args.av_vels_file,
            args.final_state_file,
            args.ref_av_vels_file,
            args.ref_final_state_file,
            tolerance=args.tolerance,
        )
    except (ValueError, OSError) as e:
        print(e)
        return 1

    av, fs = result.av_vels, result.final_state
    print("Total difference in av_vels : %.12E" % av.total)
    print("Biggest difference (at step %d) : %.12E" % (av.max_index, av.max_diff))
    print("  %.12E vs. %.12E = %.2g%%" % (av.sim_val, av.ref_val, av.max_diff_pcnt))
    print()
    print("Total difference in final_state : %.12E" % fs.total)
    # check.py:120: location printed as grid coords (x, y) from the sim file.
    print(
        "Biggest difference (at coord (%d,%d)) : %.12E"
        % (fs.coord_x, fs.coord_y, fs.max_diff)
    )
    print("  %.12E vs. %.12E = %.2g%%" % (fs.sim_val, fs.ref_val, fs.max_diff_pcnt))
    print()
    if fs.failed(result.tolerance):
        print("final state failed check")
    if av.failed(result.tolerance):
        print("av_vels failed check")
    if not result.passed:
        return 1
    print("Both tests passed!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
