"""``correct`` comes out false for the control and for a program broken
underneath the timed path, on a tiny cell on the CPU (the card's look
skipped), held to the limits of the 1024^2 cells. On the card the control
is read at the cells' own sizes by ``python -m portbench.control``."""

import time

import numpy as np
import pytest

from portbench import check, control, harness


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3, 77])
def test_the_controls_fail_and_the_program_passes(tiny, seed):
    """bf16 fails both cells' limits here. The program's c16, the f32
    cell's nearer control, separates from its f32 by far more than three
    times on av and velocity, the numbers its limits stand on; at the
    cell's own size it reads above those limits (``portbench.control``
    on the card)."""
    root, bench = tiny
    recs = {r["workload"]: r for r in control.readings(["tiny.f32", "tiny.c16"], seed, True,
                                                        "cpu", root, bench)}
    for w, rec in recs.items():
        limits = check.load_limits(root, w)
        assert all(rec["program"][n] <= limits[n] for n in check.NUMBERS), rec
        assert rec["control_correct"]["bf16"] is False, rec
    f32 = recs["tiny.f32"]
    assert set(f32["control"]) == {"c16", "bf16"}
    for n in ("av_gap_pct", "velocity_gap_pct"):
        assert f32["control"]["c16"][n] >= 3 * f32["program"][n], f32


def broken(fault):
    """A ``run_simulation`` that runs the program, then breaks its answer
    as ``fault`` says."""
    from lbm_tpu_torch.runtime import driver

    real = driver.run_simulation

    def run(params, obstacles, **kw):
        res = real(params, obstacles, **kw)
        start = np.asarray(kw["initial_cells"], np.float32)
        ny, nx = params.ny, params.nx
        if fault == "state_unchanged":  # every step returns its state
            res.cells = start.copy()
            res.av_vels = np.full_like(res.av_vels, res.av_vels[0])
        elif fault == "half_the_rows_left_out":  # rows ny/2.. never stepped
            res.cells[:, ny // 2:] = start[:, ny // 2:]
        elif fault == "one_value_altered":  # one value of the answer, where it is made
            res.cells[1, ny // 2, nx // 2] *= 1.1
        elif fault == "one_av_altered":
            res.av_vels[len(res.av_vels) // 2] *= 1.02
        return res

    return run


@pytest.mark.parametrize("workload", ["tiny.f32", "tiny.c16"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_rows_left_out",
                                   "one_value_altered", "one_av_altered"])
def test_a_broken_program_is_not_correct(tiny, monkeypatch, workload, fault):
    from lbm_tpu_torch.runtime import driver

    root, bench = tiny
    monkeypatch.setattr(driver, "run_simulation", broken(fault))
    res = harness.run_cell(workload, 9, 0.2, False, "cpu", time.perf_counter(), bench=bench,
                           root=root)["result"]
    assert not res["correct"]
    assert res["failed"] >= 1
