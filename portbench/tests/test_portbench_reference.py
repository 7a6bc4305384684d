"""The benchmark's plain reference on the CPU: against the program's plain
CPU route on a tiny deck at f32 and c16, its c16 codec against the
program's, conservation of mass, and the modules that the reference and
the harness load."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO, TINY
from portbench import check, harness, reference

STEPS = 200


def deck_and_start(seed=12_345_678_901):
    return harness.blocked_mask(TINY), harness.seeded_start(TINY, seed, "cpu")


def port_run(mask, start, dtype):
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.runtime.driver import run_simulation

    params = LBMParams(TINY["nx"], TINY["ny"], STEPS, 10, TINY["density"], TINY["accel"],
                       TINY["omega"])
    return run_simulation(params, mask, backend="auto", dtype=dtype, initial_cells=start,
                          device="cpu")


@pytest.mark.parametrize("storage", ["f32", "c16"])
def test_reference_matches_the_port_plain_route(storage):
    mask, start = deck_and_start()
    ref = reference.Deck(mask, TINY["density"], TINY["accel"], TINY["omega"], "cpu")
    av_ref, cells_ref = ref.run(start, STEPS)
    res = port_run(mask, start, torch.float32 if storage == "f32" else "c16")
    assert res.route == ("resident" if storage == "f32" else "pallas")
    gaps = {"av_gap_pct": check.av_gap_pct(res.av_vels, av_ref),
            **check.state_gaps(res.cells, cells_ref, mask == 0, "cpu")}
    # f32 against f32: rounding apart (6e-4 % at most on this deck); c16
    # against f32: c16's rounding of each step's store (3e-2 %).
    bound = 2e-3 if storage == "f32" else 0.1
    assert max(gaps.values()) < bound, gaps
    if storage == "c16":
        # The reference on its own c16 storage: the program's rounding points.
        c16 = reference.Companded.for_deck(TINY["density"], TINY["accel"])
        av16, cells16 = ref.run(start, STEPS, c16)
        np.testing.assert_allclose(av16, res.av_vels, rtol=0, atol=2e-6)
        np.testing.assert_allclose(cells16, res.cells, rtol=0, atol=1e-5)


def test_reference_leaves_its_start_alone():
    mask, start = deck_and_start()
    before = start.copy()
    reference.Deck(mask, 0.1, 0.01, 1.85, "cpu").run(start, 3)
    assert np.array_equal(start, before)


def test_c16_codec_is_the_program_codec():
    from lbm_tpu_torch.ops import devspace

    spec = devspace.DevSpec.for_params(TINY["density"], TINY["accel"])
    ours = reference.Companded.for_deck(TINY["density"], TINY["accel"])
    assert ours.bg == spec.bg and ours.h == spec.h
    gen = torch.Generator().manual_seed(5)
    bg = torch.tensor(spec.bg, dtype=torch.float32).view(9, 1, 1)
    cells = bg + (torch.rand((9, 16, 32), generator=gen) * 2 - 1) * spec.h * 1.2
    codes = ours.encode(cells)
    assert torch.equal(codes, devspace.encode_state(cells, spec))
    assert torch.equal(ours.decode(codes), devspace.decode_state(codes, spec))


@pytest.mark.parametrize("storage", ["f32", "c16"])
def test_reference_conserves_mass(storage):
    mask, start = deck_and_start(seed=77)
    ref = reference.Deck(mask, TINY["density"], TINY["accel"], TINY["omega"], "cpu")
    companded = None
    if storage == "c16":
        companded = reference.Companded.for_deck(TINY["density"], TINY["accel"])
    mass0 = start.astype(np.float64).sum()
    _, cells = ref.run(start, STEPS, companded)
    # The forcing moves mass between speeds of one cell, streaming and
    # bounce-back move it between cells, BGK keeps each cell's: only f32
    # rounding changes the total (and, on c16, each store's rounding).
    assert abs(cells.astype(np.float64).sum() / mass0 - 1) < 1e-5


def test_rest_state_stays_at_rest_without_forcing():
    mask = harness.blocked_mask(TINY)
    start = np.broadcast_to(np.float32(reference.WEIGHTS).reshape(9, 1, 1) * np.float32(0.1),
                            (9, TINY["ny"], TINY["nx"]))
    av, cells = reference.Deck(mask, 0.1, 0.0, 1.85, "cpu").run(start, 20)
    assert np.all(av == 0)
    np.testing.assert_allclose(cells, start, rtol=1e-6)


def loaded_top_levels(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
                          "sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_packages():
    names = loaded_top_levels("import portbench.reference, portbench.check, portbench.trace")
    assert not names & {"jax", "jaxlib", "flax", "lbm_tpu", "lbm_tpu_torch"}, names


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole CPU run of a tiny cell through the harness: the program is
    loaded, JAX and the JAX package are not (names compared whole)."""
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'portbench', 'tests')!r})\n"
        "import tempfile, pathlib, conftest, portbench.run\n"
        "from portbench import harness\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    root, bench = conftest.make_tiny(pathlib.Path(tmp))\n"
        "    out = harness.run_cell('tiny.f32', 3, 0.2, True, 'cpu', time.perf_counter(),"
        " bench=bench, root=root)\n"
        "assert out['result']['correct'], out\n"
        "assert harness.foreign_modules() == []\n"
    )
    names = loaded_top_levels(code)
    assert "lbm_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "lbm_tpu"}, names
