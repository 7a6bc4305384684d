"""The port's diagnostics, ``--debug``/``--check-nan``, ``--profile-dir`` and
``utils/viz.py`` against the JAX package's (``lbm_tpu/utils/diagnostics.py``,
``lbm_tpu/cli.py``, ``lbm_tpu/utils/viz.py``), on the CPU.

Tolerances: ``total_density`` and the numbers of ``debug_report`` within
1e-6 relative of the JAX package's on one seeded state (its values
widened to float64 for JAX: the JAX package's own f32 ``jnp.sum`` on the
CPU is off by 1.6e-6 there and by up to 4e-5 on the tiny deck, so its f32
sum is not the yardstick). Through the CLIs, on tests/test_cli.py's tiny
deck: the same reports, the av velocity at tests/test_sharded.py's rtol
5e-5 at f32 (another collision form and summation order) and
tests/test_torch_c16.py's 1e-3 at c16, and each ``tot density`` within
1e-6 of the float64 sum of the JAX run's state at that step.
"""

import glob
import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu import cli as jcli
from lbm_tpu.io import read_obstacles as jread_obstacles
from lbm_tpu.io import read_params as jread_params
from lbm_tpu.runtime.driver import run_simulation as jrun
from lbm_tpu.utils import diagnostics as jdiag
from lbm_tpu.utils import viz as jviz
from lbm_tpu.utils.geometry import box, write_obstacle_file, write_params_file
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.utils import diagnostics as tdiag
from lbm_tpu_torch.utils import viz as tviz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AV_RTOL = 5e-5


def seeded_state(dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    return (0.1 / 9 * (1 + 0.05 * rng.rand(9, 24, 40))).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_total_density(dtype):
    cells = seeded_state(dtype)
    # The JAX package's f32 sum on the CPU is 1.6e-6 off here; on the
    # state's float64 values it is exact.
    want = jdiag.total_density(jnp.asarray(cells, jnp.float64))
    for given in (torch.as_tensor(cells), cells):
        got = tdiag.total_density(given)
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=1e-6)


def report_numbers(text):
    lines = text.splitlines()
    return lines[0], [float(line.split(":", 1)[1]) for line in lines[1:]]


def test_debug_report():
    cells = seeded_state()
    head, got = report_numbers(tdiag.debug_report(7, 1.25e-4, torch.as_tensor(cells)))
    jhead, want = report_numbers(jdiag.debug_report(7, 1.25e-4, jnp.asarray(cells, jnp.float64)))
    assert head == jhead == "==timestep: 7=="
    np.testing.assert_allclose(got, want, rtol=1e-6)


def messages(module, error, *args, **kwargs):
    with pytest.raises(error) as e:
        module.check_finite(*args, **kwargs)
    return str(e.value)


@pytest.mark.parametrize("where", ["av", "cells"])
@pytest.mark.parametrize("tensors", [False, True])
def test_check_finite_messages(where, tensors):
    av = np.linspace(1e-4, 2e-4, 6).astype(np.float32)
    cells = seeded_state()
    if where == "av":
        av[3] = np.nan
        av[5] = np.inf
    else:
        cells[4, 2, 1] = np.inf
    want = messages(jdiag, jdiag.NaNError, av, cells, context="end of run")
    given = (torch.as_tensor(av), torch.as_tensor(cells)) if tensors else (av, cells)
    assert messages(tdiag, tdiag.NaNError, *given, context="end of run") == want
    if where == "av":
        assert want == "non-finite mean velocity at step 3 (end of run)"
        assert messages(tdiag, tdiag.NaNError, given[0]) == messages(jdiag, jdiag.NaNError, av)


def test_check_finite_passes():
    av, cells = np.ones(4, np.float32), seeded_state()
    assert tdiag.check_finite(av, cells) is None
    assert tdiag.check_finite(torch.as_tensor(av), torch.as_tensor(cells)) is None
    assert tdiag.check_finite(av) is None


@pytest.fixture
def tiny_inputs(tmp_path):
    """tests/test_cli.py's deck: 16 x 16 box, 8 steps."""
    params, obstacles = tmp_path / "tiny.params", tmp_path / "tiny_obs.dat"
    write_params_file(params, 16, 16, 8, 10, 0.1, 0.005, 1.85)
    write_obstacle_file(obstacles, box(16, 16))
    return str(params), str(obstacles)


def reports(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        assert main(argv) == 0
    lines = out.getvalue().splitlines()
    steps = [int(line.strip("=").split(":")[1]) for line in lines if line.startswith("==timestep")]
    av = [float(line.split(":")[1]) for line in lines if line.startswith("av velocity")]
    dens = [float(line.split(":")[1]) for line in lines if line.startswith("tot density")]
    return steps, np.array(av), np.array(dens)


# (port backend, JAX backend, precision): K4's plain version (the port's
# auto at f32), K1's, the reference step, and K1's c16 form (auto at c16).
DEBUG_CASES = [("auto", "reference", "f32"), ("pallas", "reference", "f32"),
               ("reference", "reference", "f32"), ("auto", "auto", "c16")]


@pytest.mark.parametrize("backend,jax_backend,precision", DEBUG_CASES)
def test_cli_debug_check_nan_matches_jax(tiny_inputs, tmp_path, backend, jax_backend, precision):
    params, obstacles = tiny_inputs
    common = ["--precision", precision, "--debug", "--check-nan"]
    steps, av, dens = reports(tcli.main, [params, obstacles, "--device", "cpu", "--backend",
                                          backend, "--out-dir", str(tmp_path / "t")] + common)
    jsteps, jav, _ = reports(jcli.main, [params, obstacles, "--backend", jax_backend,
                                         "--out-dir", str(tmp_path / "j")] + common)
    assert steps == jsteps == list(range(8))
    np.testing.assert_allclose(av, jav, rtol=AV_RTOL if precision == "f32" else 1e-3)
    jp = jread_params(params)
    masses = []
    jrun(jp, jread_obstacles(obstacles, jp), backend=jax_backend,
         dtype="c16" if precision == "c16" else jnp.float32, chunk_every=1,
         on_chunk=lambda step, cells, av: masses.append(np.asarray(cells, np.float64).sum()))
    np.testing.assert_allclose(dens, masses, rtol=1e-6)
    with open(tmp_path / "t" / "av_vels.dat") as f:
        assert len(f.read().splitlines()) == 8


def test_cli_check_nan_fails(tiny_inputs, tmp_path, capsys, monkeypatch):
    """A run whose state goes non-finite exits 1 with the JAX CLI's message."""
    params, obstacles = tiny_inputs
    from lbm_tpu_torch.runtime import driver

    real = driver.D2Q9.initial_state

    def with_nan(*args, **kwargs):
        cells = real(*args, **kwargs)
        cells[0, 5, 5] = float("nan")
        return cells

    monkeypatch.setattr(driver.D2Q9, "initial_state", with_nan)
    rc = tcli.main([params, obstacles, "--device", "cpu", "--backend", "reference",
                    "--check-nan", "--out-dir", str(tmp_path / "o")])
    assert rc == 1
    assert capsys.readouterr().err.startswith(
        "lbm_tpu_torch: error: non-finite mean velocity at step 0 (end of run)")


def test_cli_profile_dir_writes_a_trace(tiny_inputs, tmp_path):
    params, obstacles = tiny_inputs
    prof = tmp_path / "trace"
    assert tcli.main([params, obstacles, "--device", "cpu", "--backend", "pallas",
                      "--out-dir", str(tmp_path / "o"), "--profile-dir", str(prof)]) == 0
    traces = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "lbm_tpu_torch.loop" for e in events)
    assert (tmp_path / "o" / "av_vels.dat").exists()


def test_cli_debug_refused_with_mesh(tiny_inputs, tmp_path, capsys):
    params, obstacles = tiny_inputs
    assert tcli.main([params, obstacles, "--device", "cpu", "--mesh", "2", "--debug",
                      "--out-dir", str(tmp_path / "o")]) == 1
    assert "--debug" in capsys.readouterr().err


@pytest.fixture
def final_state(tiny_inputs, tmp_path):
    params, obstacles = tiny_inputs
    out = tmp_path / "fs"
    assert tcli.main([params, obstacles, "--device", "cpu", "--out-dir", str(out)]) == 0
    return str(out / "final_state.dat")


def test_load_speed_field(final_state):
    got = tviz.load_speed_field(final_state)
    assert got.shape == (16, 16)
    assert np.array_equal(got, jviz.load_speed_field(final_state))


def hide_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError


def test_ppm_bytes_match_jax(final_state, tmp_path, monkeypatch):
    hide_matplotlib(monkeypatch)
    field = tviz.load_speed_field(final_state)
    tviz.render_png(field, tmp_path / "t.png")
    jviz.render_png(field, tmp_path / "j.png")
    got, want = (tmp_path / "t.ppm").read_bytes(), (tmp_path / "j.ppm").read_bytes()
    assert got == want and got.startswith(b"P6\n16 16\n255\n")
    flat = np.zeros((3, 4))
    assert tviz.write_ppm(flat, tmp_path / "z.png") == str(tmp_path / "z.ppm")
    jviz._write_ppm(flat, tmp_path / "zj.png")
    assert (tmp_path / "z.ppm").read_bytes() == (tmp_path / "zj.ppm").read_bytes()


def test_render_png_with_matplotlib(final_state, tmp_path):
    pytest.importorskip("matplotlib")
    tviz.render_png(tviz.load_speed_field(final_state), tmp_path / "f.png")
    assert (tmp_path / "f.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_viz_module_main(final_state, tmp_path):
    """``python -m lbm_tpu_torch.utils.viz SRC DST`` renders DST."""
    dst = tmp_path / "out.png"
    proc = subprocess.run([sys.executable, "-m", "lbm_tpu_torch.utils.viz", final_state,
                           str(dst)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert dst.exists() or dst.with_suffix(".ppm").exists()


def test_port_modules_import_no_jax():
    """The new modules stand alone: neither JAX nor the JAX package."""
    for mod in ("utils/diagnostics.py", "utils/viz.py", "parallel/multihost.py"):
        with open(os.path.join(REPO, "lbm_tpu_torch", mod)) as f:
            src = f.read()
        assert not re.search(r"^\s*(import|from) (jax|lbm_tpu)\b", src, re.M), mod
