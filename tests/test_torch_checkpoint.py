"""Checkpoints and the chunked run of the port (``runtime/checkpoint.py``,
``run_simulation(checkpoint_every=...)``, ``--checkpoint-every``/
``--resume``), and their interchange with the JAX package.

A checkpoint written by either package resumes in the other: the resumed
run is held against the other package's uninterrupted run at the port's
usual tolerances (av at rtol 1e-4 and the 1% checker; the two packages
round differently in the low bits). Within the port, a chunked or resumed
run gives the bytes of an uninterrupted one.
"""

import dataclasses
import filecmp

import numpy as np
import pytest

from lbm_tpu import cli as jcli
from lbm_tpu.models.d2q9 import LBMParams as JParams
from lbm_tpu.runtime import checkpoint as jckpt
from lbm_tpu.runtime import driver as jdriver
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.models.d2q9 import LBMParams
from lbm_tpu_torch.runtime import checkpoint as tckpt
from lbm_tpu_torch.runtime import driver as tdriver
from lbm_tpu_torch.utils.checker import check_files
from lbm_tpu_torch.utils.geometry import box, write_obstacle_file, write_params_file

PARAMS = LBMParams(nx=64, ny=32, max_iters=11, reynolds_dim=10, density=0.1, accel=0.005,
                   omega=1.85)
OBSTACLES = box(64, 32)


@pytest.fixture
def deck(tmp_path):
    write_params_file(tmp_path / "input.params", *dataclasses.astuple(PARAMS))
    write_obstacle_file(tmp_path / "obstacles.dat", OBSTACLES)
    return str(tmp_path / "input.params"), str(tmp_path / "obstacles.dat")


def outputs(d):
    return d / "av_vels.dat", d / "final_state.dat"


def test_npz_round_trip(tmp_path):
    rng = np.random.RandomState(0)
    cells = rng.rand(9, 32, 64).astype(np.float32)
    av = rng.rand(5).astype(np.float32)
    path = tmp_path / "sub" / "ck.npz"
    tckpt.save_checkpoint(path, PARAMS, cells, av, 5)
    got_cells, got_av, step = tckpt.load_checkpoint(path, PARAMS)
    np.testing.assert_array_equal(got_cells, cells)
    np.testing.assert_array_equal(got_av, av)
    assert step == 5 and list(tmp_path.joinpath("sub").iterdir()) == [path]
    with pytest.raises(ValueError, match="do not match"):
        tckpt.load_checkpoint(path, dataclasses.replace(PARAMS, omega=1.7))
    tckpt.save_checkpoint(path, PARAMS, cells[:, :16], av, 5)  # not this grid's state
    with pytest.raises(ValueError, match="needs"):
        tckpt.load_checkpoint(path, PARAMS)


def test_jax_checkpoint_resumes_in_port(deck, tmp_path, capsys):
    jparams = JParams(**dataclasses.asdict(PARAMS))
    part = jdriver.run_simulation(dataclasses.replace(jparams, max_iters=4), OBSTACLES,
                                  backend="reference")
    ckpt = tmp_path / "jax.npz"
    jckpt.save_checkpoint(ckpt, jparams, part.cells, part.av_vels, 4)
    out, ref = tmp_path / "resumed", tmp_path / "jax_full"
    assert tcli.main([*deck, "--device", "cpu", "--backend", "resident", "--resume",
                      "--checkpoint-path", str(ckpt), "--out-dir", str(out)]) == 0
    assert jcli.main([*deck, "--backend", "reference", "--out-dir", str(ref)]) == 0
    capsys.readouterr()
    av = np.loadtxt(out / "av_vels.dat", usecols=[1])
    assert av.shape == (11,)
    np.testing.assert_allclose(av, np.loadtxt(ref / "av_vels.dat", usecols=[1]), rtol=1e-4)
    assert check_files(*outputs(out), *outputs(ref), tolerance=1.0).passed


def test_port_checkpoint_resumes_in_jax(deck, tmp_path, capsys):
    part = tdriver.run_simulation(dataclasses.replace(PARAMS, max_iters=6), OBSTACLES,
                                  device="cpu", backend="temporal")
    ckpt = tmp_path / "torch.npz"
    tckpt.save_checkpoint(ckpt, PARAMS, part.cells, part.av_vels, 6)
    out, ref = tmp_path / "resumed", tmp_path / "torch_full"
    assert jcli.main([*deck, "--backend", "reference", "--resume", "--checkpoint-path",
                      str(ckpt), "--out-dir", str(out)]) == 0
    assert tcli.main([*deck, "--device", "cpu", "--backend", "temporal", "--out-dir",
                      str(ref)]) == 0
    capsys.readouterr()
    av = np.loadtxt(out / "av_vels.dat", usecols=[1])
    np.testing.assert_allclose(av, np.loadtxt(ref / "av_vels.dat", usecols=[1]), rtol=1e-4)
    assert check_files(*outputs(out), *outputs(ref), tolerance=1.0).passed


def test_chunked_resident_run_equals_unchunked(tmp_path):
    """Checkpoint chunks of 4 do not align with anything in the route: the
    state and the av series are bitwise those of one chunk, and the last
    checkpoint holds the end of the run."""
    full = tdriver.run_simulation(PARAMS, OBSTACLES, device="cpu", backend="resident")
    ckpt = tmp_path / "ck.npz"
    chunked = tdriver.run_simulation(PARAMS, OBSTACLES, device="cpu", backend="resident",
                                     checkpoint_every=4, checkpoint_path=str(ckpt))
    np.testing.assert_array_equal(chunked.cells, full.cells)
    np.testing.assert_array_equal(chunked.av_vels, full.av_vels)
    cells, av, step = tckpt.load_checkpoint(ckpt, PARAMS)
    assert step == 11
    np.testing.assert_array_equal(cells, full.cells)
    np.testing.assert_array_equal(av, full.av_vels)


@pytest.mark.parametrize("backend", ["deep", "auto"])
def test_resume_at_unaligned_step_gives_uninterrupted_bytes(backend, deck, tmp_path, capsys):
    """A checkpoint at step 5 resumed with --checkpoint-every 3 (chunks 5-6,
    6-9, 9-11) writes the files of an uninterrupted run, byte for byte."""
    part = tdriver.run_simulation(dataclasses.replace(PARAMS, max_iters=5), OBSTACLES,
                                  device="cpu", backend=backend)
    ckpt = tmp_path / "ck.npz"
    tckpt.save_checkpoint(ckpt, PARAMS, part.cells, part.av_vels, 5)
    out, ref = tmp_path / "resumed", tmp_path / "full"
    assert tcli.main([*deck, "--device", "cpu", "--backend", backend, "--resume",
                      "--checkpoint-every", "3", "--checkpoint-path", str(ckpt),
                      "--out-dir", str(out)]) == 0
    assert tcli.main([*deck, "--device", "cpu", "--backend", backend, "--out-dir",
                      str(ref)]) == 0
    capsys.readouterr()
    for got, want in zip(outputs(out), outputs(ref)):
        assert filecmp.cmp(got, want, shallow=False)
    assert tckpt.load_checkpoint(ckpt, PARAMS)[2] == 11


def test_resume_of_finished_run_is_refused(deck, tmp_path, capsys):
    out = tmp_path / "out"
    assert tcli.main([*deck, "--device", "cpu", "--checkpoint-every", "4", "--out-dir",
                      str(out)]) == 0
    assert tckpt.load_checkpoint(out / "checkpoint.npz", PARAMS)[2] == 11
    capsys.readouterr()
    assert tcli.main([*deck, "--device", "cpu", "--resume", "--out-dir", str(out)]) == 1
    assert "nothing to resume" in capsys.readouterr().err


def test_orbax_is_refused(deck, tmp_path, capsys):
    assert tcli.main([*deck, "--device", "cpu", "--checkpoint-every", "4",
                      "--checkpoint-format", "orbax", "--out-dir", str(tmp_path)]) == 1
    err = capsys.readouterr().err
    assert err.startswith("lbm_tpu_torch: error:") and "JAX-only" in err


def test_resume_from_other_params_is_refused(deck, tmp_path, capsys):
    ckpt = tmp_path / "ck.npz"
    tckpt.save_checkpoint(ckpt, dataclasses.replace(PARAMS, accel=0.01),
                          np.ones((9, 32, 64), np.float32), np.ones(3, np.float32), 3)
    assert tcli.main([*deck, "--device", "cpu", "--resume", "--checkpoint-path", str(ckpt),
                      "--out-dir", str(tmp_path)]) == 1
    assert "do not match" in capsys.readouterr().err
