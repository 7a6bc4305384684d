"""The port's file formats, geometry and checker against the JAX package's.

Writers are held to identical bytes: both packages write the same arrays,
through the native library where it is built and through the pure-Python
fallback. The checker must give the same verdict and the same max diffs on
the same files. Decks come from ``utils/geometry.py``.
"""

import dataclasses
import os

import numpy as np
import pytest

from lbm_tpu import io as jio
from lbm_tpu.io.files import InputError as JInputError
from lbm_tpu.utils import checker as jchecker
from lbm_tpu.utils import geometry as jgeo
from lbm_tpu_torch import io as tio
from lbm_tpu_torch.io import files as tfiles
from lbm_tpu_torch.io.files import InputError
from lbm_tpu_torch.models.d2q9 import WEIGHTS
from lbm_tpu_torch.utils import checker as tchecker
from lbm_tpu_torch.utils import geometry as tgeo

NX, NY = 24, 16
PARAMS_FIELDS = (NX, NY, 12, 10, 0.1, 0.005, 1.85)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def make_state(seed=0):
    rng = np.random.RandomState(seed)
    mask = tgeo.box(NX, NY)
    mask[rng.randint(1, NY - 1, 6), rng.randint(1, NX - 1, 6)] = 1
    cells = ((WEIGHTS * 0.1)[:, None, None] * (1 + 0.05 * rng.rand(9, NY, NX))).astype(np.float32)
    return cells, mask


@pytest.fixture
def params(tmp_path):
    path = tmp_path / "in.params"
    tgeo.write_params_file(path, *PARAMS_FIELDS)
    return tio.read_params(path)


@pytest.mark.parametrize("native", [True, False], ids=["default", "pure-python"])
def test_writers_identical_bytes(tmp_path, monkeypatch, params, native):
    cells, mask = make_state()
    av = np.random.RandomState(1).rand(37).astype(np.float32) * 1e-3
    jparams = jio.read_params(tmp_path / "in.params")
    jio.write_final_state(tmp_path / "j_fs.dat", jparams, cells, mask)
    jio.write_av_vels(tmp_path / "j_av.dat", av)
    if not native:
        monkeypatch.setattr(tfiles, "_native_io", lambda: None)
    tio.write_final_state(tmp_path / "t_fs.dat", params, cells, mask)
    tio.write_av_vels(tmp_path / "t_av.dat", av)
    assert read(tmp_path / "t_fs.dat") == read(tmp_path / "j_fs.dat")
    assert read(tmp_path / "t_av.dat") == read(tmp_path / "j_av.dat")


def test_at_rest_state_prints_exact_zero_velocity(tmp_path, params):
    cells = np.broadcast_to((WEIGHTS * 0.1)[:, None, None], (9, NY, NX)).astype(np.float32)
    tio.write_final_state(tmp_path / "fs.dat", params, cells, tgeo.box(NX, NY))
    first_fluid = read(tmp_path / "fs.dat").decode().splitlines()[NX + 1]
    assert first_fluid.split()[2:5] == ["0.000000000000E+00"] * 3


def test_read_params_matches(tmp_path, params):
    jparams = jio.read_params(tmp_path / "in.params")
    assert dataclasses.astuple(params) == dataclasses.astuple(jparams)


def test_read_obstacles_matches(tmp_path, params):
    mask = tgeo.box_with_vertical_wall(NX, NY, wall_col=7)
    tgeo.write_obstacle_file(tmp_path / "obs.dat", mask)
    got = tio.read_obstacles(tmp_path / "obs.dat", params)
    want = jio.read_obstacles(tmp_path / "obs.dat", jio.read_params(tmp_path / "in.params"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, mask)


@pytest.mark.parametrize("content", ["1 2 3\n", "24\n16\nx\n10\n0.1\n0.005\n1.85\n",
                                     "0\n16\n5\n10\n0.1\n0.005\n1.85\n"])
def test_bad_params_raise_input_error(tmp_path, content):
    path = tmp_path / "bad.params"
    path.write_text(content)
    with pytest.raises(InputError):
        tio.read_params(path)
    with pytest.raises(JInputError):
        jio.read_params(path)


@pytest.mark.parametrize("line", ["24 0 1\n", "0 16 1\n", "1 1 2\n", "1 1\n"])
def test_bad_obstacles_raise_input_error(tmp_path, params, line):
    path = tmp_path / "bad.dat"
    path.write_text("0 0 1\n" + line)
    with pytest.raises(InputError):
        tio.read_obstacles(path, params)


@pytest.mark.parametrize("name", ["box", "channel_with_divider", "box_with_vertical_wall"])
@pytest.mark.parametrize("shape", [(128, 128), (128, 256), (96, 40)])
def test_geometry_matches(name, shape):
    np.testing.assert_array_equal(getattr(tgeo, name)(*shape), getattr(jgeo, name)(*shape))


def test_geometry_files_identical_bytes(tmp_path):
    mask = tgeo.box_with_vertical_wall(64, 32, wall_col=21)
    tgeo.write_obstacle_file(tmp_path / "t.dat", mask)
    jgeo.write_obstacle_file(tmp_path / "j.dat", mask)
    tgeo.write_params_file(tmp_path / "t.params", 1024, 1024, 20000, 10, 0.1, 0.01, 1.85)
    jgeo.write_params_file(tmp_path / "j.params", 1024, 1024, 20000, 10, 0.1, 0.01, 1.85)
    assert read(tmp_path / "t.dat") == read(tmp_path / "j.dat")
    assert read(tmp_path / "t.params") == read(tmp_path / "j.params")


def write_pair(tmp_path, params, tag, scale):
    cells, mask = make_state(seed=2)
    av = np.linspace(1e-4, 2e-3, 20)
    tio.write_final_state(tmp_path / f"{tag}_fs.dat", params, cells * scale, mask)
    tio.write_av_vels(tmp_path / f"{tag}_av.dat", av * scale)
    return str(tmp_path / f"{tag}_av.dat"), str(tmp_path / f"{tag}_fs.dat")


@pytest.mark.parametrize("scale,passed", [(1.0, True), (1.004, True), (1.02, False)])
def test_checker_matches_jax_checker(tmp_path, params, scale, passed):
    ref_av, ref_fs = write_pair(tmp_path, params, "ref", 1.0)
    sim_av, sim_fs = write_pair(tmp_path, params, "sim", scale)
    got = tchecker.check_files(sim_av, sim_fs, ref_av, ref_fs, tolerance=1.0)
    want = jchecker.check_files(sim_av, sim_fs, ref_av, ref_fs, tolerance=1.0)
    assert got.passed == want.passed == passed
    assert dataclasses.asdict(got.av_vels) == dataclasses.asdict(want.av_vels)
    assert dataclasses.asdict(got.final_state) == dataclasses.asdict(want.final_state)
    args = ["--ref-av-vels-file", ref_av, "--ref-final-state-file", ref_fs,
            "--av-vels-file", sim_av, "--final-state-file", sim_fs]
    assert tchecker.main(args) == jchecker.main(args) == (0 if passed else 1)


def test_checker_rejects_different_step_counts(tmp_path, params):
    ref_av, ref_fs = write_pair(tmp_path, params, "ref", 1.0)
    sim_av, sim_fs = write_pair(tmp_path, params, "sim", 1.0)
    tio.write_av_vels(sim_av, np.ones(5))
    with pytest.raises(ValueError):
        tchecker.check_files(sim_av, sim_fs, ref_av, ref_fs)
    assert tchecker.main(["--ref-av-vels-file", ref_av, "--ref-final-state-file", ref_fs,
                          "--av-vels-file", sim_av, "--final-state-file", sim_fs]) == 1


def test_native_library_path_is_the_repo_native_dir():
    from lbm_tpu.io import native as jnative
    from lbm_tpu_torch.io import native as tnative

    assert os.path.samefile(os.path.dirname(tnative._LIB_PATH),
                            os.path.dirname(jnative._LIB_PATH))
