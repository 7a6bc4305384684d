"""The CUDA kernels on the card: K1 and K2 against their plain versions.

These tests need an NVIDIA GPU and nvcc; without a card they skip. They
import neither JAX nor the JAX package, so they run where only the port's
dependencies exist. On the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX for the other tests.)
Tolerances: cells within 1e-5 of the state's scale and the av series at
rtol 1e-4 (the kernels contract multiply-adds into FMAs and sum in another
order than PyTorch).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lbm_tpu_torch.models.d2q9 import WEIGHTS  # noqa: E402
from lbm_tpu_torch.ops import aa as taa  # noqa: E402
from lbm_tpu_torch.ops import step as tstep  # noqa: E402

DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def make_setup(device, nx, ny, seed):
    rng = np.random.RandomState(seed)
    obstacles = np.zeros((ny, nx), dtype=np.int32)
    obstacles[0, :] = obstacles[-1, :] = 1
    obstacles[rng.randint(1, ny - 1, 8), rng.randint(0, nx, 8)] = 1
    state = (WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx))
    cells = torch.as_tensor(state.astype(np.float32)).to(device)
    return cells, torch.as_tensor((obstacles == 0).astype(np.float32)).to(device)


def assert_close(got, want):
    (gc, ga), (wc, wa) = got, want
    assert float((gc - wc).abs().max()) < 1e-5 * float(wc.abs().max())
    np.testing.assert_allclose(ga.cpu().numpy(), wa.cpu().numpy(), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(1000, 40), (33, 3)])
def test_step_kernel_matches_plain(cuda_device, nx, ny):
    cells, nobst = make_setup(cuda_device, nx, ny, seed=8)
    before = tstep.run_step.launches
    got = tstep.run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 7, 1.0)
    assert tstep.run_step.launches == before + 7
    assert_close(got, tstep.run_step_plain(cells, nobst, DENSITY, ACCEL, OMEGA, 7, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [6, 7])
@pytest.mark.parametrize("nx,ny", [(1000, 40), (33, 3)])
def test_aa_kernel_matches_plain_and_repeats(cuda_device, nx, ny, iters):
    cells, nobst = make_setup(cuda_device, nx, ny, seed=iters)
    before = taa.run_aa.launches
    got = taa.run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0)
    assert taa.run_aa.launches == before + iters
    again = taa.run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert_close(got, taa.run_aa_plain(cells, nobst, DENSITY, ACCEL, OMEGA, iters, 1.0))


@pytest.mark.cuda
def test_kernels_reject_other_collision_forms(cuda_device):
    cells, nobst = make_setup(cuda_device, 64, 8, seed=1)
    for run in (tstep.run_step, taa.run_aa):
        with pytest.raises(ValueError, match="fused"):
            run(cells, nobst, DENSITY, ACCEL, OMEGA, 2, 1.0, paired=True)
