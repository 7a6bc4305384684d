"""The port's row mesh across processes (``lbm_tpu_torch/parallel/multihost.py``,
``--multihost``) against its one-process mesh and the JAX package.

- ``initialize_multihost``: tests/test_multihost.py's branches, with
  ``torch.distributed.init_process_group`` patched (torchrun's variables
  in place of JAX's).
- The shard objects of the path in one process, two shards stepped in
  turns with their rows swapped by hand: ``shard_step.RowShard`` (K3's
  plain version) and ``band_common.BandRowShard`` (K8's and K10's) give
  the one-process mesh's bits.
- A real run of 2 processes over gloo on the CPU
  (tests/torch_multihost_worker.py), 16 x 16, 5 steps, at ``reference``,
  ``pallas``, ``band``, ``band2`` (T 4: a pass and a K3 remainder) and
  ``pallas-overlap`` (K12's plain version in ``shard_step.IpcRowShard``,
  its rows swapped over gloo) in f32 and ``pallas``, ``band`` and
  ``pallas-overlap`` in bf16: each process's result is bitwise the
  one-process ``run_simulation_sharded(n_devices=2)`` on the CPU, and the
  f32 results within 1e-6 (absolute) of the JAX package's
  ``run_simulation(backend="reference", dtype=jnp.float32)``, the av
  series also at tests/test_sharded.py's rtol 5e-5 (the port's fused
  collision form against JAX's literal one: 1.5e-5 seen). K12 on the card,
  its neighbours mapped with CUDA IPC, is tests/test_torch_cuda.py's
  ``test_ipc_row_shard_is_the_one_process_k12``.
- A world of one (no group) with ``pallas-overlap``, through the API and
  the CLI: the one-shard mesh's bits, ``--mesh 1``'s files.
- The refusals: c16 (``pallas-overlap`` too), a 2-D mesh, checkpoints and
  ``--debug`` under ``--multihost``.
"""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.models.d2q9 import LBMParams as JParams
from lbm_tpu.runtime.driver import run_simulation as jax_run
from lbm_tpu_torch import cli
from lbm_tpu_torch.models.d2q9 import D2Q9, LBMParams
from lbm_tpu_torch.ops import band as tband
from lbm_tpu_torch.ops import band2 as tband2
from lbm_tpu_torch.ops import shard_step as tshard
from lbm_tpu_torch.parallel import multihost
from lbm_tpu_torch.parallel import sharded as tsh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_multihost_worker as worker  # noqa: E402

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
# The av series against the JAX package: tests/test_sharded.py's rtol (the
# port's fused collision form against JAX's literal one, f32).
AV_RTOL = 5e-5


@pytest.fixture
def recorded(monkeypatch):
    calls = []

    def fake_init(*args, **kwargs):
        calls.append((args, kwargs))

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    return calls


def joined(address, n, rank):
    return [((), {"backend": "gloo", "init_method": f"tcp://{address}", "world_size": n,
                  "rank": rank})]


def test_explicit_args(recorded):
    multihost.initialize_multihost("host0:1234", 4, 2)
    assert recorded == joined("host0:1234", 4, 2)


def test_env_vars(recorded, monkeypatch):
    for var, value in (("MASTER_ADDR", "coord"), ("MASTER_PORT", "8476"), ("WORLD_SIZE", "16"),
                       ("RANK", "3")):
        monkeypatch.setenv(var, value)
    multihost.initialize_multihost()
    assert recorded == joined("coord:8476", 16, 3)


def test_explicit_args_override_env(recorded, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "env")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    multihost.initialize_multihost(coordinator_address="arg:2")
    (_, kwargs), = recorded
    assert kwargs["init_method"] == "tcp://arg:2"
    assert (kwargs["world_size"], kwargs["rank"]) == (8, 5)  # the environment fills the gaps


def test_unconfigured_is_one_process(recorded):
    """No variable, no argument: no group is made, and the world is this
    process alone (the JAX call's auto-detect has no counterpart)."""
    multihost.initialize_multihost()
    assert recorded == []
    assert multihost.world() == (0, 1)


def test_partial_configuration_raises(recorded, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize_multihost()
    assert recorded == []


def test_configured_failure_propagates(monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="unreachable"):
        multihost.initialize_multihost("host0:1234", 4, 0)


@pytest.mark.parametrize("var", ["WORLD_SIZE", "RANK", "MASTER_PORT"])
def test_bad_env_value(recorded, monkeypatch, var):
    monkeypatch.setenv("MASTER_ADDR", "coord")
    monkeypatch.setenv("MASTER_PORT", "8476")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv(var, "not-a-number")
    with pytest.raises(ValueError):
        multihost.initialize_multihost()
    assert recorded == []


def test_local_device_reads_local_rank(monkeypatch):
    """The default device is cuda:$LOCAL_RANK, selected as --device selects:
    with no card it raises rather than running on the host."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    seen = []
    monkeypatch.setattr("lbm_tpu_torch.runtime.device.select_device",
                        lambda index: seen.append(index) or torch.device("cpu"))
    multihost.local_device()
    assert seen == [1]


def test_ring_from_rows_is_with_ring():
    """The ring from received rows is ``with_ring``'s for a 1-D mesh."""
    g = torch.Generator().manual_seed(0)
    shards = [[torch.rand((3, 4, 5), generator=g)] for _ in range(3)]
    rings = tshard.with_ring(shards)
    for z in range(3):
        got = tshard.ring_from_rows(shards[z][0], shards[z - 1][0][:, -1:],
                                    shards[(z + 1) % 3][0][:, :1])
        assert torch.equal(got, rings[z][0])


def mesh_case(ny, nx, iters, n, seed=5):
    params = LBMParams(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10, density=0.1, accel=0.005,
                       omega=1.85)
    rng = np.random.RandomState(seed)
    obs = np.zeros((ny, nx), dtype=np.int32)
    obs[0, :] = obs[-1, :] = 1
    obs[rng.randint(1, ny - 1, 10), rng.randint(0, nx, 10)] = 1
    for z in range(1, n):  # an obstacle on each side of every seam
        obs[z * ny // n - 1, 2 * z] = obs[z * ny // n, 2 * z + 1] = 1
    return params, obs


def step_in_turns(shards, n):
    """``n`` steps (or passes) of shards that stand for processes: each
    receives its neighbours' edge rows, as ``RowExchange`` delivers them."""
    for _ in range(n):
        edges = [s.edges() for s in shards]
        for z, s in enumerate(shards):
            dn, up = s.halos()
            dn.copy_(edges[z - 1][1])
            up.copy_(edges[(z + 1) % len(shards)][0])
        for s in shards:
            s.step()


@pytest.mark.parametrize("n", [2, 3])
def test_row_shard_k3_plain_is_the_mesh(n):
    params, obs = mesh_case(18, 10, 7, n)
    ry = params.ny // n
    cells = D2Q9.initial_state(params, dtype=torch.float32)
    nob = torch.as_tensor((obs == 0).astype(np.float32))
    mesh = tsh.make_mesh(devices=["cpu"] * n)
    want, want_sums = tshard.run_shard_step_plain(
        tsh.split(cells, mesh), tsh.split(nob, mesh), params.density, params.accel,
        params.omega, params.max_iters, params.ny)
    rings = tshard.with_ring([[nob[None, z * ry:(z + 1) * ry]] for z in range(n)])
    shards = [tshard.RowShard(cells[:, z * ry:(z + 1) * ry], rings[z][0][0], z, n, params.ny,
                              params.density, params.accel, params.omega, params.max_iters)
              for z in range(n)]
    step_in_turns(shards, params.max_iters)
    for z, s in enumerate(shards):
        assert torch.equal(s.state(), want[z][0])
        assert torch.equal(s.sums, want_sums[z])


@pytest.mark.parametrize("route", ["band", "band2"])
def test_band_row_shard_plain_is_the_mesh(route):
    """Two passes of T 4 on 2 shards, the one-process mesh's bits."""
    n, block, depth = 2, 8, 4
    params, obs = mesh_case(16, 12, 2 * depth, n)
    ry = params.ny // n
    cells = D2Q9.initial_state(params, dtype=torch.float32)
    nob = torch.as_tensor((obs == 0).astype(np.float32))
    mesh = tsh.make_mesh(devices=["cpu"] * n)
    mod = tband if route == "band" else tband2
    run = tband.run_band_sharded if route == "band" else tband2.run_band2_sharded
    want, want_sums = run(tsh.split(cells, mesh), tsh.split(nob, mesh), params.density,
                          params.accel, params.omega, params.max_iters, block, depth, params.ny)

    def rows(lo):
        return nob[torch.arange(lo, lo + depth) % params.ny]

    shards = [mod.row_shard(cells[:, z * ry:(z + 1) * ry], nob[z * ry:(z + 1) * ry],
                            rows(z * ry - depth), rows((z + 1) * ry), z, n, params.ny,
                            params.density, params.accel, params.omega, block, depth, None, 2)
              for z in range(n)]
    step_in_turns(shards, 2)
    for z, s in enumerate(shards):
        assert torch.equal(s.state(), want[z][0])
        assert torch.equal(s.sums, want_sums[z])


@pytest.mark.parametrize("backend", ["reference", "pallas", "band", "pallas-overlap"])
def test_world_of_one_is_the_one_shard_mesh(backend):
    """Without a group the path runs a mesh of one process, its own
    neighbour: the bits of ``run_simulation_sharded(n_devices=1)``."""
    params, obs = worker.deck()
    got = multihost.run_simulation_multihost(params, obs, backend=backend, device="cpu")
    want = tsh.run_simulation_sharded(params, obs, devices=["cpu"], backend=backend)
    assert (got.rank, got.world, got.channel, got.route) == (0, 1, "local", want.route)
    assert np.array_equal(got.cells, want.cells)
    assert np.array_equal(got.av_vels, want.av_vels)


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Both processes' results of tests/torch_multihost_worker.py."""
    tmp = tmp_path_factory.mktemp("multihost")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_multihost_worker.py"),
                               str(rank), "2", str(port), str(tmp / f"out{rank}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    return [np.load(tmp / f"out{rank}.npz") for rank in range(2)]


@pytest.mark.parametrize("backend,precision", worker.CASES)
def test_two_processes_are_the_one_process_mesh(two_processes, backend, precision):
    params, obs = worker.deck()
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    want = tsh.run_simulation_sharded(params, obs, n_devices=2, devices=["cpu", "cpu"],
                                      backend=backend, dtype=dtype)
    key = f"{backend}_{precision}"
    for rank, got in enumerate(two_processes):
        meta = json.loads(str(got["meta"]))[key]
        assert meta == {"route": want.route, "channel": "gloo", "world": 2, "rank": rank,
                        "devices": ["cpu", "cpu"]}
        assert np.array_equal(got[key + "_cells"], want.cells)
        assert np.array_equal(got[key + "_av"], want.av_vels)


@pytest.mark.parametrize("backend", [b for b, p in worker.CASES if p == "f32"])
def test_two_processes_match_jax(two_processes, backend):
    params, obs = worker.deck()
    from dataclasses import asdict

    want = jax_run(JParams(**asdict(params)), obs, backend="reference", dtype=jnp.float32)
    for got in two_processes:
        np.testing.assert_allclose(got[f"{backend}_f32_cells"], np.asarray(want.cells),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[f"{backend}_f32_av"], np.asarray(want.av_vels),
                                   rtol=AV_RTOL, atol=1e-6)


@pytest.mark.parametrize("backend,dtype,match", [
    ("auto", "c16", "c16"),
    ("pallas-overlap", "c16", "c16"),
    ("aa", torch.float32, "single-device"),
])
def test_refusals(backend, dtype, match):
    params, obs = worker.deck()
    with pytest.raises(ValueError, match=match):
        multihost.run_simulation_multihost(params, obs, backend=backend, dtype=dtype,
                                           device="cpu")


@pytest.fixture
def tiny_deck(tmp_path):
    (tmp_path / "tiny.params").write_text("16\n16\n5\n10\n0.1\n0.005\n1.85\n")
    (tmp_path / "obs.dat").write_text("0 0 1\n3 4 1\n")
    return str(tmp_path / "tiny.params"), str(tmp_path / "obs.dat"), str(tmp_path / "out")


@pytest.mark.parametrize("extra,match", [
    (["--mesh", "2x1"], "2-D mesh"),
    (["--mesh", "2"], "does not match"),
    (["--checkpoint-every", "2"], "single-controller"),
    (["--resume"], "single-controller"),
    (["--debug"], "--debug"),
])
def test_cli_refusals(tiny_deck, capsys, extra, match):
    param, obst, out = tiny_deck
    rc = cli.main([param, obst, "--device", "cpu", "--multihost", "--out-dir", out] + extra)
    assert rc == 1
    err = capsys.readouterr().err
    assert err.startswith("lbm_tpu_torch: error:") and match in err
    assert not os.path.exists(out)


def test_cli_multihost_one_process(tiny_deck, capsys):
    """``--multihost`` without a group: a world of one, the files and the
    block of ``--mesh 1``, the stats naming the channel."""
    param, obst, out = tiny_deck
    assert cli.main([param, obst, "--device", "cpu", "--multihost", "--backend", "pallas",
                     "--out-dir", out, "--stats-json", out + ".json"]) == 0
    assert "==done==" in capsys.readouterr().out
    assert cli.main([param, obst, "--device", "cpu", "--mesh", "1", "--backend", "pallas",
                     "--out-dir", out + "1"]) == 0
    for name in ("av_vels.dat", "final_state.dat"):
        with open(os.path.join(out, name), "rb") as a, open(os.path.join(out + "1", name),
                                                             "rb") as b:
            assert a.read() == b.read()
    with open(out + ".json") as f:
        stats = json.load(f)
    assert stats["multihost"]["world"] == 1 and stats["multihost"]["channel"] == "local"
    assert stats["multihost"]["ranks"][0]["rank"] == 0


def test_cli_multihost_overlap_one_process(tiny_deck, capsys):
    """``--multihost --backend pallas-overlap`` without a group: a world of
    one (K12's plain version, the shard its own neighbour), the files of
    ``--mesh 1``."""
    param, obst, out = tiny_deck
    assert cli.main([param, obst, "--device", "cpu", "--multihost", "--backend",
                     "pallas-overlap", "--out-dir", out, "--stats-json", out + ".json"]) == 0
    assert "==done==" in capsys.readouterr().out
    assert cli.main([param, obst, "--device", "cpu", "--mesh", "1", "--backend", "pallas",
                     "--out-dir", out + "1"]) == 0
    for name in ("av_vels.dat", "final_state.dat"):
        with open(os.path.join(out, name), "rb") as a, open(os.path.join(out + "1", name),
                                                             "rb") as b:
            assert a.read() == b.read()
    with open(out + ".json") as f:
        stats = json.load(f)
    assert stats["route"] == "pallas-overlap"
    assert stats["multihost"]["channel"] == "local"
    assert stats["multihost"]["ranks"][0]["launches"]["K12 ipc"] == 0  # no card: no kernel
