"""The benchmark of ``lbm_tpu_torch``: one cell of ``BENCHMARK.json`` per run.

A cell names a configuration (a deck: ``configs/<name>.json``) and a
traffic mix (``traffic/<name>.json``: the storage the decks run at). Each
per-layer and end-to-end metric is read by ``metrics/<name>.py``, and each
cell's correctness limits are in ``limits/<workload>.json``: a cell, a mix
or a metric added as a file is found by its name, with no edit here.

A run is one batch user running whole decks back to back (a closed loop,
one client). Set-up imports torch, loads the program's kernel library
(the first run in a checkout builds it), builds the deck and the seeded
start and runs one warm-up deck cut to ``WARMUP_STEPS`` steps at the
deck's shape. The window then calls
``lbm_tpu_torch.runtime.driver.run_simulation`` on the whole deck, again
and again with the same start, until ``--seconds`` have passed, and closes
at the end of the deck running then. With ``--trace 1`` a further
``TRACE_DECKS`` decks run under ``torch.profiler`` after the window, for
the readings that need the device's trace. Once the window has closed
the plain reference (``reference.py``) runs the deck from the same start,
and ``check.py`` holds every deck's av series and the final states of
``CHECKED_FINAL_STATES`` decks drawn from the seed against it.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BENCHMARK_JSON = os.path.join(os.path.dirname(HERE), "BENCHMARK.json")
# Top-level module names the process may not hold once the window has
# closed: JAX and the JAX package the program was ported from.
FOREIGN = ("jax", "jaxlib", "flax", "lbm_tpu")
STORAGES = ("f32", "c16", "bf16")
# Every deck runs the program's own choice of kernels.
BACKEND = "auto"
# The start is the rest state with each value scaled by 1 + a u, u uniform
# in [-1, 1) from the seed: deviations of at most 4.4e-4 on the official
# deck, below what its own flow reaches and far inside c16's range.
START_PERTURBATION = 0.01
# The set-up deck's steps: two passes of a 4-step kernel.
WARMUP_STEPS = 8
# Decks, drawn from the seed, whose final state is held against the
# reference (every deck's av series is).
CHECKED_FINAL_STATES = 3
# Decks traced after the window with --trace 1.
TRACE_DECKS = 3


# ---------------------------------------------------------------- specs

def load_bench(path: str = BENCHMARK_JSON) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_named(root: str, kind: str, name: str) -> dict:
    """``<root>/<kind>/<name>.json``, which has to give its own name."""
    path = os.path.join(root, kind, f"{name}.json")
    with open(path) as f:
        spec = json.load(f)
    if spec.get("name") != name:
        raise ValueError(f"{path} names itself {spec.get('name')!r}")
    return spec


def metric_reader(root: str, name: str):
    """``read(run)`` of ``<root>/metrics/<name>.py``."""
    path = os.path.join(root, "metrics", f"{name}.py")
    modname = "portbench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, trace: bool) -> list[dict]:
    """The end-to-end metrics (``trace`` False) or the per-layer ones."""
    return bench["per_layer"] if trace else bench["end_to_end"]


# ---------------------------------------------------------------- the deck

def blocked_mask(config: dict) -> np.ndarray:
    """The deck's obstacle mask ``(ny, nx)``, 1 where blocked: whole rows
    and whole columns (negative indices count from the end), as every
    deck of the reference solver blocks them."""
    blocked = config.get("blocked", {})
    mask = np.zeros((config["ny"], config["nx"]), np.int32)
    for r in blocked.get("rows", []):
        mask[r, :] = 1
    for c in blocked.get("cols", []):
        mask[:, c] = 1
    return mask


def seeded_start(config: dict, seed: int, device) -> np.ndarray:
    """The deck's rest state times ``1 + a * u``, ``u`` uniform in [-1, 1)
    per value from ``seed`` (a torch generator on ``device``), ``a``
    ``START_PERTURBATION``: an f32 numpy array ``(9, ny, nx)``."""
    import torch

    from portbench.reference import WEIGHTS

    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 64)
    shape = (9, config["ny"], config["nx"])
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    w = torch.tensor(WEIGHTS, dtype=torch.float64, device=device) * config["density"]
    rest = w.to(torch.float32).view(9, 1, 1)
    start = rest * (1.0 + START_PERTURBATION * (2.0 * u - 1.0))
    del u
    return start.cpu().numpy()


def storage_dtype(storage: str):
    import torch

    if storage not in STORAGES:
        raise ValueError(f"storage {storage!r} is none of {STORAGES}")
    return {"f32": torch.float32, "c16": "c16", "bf16": torch.bfloat16}[storage]


@dataclasses.dataclass
class Deck:
    """What one call of the program needs, made once in set-up."""

    config: dict
    traffic: dict
    params: object  # lbm_tpu_torch's LBMParams
    obstacles: np.ndarray
    start: np.ndarray
    device: object

    def call(self, storage: str | None = None, max_iters: int | None = None):
        """One whole deck through the program's entry: the av series and
        the final state fetched to the host (no files written)."""
        from lbm_tpu_torch.runtime import driver

        params = self.params
        if max_iters is not None:
            params = dataclasses.replace(params, max_iters=max_iters)
        return driver.run_simulation(
            params, self.obstacles, backend=BACKEND,
            dtype=storage_dtype(storage or self.traffic["storage"]),
            initial_cells=self.start, fetch_final=True, device=self.device)

    @property
    def steps(self) -> int:
        return self.config["max_iters"]


def build_deck(config: dict, traffic: dict, seed: int, device) -> Deck:
    from lbm_tpu_torch.models.d2q9 import LBMParams

    params = LBMParams(nx=config["nx"], ny=config["ny"], max_iters=config["max_iters"],
                       reynolds_dim=config["reynolds_dim"], density=config["density"],
                       accel=config["accel"], omega=config["omega"])
    return Deck(config, traffic, params, blocked_mask(config),
                seeded_start(config, seed, device), device)


# ---------------------------------------------------------------- the run

@dataclasses.dataclass
class DeckTime:
    wall_s: float  # the whole call on the host clock
    loop_s: float  # the program's compute loop (SimulationResult.elapsed)


@dataclasses.dataclass
class RunRecord:
    """Everything a metric reader reads."""

    setup_s: float  # from the harness's first line to the window's start
    window_s: float  # from the window's start to the end of its last deck
    decks: list  # DeckTime of every deck of the window
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    free_cells: int  # unblocked cells of the deck
    peaks: dict | None  # this card's row of peaks.json, or None
    trace: object = None  # trace.Trace of the traced decks, or None


class Reservoir:
    """``k`` items drawn uniformly from a stream of unknown length."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def program_counters() -> dict:
    """Every ``launches*`` counter of the program's loaded ops modules."""
    out = {}
    for modname, module in list(sys.modules.items()):
        if not modname.startswith("lbm_tpu_torch.ops.") or module is None:
            continue
        for attr, obj in vars(module).items():
            if not callable(obj) or getattr(obj, "__module__", None) != modname:
                continue
            for key, value in vars(obj).items():
                if key.startswith("launches") and isinstance(value, int):
                    out[f"{attr}.{key}"] = value
    return out


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FOREIGN``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FOREIGN))


def host_state() -> dict:
    """This process's CPU seconds and, where ``/proc`` has them, the host's
    stolen CPU seconds over all its cores and its 1-minute load average."""
    out = {"cpu_s": sum(os.times()[:2])}
    try:
        with open("/proc/stat") as f:
            out["steal_s"] = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/loadavg") as f:
            out["load1"] = float(f.read().split()[0])
    except (OSError, IndexError, ValueError):
        pass
    return out


def host_line(run: RunRecord, before: dict, after: dict, root: str) -> str:
    """The window's host readings, on every run: the program's loop rate
    and its time a deck outside the loop (the per-layer readers
    ``loop_mlups`` and ``host_ms``), and ``host_state`` before and after."""
    parts = [f"{name} {metric_reader(root, name)(run)}" for name in ("loop_mlups", "host_ms")]
    parts += [f"{k} {after[k] - before[k]}" for k in ("cpu_s", "steal_s") if k in before]
    parts.append(f"load1 {before.get('load1')} -> {after.get('load1')}")
    return "portbench: host over the window: " + ", ".join(parts)


def card_line(index: int = 0) -> str:
    """nvidia-smi's name, power limit, SM clock and its maximum, power draw
    and temperature of card ``index``, or why there are none."""
    query = "name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    try:
        proc = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
                               f"--id={index}"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return proc.stdout.strip() or f"nvidia-smi: {proc.stderr.strip()}"


def load_peaks(kind: str, root: str = HERE) -> dict | None:
    with open(os.path.join(root, "peaks.json")) as f:
        return json.load(f)["cards"].get(kind)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             bench: dict | None = None, root: str = HERE) -> dict:
    """Run one cell and return ``{"result": ..., "checks": [...], "info": [...]}``:
    the result line's object, the numbers compared with their limits, and
    the lines for standard error before them."""
    import torch

    from portbench import check
    from portbench.reference import Deck as ReferenceDeck

    info = []
    bench = load_bench() if bench is None else bench
    cell = find_cell(bench, workload)
    config = load_named(root, "configs", cell["config"])
    traffic = load_named(root, "traffic", cell["traffic"])
    limits = check.load_limits(root, workload)
    readers = {m["name"]: metric_reader(root, m["name"]) for m in cell_metrics(bench, trace)}
    device = torch.device(device)
    cuda = device.type == "cuda"

    # Set-up: the deck, the seeded start, one warm-up deck cut short.
    deck = build_deck(config, traffic, seed, device)
    warm = deck.call(max_iters=WARMUP_STEPS)
    del warm
    gc.collect()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    before = program_counters()
    rng = np.random.default_rng(seed % 2 ** 64)
    kept = Reservoir(CHECKED_FINAL_STATES, rng)
    avs, times, routes = [], [], set()

    def one_deck(index):
        d0 = time.perf_counter()
        res = deck.call()
        d1 = time.perf_counter()
        times.append(DeckTime(d1 - d0, res.elapsed))
        avs.append(res.av_vels)
        routes.add(res.route)
        kept.offer((index, res.cells))
        return d1

    # The window.
    host0 = host_state()
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    end = one_deck(0)
    while end - t_win < seconds:
        end = one_deck(len(times))
    window_s = end - t_win
    window_decks = list(times)
    host1 = host_state()
    after = program_counters()

    traced = None
    if trace:
        traced = traced_decks(deck, TRACE_DECKS, one_deck, len(times), device)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    card = card_line(device.index or 0) if cuda else "cpu"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"

    info.append(f"portbench: {workload} seed {seed}: route {'+'.join(sorted(routes))}, "
        f"{len(window_decks)} decks in a window of {window_s:.6f} s, setup {setup_s:.6f} s")
    info.append("portbench: counters over the window: " + json.dumps(
        {k: after[k] - before.get(k, 0) for k in sorted(after) if after[k] != before.get(k, 0)}))
    info.append(f"portbench: card: {card}")

    # The reference, once the window has closed and the program's state is
    # freed.
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = ReferenceDeck(deck.obstacles, config["density"], config["accel"], config["omega"],
                        device)
    av_ref, cells_ref = ref.run(deck.start, deck.steps)
    del ref
    worst = {n: 0.0 for n in check.NUMBERS}
    failed = set()
    for i, av in enumerate(avs):
        gap = check.av_gap_pct(av, av_ref)
        worst["av_gap_pct"] = max(worst["av_gap_pct"], gap)
        if not gap <= limits["av_gap_pct"]:
            failed.add(i)
    free = deck.obstacles == 0
    for i, cells in kept.items:
        gaps = check.state_gaps(cells, cells_ref, free, device)
        for n, v in gaps.items():
            worst[n] = max(worst[n], v)
            if not v <= limits[n]:
                failed.add(i)
    info.append(f"portbench: reference deck {time.perf_counter() - t_ref:.3f} s; final states "
        f"compared: decks {sorted(i for i, _ in kept.items)} of {len(avs)}")
    verdict = check.verdict(worst, limits)
    correct = bool(avs) and not failed and all(ok for *_, ok in verdict)

    run = RunRecord(setup_s=setup_s, window_s=window_s, decks=window_decks, config=config,
                    traffic=traffic, free_cells=int(np.sum(deck.obstacles == 0)),
                    peaks=load_peaks(kind, root) if cuda else None, trace=traced)
    info.insert(3, host_line(run, host0, host1, root))
    metrics = {}
    for m in cell_metrics(bench, trace):
        value = readers[m["name"]](run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell["chips"],
           "memory_peak_bytes": peak, "nvidia_smi": card}
    result = {"correct": correct, "attempted": len(avs), "failed": len(failed),
              "metrics": metrics, "device": dev}
    if traced is not None:
        from portbench.trace import breakdown, busy_us

        dev["busy_s"] = busy_us(traced) / 1e6
        dev["window_s"] = (traced.hi - traced.lo) / 1e6
        result["breakdown"] = breakdown(traced)
        for line in breakdown(traced, totals=True):
            info.append(f"portbench: idle by host activity: {line}")
    checks = [{"name": n, "value": v, "limit": lim} for n, v, lim, _ in verdict]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return {"result": result, "checks": checks, "info": info}


def traced_decks(deck: Deck, n: int, one_deck, first: int, device):
    """``n`` decks under torch.profiler, each in a ``portbench.deck`` span;
    the trace is written to a temporary file, read and deleted."""
    import torch

    from portbench.trace import read_trace

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        for i in range(n):
            with torch.profiler.record_function("portbench.deck"):
                one_deck(first + i)
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_trace(path, n)
    finally:
        os.remove(path)
