"""Fixtures of the benchmark's CPU tests: a copy of ``portbench/`` with a
tiny deck added as files, and its ``BENCHMARK.json``."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PORTBENCH = os.path.join(REPO, "portbench")
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# A deck the CPU runs in a fraction of a second: the official deck's
# physics and geometry (a closed box with a wall at a third of the width).
TINY = {"name": "tiny", "source": "a CPU test deck", "nx": 48, "ny": 40, "max_iters": 300,
        "reynolds_dim": 10, "density": 0.1, "accel": 0.01, "omega": 1.85,
        "blocked": {"rows": [0, -1], "cols": [0, -1, 16]}, "reduced": [], "assumed": {}}


def add_cell(root, bench, config, traffic, limits_of):
    """Add ``config`` as a file and the cell ``<config>.<traffic>``, which
    takes the limits of the cell ``limits_of``."""
    with open(os.path.join(root, "configs", f"{config['name']}.json"), "w") as f:
        json.dump(config, f)
    name = f"{config['name']}.{traffic}"
    with open(os.path.join(root, "limits", f"{limits_of}.json")) as f:
        limits = json.load(f)
    limits["workload"] = name
    with open(os.path.join(root, "limits", f"{name}.json"), "w") as f:
        json.dump(limits, f)
    if not any(c["name"] == config["name"] for c in bench["configs"]):
        bench["configs"].append({"name": config["name"], "source": config["source"],
                                 "file": f"portbench/configs/{config['name']}.json",
                                 "reduced": [], "why": "a CPU test deck"})
    bench["workloads"].append({"name": name, "config": config["name"], "traffic": traffic,
                               "chips": 1, "why": "a CPU test cell"})
    return name


def make_tiny(tmp_path):
    """``(root, bench)``: a copy of the benchmark's files under
    ``tmp_path`` with the cells ``tiny.f32`` and ``tiny.c16`` (the limits
    of the 1024^2 cells)."""
    root = os.path.join(str(tmp_path), "portbench")
    shutil.copytree(PORTBENCH, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    add_cell(root, bench, TINY, "f32", "bristol_1024.f32")
    add_cell(root, bench, TINY, "c16", "bristol_1024.c16")
    return root, bench


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path)
