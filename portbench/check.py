"""The comparison that decides ``correct``: what the program's timed decks
returned against the plain reference (``portbench/reference.py``) on the
same deck and start.

Three numbers, each the worst over the decks compared, each held to a
limit of its own from ``portbench/limits/<workload>.json``:

- ``av_gap_pct``: the reference checker's av_vels series (check.py's
  per-step percent difference), ``100 * max_t |av - av_ref| / |av_ref|``;
- ``pressure_gap_pct``: its final-state pressure column on unblocked
  cells, ``100 * max |rho - rho_ref| / rho_ref`` (pressure is
  ``rho / 3``, so the share is the density's);
- ``velocity_gap_pct``: the final velocity field,
  ``100 * max |u - u_ref| / max |u_ref|`` over unblocked cells, ``u``
  the vector of the moments, so that an error in a slow cell counts
  against the flow's scale rather than against its own small speed.

A number that is not finite reads as infinite and fails its limit.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

NUMBERS = ("av_gap_pct", "pressure_gap_pct", "velocity_gap_pct")


def av_gap_pct(av: np.ndarray, av_ref: np.ndarray) -> float:
    av = np.asarray(av, np.float64)
    av_ref = np.asarray(av_ref, np.float64)
    if av.shape != av_ref.shape:
        return float("inf")
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.abs(av - av_ref) / np.abs(av_ref)
    return _finite(100.0 * float(np.max(gap)))


def state_gaps(cells: np.ndarray, cells_ref: np.ndarray, free: np.ndarray, device) -> dict:
    """``pressure_gap_pct`` and ``velocity_gap_pct`` of one final state, in
    f64 on ``device``."""
    if np.shape(cells) != np.shape(cells_ref):
        return {"pressure_gap_pct": float("inf"), "velocity_gap_pct": float("inf")}
    f64 = dict(dtype=torch.float64, device=device)
    mask = torch.as_tensor(np.asarray(free) != 0, device=device)
    rho, ux, uy = _moments(torch.as_tensor(cells).to(**f64))
    rho_r, ux_r, uy_r = _moments(torch.as_tensor(cells_ref).to(**f64))
    pressure = torch.abs(rho - rho_r) / torch.abs(rho_r)
    du = torch.sqrt((ux - ux_r) ** 2 + (uy - uy_r) ** 2)
    scale = torch.sqrt(ux_r ** 2 + uy_r ** 2)[mask].max()
    return {"pressure_gap_pct": _finite(100.0 * float(pressure[mask].max())),
            "velocity_gap_pct": _finite(100.0 * float(du[mask].max() / scale))}


def _moments(f: torch.Tensor):
    rho = f.sum(0)
    ux = ((f[1] + f[5] + f[8]) - (f[3] + f[6] + f[7])) / rho
    uy = ((f[2] + f[5] + f[6]) - (f[4] + f[7] + f[8])) / rho
    return rho, ux, uy


def _finite(x: float) -> float:
    return x if np.isfinite(x) else float("inf")


def load_limits(root: str, workload: str) -> dict:
    """``{number: limit}`` of a cell, from ``<root>/limits/<workload>.json``."""
    path = os.path.join(root, "limits", f"{workload}.json")
    with open(path) as f:
        limits = json.load(f)["limits"]
    missing = [n for n in NUMBERS if n not in limits]
    if missing:
        raise ValueError(f"{path}: no limit for {missing}")
    return {n: float(limits[n]) for n in NUMBERS}


def verdict(worst: dict, limits: dict) -> list[tuple[str, float, float, bool]]:
    """``(name, value, limit, within)`` for every number compared."""
    return [(n, worst[n], limits[n], worst[n] <= limits[n]) for n in NUMBERS]
