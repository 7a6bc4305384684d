"""Device selection (counterpart of ``lbm_tpu/runtime/device.py``).

The reference enumerates OpenCL devices, prints the list and honours an
``OCL_DEVICE`` index (d2q9-bgk.c:950-1007). Here ``--device N`` or
``LBM_DEVICE=N`` selects ``cuda:N``; with neither, ``cuda:0``. The CPU runs
only when named explicitly (``--device cpu`` / ``LBM_DEVICE=cpu``): with no
CUDA device and no explicit ``cpu``, selection raises rather than quietly
running on the host.
"""

from __future__ import annotations

import os
import sys

import torch


def list_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def format_device_list() -> str:
    """Human-readable device table (the reference's startup printout,
    d2q9-bgk.c:975-981)."""
    lines = ["", "Available devices:"]
    for i, d in enumerate(list_devices()):
        lines.append("%2d: %s (%s)" % (i, device_name(d), d.type))
    lines.append("    cpu (only when named with --device cpu)")
    lines.append("")
    return "\n".join(lines)


def format_selected(device: torch.device) -> str:
    """The reference's selection printout (d2q9-bgk.c:1002-1004)."""
    index = device.index if device.index is not None else 0
    return "Selected device:\n-> %s (index=%d)\n" % (device_name(device), index)


def select_device(index: int | str | None = None) -> torch.device:
    """Pick the compute device: explicit ``index`` > ``LBM_DEVICE`` > ``cuda:0``.

    ``index`` is an int, a string holding one, or ``"cpu"``. Raises
    ValueError when no CUDA device exists and the CPU was not named, and
    IndexError with the device list on a bad index (d2q9-bgk.c:985-999).
    """
    if index is None:
        index = os.environ.get("LBM_DEVICE")
    if isinstance(index, str):
        if index.strip().lower() == "cpu":
            return torch.device("cpu")
        try:
            index = int(index)
        except ValueError as e:
            raise ValueError(f"device {index!r} is neither an integer nor 'cpu'") from e
    devices = list_devices()
    if not devices:
        raise ValueError(
            "no CUDA device is available; pass --device cpu (or LBM_DEVICE=cpu) "
            "to run on the host"
        )
    if index is None:
        return devices[0]
    if not 0 <= index < len(devices):
        raise IndexError(f"device index {index} out of range\n{format_device_list()}")
    return devices[index]


def print_devices(file=sys.stderr) -> None:
    print(format_device_list(), file=file)
