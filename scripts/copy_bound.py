"""The host path's copy bound: how fast a deck's state can cross between
the host and a card, in each form the driver could copy it.

    python3 scripts/copy_bound.py [--bytes N] [--busy-s S] [--out FILE]

Each form moves ``--bytes`` (default: the 1024² f32 state, 9 x 1024 x 1024
x 4 = 37,748,736 B) 20 times on ``cuda:0`` and reports the median and mean
time and the median's rate, on the host clock around work that ends in a
wait on the stream. With ``--busy-s`` the card first runs a spin kernel of
that many seconds (its cycles a second timed once with CUDA events) before
each timed copy, and the host waits for it, as a deck's loop does before
its fetch and the next deck's upload: the host's idle threads then fall
asleep, which a copy on torch's intra-op threads pays for.

- ``dtoh_fresh_pageable``: ``t.cpu()``, a new pageable host tensor each
  time (the driver's fetch before page-locked results);
- ``dtoh_reused_pageable``: into one pageable tensor, touched before;
- ``dtoh_pinned``: into one page-locked block, ``non_blocking``;
- ``dtoh_pinned_cached``: a page-locked block taken from torch's caching
  host allocator each time, as the driver's ``_to_host`` does;
- ``htod_pageable``: ``torch.as_tensor(array).to(card)`` from a resident
  array (the driver's upload);
- ``htod_pinned``: from one page-locked block;
- ``htod_registered``: ``cudaHostRegister`` the array, copy, and
  ``cudaHostUnregister`` it, all three timed (and each alone);
- ``htod_staged_<MB>``: the array copied (torch's copy) into a cached
  page-locked block in pieces of that many MB, each piece's DMA issued as
  soon as it is copied, and ``htod_staged_whole`` in one piece;
  ``enqueue_ms`` is the host time until the last DMA is issued, the part
  the host waits for when other host work follows;
- ``htod_staged_numpy``: in one piece by numpy's copy on the calling
  thread;
- ``host_memcpy_numpy`` (one thread) and ``host_memcpy_torch`` (torch's
  intra-op threads): a copy between two resident host arrays.

It also reports the first page-locked allocation of the size (no cached
block yet) and the bytes the caching host allocator holds for one block
of the size. It needs a card and exits 2 without one: the numbers are the
card's host's and PCIe link's, never the CPU's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

STATE_BYTES = 9 * 1024 * 1024 * 4  # the 1024² f32 state
PIECES_MB = (1, 2, 4, 8, 16, None)  # None: the whole array in one piece
REPEATS = 20


def spin_hz() -> float:
    """The cycles a second of ``torch.cuda._sleep``'s spin, on CUDA events."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(10 ** 6)  # warm
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    end.synchronize()
    return 10 ** 8 / (start.elapsed_time(end) / 1e3)


def measure(nbytes: int, device, busy_s: float = 0.0) -> dict:
    import torch

    n = nbytes // 4
    stream = torch.cuda.current_stream(device)
    sync = stream.synchronize
    busy_cycles = int(busy_s * spin_hz()) if busy_s > 0 else 0
    rows = {}

    def timed(fn, wait=sync):
        """Median and mean ms of ``fn`` up to ``wait``, after a warm call
        (first touch, allocator, lazy state)."""
        fn()
        sync()
        times = []
        for _ in range(REPEATS):
            if busy_cycles:
                torch.cuda._sleep(busy_cycles)
            sync()
            t0 = time.perf_counter()
            fn()
            wait()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times), statistics.mean(times)

    def add(name, ms, **extra):
        median, mean = ms
        rows[name] = {"ms": median, "gbps": nbytes / median / 1e6, "mean_ms": mean, **extra}

    # The first page-locked block of this size class, before any is cached.
    t0 = time.perf_counter()
    first = torch.empty(n, dtype=torch.float32, pin_memory=True)
    first_alloc_ms = 1e3 * (time.perf_counter() - t0)
    stats = getattr(torch.cuda, "host_memory_stats", None)
    held = None
    if stats is not None:
        s = stats()
        held = s.get("reserved_bytes.current", s.get("allocated_bytes.current"))
    del first

    dev = torch.rand(n, device=device)
    sync()
    pageable = torch.empty(n, dtype=torch.float32)
    pageable.fill_(0.0)
    pinned = torch.empty(n, dtype=torch.float32, pin_memory=True)
    pinned.fill_(0.0)
    host = np.random.default_rng(0).random(n, dtype=np.float32)
    dst = torch.empty(n, dtype=torch.float32, device=device)

    add("dtoh_fresh_pageable", timed(lambda: dev.cpu()))
    add("dtoh_reused_pageable", timed(lambda: pageable.copy_(dev)))
    add("dtoh_pinned", timed(lambda: pinned.copy_(dev, non_blocking=True)))

    def pinned_cached():
        out = torch.empty(n, dtype=torch.float32, pin_memory=True)
        out.copy_(dev, non_blocking=True)
        sync()
        return out.numpy()

    add("dtoh_pinned_cached", timed(pinned_cached))
    add("htod_pageable", timed(lambda: torch.as_tensor(host).to(device)))
    add("htod_pinned", timed(lambda: dst.copy_(pinned, non_blocking=True)))

    cudart = torch.cuda.cudart()
    ptr = host.ctypes.data
    parts = {"register": [], "copy": [], "unregister": []}

    def registered():
        t0 = time.perf_counter()
        err = cudart.cudaHostRegister(ptr, nbytes, 0)
        t1 = time.perf_counter()
        if err != cudart.cudaError.success:
            raise RuntimeError(f"cudaHostRegister failed: {err}")
        dst.copy_(torch.from_numpy(host), non_blocking=True)
        sync()
        t2 = time.perf_counter()
        cudart.cudaHostUnregister(ptr)
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(1e3 * dt)

    add("htod_registered", timed(registered),
        **{f"{k}_ms": statistics.median(v[-REPEATS:]) for k, v in parts.items()})

    src = torch.from_numpy(host)
    for mb in PIECES_MB:
        piece = n if mb is None else mb * 2 ** 20 // 4
        enqueue = []

        def staged():
            t0 = time.perf_counter()
            stage = torch.empty(n, dtype=torch.float32, pin_memory=True)
            for lo in range(0, n, piece):
                hi = min(lo + piece, n)
                stage[lo:hi].copy_(src[lo:hi])
                dst[lo:hi].copy_(stage[lo:hi], non_blocking=True)
            enqueue.append(1e3 * (time.perf_counter() - t0))

        add(f"htod_staged_{'whole' if mb is None else mb}", timed(staged),
            enqueue_ms=statistics.median(enqueue[-REPEATS:]),
            enqueue_mean_ms=statistics.mean(enqueue[-REPEATS:]))

    enqueue = []

    def staged_numpy():
        t0 = time.perf_counter()
        stage = torch.empty(n, dtype=torch.float32, pin_memory=True)
        np.copyto(stage.numpy(), host)
        dst.copy_(stage, non_blocking=True)
        enqueue.append(1e3 * (time.perf_counter() - t0))

    add("htod_staged_numpy", timed(staged_numpy), enqueue_ms=statistics.median(enqueue[-REPEATS:]),
        enqueue_mean_ms=statistics.mean(enqueue[-REPEATS:]))

    copy = np.empty_like(host)
    add("host_memcpy_numpy", timed(lambda: np.copyto(copy, host), wait=lambda: None))
    tcopy = torch.from_numpy(copy)
    add("host_memcpy_torch", timed(lambda: tcopy.copy_(src), wait=lambda: None),
        threads=torch.get_num_threads())

    return {"bytes": nbytes, "repeats": REPEATS, "busy_s": busy_s,
            "card": torch.cuda.get_device_name(device),
            "first_pinned_alloc_ms": first_alloc_ms, "pinned_block_bytes": held,
            "forms": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="copy_bound", description=__doc__.split("\n")[0])
    ap.add_argument("--bytes", type=int, default=STATE_BYTES)
    ap.add_argument("--busy-s", type=float, default=0.0,
                    help="seconds the card spins before each timed copy")
    ap.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("copy_bound: no CUDA device; the bound is the card's host's and link's",
              file=sys.stderr)
        return 2
    result = measure(args.bytes - args.bytes % 4, torch.device("cuda:0"), args.busy_s)
    for name, row in result["forms"].items():
        extra = " ".join(f"{k} {v:.4f}" for k, v in row.items() if k not in ("ms", "gbps"))
        print(f"copy_bound: {name}: {row['ms']:.4f} ms, {row['gbps']:.3f} GB/s {extra}",
              file=sys.stderr)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
