#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each printing what it found:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: nvcc builds the kernels of ``lbm_tpu_torch/csrc`` for sm_90a
   (one process per source), and ``make -C native`` the C++ writers that
   the big decks of phase 8 need to write their outputs in seconds;
3. K1 (``csrc/step.cu``) against ``step_plain`` on the card, 1024^2 and
   1000^2, 200 steps; time per step of each at 1024^2 and 128^2;
4. K2 (``csrc/aa.cu``) against ``run_aa_plain``, 200 and 201 steps (both
   exit parities) at 1024^2 and 1000^2; K2 against K1 over 1000 steps;
   two K2 runs must give bitwise-equal results;
5. the K2 and K1 path: the four official decks, generated with
   ``utils/geometry``, through ``lbm_tpu_torch.cli.main`` (what
   ``python -m lbm_tpu_torch`` runs) with ``--backend aa`` at f32, and
   the 1024^2 deck once more with ``--backend pallas``. The launch counters,
   zeroed just before, must show that aa ran K2 and pallas ran K1 for
   every step; the 1024^2 and 256^2 results must pass the 1% gate against
   ``tests/golden/*.golden.npz``;
6. the band kernels K7 (``csrc/band.cu``), K9 (``csrc/band2.cu``) and K11
   (``csrc/band3.cu``) against their plain versions at 1024^2 and 1000^2,
   over one pass, two passes and a K1 remainder, and for K11 three and four
   passes; time per step of each kernel, its plain version and K2 at
   2048^2 and 4096^2;
7. each band kernel against K1 over 1000 steps at 2048^2 (bitwise equal or
   not, and the max difference), and two runs of each bitwise equal;
8. the band path through ``cli.main``: the four official decks with
   ``--backend auto`` (K4 on 128^2, 128x256 and 256^2, K6 on 1024^2),
   the 256^2 and 1024^2 decks with
   ``band``, ``band2`` and ``band3`` through the 1% gate, and the 1000^2 x
   1001 (ragged tiles, a K1 remainder), 2048^2 x 2048 and 4096^2 x 1024
   "walls" decks (rows 0 and ny-1 blocked) with
   ``aa``, each band backend and ``auto`` (on 4096^2 ``aa`` and ``auto``
   only); each of the latter is held
   against the ``aa`` run through ``utils/checker.check_files`` at 1% and
   directly (av series at rtol 1e-4, final_state identical bytes or within
   the kernel tolerances). The counters, zeroed just before, must account
   for every step: the band steps in their kernels, the remainders in K1;
9. the resident, temporal and deep kernels K4 (``csrc/resident.cu``), K5
   (``csrc/temporal.cu``) and K6 (``csrc/deep.cu``) against their plain
   versions at 1024^2 and 1000^2, over T and 2T+3 steps (K4: 254, 255, 256
   and 511, around its 255-step launches); time per step of each kernel,
   its plain version and K11 at 128^2, 1024^2, 2048^2 and 4096^2;
10. each of them against K1 over 1000 steps at 2048^2 (bitwise equal or not,
   and the max difference), and two runs of each bitwise equal;
11. their path through ``cli.main``: the 256^2 and 1024^2 decks with
   ``resident``, ``temporal`` and ``deep`` through the 1% gate, the 2048^2 x
   2048 walls deck with each held against phase 8's ``aa`` run, and a 256^2 run
   resumed with ``--resume --checkpoint-every`` from a step-30,001
   checkpoint, whose files must be the bytes of the uninterrupted resident
   run. The counters, zeroed just before, must account for every step.
12. the shard kernels, every shard on ``cuda:0``: K3 (``csrc/shard_step.cu``)
   on a 1-D mesh of 4 and on 2x2, K12 (same source) on 4, K8
   (``csrc/band.cu``) and K10 (``csrc/band2.cu``) on 4, against their plain
   versions at 1024^2 and 1000^2 (K3 and K12 over 50 steps, K8 and K10 over
   T and 2T+3); time per step of each at 2048^2 and 4096^2 beside the
   single-device kernel of its family (K1, K7, K9), the plain version's at
   2048^2;
13. each of them against K1 over 1000 steps on the 2048^2 walls mask: the
   joined final state bitwise equal to K1's single-device run, and two runs
   of each bitwise equal;
14. the sharded path through ``cli.main``: the 1024^2 deck with ``--mesh 4
   --device 0`` under ``auto``, ``pallas``, ``pallas-overlap``, ``band`` and
   ``band2``, and ``--mesh 2x2 --device 0`` under ``auto``, each through the
   1% gate; a 256^2 ``--mesh 4`` run resumed from a step-30,001 checkpoint
   with ``--checkpoint-every``, whose files must be the bytes of the
   uninterrupted run. The counters, zeroed just before, must account for
   every step;
15. the c16 forms (int16 companded storage, ``ops/devspace.py``) of K1, K2,
   K11 and K7 against their plain versions at 1024^2 and 1000^2 (K2 both
   exit parities; K11 and K7 one pass, two passes and a K1 remainder, K11
   three and four passes), two K2 c16 runs bitwise equal; time per step of
   each beside its f32 form (K1, K2 at 1024^2, K11 at 2048^2 and 4096^2);
16. the slab kernel K13 (``csrc/band.cu``, slab mode) at f32 and c16
   against its plain version at 1024^2 and 1024 x 1000 over one generation,
   two and a remainder (K7 passes and K1); at f32 against K1 over 1000
   steps on the 2048^2 walls mask (bitwise), two runs of each form bitwise
   equal; the (K, S) sweep, K in {1, 2, 4} and S in {128, 256, 512, 1024}
   (and 2048 at 4096^2), per step at 2048^2 and 4096^2 on the walls mask
   beside K7 and K11 in the same loop, and the default (K, S) at c16;
17. the c16 and slab path through ``cli.main``: the 256^2 and 1024^2 decks
   with ``--precision c16`` under ``auto`` (K1), ``aa`` (K2) and ``pallas``
   (K1) through the 1% gate, and under ``band3`` (K11); the 1024^2 deck
   with ``band`` (K7) at c16 and, with ``LBM_ENABLE_SLAB=1``, ``slab``
   (K13) at f32 through the 1% gate and at c16. The band kernels round
   their codes once per pass, so their c16 runs print the 1% verdict and
   are held at ``PASS_GATE_C16`` (5%); ``slab`` at f32 on phase 8's 2048^2
   walls deck held against its ``aa`` run; a 256^2 ``aa`` c16 run resumed from a step-30,001
   checkpoint, whose files must be the bytes of the uninterrupted c16 run. The counters, f32
   and c16 apart, zeroed just before, must account for every step;
18. the c16 forms of K9, K5, K6 (``csrc/band2.cu``,
   ``temporal.cu``, ``deep.cu``) at 1024^2 and on the ragged 1000^2 walls
   mask, and K3, K8, K10 with 4 row shards on ``cuda:0``, against their
   plain versions over T and 2T+3 steps (K3 50); time per step of each
   beside its f32 form in the same loop at 2048^2; two runs of K9 c16 and
   of K3 c16 bitwise equal;
19. the c16 path through ``cli.main``: ``--precision c16`` with ``band2``,
   ``temporal`` and ``deep`` on the 256^2 and 1024^2 decks, ``--mesh 4
   --device 0`` on 1024^2 under ``auto``, ``pallas`` (K3), ``band`` (K8)
   and ``band2`` (K10) and on 256^2 under ``auto``, a 256^2 ``--mesh 4`` c16
   run resumed from a step-30,001 checkpoint (the uninterrupted bytes),
   and ``--mesh 2x2 --device 0`` (its plain-torch c16 step) on a 128^2 box
   cut to ``MESH_2D_ITERS`` steps, held against the one-device K1 c16 run of
   that deck through the checker at 1%. K3 and the 2-D step round every
   step and are held at 1%; the pass routes print the 1% verdict and are
   held at ``PASS_GATE_C16``. The c16 counters, zeroed just before, must
   account for every step;
20. the gate per T: K9 and K11 at c16 with T 4, 8 and 16 on the 256^2 and
   1024^2 decks, called with explicit schedules (T 16 with 32-row tiles and
   the widest panel that fits shared memory), through the checker against
   ``tests/golden/``: a measurement, printed, held only to finite output;
21. the bf16 forms (bfloat16 storage, ``ops/devspace.py::BF16``) of K1, K2,
   K7, K9, K11, K5, K6, K13 and, with 4 row shards on ``cuda:0``, K3, K8,
   K10 against their plain versions at 1024^2 and on the ragged 1000^2
   walls mask (K13: 1000 columns by 1024 rows), over a pass (or 5 steps)
   and 2T+3 steps (K1 and K2 200, K2 201 too, K3 50); two runs of K1 bf16
   and of K2 bf16 bitwise equal; time per step of each beside its f32 and
   c16 forms in the same loop (K1, K2 at 1024^2 and 2048^2, the others at
   2048^2), the plain version's too;
22. the bf16 path through ``cli.main --precision bf16``: ``auto``, ``aa``,
   ``pallas`` and ``band3`` on the 256^2 and 1024^2 decks, ``band``,
   ``band2``, ``temporal``, ``deep`` and (``LBM_ENABLE_SLAB=1``) ``slab``
   on 1024^2, ``--mesh 4 --device 0`` on 1024^2 under ``auto`` (K3),
   ``band`` (K8), ``band2`` (K10) and ``pallas-overlap`` (the f32 K12
   between one cast in and one out), ``--mesh 2x2 --device 0`` (its
   plain-torch bf16 step) on a 128^2 box cut to ``MESH_2D_ITERS``, and a
   256^2 ``auto`` run resumed from a step-30,001 checkpoint, whose files
   must be the bytes of the uninterrupted run. bf16 cannot pass the 1%
   gate (the JAX CLI says so): each deck prints the checker's verdict
   against ``tests/golden/`` and is held to finite output and to the bf16
   counters, zeroed just before, which must account for every step (and
   no f32 or c16 counter but K12's may move);
23. K4's shared-memory form (``csrc/resident.cu``): the barrier floor (us
   per ``grid.sync()`` of an empty cooperative loop at the global-memory
   form's grid and at one block per SM); the form against the plain
   version at 128^2, 128x256, 256^2, 384^2 and a ragged 130x250 grid over
   254, 255, 256 and 511 steps, each launch counted in its own counter,
   and two 511-step runs bitwise equal; against
   ``run_resident_slabs_plain`` (its schedule block by block) over 9 steps
   on 128^2 and 130x250; its time per step beside the global-memory form
   and K2 in turns at the first four sizes, and a sweep of its rows per
   block and T at 128^2 and 256^2;
24. K11 (``csrc/band3.cu``) at f32, c16 and bf16 against its plain
   version over a pass and 2T+3 steps at 1024^2, on the 1000^2 walls mask
   and on a ragged 998 x 1000 grid, two runs of each bitwise equal; its
   time per step beside K2 in turns at 1024^2, 2048^2 and 4096^2 for each
   storage (the K11/K2 ratio);
25. the ``auto`` crossover: K4 (the form ``run_resident`` picks), K6, K7,
   K9 and K11, each at the driver's schedule, in turns at the 128x256
   deck's shape and the squares 256^2, 384^2, 448^2, 512^2, 640^2, 768^2
   and 1024^2, with the route ``auto`` takes at each;
26. K3's 16-bit forms (four cells per thread, 64-bit words) and K9 in one
   window (``csrc/band2.cu``): the floor of a thread-block cluster barrier
   (us per ``cluster.sync()`` of 2 x SMs blocks of 512 threads, clusters of
   1, 2, 4 and 8); K3 at c16 and bf16 over 50 steps on 1024^2 and 1000^2
   with 4 row shards, 1001 x 1024 (an odd shard width) with 4 and 1024^2 on
   a 2 x 1 mesh, its state bitwise K1's of the same storage, av within 1e-6
   of K1's, two runs bitwise equal, and against its plain version on the
   ragged grids; K9 at f32, c16 and bf16 against its plain version at T 4,
   8 and 16, full row and panel, on ragged grids, two runs bitwise equal,
   and at f32 on the driver's schedule against K1 over 200 steps at 1024^2;
   K3 (f32 too) timed beside K1 of the same storage and K9 beside K11 and
   K2 of the same storage, in turns, at 1024^2, 2048^2 and 4096^2; K9's schedule
   sweep at 2048^2, and at 256^2-1024^2 for the smaller tiles;
27. K5 and K6 in one window, AA steps on the trapezoid (``csrc/temporal.cu``,
   ``deep.cu``, ``trapezoid.cuh``): at f32, c16 and bf16 against their
   plain versions at T 3, 4 and 8 over 2T+3 steps, on ragged tiles (the
   last row block as short as T), a full row, a single tile that wraps
   onto itself and every schedule of the driver's tiers, two runs bitwise
   equal; one K5 pass from packs that differ from the state's rows (at 16
   bits the packs the bits of the state rows they copy); at f32 on the
   driver's schedules against K1 over 200 steps at 1024^2; both timed
   beside K9 and K11 of the same storage, in turns, at 1024^2, 2048^2 and
   4096^2; their schedule sweep at 256^2-4096^2, in a process whose
   kernels are built with every candidate's window at constant strides;
   and the c16 decks of phase 19 with ``temporal`` and ``deep`` (the gate
   values);
28. K7 and K8 in one window at any T (``csrc/band.cu`` on
   ``band_common.cuh``'s one-window pass): at f32, c16 and bf16 against
   their plain versions over 2T+3 steps at T 1, 3, 4, 5 and 8, full row and
   panel, ragged grids, a block shorter than 2T, K8 on 4 row shards, two
   runs bitwise equal; at f32 with T 3, 4 and 5 against K1 (K7 over 200
   steps at 1024^2, K8 on 4 shards of it over 60); K7 beside K9 at
   1024^2-4096^2, K13 beside them at 2048^2 and 4096^2, K8 beside K10 on 4
   shards at 1024^2-4096^2, each storage, in turns; K7's schedule sweep
   (T 3, 4, 5, 8) at 1024^2-4096^2; the loop MLUPS of ``band`` and
   ``auto`` on the official decks and the 2048^2 and 4096^2 walls decks
   (``run_simulation``, no files);
29. K1's 16-bit forms and K2's c16 and bf16 forms in aligned words of four
   cells (``csrc/step.cu::step_word_kernel``, ``csrc/aa.cu::
   aa_word_kernel``): the c16 codec against its form with conversion
   instructions over every input (``csrc/codec_check.cu``); each form by
   the shape rule on 1024^2, 1000 x 1001 (word forms) and 130 x 97 (the
   one-cell form) against its plain version, two runs bitwise equal, the
   word forms' state bitwise the one-cell forms' over 200 steps at 1024^2
   and over three chained calls; registers and blocks per SM of every form;
   the word and one-cell forms in turns at 1024^2-4096^2; the c16 gate of
   ``auto`` (K1) and ``aa`` (K2) on the 256^2 and 1024^2 decks, and their
   loop MLUPS on 1024^2 (``run_simulation``, no files) with the word
   forms' launch counters;
30. the row mesh across processes (``parallel/multihost.py``): K3 with its
   ring filled from received rows (``shard_step.RowShard``) on 2 shards of
   1024^2 on the card, their rows handed over by hand, against the plain
   shard step (50 steps), bitwise K3 with the peer fill, timed beside it
   in turns; K12 across 2 processes on the card (``shard_step.IpcRowShard``,
   each process mapping its neighbour's shard with CUDA IPC; spawned as
   ``tests/torch_multihost_worker.py ipc``) on the 1024^2 deck's two
   shards: over 50 steps bitwise the one-process K12 and against the plain
   shard step, then timed over 2,000 steps; then 2 ranks of ``python -m
   lbm_tpu_torch --multihost`` (``torch.distributed`` over gloo, both on
   ``--device 0``) on the 1024^2 deck cut to 200 steps with ``auto`` (K3)
   and ``band`` (K8 and a K3 remainder), and cut to 2,000 steps with
   ``pallas-overlap`` (K12, the ``ipc`` channel; and at bf16, the f32 K12
   between two casts, on 200): rank 0's files must be
   the bytes of the one-process ``--mesh 2 --device 0`` run, its stats the
   same route and Reynolds number, every rank's result digest equal, and
   the ranks' launch counters must account for every step; each layout's
   loop us/step printed, K12 over ipc beside gloo's ``auto`` and the
   one-process K12. With two cards or more, the same with one card per rank
   (rows over NCCL, K12 over ipc between the cards) against ``--mesh 2`` on
   those cards; with one, a line says it was not run;
31. diagnostics, profile and viz on the card: ``--debug --check-nan`` on
   the 128^2 deck cut to 50 steps at f32 (K4) and c16 (K1), 50 reports,
   each ``tot density`` within 1e-5 of ``total_density`` of the plain run
   (the route's plain version on the CPU); ``--check-nan`` on a run resumed
   from a state seeded with a NaN exits 1; ``--profile-dir`` on the 1024^2
   deck cut to 2,000 steps under ``auto``: the trace must parse and name
   K6's kernel, and the device's busy and idle shares of the loop's
   window are printed; ``python -m lbm_tpu_torch.utils.viz`` renders the
   128^2 run's ``final_state.dat`` (a PPM of 128 x 128 pixels where
   matplotlib is missing);
32. K11 on the trapezoid (its load fused into its first step, its store
   into its last) at f32, c16 and bf16 against its plain version, two runs
   bitwise equal, at T 4, 8 and 16, full row and panel, and at the
   driver's schedule on a ragged 998 x 1000 grid and the 1000^2 walls
   mask; K4's global-memory form (one copy stepped in place) against its
   plain version at 512^2-1024^2 and 1000 x 998 over 254-511 steps,
   bitwise K1 over 200 steps, bitwise repeatable and resumed to the whole
   run's bits; both timed in turns beside their rivals (K9 and K2; K2 and
   K6). With ``--phase 32`` alone, also: K4 with and without its
   persisting-L2 window at 768^2-1280^2 and the L2's rate; K11's schedule
   sweep in a process whose kernels are built with every candidate's
   window at constant strides; the loop MLUPS of ``band3``, ``deep`` and
   ``auto`` on the 1024^2 deck and the walls 2048^2 and 4096^2 decks; and
   phase 25's crossover.

33. (``--phase 33`` only) K5 and K6 by rounds of blocks: in a process
   whose kernels are built with every candidate's window at constant
   strides, K6's registers and blocks per SM and both kernels in turns at
   1024^2 and 2048^2 on the tier's (36, 4, 56) and the cuts of K56_WAVES;
   each cut against (36, 4, 56) over 2 passes at 1024^2, the state
   bitwise and the av within 1e-6; both kernels' us per pass on grids of
   whole tiles making 1-8 rounds and at 1008^2-2048^2.
   ``--phase 33 --import-from DIR`` times the passes of the package under
   DIR alone (run it and this tree in turns, in processes of their own).

``python3 chip_smoke.py --phase 25`` (or 26-33) runs phases 1, 2 and
that phase only (no kernel report), and ``--phase 26 --import-from DIR``
only phase 26's K9 checks and its timing in turns, of the
``lbm_tpu_torch`` package under DIR (another checkout, such as the parent
commit unpacked into a git-ignored directory, or a trial patched onto one),
so that a redesign and the body it replaces are held to the same rivals;
``--phase 27 --import-from DIR`` likewise phase 27's K5 and K6 checks,
their timing beside K9 and K11 and their c16 gate decks, and ``--phase 28
--import-from DIR`` phase 28's K7 and K8 checks and their timing beside
K9, K10 and K13, and ``--phase 29 --import-from DIR`` phase 29's checks,
timings and loop MLUPS of that package, its c16 gate values printed but
not held (so that a diagnostic trial such as ``trials/k2_noforce.patch``
can be timed), and ``--phase 32 --import-from DIR`` phase 32's K11 and K4
checks and their timings beside K9, K2 and K6.

Tolerances: kernel against plain version, cells within 1e-5 of the
state's scale and av series at rtol 1e-4 (f32 with FMA contraction in the
kernels and another summation order); at c16 the decoded cells within
5e-6 and the av series at rtol 1e-3 (FMA contraction can move a code by
one quantum at a rounding tie, and a moved code feeds the next steps);
at bf16, counted on the bit patterns, ``TOL_BF16`` over a pass and
``TOL_BF16_SPREAD`` over longer runs (below); golden gate 1% (the
reference's checker; the pass routes at c16: ``PASS_GATE_C16``; bf16: no
limit). Any failure exits non-zero
before the last line. The last two lines are the kernel report and
``{"ok": true, "device": {...}}``. In the report ``ms``/``plain_ms`` are
per step (K1, K2 and K4's global-memory form at 1024^2, K4's
shared-memory form at 256^2, the c16 and bf16 forms of K1 and K2 too, the
others at 2048^2, the shard kernels with 4 shards); ``bound_ms``
is the least time of that step on an H100 at this run's shape: the larger
of its bytes over 3.35 TB/s and its f32 operations
(``FLOPS_PER_CELL_STEP``) over 67 TFLOP/s. The bytes: 76 B per cell (9
f32 planes read and written and the f32 mask, each once) or 40 B at c16
and bf16 (9 int16 or bfloat16 planes), per launch of a one-step kernel
and per pass of a T-step one; for K13 those bytes times (S + 2KT) / S per
generation of K*T steps, the HBM traffic when a slab's inner passes stay
in L2.
``library_ms`` is null, as no single PyTorch call computes these steps.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_CELLS = 1e-5
TOL_AV = 1e-4
TOL_C16_CELLS = 5e-6  # absolute, on decoded cells
TOL_C16_AV = 1e-3
# The checker's limit (percent) for the band kernels at c16, which round
# once per pass (phases 17 and 19); the 1% verdict is printed beside it.
PASS_GATE_C16 = 5.0
# Steps of phase 19's 2-D mesh c16 deck: its step is plain PyTorch, one
# launch per operation.
MESH_2D_ITERS = 1000
DENSITY, ACCEL, OMEGA = 0.1, 0.005, 1.85
# An H100 SXM's peaks (NVIDIA's data sheet): HBM3 bytes/s and f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
BYTES_PER_CELL = 76  # 9 f32 planes read, 9 written, the f32 mask read
BYTES_PER_CELL_C16 = 40  # 9 int16 planes read, 9 written, the f32 mask read
# f32 operations of one cell-step of collide_fused (lbm_common.cuh: 9-value
# moments, the four paired relaxations, the select) with the forcing test
# and the |u| sum: counted from the source, about 70.
FLOPS_PER_CELL_STEP = 70

# (nx, ny, maxIters, reynolds_dim, density, accel, omega) and geometry of the
# four official decks (examples/generate_inputs.py, which imports the JAX
# package and so cannot be used here).
DECKS = {
    "128x128": ((128, 128, 40000, 10, 0.1, 0.005, 1.85), "box", {}),
    "128x256": ((128, 256, 40000, 10, 0.1, 0.005, 1.85), "channel_with_divider", {}),
    "256x256": ((256, 256, 80000, 10, 0.1, 0.005, 1.85), "box", {}),
    "1024x1024": ((1024, 1024, 20000, 10, 0.1, 0.01, 1.85), "box_with_vertical_wall",
                  {"wall_col": 341}),
}


T_START = time.time()


def log(*args):
    print(*args, flush=True)


def phase(title):
    log(f"== {title} (at {time.time() - T_START:.1f} s)")


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0 and proc.stdout.strip(), f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def random_setup(torch, nx, ny, seed):
    import numpy as np

    from lbm_tpu_torch.models.d2q9 import WEIGHTS
    from lbm_tpu_torch.utils.geometry import box

    rng = np.random.RandomState(seed)
    mask = box(nx, ny)
    mask[rng.randint(1, ny - 1, ny // 4), rng.randint(1, nx - 1, ny // 4)] = 1
    state = ((WEIGHTS * DENSITY)[:, None, None] * (1 + 0.05 * rng.rand(9, ny, nx)))
    dev = torch.device("cuda", 0)
    cells = torch.as_tensor(state.astype(np.float32)).to(dev)
    nobst = torch.as_tensor((mask == 0).astype(np.float32)).to(dev)
    return cells, nobst


def timed(torch, fn):
    """(result, ms) of one call, timed with CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare(torch, name, got, want, spec=None):
    """Kernel against plain version; ``spec``: c16 codes, compared decoded."""
    (gc, ga), (wc, wa) = got, want
    torch.cuda.synchronize()
    if spec is not None:
        from lbm_tpu_torch.ops.devspace import decode_state

        check(gc.dtype == torch.int16, f"{name}: c16 output is {gc.dtype}")
        gc, wc = decode_state(gc, spec), decode_state(wc, spec)
    check(bool(torch.isfinite(gc).all()) and bool(torch.isfinite(ga).all()),
          f"{name}: non-finite output")
    err = float((gc - wc).abs().max())
    scale = float(wc.abs().max())
    lim_cells = TOL_CELLS * scale if spec is None else TOL_C16_CELLS
    lim_av = TOL_AV if spec is None else TOL_C16_AV
    av_rel = float(((ga.double() - wa.double()).abs() / wa.double().abs()).max())
    log(f"  {name}: max|cells diff| {err:.3e} (limit {lim_cells:.3e}), "
        f"max av rel diff {av_rel:.3e} (limit {lim_av})")
    check(err <= lim_cells, f"{name}: cells differ by {err}")
    check(av_rel <= lim_av, f"{name}: av series differs by {av_rel}")
    return err


def kernel_phase(torch, label, kernel, plain, parity_steps):
    """Kernel against its plain version; returns (max_abs_err, ms, plain_ms)
    per step at 1024^2."""
    errs = []
    for (nx, ny) in ((1024, 1024), (1000, 1000)):
        cells, nobst = random_setup(torch, nx, ny, seed=nx)
        for n in parity_steps:
            got = kernel(cells, nobst, DENSITY, ACCEL, OMEGA, n, 1.0)
            want = plain(cells, nobst, DENSITY, ACCEL, OMEGA, n, 1.0)
            errs.append(compare(torch, f"{label} {nx}x{ny} {n} steps", got, want))
    per_step = {}
    for (nx, n_kernel, n_plain) in ((1024, 1000, 100), (128, 2000, 200)):
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        kernel(cells, nobst, DENSITY, ACCEL, OMEGA, 10, 1.0)  # warm up
        plain(cells, nobst, DENSITY, ACCEL, OMEGA, 5, 1.0)
        _, k_ms = timed(torch, lambda: kernel(cells, nobst, DENSITY, ACCEL, OMEGA, n_kernel, 1.0))
        _, p_ms = timed(torch, lambda: plain(cells, nobst, DENSITY, ACCEL, OMEGA, n_plain, 1.0))
        per_step[nx] = (k_ms / n_kernel, p_ms / n_plain)
        log(f"  {label} {nx}x{nx}: kernel {1e3 * k_ms / n_kernel:.2f} us/step "
            f"({nx * nx * n_kernel / k_ms / 1e3:.1f} MLUPS), plain "
            f"{1e3 * p_ms / n_plain:.2f} us/step")
    return max(errs), per_step[1024][0], per_step[1024][1]


def bound(cells, depth=1, bytes_per_cell=BYTES_PER_CELL):
    """``(bound_ms, bound_by)`` of one step over ``cells`` cells on an H100:
    a one-step kernel (depth 1) moves ``bytes_per_cell`` (76 at f32, 40 at
    c16), a T-step pass that many per cell per T steps."""
    bytes_ms = 1e3 * cells * bytes_per_cell / depth / HBM_BYTES_S
    ops_ms = 1e3 * cells * FLOPS_PER_CELL_STEP / F32_FLOPS
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def write_gold(npz_path, out_dir):
    """The committed f64 gold (tests/golden/*.npz) in the reference's file
    formats, the way tests/test_golden.py materialises it: av_vels as
    written by the solver, final_state with the pressure column only (the
    checker reads columns 0, 1 and 5)."""
    import numpy as np

    from lbm_tpu_torch.io import write_av_vels

    data = np.load(npz_path)
    av_path = os.path.join(out_dir, "gold_av_vels.dat")
    fs_path = os.path.join(out_dir, "gold_final_state.dat")
    write_av_vels(av_path, data["av_vels"])
    pressure = data["pressure"]
    ny, nx = pressure.shape
    with open(fs_path, "w") as f:
        f.write("".join("%d %d 0 0 0 %.12E 0\n" % (jj, ii, pressure[ii, jj])
                        for ii in range(ny) for jj in range(nx)))
    return av_path, fs_path


def run_deck(cli, tag, backend, work, gpu_line, mesh=None, precision="f32", gate=1.0):
    """One official deck through ``cli.main``; ``mesh`` adds ``--mesh mesh
    --device 0``, ``precision`` ``--precision`` (f32 adds nothing). Where
    there is a gold, the run must pass the checker at ``gate`` percent (the
    reference's 1% unless stated; None: held to nothing, as bf16, which the
    gate cannot hold); the 1% verdict is printed either way."""
    import numpy as np

    from lbm_tpu_torch.utils import geometry
    from lbm_tpu_torch.utils.checker import check_files

    fields, geo, kw = DECKS[tag]
    extra = [] if mesh is None else ["--mesh", mesh, "--device", "0"]
    if precision != "f32":
        extra += ["--precision", precision]
    deck_dir = os.path.join(work, f"{tag}-{backend}" + ("" if mesh is None else f"-mesh{mesh}")
                            + ("" if precision == "f32" else f"-{precision}"))
    os.makedirs(deck_dir)
    params_path = os.path.join(deck_dir, f"input_{tag}.params")
    obst_path = os.path.join(deck_dir, f"obstacles_{tag}.dat")
    geometry.write_params_file(params_path, *fields)
    geometry.write_obstacle_file(obst_path, getattr(geometry, geo)(fields[0], fields[1], **kw))
    stats_path = os.path.join(deck_dir, "stats.json")
    rc = cli.main([params_path, obst_path, "--backend", backend, "--out-dir", deck_dir,
                   "--stats-json", stats_path, *extra])
    backend = " ".join([backend, *extra])
    check(rc == 0, f"{tag} --backend {backend}: cli.main returned {rc}")
    with open(stats_path) as f:
        stats = json.load(f)
    check(stats["torch_device"].startswith("cuda"), f"{tag}: ran on {stats['torch_device']}")
    av = np.loadtxt(os.path.join(deck_dir, "av_vels.dat"), usecols=[1])
    check(av.shape == (fields[2],) and np.isfinite(av).all(), f"{tag}: bad av_vels")
    line = (f"  {tag} --backend {backend}: route {stats['route']} on {stats['torch_device']}, "
            f"loop {stats['loop_s']:.4f} s, {stats['mlups']:.1f} MLUPS, "
            f"Reynolds {stats['reynolds']:.12E} [{gpu_line}]")
    gold = os.path.join(ROOT, "tests", "golden", f"{tag}.golden.npz")
    if os.path.exists(gold):
        gav, gfs = write_gold(gold, deck_dir)
        res = check_files(os.path.join(deck_dir, "av_vels.dat"),
                          os.path.join(deck_dir, "final_state.dat"), gav, gfs,
                          tolerance=1.0 if gate is None else gate)
        at_1 = max(abs(res.av_vels.max_diff_pcnt), abs(res.final_state.max_diff_pcnt)) <= 1.0
        held = ("" if gate == 1.0 else " (held to no limit)" if gate is None
                else f" (held at {gate}%: {'PASS' if res.passed else 'FAIL'})")
        line += (f"\n    golden gate (1%): av_vels max diff {res.av_vels.max_diff_pcnt:.4g}% "
                 f"at step {res.av_vels.max_index}, pressure max diff "
                 f"{res.final_state.max_diff_pcnt:.4g}% at ({res.final_state.coord_x},"
                 f"{res.final_state.coord_y}): {'PASS' if at_1 else 'FAIL'}" + held)
        log(line)
        stats["gate"] = (res.av_vels.max_diff_pcnt, res.final_state.max_diff_pcnt)
        check(gate is None or res.passed,
              f"{tag} --backend {backend} fails the golden gate at {gate}%")
    else:
        log(line)
    return stats


# The band kernels: route -> (name in the report, source, the TPU kernel it
# replaces).
BANDS = {
    "band": ("K7 band (one window, AA steps, any T)", "lbm_tpu_torch/csrc/band.cu",
             "lbm_tpu/ops/pallas_band.py:172"),
    "band2": ("K9 band2 (one window, AA steps)", "lbm_tpu_torch/csrc/band2.cu",
              "lbm_tpu/ops/pallas_band2.py:90"),
    "band3": ("K11 band3 (one in-place AA window)", "lbm_tpu_torch/csrc/band3.cu",
              "lbm_tpu/ops/pallas_band3.py:306"),
}
# The route auto takes at f32 above K4's states (runtime/driver.py:
# select_route), and on each official deck.
AUTO_ABOVE = "deep"
AUTO_ROUTES = {"128x128": "resident", "128x256": "resident", "256x256": "resident",
               "1024x1024": AUTO_ABOVE}
# (n, iters) of the n x n "walls" decks: a ragged grid whose iterations
# leave a K1 remainder, then the JAX package's HBM-regime rows.
WALLS_DECKS = ((1000, 1001), (2048, 2048), (4096, 1024))


def band_routes():
    """route -> (label, kernel, plain, (block, depth, panel)) with the
    driver's schedules."""
    import torch

    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band, band2, band3
    from lbm_tpu_torch.runtime.driver import pass_schedule

    params = LBMParams(nx=1024, ny=1024, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    plains = {"band": band.run_band_plain, "band2": band2.run_band2_plain,
              "band3": band3.run_band3_plain}
    out = {}
    for route in BANDS:
        run, cfg = pass_schedule(route, params, torch.float32)
        out[route] = (BANDS[route][0].split()[0], run, plains[route], cfg)
    return out


def pass_depth(route, ny, nx, dtype="f32"):
    """T of the driver's schedule for ``route`` (a pass route) on an ny x nx grid."""
    import torch

    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.runtime.driver import pass_schedule

    params = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    return pass_schedule(route, params, torch.float32 if dtype == "f32" else dtype)[1][1]


def band_phase(torch, label, kernel, plain, cfg, step_counts, aa_us):
    """Band kernel against its plain version at 1024^2 and 1000^2; returns
    (max_abs_err, {n: (kernel ms, plain ms)} per step at 2048^2 and 4096^2)."""
    block, depth, panel = cfg

    def run(fn, cells, nobst, n):
        return fn(cells, nobst, DENSITY, ACCEL, OMEGA, n, block, depth, panel=panel)

    errs = []
    for (nx, ny) in ((1024, 1024), (1000, 1000)):
        cells, nobst = random_setup(torch, nx, ny, seed=nx + depth)
        for n in step_counts:
            errs.append(compare(torch, f"{label} {nx}x{ny} {n} steps",
                                run(kernel, cells, nobst, n), run(plain, cells, nobst, n)))
    per_step = {}
    for nx, n_kernel in ((2048, 800), (4096, 200)):
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        n_plain = 2 * depth
        run(kernel, cells, nobst, 2 * depth)  # warm up, the allocator included
        run(plain, cells, nobst, n_plain)
        _, k_ms = timed(torch, lambda: run(kernel, cells, nobst, n_kernel))
        _, p_ms = timed(torch, lambda: run(plain, cells, nobst, n_plain))
        per_step[nx] = (k_ms / n_kernel, p_ms / n_plain)
        log(f"  {label} {nx}x{nx} (block {block}, depth {depth}, panel {panel}): kernel "
            f"{1e3 * k_ms / n_kernel:.2f} us/step ({nx * nx * n_kernel / k_ms / 1e3:.1f} MLUPS), "
            f"plain {1e3 * p_ms / n_plain:.2f} us/step, K2 {aa_us[nx]:.2f} us/step")
    return max(errs), per_step


def write_walls_deck(work, n, iters):
    """The JAX package's HBM-regime rows (scripts/r5_headline_session.py):
    an n x n channel with rows 0 and ny-1 blocked."""
    import numpy as np

    from lbm_tpu_torch.utils import geometry

    deck = os.path.join(work, f"walls{n}")
    os.makedirs(deck)
    params_path = os.path.join(deck, "input.params")
    obst_path = os.path.join(deck, "obstacles.dat")
    geometry.write_params_file(params_path, n, n, iters, 10, DENSITY, ACCEL, OMEGA)
    mask = np.zeros((n, n), np.int32)
    mask[0, :] = mask[-1, :] = 1
    geometry.write_obstacle_file(obst_path, mask)
    return params_path, obst_path


def run_walls(cli, deck, backend, work, n, gpu_line):
    out = os.path.join(work, f"walls{n}-{backend}")
    os.makedirs(out)
    stats_path = os.path.join(out, "stats.json")
    rc = cli.main([*deck, "--backend", backend, "--out-dir", out, "--stats-json", stats_path])
    check(rc == 0, f"walls {n}^2 --backend {backend}: cli.main returned {rc}")
    with open(stats_path) as f:
        stats = json.load(f)
    check(stats["torch_device"].startswith("cuda"), f"walls {n}^2: ran on {stats['torch_device']}")
    log(f"  walls {n}x{n} x {stats['max_iters']} --backend {backend}: route {stats['route']}, "
        f"loop {stats['loop_s']:.4f} s, {stats['mlups']:.1f} MLUPS [{gpu_line}]")
    return out, stats


def hold_against(out, ref, what):
    """A run's files against the K2 run's: the 1% checker, then directly."""
    import numpy as np

    from lbm_tpu_torch.utils.checker import check_files

    files = [os.path.join(d, f) for d in (out, ref) for f in ("av_vels.dat", "final_state.dat")]
    res = check_files(*files, tolerance=1.0)
    av, av_ref = (np.loadtxt(f, usecols=[1]) for f in (files[0], files[2]))
    check(bool(np.isfinite(av).all()), f"{what}: non-finite av_vels")
    av_rel = float((np.abs(av - av_ref) / np.abs(av_ref)).max())
    same = filecmp.cmp(files[1], files[3], shallow=False)
    line = (f"    vs K2: checker av_vels {res.av_vels.max_diff_pcnt:.4g}%, pressure "
            f"{res.final_state.max_diff_pcnt:.4g}%: {'PASS' if res.passed else 'FAIL'}; "
            f"av max rel diff {av_rel:.3e} (limit {TOL_AV}); final_state "
            f"{'byte-identical' if same else 'differs'}")
    if not same:
        fs, fs_ref = (np.loadtxt(f, usecols=[2, 3, 4, 5]) for f in (files[1], files[3]))
        p_err = float(np.abs(fs[:, 3] - fs_ref[:, 3]).max())
        u_err = float(np.abs(fs[:, :3] - fs_ref[:, :3]).max())
        p_lim = TOL_CELLS * float(np.abs(fs_ref[:, 3]).max())
        u_lim = TOL_AV * float(np.abs(fs_ref[:, :3]).max())
        line += (f", pressure max diff {p_err:.3e} (limit {p_lim:.3e}), velocity "
                 f"{u_err:.3e} (limit {u_lim:.3e})")
        check(p_err <= p_lim and u_err <= u_lim, f"{what}: final state differs from K2's")
    log(line)
    check(res.passed, f"{what} fails the 1% checker against K2")
    check(av_rel <= TOL_AV, f"{what}: av series differs from K2's by {av_rel}")


def build_native_io():
    """``make -C native``: the C++ writers of io/native.py (byte-identical
    to the Python ones, which stay the fallback)."""
    t0 = time.time()
    proc = subprocess.run(["make", "-C", os.path.join(ROOT, "native")], capture_output=True,
                          text=True, timeout=300)
    from lbm_tpu_torch.io import native

    native._lib.cache_clear()
    ok = proc.returncode == 0 and native.available()
    log(f"  native IO library: {'built' if ok else 'NOT built (Python writers)'} in "
        f"{time.time() - t0:.1f} s{'' if ok else ': ' + proc.stderr.strip()[-300:]}")


# The resident, temporal and deep kernels: route -> (name in the report,
# source, the TPU kernel it replaces).
SCHEDULED = {
    "resident": ("K4 resident (persistent cooperative grid)", "lbm_tpu_torch/csrc/resident.cu",
                 "lbm_tpu/ops/pallas_resident.py:66"),
    "temporal": ("K5 temporal (one window, AA steps on the trapezoid, carried row packs)",
                 "lbm_tpu_torch/csrc/temporal.cu", "lbm_tpu/ops/pallas_temporal.py:76"),
    "deep": ("K6 deep (one window, AA steps on the trapezoid, halos from the state)",
             "lbm_tpu_torch/csrc/deep.cu", "lbm_tpu/ops/pallas_deep.py:68"),
}


def scheduled_routes():
    """route -> (label, kernel, plain, depth) with the driver's schedules;
    kernel and plain take (cells, nobst, n_steps). K4's "depth" is 1: it
    has no remainder."""
    import torch

    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import deep, resident, temporal
    from lbm_tpu_torch.runtime.driver import pass_schedule

    def res(fn):
        return lambda c, o, n: fn(c, o, DENSITY, ACCEL, OMEGA, n, 1.0, chunk=resident.CHUNK_STEPS)

    out = {"resident": ("K4", res(resident.run_resident), res(resident.run_resident_plain), 1)}
    # K5's and K6's schedules at 2048^2, where the report times them.
    params = LBMParams(nx=2048, ny=2048, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    for route, plain in (("temporal", temporal.run_temporal_plain), ("deep", deep.run_deep_plain)):
        run, (block, depth, panel) = pass_schedule(route, params, torch.float32)

        def bind(fn, block=block, depth=depth, panel=panel):
            return lambda c, o, n: fn(c, o, DENSITY, ACCEL, OMEGA, n, block, depth, panel=panel)

        out[route] = (SCHEDULED[route][0].split()[0], bind(run), bind(plain), depth)
    return out


def scheduled_phase(torch, label, kernel, plain, step_counts, depth, k11):
    """K4, K5 or K6 against its plain version at 1024^2 and 1000^2; returns
    (max_abs_err, {n: (kernel ms, plain ms)} per step at 128^2-4096^2)."""
    errs = []
    for (nx, ny) in ((1024, 1024), (1000, 1000)):
        cells, nobst = random_setup(torch, nx, ny, seed=nx + depth)
        for n in step_counts:
            errs.append(compare(torch, f"{label} {nx}x{ny} {n} steps",
                                kernel(cells, nobst, n), plain(cells, nobst, n)))
    per_step = {}
    for nx, n_kernel, n_plain in ((128, 2040, 6), (1024, 480, 6), (2048, 240, 2), (4096, 96, 2)):
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        n_plain *= depth  # whole passes: no K1 remainder in the plain time
        kernel(cells, nobst, n_plain)  # warm up, the allocator included
        k11(cells, nobst, 24)
        plain(cells, nobst, n_plain)
        _, k_ms = timed(torch, lambda: kernel(cells, nobst, n_kernel))
        _, b_ms = timed(torch, lambda: k11(cells, nobst, n_kernel))
        _, p_ms = timed(torch, lambda: plain(cells, nobst, n_plain))
        per_step[nx] = (k_ms / n_kernel, p_ms / n_plain)
        log(f"  {label} {nx}x{nx}: kernel {1e3 * k_ms / n_kernel:.2f} us/step "
            f"({nx * nx * n_kernel / k_ms / 1e3:.1f} MLUPS), plain {1e3 * p_ms / n_plain:.2f} "
            f"us/step, K11 {1e3 * b_ms / n_kernel:.2f} us/step")
    return max(errs), per_step


def resume_run(cli, work, gpu_line, backend="resident", mesh=None, precision="f32"):
    """The 256^2 deck from a checkpoint at step 30,001 of 80,000 (taken by
    run_simulation, or run_simulation_sharded on ``mesh`` shards of
    ``cuda:0``) through ``cli.main --resume --checkpoint-every 25000``: its
    files must be the bytes of the uninterrupted run of ``backend`` at
    ``precision`` in ``work`` (run_deck's directory). Returns the step
    counts of the runs made: the head run's, then each resumed chunk's."""
    import dataclasses

    import torch

    from lbm_tpu_torch.io import read_obstacles, read_params
    from lbm_tpu_torch.parallel.sharded import run_simulation_sharded
    from lbm_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
    from lbm_tpu_torch.runtime.driver import compute_chunk_sizes, run_simulation

    tail = ("" if mesh is None else f"-mesh{mesh}") + ("" if precision == "f32" else f"-{precision}")
    full = os.path.join(work, f"256x256-{backend}{tail}")
    params_path = os.path.join(full, "input_256x256.params")
    obst_path = os.path.join(full, "obstacles_256x256.dat")
    params = read_params(params_path)
    obstacles = read_obstacles(obst_path, params)
    start, every = params.max_iters * 3 // 8 + 1, params.max_iters * 5 // 16
    head = dataclasses.replace(params, max_iters=start)
    dtype = {"f32": torch.float32, "c16": "c16", "bf16": torch.bfloat16}[precision]
    if mesh is None:
        part = run_simulation(head, obstacles, device="cuda:0", backend=backend, dtype=dtype)
    else:
        part = run_simulation_sharded(head, obstacles, devices=["cuda:0"] * int(mesh),
                                      backend=backend, dtype=dtype)
    out = os.path.join(work, f"256x256-resumed{tail}")
    ckpt = os.path.join(out, "checkpoint.npz")
    save_checkpoint(ckpt, params, part.cells, part.av_vels, start)
    extra = [] if mesh is None else ["--mesh", mesh, "--device", "0"]
    if precision != "f32":
        extra += ["--precision", precision]
    rc = cli.main([params_path, obst_path, "--backend", backend, "--resume", "--checkpoint-every",
                   str(every), "--checkpoint-path", ckpt, "--out-dir", out, *extra])
    check(rc == 0, f"resumed 256^2 run: cli.main returned {rc}")
    same = [filecmp.cmp(os.path.join(out, f), os.path.join(full, f), shallow=False)
            for f in ("av_vels.dat", "final_state.dat")]
    step = load_checkpoint(ckpt, params)[2]
    log(f"  256x256 --backend {backend} {' '.join(extra)} resumed at step {start} with "
        f"--checkpoint-every {every}: av_vels.dat {'identical' if same[0] else 'DIFFERS'}, "
        f"final_state.dat {'identical' if same[1] else 'DIFFERS'} to the uninterrupted run; "
        f"last checkpoint at step {step} [{gpu_line}]")
    check(all(same), "the resumed 256^2 run's files differ from the uninterrupted run's")
    check(step == params.max_iters, f"the last checkpoint is at step {step}")
    return [start] + compute_chunk_sizes(start, params.max_iters, every)


# The shard kernels: name -> (name in the report, source, the TPU kernel it
# replaces).
SHARDED = {
    "K3": ("K3 shard step (ghost ring, refilled between steps)",
           "lbm_tpu_torch/csrc/shard_step.cu", "lbm_tpu/ops/pallas_step.py:164"),
    "K12": ("K12 shard step storing its edges into the neighbours' rings",
            "lbm_tpu_torch/csrc/shard_step.cu", "lbm_tpu/ops/pallas_remote.py:49"),
    "K8": ("K8 sharded band (one window, AA steps, any T)", "lbm_tpu_torch/csrc/band.cu",
           "lbm_tpu/ops/pallas_band.py:574"),
    "K10": ("K10 sharded band2 (one window, AA steps)", "lbm_tpu_torch/csrc/band2.cu",
            "lbm_tpu/ops/pallas_band2.py:584"),
}


def shard_routes():
    """name -> (kernel, plain, meshes, family, depth) with the driver's
    schedules: kernel and plain take (shards, nob_shards, n_steps, ny),
    family (the single-device kernel of the same family) (cells, nobst,
    n_steps)."""
    import torch

    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band, band2, shard_step, step

    params = LBMParams(nx=1024, ny=1024, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)

    def steps(fn):
        return lambda s, o, n, ny: fn(s, o, DENSITY, ACCEL, OMEGA, n, ny)

    def k1(c, o, n):
        return step.run_step(c, o, DENSITY, ACCEL, OMEGA, n, 1.0)

    out = {"K3": (steps(shard_step.run_shard_step), steps(shard_step.run_shard_step_plain),
                  ((4, 1), (2, 2)), k1, 1),
           "K12": (steps(shard_step.run_shard_overlap), steps(shard_step.run_shard_step_plain),
                   ((4, 1),), k1, 1)}
    for name, mod, run, cfg in (("K8", band, "run_band", band.schedule(params, torch.float32)),
                                ("K10", band2, "run_band2", band2.schedule(params, torch.float32))):
        block, depth, panel = cfg

        def bind(fn, block=block, depth=depth, panel=panel):
            return lambda s, o, n, ny: fn(s, o, DENSITY, ACCEL, OMEGA, n, block, depth, ny,
                                          panel=panel)

        def family(c, o, n, fn=getattr(mod, run), block=block, depth=depth, panel=panel):
            return fn(c, o, DENSITY, ACCEL, OMEGA, n, block, depth, panel=panel)

        out[name] = (bind(getattr(mod, run + "_sharded")),
                     bind(getattr(mod, run + "_sharded_plain")), ((4, 1),), family, depth)
    return out


def on_mesh(cells, nobst, py, px):
    """A state and mask cut into a py x px mesh of shards, all on cuda:0."""
    from lbm_tpu_torch.parallel.sharded import make_mesh_2d, split

    mesh = make_mesh_2d(py, px, ["cuda:0"] * (py * px))
    return split(cells, mesh), split(nobst, mesh)


def joined(torch, out):
    """(state, av) of a mesh run: the shards joined on the card, the raw
    per-shard sums added in shard order."""
    from lbm_tpu_torch.parallel.sharded import mesh_totals

    shards, sums = out
    return torch.cat([torch.cat(list(row), dim=2) for row in shards], dim=1), mesh_totals(sums, 1.0)


def shard_phase(torch, name, kernel, plain, meshes, family, depth):
    """A shard kernel against its plain version at 1024^2 and 1000^2; returns
    (max_abs_err, {(mesh, n): (kernel ms, plain ms or None, family ms)} per
    step at 2048^2 and 4096^2)."""
    errs = []
    counts = (50,) if depth == 1 else (depth, 2 * depth + 3)
    for (nx, ny) in ((1024, 1024), (1000, 1000)):
        cells, nobst = random_setup(torch, nx, ny, seed=nx + depth)
        for py, px in meshes:
            s, o = on_mesh(cells, nobst, py, px)
            for n in counts:
                errs.append(compare(torch, f"{name} {py}x{px} {nx}x{ny} {n} steps",
                                    joined(torch, kernel(s, o, n, ny)),
                                    joined(torch, plain(s, o, n, ny))))
    per_step = {}
    for nx, n_kernel in ((2048, 400), (4096, 100)):
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        family(cells, nobst, 2 * depth)  # warm up, the allocator included
        _, f_ms = timed(torch, lambda: family(cells, nobst, n_kernel))
        for py, px in meshes:
            s, o = on_mesh(cells, nobst, py, px)
            kernel(s, o, 2 * depth, nx)
            _, k_ms = timed(torch, lambda: kernel(s, o, n_kernel, nx))
            p_ms = None
            if nx == 2048:
                n_plain = 2 * depth
                plain(s, o, n_plain, nx)
                _, p_ms = timed(torch, lambda: plain(s, o, n_plain, nx))
                p_ms /= n_plain
            per_step[(py, px), nx] = (k_ms / n_kernel, p_ms, f_ms / n_kernel)
            log(f"  {name} {py}x{px} shards of {nx}x{nx}: kernel {1e3 * k_ms / n_kernel:.2f} "
                f"us/step ({nx * nx * n_kernel / k_ms / 1e3:.1f} MLUPS), "
                + (f"plain {1e3 * p_ms:.2f} us/step, " if p_ms else "")
                + f"single-device {1e3 * f_ms / n_kernel:.2f} us/step")
        del cells, nobst
    return max(errs), per_step


def mesh_phases(torch, cli, run_step, gpu_line):
    """Phases 12-14; returns (shard_routes(), {name: phase-12 result},
    {route: launches in phase 14})."""
    phase("12. shard kernels K3, K12, K8, K10 vs their plain versions (shards on cuda:0)")
    shard = shard_routes()
    shard_res = {}
    for name, (kernel, plain, meshes, family, depth) in shard.items():
        shard_res[name] = shard_phase(torch, name, kernel, plain, meshes, family, depth)

    phase("13. shard kernels vs K1 over 1000 steps on the 2048^2 walls mask, and repeatability")
    cells, nobst = random_setup(torch, 2048, 2048, seed=19)
    nobst.fill_(1.0)
    nobst[0].zero_()
    nobst[-1].zero_()
    k1 = run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, 1.0)
    for name, (kernel, _, meshes, _, _) in shard.items():
        for py, px in meshes:
            s, o = on_mesh(cells, nobst, py, px)
            (c1, a1), (c2, a2) = (joined(torch, kernel(s, o, 1000, 2048)) for _ in range(2))
            torch.cuda.synchronize()
            log(f"  {name} {py}x{px} vs K1: final state bitwise equal: {torch.equal(c1, k1[0])}, "
                f"max diff {float((c1 - k1[0]).abs().max()):.3e}")
            compare(torch, f"{name} {py}x{px} vs K1 2048x2048 1000 steps", (c1, a1), k1)
            check(torch.equal(c1, k1[0]), f"{name} {py}x{px}: final state differs from K1's")
            check(torch.equal(c1, c2) and torch.equal(a1, a2),
                  f"{name} {py}x{px} is not run-to-run deterministic")
            log(f"  {name} {py}x{px} determinism: two 1000-step runs give bitwise-equal av "
                "series and state")
            del s, o, c1, c2
    del cells, nobst, k1

    phase("14. the sharded path: lbm_tpu_torch.cli.main --mesh 4 / 2x2 --device 0, and --resume")
    from lbm_tpu_torch.ops import band, band2, shard_step

    mesh_counters = {"pallas": shard_step.run_shard_step, "pallas-overlap":
                     shard_step.run_shard_overlap, "band": band.run_band_sharded,
                     "band2": band2.run_band2_sharded}
    for fn in mesh_counters.values():
        fn.launches = 0
    want_mesh = dict.fromkeys(mesh_counters, 0)

    def account_mesh(stats):
        route, n = stats["route"], stats["max_iters"]
        check(route in mesh_counters, f"unexpected route {route}")
        check(len(stats["shards"]) == 4 and all(sh["device"] == "cuda:0" for sh in stats["shards"]),
              f"shards not all on cuda:0: {stats['shards']}")
        depth = shard["K8" if route == "band" else "K10"][4] if route.startswith("band") else 1
        want_mesh[route] += n // depth * depth
        want_mesh["pallas"] += n % depth

    with tempfile.TemporaryDirectory() as work:
        for backend, mesh in (("auto", "4"), ("pallas", "4"), ("pallas-overlap", "4"),
                              ("band", "4"), ("band2", "4"), ("auto", "2x2")):
            stats = run_deck(cli, "1024x1024", backend, work, gpu_line, mesh=mesh)
            check(backend != "auto" or stats["route"] == "pallas",
                  f"--mesh {mesh} auto routed {stats['route']}, not pallas (K3)")
            account_mesh(stats)
        account_mesh(run_deck(cli, "256x256", "auto", work, gpu_line, mesh="4"))
        want_mesh["pallas"] += sum(resume_run(cli, work, gpu_line, backend="auto", mesh="4"))
    got_mesh = {route: fn.launches for route, fn in mesh_counters.items()}
    log(f"  launch counters: K3 {got_mesh['pallas']} mesh steps (want {want_mesh['pallas']}), "
        f"K12 {got_mesh['pallas-overlap']} (want {want_mesh['pallas-overlap']}), K8 "
        f"{got_mesh['band']} (want {want_mesh['band']}), K10 {got_mesh['band2']} (want "
        f"{want_mesh['band2']})")
    for route in mesh_counters:
        check(got_mesh[route] == want_mesh[route], f"--mesh --backend {route}: not every step "
              "ran in its kernel")

    return shard, shard_res, got_mesh


# The c16 forms and the slab kernel: name -> (name in the report, source,
# the TPU kernel it replaces).
C16_KERNELS = {
    "K1": ("K1 fused step, c16", "lbm_tpu_torch/csrc/step.cu", "lbm_tpu/ops/pallas_step.py:164"),
    "K2": ("K2 in-place AA, c16", "lbm_tpu_torch/csrc/aa.cu", "lbm_tpu/ops/pallas_aa.py:163"),
    "K11": ("K11 band3 (one in-place AA window), c16", "lbm_tpu_torch/csrc/band3.cu",
            "lbm_tpu/ops/pallas_band3.py:306"),
    "K7": ("K7 band (one window, AA steps, any T), c16", "lbm_tpu_torch/csrc/band.cu",
           "lbm_tpu/ops/pallas_band.py:172"),
}
SLAB = ("K13 slab (band passes over y-slabs)", "lbm_tpu_torch/csrc/band.cu",
        "lbm_tpu/ops/pallas_slab.py:76")


def walls_setup(torch, n, seed):
    """A random state on the n x n walls mask (rows 0 and n-1 blocked)."""
    cells, nobst = random_setup(torch, n, n, seed=seed)
    nobst.fill_(1.0)
    nobst[0].zero_()
    nobst[-1].zero_()
    return cells, nobst


def c16_phase(torch, spec, routes):
    """Phase 15; returns {name: (max_abs_err, ms, plain_ms, f32 ms)} at the
    report's shape (K1, K2 1024^2; K11, K7 2048^2)."""
    from lbm_tpu_torch.ops import devspace
    from lbm_tpu_torch.ops.aa import run_aa, run_aa_plain
    from lbm_tpu_torch.ops.step import run_step, run_step_plain

    def steps(fn):
        return lambda c, o, n, dev=None: fn(c, o, DENSITY, ACCEL, OMEGA, n, 1.0, dev=dev)

    def passes(fn, cfg):
        block, depth, panel = cfg
        return lambda c, o, n, dev=None: fn(c, o, DENSITY, ACCEL, OMEGA, n, block, depth,
                                            panel=panel, dev=dev)

    k11, k7 = routes["band3"], routes["band"]
    t11, t7 = k11[3][1], k7[3][1]
    kernels = {"K1": (steps(run_step), steps(run_step_plain), (50,)),
               "K2": (steps(run_aa), steps(run_aa_plain), (50, 51)),
               "K11": (passes(k11[1], k11[3]), passes(k11[2], k11[3]),
                       (t11, 2 * t11 + 3, 3 * t11, 4 * t11)),
               "K7": (passes(k7[1], k7[3]), passes(k7[2], k7[3]), (t7, 2 * t7 + 3))}
    out = {}
    for name, (kernel, plain, counts) in kernels.items():
        errs = []
        for (nx, ny) in ((1024, 1024), (1000, 1000)):
            cells, nobst = random_setup(torch, nx, ny, seed=nx + 3)
            q = devspace.encode_state(cells, spec)
            for n in counts:
                errs.append(compare(torch, f"{name} c16 {nx}x{ny} {n} steps",
                                    kernel(q, nobst, n, spec), plain(q, nobst, n, spec), spec))
        out[name] = [max(errs)]
    cells, nobst = random_setup(torch, 1024, 1024, seed=23)
    q = devspace.encode_state(cells, spec)
    (c1, a1), (c2, a2) = (run_aa(q, nobst, DENSITY, ACCEL, OMEGA, 301, 1.0, dev=spec)
                          for _ in range(2))
    torch.cuda.synchronize()
    check(torch.equal(c1, c2) and torch.equal(a1, a2), "K2 c16 is not run-to-run deterministic")
    log("  K2 c16 determinism: two 301-step runs give bitwise-equal av series and codes")
    for name, (kernel, plain, counts) in kernels.items():
        for nx, n_kernel in (((1024, 1000),) if name in ("K1", "K2") else ((2048, 800), (4096, 200))):
            cells, nobst = random_setup(torch, nx, nx, seed=7)
            q = devspace.encode_state(cells, spec)
            n_plain = 50 if name in ("K1", "K2") else 2 * counts[0]
            kernel(cells, nobst, 10 * counts[0])  # warm up, the allocator included
            kernel(q, nobst, 10 * counts[0], spec)
            _, f_ms = timed(torch, lambda: kernel(cells, nobst, n_kernel))
            _, k_ms = timed(torch, lambda: kernel(q, nobst, n_kernel, spec))
            p_ms = None
            if nx <= 2048:
                plain(q, nobst, counts[0], spec)
                _, p_ms = timed(torch, lambda: plain(q, nobst, n_plain, spec))
                p_ms /= n_plain
            log(f"  {name} c16 {nx}x{nx}: kernel {1e3 * k_ms / n_kernel:.2f} us/step "
                f"({nx * nx * n_kernel / k_ms / 1e3:.1f} MLUPS), f32 form {1e3 * f_ms / n_kernel:.2f}"
                f" us/step" + (f", plain {1e3 * p_ms:.2f} us/step" if p_ms else ""))
            if nx in (1024, 2048):
                out[name] += [k_ms / n_kernel, p_ms, f_ms / n_kernel]
        del cells, nobst, q
    return out


def slab_phase(torch, spec, routes):
    """Phase 16; returns (the default schedule at 2048^2, err, c16 err,
    {(n, K, S): ms}, plain ms and c16 plain ms at 2048^2, {n: (K7, K11, K13
    c16, K7 c16) ms})."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import devspace, slab
    from lbm_tpu_torch.ops.step import run_step

    def cfg_for(n):
        return slab.schedule(LBMParams(nx=n, ny=n, max_iters=1, reynolds_dim=10,
                                       density=DENSITY, accel=ACCEL, omega=OMEGA),
                             torch.float32)

    def k13(c, o, n, cfg, dev=None, fn=slab.run_band_slab):
        block, depth, panel, kp, sb = cfg
        return fn(c, o, DENSITY, ACCEL, OMEGA, n, block, depth, kp, sb, panel=panel, dev=dev)

    cfg = cfg_for(1024)
    kt, depth = cfg[3] * cfg[1], cfg[1]
    log(f"  default schedule at 1024^2: block {cfg[0]}, depth {depth}, panel {cfg[2]}, K "
        f"{cfg[3]}, S {cfg[4]}; at 2048^2 S {cfg_for(2048)[4]}, at 4096^2 S {cfg_for(4096)[4]}")
    errs = {None: [], "c16": []}
    for (nx, ny) in ((1024, 1024), (1000, 1024)):
        cells, nobst = random_setup(torch, nx, ny, seed=nx + 5)
        for dev in (None, spec):
            x = cells if dev is None else devspace.encode_state(cells, spec)
            for n in (kt, 2 * kt, 2 * kt + depth + 3):
                errs[None if dev is None else "c16"].append(compare(
                    torch, f"K13 {'c16' if dev else 'f32'} {nx} cols x {ny} rows {n} steps",
                    k13(x, nobst, n, cfg, dev), k13(x, nobst, n, cfg, dev, slab.run_band_slab_plain),
                    dev))
    cells, nobst = walls_setup(torch, 2048, 29)
    cfg2 = cfg_for(2048)
    k1 = run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, 1.0)
    (c1, a1), (c2, a2) = (k13(cells, nobst, 1000, cfg2) for _ in range(2))
    torch.cuda.synchronize()
    log(f"  K13 vs K1: final state bitwise equal: {torch.equal(c1, k1[0])}, max diff "
        f"{float((c1 - k1[0]).abs().max()):.3e}")
    compare(torch, "K13 vs K1 2048x2048 walls 1000 steps", (c1, a1), k1)
    check(torch.equal(c1, k1[0]), "K13: final state differs from K1's")
    check(torch.equal(c1, c2) and torch.equal(a1, a2), "K13 is not run-to-run deterministic")
    q = devspace.encode_state(cells, spec)
    (c1, a1), (c2, a2) = (k13(q, nobst, 1000, cfg2, spec) for _ in range(2))
    torch.cuda.synchronize()
    check(torch.equal(c1, c2) and torch.equal(a1, a2), "K13 c16 is not run-to-run deterministic")
    log("  K13 determinism: two 1000-step runs of each form give bitwise-equal av series and "
        "state")
    del cells, nobst, k1, c1, c2, q
    band_run, band_cfg = routes["band"][1], routes["band"][3]
    b3_run, b3_cfg = routes["band3"][1], routes["band3"][3]

    def band(fn, cfg, c, o, n, dev=None):
        return fn(c, o, DENSITY, ACCEL, OMEGA, n, cfg[0], cfg[1], panel=cfg[2], dev=dev)

    sweep, beside = {}, {}
    plain_ms = plain_c16_ms = None
    for n, steps in ((2048, 512), (4096, 128)):
        cells, nobst = walls_setup(torch, n, 7)
        q = devspace.encode_state(cells, spec)
        base = cfg_for(n)
        band(band_run, band_cfg, cells, nobst, 16)
        band(b3_run, b3_cfg, cells, nobst, 16)
        _, k7_ms = timed(torch, lambda: band(band_run, band_cfg, cells, nobst, steps))
        _, k11_ms = timed(torch, lambda: band(b3_run, b3_cfg, cells, nobst, steps))
        for kp in (1, 2, 4):
            for sb in (128, 256, 512, 1024) + ((2048,) if n == 4096 else ()):
                c = base[:3] + (kp, sb)
                k13(cells, nobst, 16, c)
                _, ms = timed(torch, lambda: k13(cells, nobst, steps, c))
                sweep[n, kp, sb] = ms / steps
                log(f"  K13 {n}x{n} walls K {kp} S {sb}: {1e3 * ms / steps:.2f} us/step "
                    f"({n * n * steps / ms / 1e3:.1f} MLUPS)")
        k13(q, nobst, 16, base, spec)
        band(band_run, band_cfg, q, nobst, 16, spec)
        _, c16_ms = timed(torch, lambda: k13(q, nobst, steps, base, spec))
        _, k7c_ms = timed(torch, lambda: band(band_run, band_cfg, q, nobst, steps, spec))
        beside[n] = (k7_ms / steps, k11_ms / steps, c16_ms / steps, k7c_ms / steps)
        log(f"  {n}x{n} walls, same loop: K7 {1e3 * k7_ms / steps:.2f}, K11 "
            f"{1e3 * k11_ms / steps:.2f}, K13 default (K {base[3]}, S {base[4]}) "
            f"{1e3 * sweep[n, base[3], base[4]]:.2f}, K13 c16 {1e3 * c16_ms / steps:.2f}, K7 c16 "
            f"{1e3 * k7c_ms / steps:.2f} us/step")
        if n == 2048:
            n_plain = base[3] * base[1]
            k13(cells, nobst, n_plain, base, fn=slab.run_band_slab_plain)
            _, plain_ms = timed(torch, lambda: k13(cells, nobst, n_plain, base,
                                                   fn=slab.run_band_slab_plain))
            _, plain_c16_ms = timed(torch, lambda: k13(q, nobst, n_plain, base, spec,
                                                       slab.run_band_slab_plain))
            plain_ms, plain_c16_ms = plain_ms / n_plain, plain_c16_ms / n_plain
            log(f"  K13 plain 2048x2048: {1e3 * plain_ms:.2f} us/step, c16 "
                f"{1e3 * plain_c16_ms:.2f} us/step")
        del cells, nobst, q
    ranked = sorted(sweep, key=lambda key: (key[0], sweep[key]))
    for n in (2048, 4096):
        top = [key for key in ranked if key[0] == n][:3]
        log(f"  K13 sweep {n}^2, fastest first: " + ", ".join(
            f"K {kp} S {sb} {1e3 * sweep[n, kp, sb]:.2f}" for _, kp, sb in top))
    return cfg2, max(errs[None]), max(errs["c16"]), sweep, plain_ms, plain_c16_ms, beside


def c16_path_phase(torch, cli, gpu_line, walls_ref):
    """Phase 17; returns {counter name: launches}."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import aa, band, band3, slab, step
    from lbm_tpu_torch.runtime.driver import pass_schedule

    fns = {"K1": step.run_step, "K2": aa.run_aa, "K11": band3.run_band3, "K7": band.run_band,
           "K13": slab.run_band_slab}
    for fn in fns.values():
        fn.launches = fn.launches_c16 = 0
    want = {f"{name}{tail}": 0 for name in fns for tail in ("", " c16")}

    def split(route, n, tail, ny):
        params = LBMParams(nx=ny, ny=ny, max_iters=1, reynolds_dim=10, density=DENSITY,
                           accel=ACCEL, omega=OMEGA)
        if route == "slab":
            _, depth, _, kpasses, _ = slab.schedule(params, torch.float32)
            want["K13" + tail] += n // (kpasses * depth) * kpasses * depth
            n %= kpasses * depth
            route = "band"
        name = {"band3": "K11", "band": "K7", "aa": "K2", "pallas": "K1"}[route]
        if route.startswith("band"):
            depth = pass_schedule(route, params, torch.float32)[1][1]
            want[name + tail] += n // depth * depth
            want["K1" + tail] += n % depth
        else:
            want[name + tail] += n

    def account(stats, chunks=None):
        tail = " c16" if stats["precision"] == "c16" else ""
        for n in chunks or (stats["max_iters"],):
            split(stats["route"], n, tail, stats["ny"])

    with tempfile.TemporaryDirectory() as work:
        for tag in ("256x256", "1024x1024"):
            for backend in ("auto", "aa", "pallas"):
                stats = run_deck(cli, tag, backend, work, gpu_line, precision="c16")
                check(backend != "auto" or stats["route"] == "pallas",
                      f"{tag} c16: auto routed {stats['route']}, not pallas (K1)")
                account(stats)
            # The band kernels round once per pass (T steps), as the JAX
            # package's do: that cadence drifts past the 1% gate on the
            # 256^2 deck, so these runs are held at PASS_GATE_C16 percent,
            # which a saturated or broken run exceeds many times over.
            account(run_deck(cli, tag, "band3", work, gpu_line, precision="c16",
                             gate=PASS_GATE_C16))
        account(run_deck(cli, "1024x1024", "band", work, gpu_line, precision="c16",
                         gate=PASS_GATE_C16))
        os.environ["LBM_ENABLE_SLAB"] = "1"  # the quarantined route
        try:
            for precision in ("f32", "c16"):
                account(run_deck(cli, "1024x1024", "slab", work, gpu_line, precision=precision,
                                 gate=1.0 if precision == "f32" else PASS_GATE_C16))
            deck, ref = walls_ref
            out, stats = run_walls(cli, deck, "slab", work, 2048, gpu_line)
            account(stats)
            hold_against(out, ref, "walls 2048^2 --backend slab")
            shutil.rmtree(out)
        finally:
            del os.environ["LBM_ENABLE_SLAB"]
        # K2 rounds its codes every step, so chunk boundaries anywhere give
        # the same bits; the band kernels round once per pass.
        for n in resume_run(cli, work, gpu_line, backend="aa", precision="c16"):
            split("aa", n, " c16", 256)
    got = {f"{name}{tail}": getattr(fn, "launches" if not tail else "launches_c16")
           for name, fn in fns.items() for tail in ("", " c16")}
    log("  launch counters: " + ", ".join(f"{k} {got[k]} steps (want {want[k]})" for k in got))
    for k in got:
        check(got[k] == want[k], f"{k}: not every step of the c16 and slab path ran in its kernel")
    check(all(got[k] > 0 for k in ("K1 c16", "K2 c16", "K11 c16", "K7 c16", "K13", "K13 c16")),
          "a kernel of the c16 and slab path was never launched")
    return got


# The c16 forms of K9, K5, K6, K3, K8 and K10: name -> (name in the report,
# source, the TPU kernel it replaces).
C16_MORE = {
    "K9": (BANDS["band2"][0] + ", c16", *BANDS["band2"][1:]),
    "K5": (SCHEDULED["temporal"][0] + ", c16", *SCHEDULED["temporal"][1:]),
    "K6": (SCHEDULED["deep"][0] + ", c16", *SCHEDULED["deep"][1:]),
    "K3": (SHARDED["K3"][0] + ", c16 (1-D mesh)", *SHARDED["K3"][1:]),
    "K8": (SHARDED["K8"][0] + ", c16", *SHARDED["K8"][1:]),
    "K10": (SHARDED["K10"][0] + ", c16", *SHARDED["K10"][1:]),
}
C16_MORE_ROUTES = {"K9": "band2", "K5": "temporal", "K6": "deep"}


def c16_more_forms():
    """name -> (kernel, plain, depth, on shards): single-device forms take
    (cells, nobst, n, dev), the mesh forms (shards, nob_shards, n, ny, dev),
    with the driver's schedules."""
    import torch

    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band, band2, deep, shard_step, temporal
    from lbm_tpu_torch.runtime.driver import pass_schedule

    # The schedules at 2048^2, where the report times these forms.
    params = LBMParams(nx=2048, ny=2048, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    plains = {"band2": band2.run_band2_plain, "temporal": temporal.run_temporal_plain,
              "deep": deep.run_deep_plain}
    out = {}
    for name, route in C16_MORE_ROUTES.items():
        run, (block, depth, panel) = pass_schedule(route, params, "c16")

        def bind(fn, block=block, depth=depth, panel=panel):
            return lambda c, o, n, dev=None: fn(c, o, DENSITY, ACCEL, OMEGA, n, block, depth,
                                                panel=panel, dev=dev)

        out[name] = (bind(run), bind(plains[route]), depth, False)

    def steps(fn):
        return lambda s, o, n, ny, dev=None: fn(s, o, DENSITY, ACCEL, OMEGA, n, ny, dev=dev)

    out["K3"] = (steps(shard_step.run_shard_step), steps(shard_step.run_shard_step_plain), 1,
                 True)
    for name, mod, run, cfg in (("K8", band, "run_band_sharded", band.schedule(params, "c16")),
                                ("K10", band2, "run_band2_sharded",
                                 band2.schedule(params, "c16"))):
        block, depth, panel = cfg

        def bind(fn, block=block, depth=depth, panel=panel):
            return lambda s, o, n, ny, dev=None: fn(s, o, DENSITY, ACCEL, OMEGA, n, block, depth,
                                                    ny, panel=panel, dev=dev)

        out[name] = (bind(getattr(mod, run)), bind(getattr(mod, run + "_plain")), depth, True)
    return out


def c16_more_phase(torch, spec, forms):
    """Phase 18; returns {name: (max_abs_err, ms, plain_ms, f32 ms)} per step
    at 2048^2 (the mesh forms with 4 row shards on cuda:0)."""
    from lbm_tpu_torch.ops import devspace
    from lbm_tpu_torch.ops.step import run_step

    def call(fn, on_shards, x, o, n, dev=None):
        """fn on a grid, or on its 4 row shards joined (state, av)."""
        if not on_shards:
            return fn(x, o, n, dev)
        return joined(torch, fn(x, o, n, x[0][0].shape[1] * 4, dev))

    out = {}
    for name, (kernel, plain, depth, on_shards) in forms.items():
        errs = []
        for nx, ny in ((1024, 1024), (1000, 1000)):
            cells, nobst = (random_setup(torch, nx, ny, seed=nx + 31) if nx == 1024
                            else walls_setup(torch, nx, 41))
            x, o = devspace.encode_state(cells, spec), nobst
            if on_shards:
                x, o = on_mesh(x, o, 4, 1)
            for n in ((50,) if depth == 1 else (depth, 2 * depth + 3)):
                errs.append(compare(torch, f"{name} c16 {nx}x{ny} {n} steps",
                                    call(kernel, on_shards, x, o, n, spec),
                                    call(plain, on_shards, x, o, n, spec), spec))
        out[name] = [max(errs)]
    cells, nobst = random_setup(torch, 1024, 1024, seed=37)
    q = devspace.encode_state(cells, spec)
    for name in ("K9", "K3"):
        kernel, _, _, on_shards = forms[name]
        x, o = on_mesh(q, nobst, 4, 1) if on_shards else (q, nobst)
        (c1, a1), (c2, a2) = (call(kernel, on_shards, x, o, 301, spec) for _ in range(2))
        torch.cuda.synchronize()
        check(torch.equal(c1, c2) and torch.equal(a1, a2),
              f"{name} c16 is not run-to-run deterministic")
        log(f"  {name} c16 determinism: two 301-step runs give bitwise-equal av series and codes")
    s, o = on_mesh(q, nobst, 4, 1)
    k3 = call(forms["K3"][0], True, s, o, 50, spec)
    k1 = run_step(q, nobst, DENSITY, ACCEL, OMEGA, 50, 1.0, dev=spec)
    log(f"  K3 c16 (4 shards) vs K1 c16 over 50 steps: codes bitwise equal: "
        f"{torch.equal(k3[0], k1[0])}")
    compare(torch, "K3 c16 vs K1 c16 1024x1024 50 steps", k3, k1, spec)
    del cells, nobst, q, s, o, k3, k1
    cells, nobst = random_setup(torch, 2048, 2048, seed=7)
    q = devspace.encode_state(cells, spec)
    for name, (kernel, plain, depth, on_shards) in forms.items():
        n = 400 if on_shards else 800
        xf, xq, o = cells, q, nobst
        if on_shards:
            (xf, o), (xq, _) = on_mesh(cells, nobst, 4, 1), on_mesh(q, nobst, 4, 1)
        call(kernel, on_shards, xf, o, 2 * depth)  # warm up, the allocator included
        call(kernel, on_shards, xq, o, 2 * depth, spec)
        _, f_ms = timed(torch, lambda: call(kernel, on_shards, xf, o, n))
        _, k_ms = timed(torch, lambda: call(kernel, on_shards, xq, o, n, spec))
        n_plain = 2 * depth
        call(plain, on_shards, xq, o, depth, spec)
        _, p_ms = timed(torch, lambda: call(plain, on_shards, xq, o, n_plain, spec))
        out[name] += [k_ms / n, p_ms / n_plain, f_ms / n]
        log(f"  {name} c16 2048x2048{' (4 shards)' if on_shards else ''}: kernel "
            f"{1e3 * k_ms / n:.2f} us/step ({2048 * 2048 * n / k_ms / 1e3:.1f} MLUPS), f32 form "
            f"{1e3 * f_ms / n:.2f} us/step, plain {1e3 * p_ms / n_plain:.2f} us/step")
        del xf, xq, o
    del cells, nobst, q
    return out


def mesh_2d_run(cli, work, gpu_line, precision="c16"):
    """``--mesh 2x2 --device 0 --precision`` c16 or bf16 (auto: the
    plain-torch step of that storage) on a 128^2 box cut to MESH_2D_ITERS
    steps, held against the one-device ``pallas`` (K1) run of the same deck
    through the checker at 1% (bf16, whose plain step rounds every
    operation: the verdict printed, held to finite output). Returns the two
    stats."""
    import numpy as np

    from lbm_tpu_torch.utils import geometry
    from lbm_tpu_torch.utils.checker import check_files

    deck = os.path.join(work, f"box128-{precision}")
    os.makedirs(deck)
    params_path = os.path.join(deck, "input.params")
    obst_path = os.path.join(deck, "obstacles.dat")
    geometry.write_params_file(params_path, 128, 128, MESH_2D_ITERS, 10, DENSITY, ACCEL, OMEGA)
    geometry.write_obstacle_file(obst_path, geometry.box(128, 128))
    stats, outs = [], []
    for extra in (["--mesh", "2x2", "--backend", "auto"], ["--backend", "pallas"]):
        out = os.path.join(deck, extra[1])
        stats_path = os.path.join(out, "stats.json")
        os.makedirs(out)
        rc = cli.main([params_path, obst_path, "--device", "0", "--precision", precision,
                       "--out-dir", out, "--stats-json", stats_path, *extra])
        check(rc == 0, f"128^2 {precision} {' '.join(extra)}: cli.main returned {rc}")
        with open(stats_path) as f:
            stats.append(json.load(f))
        outs.append(out)
        log(f"  box 128x128 x {MESH_2D_ITERS} {precision} {' '.join(extra)} --device 0: route "
            f"{stats[-1]['route']}, loop {stats[-1]['loop_s']:.4f} s, {stats[-1]['mlups']:.1f} "
            f"MLUPS [{gpu_line}]")
    check(stats[0]["route"] == "reference" and stats[1]["route"] == "pallas",
          f"2-D {precision} routes {stats[0]['route']}, {stats[1]['route']}")
    files = [os.path.join(d, f) for d in outs for f in ("av_vels.dat", "final_state.dat")]
    res = check_files(*files, tolerance=1.0)
    av, av_ref = (np.loadtxt(f, usecols=[1]) for f in (files[0], files[2]))
    log(f"    2x2 vs K1 {precision}: checker av_vels {res.av_vels.max_diff_pcnt:.4g}%, pressure "
        f"{res.final_state.max_diff_pcnt:.4g}%: {'PASS' if res.passed else 'FAIL'}; av max rel "
        f"diff {float((np.abs(av - av_ref) / np.abs(av_ref)).max()):.3e}")
    check(bool(np.isfinite(av).all()), f"the 2x2 {precision} run has non-finite av_vels")
    check(precision == "bf16" or res.passed, f"the 2x2 {precision} run fails the 1% checker")
    return stats


def c16_mesh_path_phase(torch, cli, gpu_line, forms):
    """Phase 19; returns {counter name: launches}."""
    from lbm_tpu_torch.ops import band, band2, deep, shard_step, step, temporal

    fns = {"K9": band2.run_band2, "K5": temporal.run_temporal, "K6": deep.run_deep,
           "K1": step.run_step, "K3": shard_step.run_shard_step, "K8": band.run_band_sharded,
           "K10": band2.run_band2_sharded}
    for fn in fns.values():
        fn.launches = fn.launches_c16 = 0
    want = dict.fromkeys(fns, 0)
    kernel_of = {"band2": "K9", "temporal": "K5", "deep": "K6"}
    mesh_kernel_of = {"pallas": "K3", "band": "K8", "band2": "K10"}

    def account(stats):
        route, n = stats["route"], stats["max_iters"]
        if stats["mesh"] == "0":
            check(route in kernel_of or route == "pallas", f"unexpected c16 route {route}")
            name, rem = kernel_of.get(route, "K1"), "K1"
        elif "x" in stats["mesh"]:
            check(route == "reference", f"--mesh {stats['mesh']} c16 routed {route}")
            return
        else:
            check(all(sh["device"] == "cuda:0" for sh in stats["shards"]),
                  f"shards not all on cuda:0: {stats['shards']}")
            name, rem = mesh_kernel_of[route], "K3"
        depth = forms[name][2] if name in forms else 1
        want[name] += n // depth * depth
        want[rem] += n % depth

    with tempfile.TemporaryDirectory() as work:
        for tag in ("256x256", "1024x1024"):
            for backend in ("band2", "temporal", "deep"):
                account(run_deck(cli, tag, backend, work, gpu_line, precision="c16",
                                 gate=PASS_GATE_C16))
        for backend in ("auto", "pallas", "band", "band2"):
            stats = run_deck(cli, "1024x1024", backend, work, gpu_line, mesh="4", precision="c16",
                             gate=1.0 if backend in ("auto", "pallas") else PASS_GATE_C16)
            check(backend != "auto" or stats["route"] == "pallas",
                  f"--mesh 4 c16 auto routed {stats['route']}, not pallas (K3)")
            account(stats)
        account(run_deck(cli, "256x256", "auto", work, gpu_line, mesh="4", precision="c16"))
        # K3 rounds its codes every step, so the resumed run gives the bits.
        want["K3"] += sum(resume_run(cli, work, gpu_line, backend="auto", mesh="4",
                                     precision="c16"))
        for stats in mesh_2d_run(cli, work, gpu_line):
            account(stats)
    got = {f"{name} c16": fn.launches_c16 for name, fn in fns.items()}
    got_f32 = {name: fn.launches for name, fn in fns.items()}
    log("  launch counters: " + ", ".join(f"{k} {got[k]} steps (want {want[k.split()[0]]})"
                                          for k in got))
    for k, n in got.items():
        check(n == want[k.split()[0]], f"{k}: not every step of the c16 path ran in its kernel")
        check(n > 0, f"{k}: a kernel of the c16 path was never launched")
    check(not any(got_f32.values()), f"an f32 counter moved on the c16 path: {got_f32}")
    return got


def t16_panel(plane_copies, block, depth):
    """The widest panel whose window fits the shared memory of a block."""
    from lbm_tpu_torch.ops.band_common import SMEM_LIMIT, smem_bytes

    panel = 1
    while smem_bytes(plane_copies, 4096, block, depth, panel + 1) <= SMEM_LIMIT:
        panel += 1
    return panel


def gate_per_t_phase(torch, gpu_line):
    """Phase 20; returns {(kernel, T, deck): (av %, pressure %, loop s)}."""
    import numpy as np

    from lbm_tpu_torch.io import write_av_vels, write_final_state
    from lbm_tpu_torch.models.d2q9 import D2Q9, LBMParams
    from lbm_tpu_torch.ops import band2, band3, devspace
    from lbm_tpu_torch.utils import geometry
    from lbm_tpu_torch.utils.checker import check_files

    kernels = {"K9": (band2.run_band2, band2.PLANE_COPIES, (24, 24)),
               "K11": (band3.run_band3, band3.PLANE_COPIES, (24, 56))}
    out = {}
    with tempfile.TemporaryDirectory() as work:
        for tag in ("256x256", "1024x1024"):
            fields, geo, kw = DECKS[tag]
            params = LBMParams(*fields)
            obstacles = getattr(geometry, geo)(fields[0], fields[1], **kw)
            gold = write_gold(os.path.join(ROOT, "tests", "golden", f"{tag}.golden.npz"), work)
            dev = torch.device("cuda", 0)
            spec = devspace.DevSpec.for_params(params.density, params.accel)  # the deck's H
            nobst = torch.as_tensor((obstacles == 0).astype(np.float32)).to(dev)
            q0 = devspace.encode_state(D2Q9.initial_state(params, dtype=torch.float32,
                                                          device=dev), spec)
            inv = float(np.float32(1.0 / int(np.sum(obstacles == 0))))
            for name, (run, copies, (block, panel)) in kernels.items():
                for depth in (4, 8, 16):
                    b, p = (block, panel) if depth < 16 else (2 * depth, t16_panel(copies, 32, 16))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    cells, av = run(q0, nobst, params.density, params.accel, params.omega,
                                    params.max_iters, b, depth, panel=p, inv_tot_cells=inv,
                                    dev=spec)
                    torch.cuda.synchronize()
                    loop = time.perf_counter() - t0
                    d = os.path.join(work, f"{tag}-{name}-T{depth}")
                    os.makedirs(d)
                    write_av_vels(os.path.join(d, "av_vels.dat"), av.cpu().numpy())
                    write_final_state(os.path.join(d, "final_state.dat"), params,
                                      devspace.decode_state(cells, spec).cpu().numpy(), obstacles)
                    res = check_files(os.path.join(d, "av_vels.dat"),
                                      os.path.join(d, "final_state.dat"), *gold, tolerance=1.0)
                    check(bool(torch.isfinite(av).all()), f"{name} T {depth} {tag}: non-finite av")
                    out[name, depth, tag] = (res.av_vels.max_diff_pcnt,
                                             res.final_state.max_diff_pcnt, loop)
                    log(f"  {name} c16 T {depth} (block {b}, panel {p}) {tag} x "
                        f"{params.max_iters}: av_vels {res.av_vels.max_diff_pcnt:.4g}% at step "
                        f"{res.av_vels.max_index}, pressure {res.final_state.max_diff_pcnt:.4g}%:"
                        f" 1% gate {'PASS' if res.passed else 'FAIL'}; loop {loop:.3f} s "
                        f"[{gpu_line}]")
                    shutil.rmtree(d)
    return out


# The bf16 forms: name -> (name in the report, source, the TPU kernel it
# replaces).
BF16_KERNELS = {
    "K1": (C16_KERNELS["K1"][0][:-3] + "bf16", *C16_KERNELS["K1"][1:]),
    "K2": (C16_KERNELS["K2"][0][:-3] + "bf16", *C16_KERNELS["K2"][1:]),
    "K7": (BANDS["band"][0] + ", bf16", *BANDS["band"][1:]),
    "K9": (BANDS["band2"][0] + ", bf16", *BANDS["band2"][1:]),
    "K11": (BANDS["band3"][0] + ", bf16", *BANDS["band3"][1:]),
    "K5": (SCHEDULED["temporal"][0] + ", bf16", *SCHEDULED["temporal"][1:]),
    "K6": (SCHEDULED["deep"][0] + ", bf16", *SCHEDULED["deep"][1:]),
    "K13": (SLAB[0] + ", bf16", *SLAB[1:]),
    "K3": (SHARDED["K3"][0] + ", bf16 (1-D mesh)", *SHARDED["K3"][1:]),
    "K8": (SHARDED["K8"][0] + ", bf16", *SHARDED["K8"][1:]),
    "K10": (SHARDED["K10"][0] + ", bf16", *SHARDED["K10"][1:]),
}
# (ulps per value, fraction of values differing, av rtol), as the CPU tests
# (tests/test_torch_bf16.py): over one pass and a remainder (a few steps
# of a one-step kernel) TOL_BF16. Over longer runs the rare flips of the
# first roundings (FMA contraction in the kernels moves an f32 value by an
# ulp, which a bf16 rounding boundary can split) move their neighbours
# across their own boundaries, and the runs are held at TOL_BF16_SPREAD
# (on an H100: up to 9 ulps and 2.8% of the values after 39-201 steps, the
# av series within 3e-4; a rounding in the wrong place moves most values).
TOL_BF16 = (2, 0.01, 1e-3)
TOL_BF16_SPREAD = (16, 0.1, 1e-3)
# K11 over 2T+3 steps in phase 32: the card tests' spread tolerance
# (tests/test_torch_cuda.py::BF16_SPREAD_TOL). K11 stores its S state with
# the next forcing added, a delta of about 1.4 bf16 ulps on the ny-2 row,
# so a flipped rounding there moves |u| of its cells by up to a tenth: on
# a 40 x 70 grid at T 16 the av series moved by 1.05e-3 on an H100, in the
# parent's body and the new one alike (PERF.md section 6).
TOL_BF16_K11_SPREAD = (4, 0.05, 5e-3)
# The route of ``auto`` at bf16 (runtime/driver.py::select_route).
AUTO_ROUTE_BF16 = "aa"
BYTES_PER_CELL_BF16 = 40  # 9 bf16 planes read, 9 written, the f32 mask read


def bf16_forms(routes, more, slab_cfg):
    """name -> (kernel, plain, depth, on_shards, counts): kernel and plain
    take (x, nobst, n, dev) on a grid or (shards, nob_shards, n, ny, dev) on
    4 row shards, with the driver's schedules; ``counts`` the step counts
    held against the plain version (short ones at TOL_BF16)."""
    import torch

    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import slab
    from lbm_tpu_torch.ops.aa import run_aa, run_aa_plain
    from lbm_tpu_torch.ops.step import run_step, run_step_plain

    def steps(fn):
        return lambda c, o, n, dev=None: fn(c, o, DENSITY, ACCEL, OMEGA, n, 1.0, dev=dev)

    def passes(fn, cfg):
        block, depth, panel = cfg
        return lambda c, o, n, dev=None: fn(c, o, DENSITY, ACCEL, OMEGA, n, block, depth,
                                            panel=panel, dev=dev)

    def k13(fn):
        def run(c, o, n, dev=None):
            _, ny, nx = c.shape  # the default schedule of the grid: S = ny / 2
            block, depth, panel, kp, sb = slab.schedule(LBMParams(
                nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=DENSITY, accel=ACCEL,
                omega=OMEGA), torch.float32)
            return fn(c, o, DENSITY, ACCEL, OMEGA, n, block, depth, kp, sb, panel=panel, dev=dev)

        return run

    out = {"K1": (steps(run_step), steps(run_step_plain), 1, False, (5, 200)),
           "K2": (steps(run_aa), steps(run_aa_plain), 1, False, (5, 200, 201))}
    for name, route in (("K7", "band"), ("K9", "band2"), ("K11", "band3")):
        cfg = routes[route][3]
        out[name] = (passes(routes[route][1], cfg), passes(routes[route][2], cfg), cfg[1], False,
                     (cfg[1], 2 * cfg[1] + 3))
    for name in ("K5", "K6", "K3", "K8", "K10"):
        kernel, plain, depth, on_shards = more[name]
        out[name] = (kernel, plain, depth, on_shards,
                     (5, 50) if depth == 1 else (depth, 2 * depth + 3))
    kt = slab_cfg[3] * slab_cfg[1]
    out["K13"] = (k13(slab.run_band_slab), k13(slab.run_band_slab_plain), kt, False,
                  (kt, 2 * kt + slab_cfg[1] + 3))
    return out


def bf16_compare(torch, name, got, want, tol):
    """A bf16 kernel against its plain version, on the bit patterns; returns
    the largest |difference| of the values."""
    (gc, ga), (wc, wa) = got, want
    torch.cuda.synchronize()
    check(gc.dtype == torch.bfloat16, f"{name}: bf16 output is {gc.dtype}")
    check(bool(torch.isfinite(gc.float()).all()) and bool(torch.isfinite(ga).all()),
          f"{name}: non-finite output")

    def ordered(x):
        u = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u)

    ulps = (ordered(gc) - ordered(wc)).abs()
    max_ulps, frac = int(ulps.max()), float((ulps > 0).float().mean())
    av_rel = float(((ga.double() - wa.double()).abs() / wa.double().abs()).max())
    log(f"  {name}: max {max_ulps} ulps (limit {tol[0]}), {100 * frac:.4f}% of values differ "
        f"(limit {100 * tol[1]:g}%), max av rel diff {av_rel:.3e} (limit {tol[2]})")
    check(max_ulps <= tol[0] and frac <= tol[1], f"{name}: bf16 values differ beyond {tol}")
    check(av_rel <= tol[2], f"{name}: av series differs by {av_rel}")
    return float((gc.float() - wc.float()).abs().max())


def bf16_phase(torch, spec, forms):
    """Phase 21; returns {name: [max_abs_err, ms, plain_ms, f32 ms, c16 ms]}
    per step (K1, K2 at 1024^2, the others at 2048^2, the mesh forms with 4
    row shards on cuda:0)."""
    from lbm_tpu_torch.ops import devspace

    bf = devspace.BF16

    def call(fn, on_shards, x, o, n, dev=None):
        if on_shards:
            return joined(torch, fn(x, o, n, x[0][0].shape[1] * 4, dev))
        return fn(x, o, n, dev)

    out = {}
    for name, (kernel, plain, depth, on_shards, counts) in forms.items():
        errs = []
        for nx, ny in ((1024, 1024), (1000, 1024 if name == "K13" else 1000)):
            cells, nobst = (random_setup(torch, nx, ny, seed=nx + 43) if nx == ny == 1024
                            else walls_setup(torch, nx, 47) if nx == ny
                            else random_setup(torch, nx, ny, seed=49))  # K13: S must divide ny
            x, o = devspace.encode_state(cells, bf), nobst
            if on_shards:
                x, o = on_mesh(x, o, 4, 1)
            for n in counts:
                tol = TOL_BF16 if n <= max(depth + 3, 5) else TOL_BF16_SPREAD
                errs.append(bf16_compare(torch, f"{name} bf16 {nx}x{ny} {n} steps",
                                         call(kernel, on_shards, x, o, n, bf),
                                         call(plain, on_shards, x, o, n, bf), tol))
        out[name] = [max(errs)]
    cells, nobst = random_setup(torch, 1024, 1024, seed=53)
    x = devspace.encode_state(cells, bf)
    for name in ("K1", "K2"):
        (c1, a1), (c2, a2) = (forms[name][0](x, nobst, 301, bf) for _ in range(2))
        torch.cuda.synchronize()
        check(torch.equal(c1, c2) and torch.equal(a1, a2),
              f"{name} bf16 is not run-to-run deterministic")
        log(f"  {name} bf16 determinism: two 301-step runs give bitwise-equal av series and "
            "state")
    del cells, nobst, x
    for name, (kernel, plain, depth, on_shards, _) in forms.items():
        one_step = name in ("K1", "K2")
        sizes = (1024, 2048) if one_step else (2048,)
        for nx in sizes:
            cells, nobst = random_setup(torch, nx, nx, seed=7)
            xs = {None: cells, "c16": devspace.encode_state(cells, spec),
                  "bf16": devspace.encode_state(cells, bf)}
            o = nobst
            if on_shards:
                xs = {k: on_mesh(v, nobst, 4, 1)[0] for k, v in xs.items()}
                o = on_mesh(cells, nobst, 4, 1)[1]
            devs = {None: None, "c16": spec, "bf16": bf}
            n = (1000 if nx == 1024 else 400) if one_step else (400 if on_shards else 800)
            n = max(n // depth, 1) * depth
            for key in xs:  # warm up each form, the allocator included
                call(kernel, on_shards, xs[key], o, 2 * depth, devs[key])
            ms = {}
            for key in (None, "c16", "bf16"):
                _, t = timed(torch, lambda: call(kernel, on_shards, xs[key], o, n, devs[key]))
                ms[key] = t / n
            p_ms = None
            if nx == sizes[-1] or one_step:
                n_plain = 50 if one_step else 2 * depth
                call(plain, on_shards, xs["bf16"], o, depth, bf)
                _, p_ms = timed(torch, lambda: call(plain, on_shards, xs["bf16"], o, n_plain, bf))
                p_ms /= n_plain
            log(f"  {name} {nx}x{nx}{' (4 shards)' if on_shards else ''}, same loop: bf16 "
                f"{1e3 * ms['bf16']:.2f} us/step ({nx * nx / ms['bf16'] / 1e3:.1f} MLUPS), c16 "
                f"{1e3 * ms['c16']:.2f}, f32 {1e3 * ms[None]:.2f} us/step"
                + (f"; bf16 plain {1e3 * p_ms:.2f} us/step" if p_ms else ""))
            if nx == (1024 if one_step else 2048):
                out[name] += [ms["bf16"], p_ms, ms[None], ms["c16"]]
            elif one_step:
                out[name + " 2048"] = ms["bf16"]
            del cells, nobst, xs, o
    log(f"  auto at bf16: K1 {1e3 * out['K1'][1]:.2f} vs K2 {1e3 * out['K2'][1]:.2f} us/step at "
        f"1024^2, K1 {1e3 * out['K1 2048']:.2f} vs K2 {1e3 * out['K2 2048']:.2f} at 2048^2")
    return out


def bf16_path_phase(torch, cli, gpu_line, forms, slab_cfg):
    """Phase 22; returns {counter name: bf16 launches}."""
    from lbm_tpu_torch.ops import (aa, band, band2, band3, deep, shard_step, slab, step,
                                   temporal)

    fns = {"K1": step.run_step, "K2": aa.run_aa, "K7": band.run_band, "K9": band2.run_band2,
           "K11": band3.run_band3, "K5": temporal.run_temporal, "K6": deep.run_deep,
           "K13": slab.run_band_slab, "K3": shard_step.run_shard_step,
           "K8": band.run_band_sharded, "K10": band2.run_band2_sharded}
    for fn in (*fns.values(), shard_step.run_shard_overlap):
        fn.launches = 0
        fn.launches_c16 = fn.launches_bf16 = 0
    want = dict.fromkeys(fns, 0)
    want_k12 = 0
    kernel_of = {"pallas": "K1", "aa": "K2", "band": "K7", "band2": "K9", "band3": "K11",
                 "temporal": "K5", "deep": "K6"}
    mesh_kernel_of = {"pallas": "K3", "band": "K8", "band2": "K10"}
    kt = slab_cfg[3] * slab_cfg[1]

    def account(stats, n=None):
        nonlocal want_k12
        route, n = stats["route"], stats["max_iters"] if n is None else n
        check(stats["precision"] == "bf16", f"a bf16 run ran at {stats['precision']}")
        if "x" in stats["mesh"]:
            check(route == "reference", f"--mesh {stats['mesh']} bf16 routed {route}")
            return
        if stats["mesh"] != "0":
            check(all(sh["device"] == "cuda:0" for sh in stats["shards"]),
                  f"shards not all on cuda:0: {stats['shards']}")
            if route == "pallas-overlap":  # the f32 K12 between two casts
                want_k12 += n
                return
            name, rem = mesh_kernel_of[route], "K3"
        elif route == "slab":
            want["K13"] += n // kt * kt
            n %= kt
            name, rem = "K7", "K1"
        else:
            name, rem = kernel_of[route], "K1"
        depth = forms[name][2]
        want[name] += n // depth * depth
        want[rem] += n % depth

    gates = {}
    with tempfile.TemporaryDirectory() as work:
        for tag in ("256x256", "1024x1024"):
            for backend in ("auto", "aa", "pallas", "band3"):
                stats = run_deck(cli, tag, backend, work, gpu_line, precision="bf16", gate=None)
                gates[tag, backend] = stats.get("gate")
                check(backend != "auto" or stats["route"] == AUTO_ROUTE_BF16,
                      f"{tag} bf16: auto routed {stats['route']}, not {AUTO_ROUTE_BF16}")
                account(stats)
        for backend in ("band", "band2", "temporal", "deep"):
            stats = run_deck(cli, "1024x1024", backend, work, gpu_line, precision="bf16",
                             gate=None)
            gates["1024x1024", backend] = stats.get("gate")
            account(stats)
        os.environ["LBM_ENABLE_SLAB"] = "1"  # the quarantined route
        try:
            stats = run_deck(cli, "1024x1024", "slab", work, gpu_line, precision="bf16", gate=None)
            gates["1024x1024", "slab"] = stats.get("gate")
            account(stats)
        finally:
            del os.environ["LBM_ENABLE_SLAB"]
        for backend in ("auto", "band", "band2", "pallas-overlap"):
            stats = run_deck(cli, "1024x1024", backend, work, gpu_line, mesh="4",
                             precision="bf16", gate=None)
            gates["1024x1024 mesh 4", backend] = stats.get("gate")
            check(backend != "auto" or stats["route"] == "pallas",
                  f"--mesh 4 bf16 auto routed {stats['route']}, not pallas (K3)")
            account(stats)
        for stats in mesh_2d_run(cli, work, gpu_line, precision="bf16"):
            account(stats)
        # K2 rounds every step and a bf16 checkpoint holds the state's exact
        # values, so the resumed run writes the uninterrupted run's bytes.
        for n in resume_run(cli, work, gpu_line, backend="auto", precision="bf16"):
            account({"route": "aa", "mesh": "0", "precision": "bf16", "max_iters": n})
    got = {name: fn.launches_bf16 for name, fn in fns.items()}
    log("  bf16 launch counters: " + ", ".join(f"{k} {got[k]} steps (want {want[k]})"
                                               for k in got)
        + f"; K12 (f32 form between casts) {shard_step.run_shard_overlap.launches} (want "
        f"{want_k12})")
    for k, n in got.items():
        check(n == want[k], f"{k}: not every step of the bf16 path ran in its bf16 form")
        check(n > 0, f"{k}: a bf16 form of the path was never launched")
    check(shard_step.run_shard_overlap.launches == want_k12 > 0,
          "--mesh 4 --backend pallas-overlap at bf16 did not run every step in K12")
    moved = {k: (fn.launches, fn.launches_c16) for k, fn in fns.items()
             if fn.launches or fn.launches_c16}
    check(not moved, f"an f32 or c16 counter moved on the bf16 path: {moved}")
    return got, gates

# K4's shared-memory form in the report.
RESIDENT_SMEM = ("K4 resident, shared-memory form (slabs held on the SMs, one barrier per T "
                 "steps)", "lbm_tpu_torch/csrc/resident.cu", "lbm_tpu/ops/pallas_resident.py:66")
# (nx, ny) of phase 23: the three small official decks, 384^2 and a ragged grid.
K4_SIZES = ((128, 128), (128, 256), (256, 256), (384, 384), (130, 250))
# Steps of a timed K4 run: ten 255-step launches.
K4_TIMED_STEPS = 2550


def turns(torch, fns, n):
    """{name: us per step}, the best of two runs of each of ``fns`` (name ->
    fn running ``n`` steps), timed in turns forward and back after a warm-up."""
    for fn in fns.values():
        fn()
    out = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        out[name].append(1e3 * timed(torch, fns[name])[1] / n)
    return {name: min(v) for name, v in out.items()}


def barrier_floor(torch, blocks, threads, syncs=2000):
    """us per grid.sync() of a cooperative launch of blocks x threads that
    does nothing else (csrc/resident.cu::grid_sync_kernel)."""
    from lbm_tpu_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        rc = lib.lbm_grid_sync_probe(blocks, threads, syncs, stream)
        check(rc == 0, f"barrier probe ({blocks} x {threads}): CUDA error {rc}")

    go()
    return 1e3 * timed(torch, go)[1] / syncs


def k4_smem_phase(torch, gpu_line):
    """Phase 23; returns (max_abs_err, {(nx, ny): {form: us per step}}, the
    plain version's ms per step at 256^2)."""
    from lbm_tpu_torch.ops import resident
    from lbm_tpu_torch.ops.aa import run_aa
    from lbm_tpu_torch.ops.band_common import SMEM_LIMIT

    dev = torch.device("cuda", 0)
    sms, k4_blocks = resident.sm_count(dev), resident.max_blocks(dev)
    for blocks, threads in ((k4_blocks, resident._THREADS), (sms, 512)):
        log(f"  barrier floor: {barrier_floor(torch, blocks, threads):.3f} us per grid.sync() "
            f"of {blocks} blocks x {threads} threads [{gpu_line}]")

    def run(fn, c, o, n):
        return fn(c, o, DENSITY, ACCEL, OMEGA, n, 1.0)

    errs = []
    for nx, ny in K4_SIZES:
        cells, nobst = random_setup(torch, nx, ny, seed=nx + ny)
        cfg = resident.resident_smem_config(ny, nx, sms)
        check(cfg is not None, f"K4: no shared-memory schedule for {nx}x{ny}")
        for n in (254, 255, 256, 511):
            before = resident.run_resident.launches_smem
            got = run(resident.run_resident, cells, nobst, n)
            check(resident.run_resident.launches_smem == before + n,
                  f"K4 {nx}x{ny}: not run in the shared-memory form")
            errs.append(compare(torch, f"K4 smem {nx}x{ny} {n} steps ({cfg[0]} blocks of {cfg[1]} "
                                f"rows, T {cfg[2]})", got,
                                run(resident.run_resident_plain, cells, nobst, n)))
        again = run(resident.run_resident, cells, nobst, 511)
        torch.cuda.synchronize()
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              f"K4 smem {nx}x{ny} is not run-to-run deterministic")
        # A run split where no pass ends (101 + 154 steps) gives the 255-step
        # run bit for bit: each step's sum adds its terms in one order.
        head = run(resident.run_resident, cells, nobst, 101)
        tail = run(resident.run_resident, head[0], nobst, 154)
        whole = run(resident.run_resident, cells, nobst, 255)
        torch.cuda.synchronize()
        check(torch.equal(tail[0], whole[0]) and torch.equal(torch.cat([head[1], tail[1]]),
                                                             whole[1]),
              f"K4 smem {nx}x{ny}: a run split at step 101 differs from the whole run")
    log("  K4 smem determinism: two 511-step runs of each grid give bitwise-equal av and state, "
        "and a 255-step run split at step 101 gives the whole run's bits")
    for nx, ny in (K4_SIZES[0], K4_SIZES[-1]):
        cells, nobst = random_setup(torch, nx, ny, seed=5)
        cfg = resident.resident_smem_config(ny, nx, sms)
        compare(torch, f"K4 smem vs run_resident_slabs_plain {nx}x{ny} 9 steps",
                run(resident.run_resident, cells, nobst, 9),
                resident.run_resident_slabs_plain(cells, nobst, DENSITY, ACCEL, OMEGA, 9, 1.0,
                                                  cfg[1], cfg[2]))
    per, n = {}, K4_TIMED_STEPS
    for nx, ny in K4_SIZES[:4]:
        cells, nobst = random_setup(torch, nx, ny, seed=7)
        cfg = resident.resident_smem_config(ny, nx, sms)
        blocks = k4_grid(resident, ny, nx)
        per[nx, ny] = turns(torch, {
            "global-memory form": lambda: resident.launch(cells, nobst, DENSITY, ACCEL, OMEGA, n,
                                                          1.0, 255, blocks),
            "shared-memory form": lambda: resident.launch_smem(cells, nobst, DENSITY, ACCEL,
                                                               OMEGA, n, 1.0, 255, cfg),
            "K2": lambda: run(run_aa, cells, nobst, n)}, n)
        t = per[nx, ny]
        log(f"  K4 {nx}x{ny}: shared-memory form {t['shared-memory form']:.3f} us/step "
            f"({cfg[0]} blocks of {cfg[1]} rows, T {cfg[2]}), global-memory form "
            f"{t['global-memory form']:.3f}, K2 {t['K2']:.3f} (in turns); "
            f"{t['global-memory form'] / t['shared-memory form']:.2f}x [{gpu_line}]")
        if nx == ny and nx < 384:  # the schedule sweep: rows per block and T
            sweep = {}
            for rows in (-(-ny // sms), -(-ny // (sms // 2))):
                for depth in (1, 2, 3, 4, 6):
                    smem = resident.resident_smem_bytes(nx, rows, depth)
                    if smem <= SMEM_LIMIT:
                        cf = (-(-ny // rows), rows, depth, smem)
                        sweep[rows, depth] = turns(torch, {0: lambda: resident.launch_smem(
                            cells, nobst, DENSITY, ACCEL, OMEGA, n, 1.0, 255, cf)}, n)[0]
            log(f"  K4 {nx}x{ny} shared-memory schedules (rows, T: us/step): "
                + ", ".join(f"{r}, {d}: {v:.3f}" for (r, d), v in sweep.items()))
    cells, nobst = random_setup(torch, 256, 256, seed=7)
    run(resident.run_resident_plain, cells, nobst, 5)
    _, p_ms = timed(torch, lambda: run(resident.run_resident_plain, cells, nobst, 50))
    return max(errs), per, p_ms / 50


def k11_phase(torch, spec, gpu_line, cfg):
    """Phase 24."""
    from lbm_tpu_torch.ops import band3, devspace
    from lbm_tpu_torch.ops.aa import run_aa

    block, depth, panel = cfg
    forms = {"f32": None, "c16": spec, "bf16": devspace.BF16}

    def k11(c, o, n, dev):
        return band3.run_band3(c, o, DENSITY, ACCEL, OMEGA, n, block, depth, panel=panel,
                               dev=dev)

    grids = {"1024x1024": random_setup(torch, 1024, 1024, seed=29), "walls 1000x1000":
             walls_setup(torch, 1000, 31), "998x1000": random_setup(torch, 998, 1000, seed=37)}
    for name, dev in forms.items():
        for tag, (cells, nobst) in grids.items():
            q = cells if dev is None else devspace.encode_state(cells, dev)
            for n in (depth, 2 * depth + 3):
                got = k11(q, nobst, n, dev)
                want = band3.run_band3_plain(q, nobst, DENSITY, ACCEL, OMEGA, n, block, depth,
                                             panel=panel, dev=dev)
                what = f"K11 {name} {tag} {n} steps"
                if name == "bf16":
                    bf16_compare(torch, what, got, want,
                                 TOL_BF16 if n == depth else TOL_BF16_SPREAD)
                else:
                    compare(torch, what, got, want, dev)
            again = k11(q, nobst, 2 * depth + 3, dev)
            torch.cuda.synchronize()
            check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                  f"K11 {name} {tag} is not run-to-run deterministic")
    log("  K11 determinism: two runs of each form and grid give bitwise-equal av and state")
    del grids
    for nx, n in ((1024, 800), (2048, 400), (4096, 100)):
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        n -= n % depth
        for name, dev in forms.items():
            q = cells if dev is None else devspace.encode_state(cells, dev)
            t = turns(torch, {"K11": lambda: k11(q, nobst, n, dev),
                              "K2": lambda: run_aa(q, nobst, DENSITY, ACCEL, OMEGA, n, 1.0,
                                                   dev=dev)}, n)
            log(f"  K11 {name} {nx}x{nx}: {t['K11']:.2f} us/step, K2 {t['K2']:.2f} us/step "
                f"(in turns): K11/K2 {t['K11'] / t['K2']:.3f} [{gpu_line}]")
        del cells, nobst


# (nx, ny) of phase 25's sweep: the squares around K4's limit and the
# 128x256 deck's shape. Its runs take CROSSOVER_STEPS steps, a multiple of
# every T of the driver's schedules.
CROSSOVER_SIZES = ((128, 256), (256, 256), (384, 384), (448, 448), (512, 512), (640, 640),
                   (768, 768), (1024, 1024))
CROSSOVER_STEPS = 2520


def crossover_phase(torch, gpu_line):
    """Phase 25: the routes auto may take at f32, in turns at CROSSOVER_SIZES,
    each at the driver's schedule: K4 (the form run_resident picks), K6, K7,
    K9 and K11; returns {(nx, ny): {kernel: us per step}}."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band, band2, band3, deep, resident
    from lbm_tpu_torch.runtime.driver import pass_schedule, select_route

    sms = resident.sm_count(torch.device("cuda", 0))
    n = CROSSOVER_STEPS
    runs = {"K6": ("deep", deep.run_deep), "K7": ("band", band.run_band),
            "K9": ("band2", band2.run_band2), "K11": ("band3", band3.run_band3)}
    out = {}
    for nx, ny in CROSSOVER_SIZES:
        params = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=DENSITY,
                           accel=ACCEL, omega=OMEGA)
        cells, nobst = random_setup(torch, nx, ny, seed=3)
        fns = {"K4": lambda: resident.run_resident(cells, nobst, DENSITY, ACCEL, OMEGA, n, 1.0)}
        cfgs = {}
        for name, (route, fn) in runs.items():
            cfgs[name] = b, t, p = pass_schedule(route, params, torch.float32)[1]
            fns[name] = (lambda fn=fn, b=b, t=t, p=p: fn(cells, nobst, DENSITY, ACCEL, OMEGA, n,
                                                         b, t, panel=p))
        t = out[nx, ny] = turns(torch, fns, n)
        form = "shared-memory" if resident.resident_smem_config(ny, nx, sms) else "global-memory"
        best = min(t, key=t.get)
        log(f"  {nx}x{ny} (us/step in turns): K4 ({form} form) {t['K4']:.3f}, "
            + ", ".join(f"{k} {cfgs[k]} {t[k]:.3f}" for k in runs)
            + f": {best} fastest; auto routes {select_route(params, 'auto', torch.float32)} "
            f"[{gpu_line}]")
        del cells, nobst
    return out


# (nx, ny, py) of phase 26's K3 grids: 1024^2 and 1000^2 on 4 row shards,
# 1001 columns (an odd rx) on 4, and 1024^2 on a 2 x 1 mesh.
K3_16_GRIDS = ((1024, 1024, 4), (1000, 1000, 4), (1001, 1024, 4), (1024, 1024, 2))
# (nx, ny, (block, depth, panel)) of phase 26's K9 checks: T 4, 8 and 16,
# full row (panel None) and panel, on ragged grids.
K9_CHECKS = ((100, 97, (24, 4, 56)), (100, 97, (8, 4, None)), (150, 100, (16, 8, 40)),
             (130, 100, (16, 8, None)), (200, 150, (32, 16, 40)), (40, 70, (32, 16, None)))
# Phase 26's K9 schedule sweep (block, depth, panel), T 4 and 8: at 2048^2,
# and the smaller tiles at the sizes where the large ones leave SMs idle.
K9_SWEEP = {2048: ((24, 4, 24), (24, 4, 56), (32, 4, 56), (24, 4, 72), (40, 4, 40), (40, 4, 48),
                   (16, 4, 56), (48, 8, 56)),
            256: ((16, 4, 24), (24, 4, 24), (16, 4, 40), (24, 4, 40), (32, 4, 56)),
            512: ((16, 4, 24), (24, 4, 24), (24, 4, 40), (32, 4, 56)),
            1024: ((24, 4, 24), (24, 4, 40), (32, 4, 56))}


def cluster_floor(torch, blocks, threads, cluster, syncs=2000):
    """us per cluster.sync() of a launch of blocks x threads in clusters of
    ``cluster`` that does nothing else (csrc/band2.cu::cluster_sync_loop)."""
    from lbm_tpu_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        rc = lib.lbm_cluster_sync_probe(blocks, threads, cluster, syncs, stream)
        check(rc == 0, f"cluster barrier probe ({blocks} x {threads} / {cluster}): CUDA error {rc}")

    go()
    return 1e3 * timed(torch, go)[1] / syncs


def redesign9_turns(torch, spec, gpu_line):
    """Phase 26's times: K3 at f32, c16 and bf16 beside K1 of the same
    storage (4 row shards), K9 beside K11 and K2 of the same storage, in turns at
    1024^2-4096^2, with the driver's schedules of the imported package."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band2, band3, devspace, shard_step
    from lbm_tpu_torch.ops.aa import run_aa
    from lbm_tpu_torch.ops.step import run_step

    params = LBMParams(nx=2048, ny=2048, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    k9_cfg, k11_cfg = band2.schedule(params, torch.float32), band3.schedule(params, torch.float32)
    forms = {"f32": None, "c16": spec, "bf16": devspace.BF16}
    out = {}
    for nx, n in ((1024, 400), (2048, 200), (4096, 48)):
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        for name, dev in forms.items():
            q = cells if dev is None else devspace.encode_state(cells, dev)
            s, o = on_mesh(q, nobst, 4, 1)
            t = turns(torch, {
                "K3": lambda: shard_step.run_shard_step(s, o, DENSITY, ACCEL, OMEGA, n, nx,
                                                        dev=dev),
                "K1": lambda: run_step(q, nobst, DENSITY, ACCEL, OMEGA, n, 1.0, dev=dev)}, n)
            out["K3", name, nx] = t
            log(f"  K3 {name} {nx}x{nx} (4 shards): {t['K3']:.2f} us/step, K1 {t['K1']:.2f} "
                f"(in turns): K3/K1 {t['K3'] / t['K1']:.3f} [{gpu_line}]")
            del s, o
            m = 2 * n - 2 * n % k9_cfg[1]

            def band(fn, cfg):
                return lambda: fn(q, nobst, DENSITY, ACCEL, OMEGA, m, cfg[0], cfg[1], panel=cfg[2],
                                  dev=dev)

            t = turns(torch, {"K9": band(band2.run_band2, k9_cfg),
                              "K11": band(band3.run_band3, k11_cfg),
                              "K2": lambda: run_aa(q, nobst, DENSITY, ACCEL, OMEGA, m, 1.0,
                                                   dev=dev)}, m)
            out["K9", name, nx] = t
            log(f"  K9 {name} {nx}x{nx} {k9_cfg}: {t['K9']:.2f} us/step, K11 {t['K11']:.2f}, K2 "
                f"{t['K2']:.2f} (in turns): K9/K11 {t['K9'] / t['K11']:.3f}, K9/K2 "
                f"{t['K9'] / t['K2']:.3f} [{gpu_line}]")
        del cells, nobst
    return out


def k9_checks(torch, spec, skip_refused=False):
    """K9 at f32, c16 and bf16 against its plain version (K9_CHECKS), two
    runs bitwise equal; at f32 on the driver's schedule, against K1 over 200
    steps at 1024^2 (phase 7's verdict printed, its tolerance held).
    ``skip_refused``: pass over a schedule whose window the package refuses
    (an imported older package), saying so."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band2, devspace
    from lbm_tpu_torch.ops import band_common as BC
    from lbm_tpu_torch.ops.step import run_step

    checks = []
    for nx, ny, cfg in K9_CHECKS:
        try:
            BC.check_smem("band2 kernel", band2.PLANE_COPIES, nx, *cfg)
            checks.append((nx, ny, cfg))
        except ValueError as e:
            check(skip_refused, str(e))
            log(f"  K9 {nx}x{ny} {cfg}: not checked, the package refuses it ({e})")
    for name, dev in {"f32": None, "c16": spec, "bf16": devspace.BF16}.items():
        for nx, ny, (block, depth, panel) in checks:
            cells, nobst = random_setup(torch, nx, ny, seed=nx + depth)
            q = cells if dev is None else devspace.encode_state(cells, dev)
            n = 2 * depth + 3

            def k9(fn):
                return fn(q, nobst, DENSITY, ACCEL, OMEGA, n, block, depth, panel=panel, dev=dev)

            got, again = k9(band2.run_band2), k9(band2.run_band2)
            want = k9(band2.run_band2_plain)
            what = f"K9 {name} {nx}x{ny} T {depth} {'panel ' + str(panel) if panel else 'full row'}"
            if name == "bf16":
                bf16_compare(torch, what, got, want, TOL_BF16_SPREAD)
            else:
                compare(torch, what, got, want, dev)
            check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                  f"{what}: not run-to-run deterministic")
    log("  K9 determinism: two runs of each schedule give bitwise-equal av and state")
    params = LBMParams(nx=1024, ny=1024, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    block, depth, panel = band2.schedule(params, torch.float32)
    cells, nobst = random_setup(torch, 1024, 1024, seed=5)
    got = band2.run_band2(cells, nobst, DENSITY, ACCEL, OMEGA, 200, block, depth, panel=panel)
    k1 = run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 200, 1.0)
    torch.cuda.synchronize()
    what = f"K9 f32 {(block, depth, panel)} vs K1 1024x1024 200 steps"
    log(f"  {what}: final state bitwise equal: {torch.equal(got[0], k1[0])}, max diff "
        f"{float((got[0] - k1[0]).abs().max()):.3e}")
    compare(torch, what, got, k1)


def redesign9_phase(torch, spec, gpu_line):
    """Phase 26: the cluster barrier's floor; K3's 16-bit forms against their
    plain version and K1 (bitwise); K9 against its plain version at T 4, 8
    and 16; both timed beside their rivals (redesign9_turns); K9's schedule
    sweep at 2048^2."""
    from lbm_tpu_torch.ops import band2, band3, devspace, resident, shard_step
    from lbm_tpu_torch.ops.step import run_step

    sms = resident.sm_count(torch.device("cuda", 0))
    for cluster in (1, 2, 4, 8):
        log(f"  cluster barrier floor: {cluster_floor(torch, 2 * sms, 512, cluster):.3f} us per "
            f"cluster.sync() of {2 * sms} blocks x 512 threads in clusters of {cluster} "
            f"[{gpu_line}]")
    forms16 = {"c16": spec, "bf16": devspace.BF16}
    for name, dev in forms16.items():
        for nx, ny, py in K3_16_GRIDS:
            cells, nobst = random_setup(torch, nx, ny, seed=nx + py)
            q = devspace.encode_state(cells, dev)
            s, o = on_mesh(q, nobst, py, 1)

            def k3():
                return joined(torch, shard_step.run_shard_step(s, o, DENSITY, ACCEL, OMEGA, 50,
                                                               ny, dev=dev))

            got, again = k3(), k3()
            k1 = run_step(q, nobst, DENSITY, ACCEL, OMEGA, 50, 1.0, dev=dev)
            torch.cuda.synchronize()
            what = f"K3 {name} {nx}x{ny} ({py} shards, rx {nx}) 50 steps"
            check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                  f"{what}: not run-to-run deterministic")
            check(torch.equal(got[0], k1[0]), f"{what}: state differs from K1's")
            av_rel = float(((got[1].double() - k1[1].double()).abs() / k1[1].double().abs()).max())
            check(av_rel <= 1e-6, f"{what}: av differs from K1's by {av_rel}")
            log(f"  {what}: state bitwise K1's, av within {av_rel:.2e} of K1's, two runs "
                "bitwise equal")
            if nx != 1024:  # the plain version on the ragged and odd-rx grids
                want = joined(torch, shard_step.run_shard_step_plain(s, o, DENSITY, ACCEL, OMEGA,
                                                                     50, ny, dev=dev))
                if name == "bf16":
                    bf16_compare(torch, f"{what} vs plain", got, want, TOL_BF16_SPREAD)
                else:
                    compare(torch, f"{what} vs plain", got, want, dev)
            del cells, nobst, q, s, o, got, again, k1
    k9_checks(torch, spec)
    redesign9_turns(torch, spec, gpu_line)
    for nx, schedules in K9_SWEEP.items():
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        n = 400 * 2048 // nx
        fns = {cfg: (lambda cfg=cfg: band2.run_band2(cells, nobst, DENSITY, ACCEL, OMEGA, n,
                                                     cfg[0], cfg[1], panel=cfg[2]))
               for cfg in schedules}
        fns["K11"] = lambda: band3.run_band3(cells, nobst, DENSITY, ACCEL, OMEGA, n, 24, 4,
                                             panel=56)
        t = turns(torch, fns, n)
        log(f"  K9 schedules at {nx}^2 f32 ((block, depth, panel): us/step, in turns beside K11 "
            f"{t['K11']:.3f}): " + ", ".join(f"{cfg}: {t[cfg]:.3f}" for cfg in schedules)
            + f" [{gpu_line}]")



# (nx, ny, (block, depth, panel)) of phase 27's K5 and K6 checks: T 3, 4 and
# 8, ragged tiles (the last row block as short as T rows), a full row, and
# a single tile that wraps onto itself (ny < block); k56_checks adds every
# schedule of the driver's K5 and K6 tiers on a grid ragged both ways.
K56_CHECKS = ((100, 100, (32, 4, 56)), (97, 97, (20, 3, 24)), (150, 104, (24, 8, 40)),
              (130, 75, (16, 3, None)), (70, 12, (16, 4, 20)))
# Phase 27's K5 and K6 schedule sweep (block, depth, panel) at 2048^2 and
# 4096^2, and the smaller tiles at the sizes where the large ones leave SMs
# idle. Its process builds every candidate's window with constant strides.
K56_SWEEP = {n: ((32, 4, 56), (24, 4, 56), (32, 4, 72), (40, 4, 48), (24, 4, 24), (32, 4, 24),
                 (32, 4, 40), (32, 4, 48), (36, 4, 56))
             for n in (2048, 4096)}
K56_SWEEP.update({n: ((16, 4, 24), (24, 4, 24), (32, 4, 24), (16, 4, 40), (32, 4, 40),
                      (32, 4, 56), (36, 4, 56)) for n in (256, 512, 1024, 1536)})
# Phase 33's sweep at 1024^2 and 2048^2: the tier's schedule and cuts of
# 1024^2 into whole rounds of two blocks on 132 SMs whose window holds two
# blocks per SM (528 tiles: (47, 4, 43), (43, 4, 47), (43, 4, 48); 522:
# (36, 4, 57); 513: (38, 4, 54)), and windows of 44 rows whose panel is a
# multiple of 8 columns or not.
K56_WAVES = {n: ((36, 4, 56), (47, 4, 43), (43, 4, 47), (43, 4, 48), (36, 4, 57), (38, 4, 54),
                 (36, 4, 48), (36, 4, 52)) for n in (1024, 2048)}
# (ny, nx) of phase 33's times per pass at the tier's (36, 4, 56): grids of
# whole tiles making 1, 2, 3, 4 and 8 rounds of 264, and the decks' sides.
K56_ROUND_GRIDS = ((792, 672), (792, 1344), (1188, 1344), (1584, 1344), (1584, 2688),
                   (1008, 1008), (1024, 1024), (1536, 1536), (2048, 2048))


def k56_routes():
    """route -> (name, kernel, plain): K5 and K6 with the signature
    fn(cells, nobst, n, block, depth, panel, dev)."""
    from lbm_tpu_torch.ops import deep, temporal

    def bind(fn):
        return lambda c, o, n, block, depth, panel, dev: fn(c, o, DENSITY, ACCEL, OMEGA, n, block,
                                                            depth, panel=panel, dev=dev)

    return {"temporal": ("K5", bind(temporal.run_temporal), bind(temporal.run_temporal_plain)),
            "deep": ("K6", bind(deep.run_deep), bind(deep.run_deep_plain))}


def k56_checks(torch, spec, skip_refused=False):
    """K5 and K6 at f32, c16 and bf16 against their plain versions over 2T+3
    steps (K56_CHECKS and the schedules of the driver's tiers), two runs
    bitwise equal; K5 one pass from packs that differ from the state's
    rows; at f32 on the driver's schedules against K1 over 200 steps at
    1024^2 (bitwise or not printed, the tolerance held). ``skip_refused``:
    pass over a schedule the package refuses (an imported older package),
    saying so."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import devspace, temporal
    from lbm_tpu_torch.ops import band_common as BC
    from lbm_tpu_torch.ops.step import run_step
    from lbm_tpu_torch.runtime import driver

    routes = k56_routes()
    tiers = tuple(cfg for cfg, _ in getattr(temporal, "TRAPEZOID_TIERS", ()))
    checks = []
    for nx, ny, cfg in K56_CHECKS + tuple((2 * p - 7, 2 * b - 5, (b, t, p)) for b, t, p in tiers):
        try:
            BC.check_smem("temporal kernel", temporal.PLANE_COPIES, nx, *cfg)
            checks.append((nx, ny, cfg))
        except ValueError as e:
            check(skip_refused, str(e))
            log(f"  K5/K6 {nx}x{ny} {cfg}: not checked, the package refuses it ({e})")
    forms = {"f32": None, "c16": spec, "bf16": devspace.BF16}
    for name, dev in forms.items():
        for nx, ny, (block, depth, panel) in checks:
            cells, nobst = random_setup(torch, nx, ny, seed=nx + ny + depth)
            q = cells if dev is None else devspace.encode_state(cells, dev)
            n = 2 * depth + 3
            for route, (label, kernel, plain) in routes.items():
                got = kernel(q, nobst, n, block, depth, panel, dev)
                again = kernel(q, nobst, n, block, depth, panel, dev)
                want = plain(q, nobst, n, block, depth, panel, dev)
                what = (f"{label} {name} {nx}x{ny} T {depth} block {block} "
                        f"{'panel ' + str(panel) if panel else 'full row'}")
                if name == "bf16":
                    bf16_compare(torch, what, got, want, TOL_BF16_SPREAD)
                else:
                    compare(torch, what, got, want, dev)
                check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                      f"{what}: not run-to-run deterministic")
        # One K5 pass from packs that differ from the state's rows.
        cells, nobst = random_setup(torch, 70, 97, seed=41)
        q = cells if dev is None else devspace.encode_state(cells, dev)
        for depth in (3, 4):
            last, first = temporal.make_halos_t(q, 20, depth)
            if name == "c16":
                state = (q, last + 3, first - 3)
            else:
                state = (q, (last.float() * 1.01).to(q.dtype), (first.float() * 0.99).to(q.dtype))
            got, av = temporal.step_t(state, nobst, DENSITY, ACCEL, OMEGA, 20, depth, panel=32,
                                      dev=dev)
            want, want_av = temporal.step_t_plain(state, nobst, DENSITY, ACCEL, OMEGA, 20, depth,
                                                  dev=dev)
            what = f"K5 {name} one pass from other packs, T {depth}"
            if name == "bf16":
                bf16_compare(torch, what, (got[0], av), (want[0], want_av), TOL_BF16)
            else:
                compare(torch, what, (got[0], av), (want[0], want_av), dev)
            if dev is None:
                for g, w in zip(got[1:], want[1:]):
                    check(float((g - w).abs().max()) <= TOL_CELLS * float(w.abs().max()),
                          f"{what}: the packs differ from the plain pass's")
            else:
                own_last, own_first = temporal.make_halos_t(got[0], 20, depth)
                check(torch.equal(got[1], own_last) and torch.equal(got[2], own_first),
                      f"{what}: the packs are not the bits of the state rows they copy")
    log(f"  K5 and K6 determinism: two runs of each of {len(checks)} schedules give "
        "bitwise-equal av and state")
    params = LBMParams(nx=1024, ny=1024, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    cells, nobst = random_setup(torch, 1024, 1024, seed=5)
    k1 = run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 200, 1.0)
    for route, (label, _, _) in routes.items():
        run, (block, depth, panel) = driver.pass_schedule(route, params, torch.float32)
        got = run(cells, nobst, DENSITY, ACCEL, OMEGA, 200, block, depth, panel=panel)
        torch.cuda.synchronize()
        what = f"{label} f32 {(block, depth, panel)} vs K1 1024x1024 200 steps"
        log(f"  {what}: final state bitwise equal: {torch.equal(got[0], k1[0])}, max diff "
            f"{float((got[0] - k1[0]).abs().max()):.3e}")
        compare(torch, what, got, k1)


def redesign10_turns(torch, spec, gpu_line):
    """Phase 27's times: K5 and K6 beside K9 and K11 of the same storage, in
    turns at 1024^2-4096^2, with the driver's schedules of the imported
    package; returns {(name, storage, n): {kernel: us per step}}."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band2, band3, deep, devspace, temporal
    from lbm_tpu_torch.runtime.driver import pass_schedule

    forms = {"f32": None, "c16": spec, "bf16": devspace.BF16}
    out = {}
    for nx, n in ((1024, 800), (2048, 240), (4096, 64)):
        params = LBMParams(nx=nx, ny=nx, max_iters=1, reynolds_dim=10, density=DENSITY,
                           accel=ACCEL, omega=OMEGA)
        cfg = {route: pass_schedule(route, params, torch.float32)[1]
               for route in ("temporal", "deep", "band2", "band3")}
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        for name, dev in forms.items():
            q = cells if dev is None else devspace.encode_state(cells, dev)

            def pas(fn, route):
                b, t, p = cfg[route]
                return lambda: fn(q, nobst, DENSITY, ACCEL, OMEGA, n, b, t, panel=p, dev=dev)

            t = turns(torch, {"K5": pas(temporal.run_temporal, "temporal"),
                              "K6": pas(deep.run_deep, "deep"),
                              "K9": pas(band2.run_band2, "band2"),
                              "K11": pas(band3.run_band3, "band3")}, n)
            out[name, nx] = t
            log(f"  {name} {nx}x{nx} (K5 {cfg['temporal']}, K6 {cfg['deep']}): K5 {t['K5']:.2f} "
                f"us/step, K6 {t['K6']:.2f}, K9 {t['K9']:.2f}, K11 {t['K11']:.2f} (in turns): "
                f"K5/K9 {t['K5'] / t['K9']:.3f}, K6/K9 {t['K6'] / t['K9']:.3f}, K5/K11 "
                f"{t['K5'] / t['K11']:.3f}, K6/K11 {t['K6'] / t['K11']:.3f} [{gpu_line}]")
        del cells, nobst
    return out


def k56_gate_decks(cli, gpu_line):
    """The c16 decks of phase 19 for K5 and K6 (``temporal``, ``deep`` on
    256^2 and 1024^2), their 1% verdict printed and held at PASS_GATE_C16."""
    with tempfile.TemporaryDirectory() as work:
        for tag in ("256x256", "1024x1024"):
            for backend in ("temporal", "deep"):
                run_deck(cli, tag, backend, work, gpu_line, precision="c16", gate=PASS_GATE_C16)


def k56_sweep(torch, gpu_line, sweep):
    """K5's and K6's schedules (``sweep``: side -> schedules) at f32 in turns
    beside K11, and K6's registers and blocks per SM on each window."""
    from lbm_tpu_torch.ops import band3, deep

    routes = k56_routes()
    for nx, schedules in sweep.items():
        if hasattr(deep, "kernel_attrs"):
            log(f"  K6 f32 at {nx}^2 (registers, local bytes, blocks of 512 per SM): "
                + ", ".join(f"{cfg}: {deep.kernel_attrs(nx, nx, *cfg)}" for cfg in schedules))
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        n = max(8, 240 * 2048 // nx) // 8 * 8
        for route, (label, kernel, _) in routes.items():
            fns = {cfg: (lambda cfg=cfg: kernel(cells, nobst, n, *cfg, None)) for cfg in schedules}
            fns["K11"] = lambda: band3.run_band3(cells, nobst, DENSITY, ACCEL, OMEGA, n, 24, 4,
                                                 panel=56)
            t = turns(torch, fns, n)
            log(f"  {label} schedules at {nx}^2 f32 ((block, depth, panel): us/step, in turns "
                f"beside K11 {t['K11']:.3f}): " + ", ".join(f"{cfg}: {t[cfg]:.3f}"
                                                            for cfg in schedules)
                + f" [{gpu_line}]")
        del cells, nobst


def k56_sweep_main(name="K56_SWEEP"):
    """The body of k56_sweep_process: builds the kernels with every
    candidate's window of the sweep ``name`` (K56_SWEEP, K56_WAVES) at
    constant strides, as the build compiles the windows of the driver's
    schedules, and sweeps."""
    import torch

    from lbm_tpu_torch.ops import _build, temporal

    sweep = globals()[name]
    candidates = tuple(dict.fromkeys(cfg for cfgs in sweep.values() for cfg in cfgs))
    temporal.TRAPEZOID_TIERS = tuple((cfg, 0) for cfg in candidates)
    b = _build.library().build_info
    log(f"  sweep's kernels {'built' if b['built'] else 'loaded'} in {b['seconds']:.1f} s, "
        f"K5 and K6 with constant strides for the windows {b['windows']}")
    k56_sweep(torch, nvidia_smi(), sweep)
    return 0


def k56_sweep_process(name="K56_SWEEP"):
    """Runs k56_sweep_main in a process of its own, so that every candidate
    is timed under the same stride regime."""
    code = f"import sys, chip_smoke; sys.exit(chip_smoke.k56_sweep_main({name!r}))"
    rc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=600).returncode
    check(rc == 0, f"the K5 and K6 schedule sweep {name} exited {rc}")


def k56_pass_times(torch, gpu_line):
    """K5's and K6's us per pass at (36, 4, 56) on K56_ROUND_GRIDS (the best
    of 3 runs of many passes from one C call, CUDA events); a round is
    264 tiles, two blocks on each of an H100's 132 SMs."""
    for ny, nx in K56_ROUND_GRIDS:
        cells, nobst = random_setup(torch, nx, ny, seed=3)
        passes = max(200, int(2e9 // (ny * nx)))
        tiles = -(-ny // 36) * -(-nx // 56)
        line = []
        for route, (label, kernel, _) in k56_routes().items():
            kernel(cells, nobst, 200, 36, 4, 56, None)
            ms = min(timed(torch, lambda: kernel(cells, nobst, 4 * passes, 36, 4, 56, None))[1]
                     for _ in range(3))
            line.append(f"{label} {1e3 * ms / passes:.2f}")
        log(f"  {ny}x{nx}, {tiles} tiles ({tiles / 264:.2f} rounds), us per pass of "
            f"(36, 4, 56): {', '.join(line)} [{gpu_line}]")
        del cells, nobst


def waves_phase(torch, gpu_line):
    """Phase 33: K5's and K6's passes by rounds of blocks, cut and order.
    The sweep K56_WAVES in a process of its own (blocks per SM, times in
    turns); each whole-round cut of 1024^2 against the tier's (36, 4, 56)
    over 2 passes, the state bitwise; the times per pass on
    K56_ROUND_GRIDS."""
    from lbm_tpu_torch.ops import temporal

    k56_sweep_process("K56_WAVES")
    cells, nobst = random_setup(torch, 1024, 1024, seed=33)
    for route, (label, kernel, _) in k56_routes().items():
        want = kernel(cells, nobst, 8, 36, 4, 56, None)
        for cfg in K56_WAVES[1024][1:]:
            got = kernel(cells, nobst, 8, *cfg, None)
            rel = float(((got[1] - want[1]).abs() / want[1].abs()).max())
            check(torch.equal(got[0], want[0]) and rel <= 1e-6,
                  f"{label} {cfg} vs (36, 4, 56) at 1024^2: the state differs or av by {rel:.2e}")
            log(f"  {label} {cfg} vs (36, 4, 56), 1024^2, 2 passes: state bitwise equal, av "
                f"within {rel:.2e} relative; tiles and tail a pass "
                f"{temporal.tiles_of_pass(1024, 1024, cfg[0], cfg[2])}")
    del cells, nobst
    k56_pass_times(torch, gpu_line)


def redesign10_phase(torch, spec, cli, gpu_line):
    """Phase 27: K5 and K6 in one window (AA steps on the trapezoid) against
    their plain versions and K1; timed beside K9 and K11 in turns; the
    schedule sweep; the c16 gate decks."""
    k56_checks(torch, spec)
    redesign10_turns(torch, spec, gpu_line)
    k56_sweep_process()
    k56_gate_decks(cli, gpu_line)


# (nx, ny, (block, depth, panel)) of phase 28's K7 checks: T 1, 3, 4, 5 and
# 8, full row (panel None) and panel, ragged grids, a block shorter than 2T
# (outside K9's domain), and a tile of one row and one column.
K7_CHECKS = ((45, 37, (8, 1, 11)), (100, 97, (24, 3, 56)), (100, 97, (5, 3, None)),
             (100, 97, (24, 4, 20)), (70, 97, (7, 5, 13)), (40, 70, (16, 5, None)),
             (150, 100, (16, 8, 40)), (33, 21, (1, 3, 1)))
# (nx, ny, shards, (block, depth, panel)) of phase 28's K8 checks.
K8_CHECKS = ((70, 100, 4, (16, 3, 20)), (70, 100, 4, (16, 5, None)), (64, 96, 4, (8, 4, 24)),
             (70, 100, 4, (16, 1, 7)))
# Phase 28's K7 schedule sweep (block, depth, panel): T 3, 4, 5 and 8 at
# 1024^2-4096^2, panels whose one-copy window holds two blocks per SM, and
# at 1024^2 the full-row windows that fit a block.
K7_SWEEP = {n: ((32, 4, 56), (24, 4, 56), (36, 4, 56), (40, 4, 48), (24, 4, 24), (32, 3, 56),
                (34, 3, 58), (30, 5, 54), (32, 5, 56), (24, 5, 40), (24, 8, 40), (32, 8, 32))
            for n in (1024, 2048, 4096)}
K7_SWEEP[1024] += ((1, 1, None), (2, 1, None))


def k78_checks(torch, spec, skip_refused=False):
    """K7 (K7_CHECKS) and K8 (K8_CHECKS) at f32, c16 and bf16 against their
    plain versions over 2T+3 steps, two runs bitwise equal; at f32 on
    1024^2 with T 3, 4 and 5 (the driver's tile), K7 over 200 steps and K8
    on 4 shards over 60, their states bitwise K1's or not (printed) and
    held at the tolerance. ``skip_refused``: pass over a schedule the
    package refuses (an imported older package), saying so."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band, devspace
    from lbm_tpu_torch.ops.step import run_step

    def attempt(what, fn):
        try:
            return fn()
        except ValueError as e:
            check(skip_refused, f"{what}: {e}")
            log(f"  {what}: not checked, the package refuses it ({e})")
            return None

    forms = {"f32": None, "c16": spec, "bf16": devspace.BF16}
    for name, dev in forms.items():
        for nx, ny, (block, depth, panel) in K7_CHECKS:
            cells, nobst = random_setup(torch, nx, ny, seed=nx + depth)
            q = cells if dev is None else devspace.encode_state(cells, dev)
            n = 2 * depth + 3

            def k7(fn):
                return fn(q, nobst, DENSITY, ACCEL, OMEGA, n, block, depth, panel=panel, dev=dev)

            what = f"K7 {name} {nx}x{ny} T {depth} block {block} " + (
                f"panel {panel}" if panel else "full row")
            got = attempt(what, lambda: k7(band.run_band))
            if got is None:
                continue
            again = k7(band.run_band)
            want = k7(band.run_band_plain)
            if name == "bf16":
                bf16_compare(torch, what, got, want, TOL_BF16_SPREAD)
            else:
                compare(torch, what, got, want, dev)
            check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                  f"{what}: not run-to-run deterministic")
        for nx, ny, py, (block, depth, panel) in K8_CHECKS:
            cells, nobst = random_setup(torch, nx, ny, seed=ny + depth)
            q = cells if dev is None else devspace.encode_state(cells, dev)
            s, o = on_mesh(q, nobst, py, 1)
            n = 2 * depth + 3

            def k8(fn):
                return joined(torch, fn(s, o, DENSITY, ACCEL, OMEGA, n, block, depth, ny,
                                        panel=panel, dev=dev))

            what = f"K8 {name} {nx}x{ny} on {py} shards T {depth} block {block} " + (
                f"panel {panel}" if panel else "full row")
            got = attempt(what, lambda: k8(band.run_band_sharded))
            if got is None:
                continue
            again = k8(band.run_band_sharded)
            want = k8(band.run_band_sharded_plain)
            if name == "bf16":
                bf16_compare(torch, what, got, want, TOL_BF16_SPREAD)
            else:
                compare(torch, what, got, want, dev)
            check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                  f"{what}: not run-to-run deterministic")
    log("  K7 and K8 determinism: two runs of each schedule give bitwise-equal av and state")
    params = LBMParams(nx=1024, ny=1024, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    block, _, panel = band.schedule(params, torch.float32)
    cells, nobst = random_setup(torch, 1024, 1024, seed=5)
    s, o = on_mesh(cells, nobst, 4, 1)
    for depth in (3, 4, 5):
        for what, n, run in (
                ("K7", 200, lambda n, d: band.run_band(cells, nobst, DENSITY, ACCEL, OMEGA, n,
                                                       block, d, panel=panel)),
                ("K8 (4 shards)", 60, lambda n, d: joined(torch, band.run_band_sharded(
                    s, o, DENSITY, ACCEL, OMEGA, n, block, d, 1024, panel=panel)))):
            what = f"{what} f32 {(block, depth, panel)} vs K1 1024x1024 {n} steps"
            got = attempt(what, lambda: run(n, depth))
            if got is None:
                continue
            k1 = run_step(cells, nobst, DENSITY, ACCEL, OMEGA, n, 1.0)
            torch.cuda.synchronize()
            log(f"  {what}: final state bitwise equal: {torch.equal(got[0], k1[0])}, max diff "
                f"{float((got[0] - k1[0]).abs().max()):.3e}")
            compare(torch, what, got, k1)


def redesign11_turns(torch, spec, gpu_line):
    """Phase 28's times, with the driver's schedules of the imported package:
    K7 beside K9 (and K9 at K7's schedule, where K9 takes it) and K8
    beside K10 on 4 shards at 1024^2, 2048^2 and 4096^2, K13 beside K7 and
    K9 at 2048^2 and 4096^2, each of the same storage, in turns; returns
    {(storage, n[, "mesh"]): {kernel: us per step}}."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band, band2, devspace, slab
    from lbm_tpu_torch.runtime.driver import pass_schedule

    forms = {"f32": None, "c16": spec, "bf16": devspace.BF16}
    out = {}
    for nx, n in ((1024, 480), (2048, 240), (4096, 80)):
        params = LBMParams(nx=nx, ny=nx, max_iters=1, reynolds_dim=10, density=DENSITY,
                           accel=ACCEL, omega=OMEGA)
        k7_cfg = pass_schedule("band", params, torch.float32)[1]
        k9_cfg = pass_schedule("band2", params, torch.float32)[1]
        k13_cfg = slab.schedule(params, torch.float32)
        m = n - n % (k13_cfg[1] * k13_cfg[3])
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        for name, dev in forms.items():
            q = cells if dev is None else devspace.encode_state(cells, dev)

            def pas(fn, cfg):
                return lambda: fn(q, nobst, DENSITY, ACCEL, OMEGA, m, cfg[0], cfg[1],
                                  panel=cfg[2], dev=dev)

            fns = {"K7": pas(band.run_band, k7_cfg), "K9": pas(band2.run_band2, k9_cfg)}
            if band2.band2_supported(nx, nx, *k7_cfg) and k7_cfg != k9_cfg:
                fns["K9 at K7's"] = pas(band2.run_band2, k7_cfg)
            if nx > 1024:
                fns["K13"] = lambda: slab.run_band_slab(
                    q, nobst, DENSITY, ACCEL, OMEGA, m, *k13_cfg[:2], *k13_cfg[3:],
                    panel=k13_cfg[2], dev=dev)
            t = out[name, nx] = turns(torch, fns, m)
            log(f"  {name} {nx}x{nx} (K7 {k7_cfg}, K9 {k9_cfg}, K13 {k13_cfg}; us/step in "
                "turns): " + ", ".join(f"{k} {v:.2f}" for k, v in t.items())
                + f"; K7/K9 {t['K7'] / t['K9']:.3f}"
                + (f", K13/K7 {t['K13'] / t['K7']:.3f}" if "K13" in t else "") + f" [{gpu_line}]")
            s, o = on_mesh(q, nobst, 4, 1)

            def sharded(fn, cfg):
                return lambda: fn(s, o, DENSITY, ACCEL, OMEGA, m, cfg[0], cfg[1], nx,
                                  panel=cfg[2], dev=dev)

            t = out[name, nx, "mesh"] = turns(torch, {
                "K8": sharded(band.run_band_sharded, k7_cfg),
                "K10": sharded(band2.run_band2_sharded, k9_cfg)}, m)
            log(f"  {name} {nx}x{nx} on 4 shards (us/step in turns): K8 {t['K8']:.2f}, K10 "
                f"{t['K10']:.2f}: K8/K10 {t['K8'] / t['K10']:.3f} [{gpu_line}]")
            del s, o
        del cells, nobst
    return out


def k7_sweep(torch, gpu_line):
    """K7's schedules (K7_SWEEP) at f32 in turns beside K9 at its driver
    schedule; returns {(n, schedule): us per step}."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band, band2
    from lbm_tpu_torch.ops import band_common as BC

    out = {}
    for nx, schedules in K7_SWEEP.items():
        params = LBMParams(nx=nx, ny=nx, max_iters=1, reynolds_dim=10, density=DENSITY,
                           accel=ACCEL, omega=OMEGA)
        k9 = band2.schedule(params, torch.float32)
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        n = max(120, 240 * 2048 // nx) // 120 * 120
        fits = [cfg for cfg in schedules if BC.smem_bytes(1, nx, *cfg) <= BC.SMEM_LIMIT]
        fns = {cfg: (lambda cfg=cfg: band.run_band(cells, nobst, DENSITY, ACCEL, OMEGA, n,
                                                   cfg[0], cfg[1], panel=cfg[2]))
               for cfg in fits}
        fns["K9"] = lambda: band2.run_band2(cells, nobst, DENSITY, ACCEL, OMEGA, n, k9[0], k9[1],
                                            panel=k9[2])
        t = turns(torch, fns, n)
        out.update({(nx, cfg): t[cfg] for cfg in fits})
        log(f"  K7 schedules at {nx}^2 f32 ((block, depth, panel): us/step, in turns beside K9 "
            f"{k9} {t['K9']:.3f}): " + ", ".join(f"{cfg}: {t[cfg]:.3f}" for cfg in fits)
            + f" [{gpu_line}]")
        del cells, nobst
    return out


def deck_mlups(torch, gpu_line, backends=("band", "auto"), tags=None):
    """Loop MLUPS (``SimulationResult.mlups``, the number ``cli.main``
    reports) of ``backends`` (``band``, K7, and ``auto`` by default) on the
    decks of ``tags`` (the four official decks and the 2048^2 x 2048 and
    4096^2 x 1024 walls decks by default), through ``run_simulation``
    without fetching the final state; returns {(deck, backend): (MLUPS,
    route)}."""
    import numpy as np

    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.runtime.driver import run_simulation
    from lbm_tpu_torch.utils import geometry

    decks = {tag: (LBMParams(*fields), getattr(geometry, geo)(fields[0], fields[1], **kw))
             for tag, (fields, geo, kw) in DECKS.items()}
    for n, iters in WALLS_DECKS[1:]:
        mask = np.zeros((n, n), np.int32)
        mask[0, :] = mask[-1, :] = 1
        decks[f"walls {n}^2"] = (LBMParams(n, n, iters, 10, DENSITY, ACCEL, OMEGA), mask)
    out = {}
    for tag, (params, obstacles) in decks.items():
        if tags is not None and tag not in tags:
            continue
        for backend in backends:
            res = run_simulation(params, obstacles, backend=backend, device="cuda:0",
                                 fetch_final=False)
            check(np.isfinite(res.av_vels).all(), f"{tag} --backend {backend}: non-finite av")
            out[tag, backend] = (res.mlups(params), res.route)
        log(f"  {tag} x {params.max_iters}: loop MLUPS "
            + ", ".join(f"{b} ({out[tag, b][1]}) {out[tag, b][0]:.1f}" for b in backends)
            + f" [{gpu_line}]")
    return out


def redesign11_phase(torch, spec, gpu_line):
    """Phase 28: K7 and K8 in one window at any T against their plain
    versions and K1; timed beside K9, K10 and K13 in turns; K7's schedule
    sweep; the decks' loop MLUPS."""
    k78_checks(torch, spec)
    redesign11_turns(torch, spec, gpu_line)
    k7_sweep(torch, gpu_line)
    deck_mlups(torch, gpu_line)


# (nx, ny) of phase 29's checks: 1024^2 and an odd-height 1000-wide grid
# (word forms), and a width that is not a multiple of the word (one-cell
# forms, by the shape rule).
R12_GRIDS = ((1024, 1024), (1000, 1001), (130, 97))
# The three calls of phase 29's chunked runs (odd and even lengths; 200
# steps, the unchunked run's).
R12_CHUNKS = (67, 66, 67)
# (n, steps) of phase 29's timings in turns.
R12_TURNS = ((1024, 2000), (2048, 500), (4096, 125))


def redesign12_forms(spec):
    """Phase 29's forms: name -> (module, kernel, plain version, storage):
    K1 and K2 at c16 and bf16."""
    from lbm_tpu_torch.ops import aa, devspace, step

    return {f"{k} {dev.name}": (mod, kernel, plain, dev)
            for k, mod, kernel, plain in (("K1", step, step.run_step, step.run_step_plain),
                                          ("K2", aa, aa.run_aa, aa.run_aa_plain))
            for dev in (spec, devspace.BF16)}


def word_of(mod, nx, dev):
    """Whether the shape rule gives ``mod``'s kernel the word form (never
    in a package without word forms)."""
    return hasattr(mod, "word_form") and mod.word_form(nx, dev)


def hold_16bit(torch, name, got, want, dev):
    """A 16-bit run against its plain version, at phases 3-4's c16 and
    phase 21's bf16 tolerances."""
    if dev.name == "bf16":
        return bf16_compare(torch, name, got, want, TOL_BF16_SPREAD)
    return compare(torch, name, got, want, dev)


def redesign12_checks(torch, spec):
    """K1 and K2 at c16 and bf16 on R12_GRIDS: against their plain versions,
    two runs bitwise equal, the launch counters per form; where the shape
    rule picks the word form, its state bitwise the one-cell form's over
    200 steps at 1024^2 (the av series at TOL_AV: another order of the
    sums), and over three chained calls of R12_CHUNKS steps."""
    from lbm_tpu_torch.ops import devspace

    for name, (mod, kernel, plain, dev) in redesign12_forms(spec).items():
        counter = f"launches_word_{dev.name}"
        for nx, ny in R12_GRIDS:
            cells, nobst = random_setup(torch, nx, ny, seed=nx + ny)
            q = devspace.encode_state(cells, dev)
            n = 200 if nx == 1024 else 50
            word = word_of(mod, nx, dev)

            def run(fn, x, m):
                return fn(x, nobst, DENSITY, ACCEL, OMEGA, m, 1.0, dev=dev)

            before = (getattr(kernel, f"launches_{dev.name}"), getattr(kernel, counter, 0))
            got = run(kernel, q, n)
            moved = (getattr(kernel, f"launches_{dev.name}") - before[0],
                     getattr(kernel, counter, 0) - before[1])
            what = (f"{name} {nx}x{ny} {n} steps, "
                    + ("word form" if word else "one-cell form (shape rule)"))
            check(moved == (n, n if word else 0), f"{what}: launch counters moved {moved}")
            hold_16bit(torch, what + " vs plain", got, run(plain, q, n), dev)
            again = run(kernel, q, n)
            check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                  f"{what}: not run-to-run deterministic")
            if not word:
                log(f"  {what}: counted as the one-cell form, two runs bitwise equal")
                continue
            cell = mod.launch(q, nobst, DENSITY, ACCEL, OMEGA, n, 1.0, False, dev)
            x, avs = q, []
            for m in R12_CHUNKS if nx == 1024 else ():
                x, a = run(kernel, x, m)
                avs.append(a)
            torch.cuda.synchronize()
            av_rel = float(((got[1].double() - cell[1].double()).abs()
                            / cell[1].double().abs()).max())
            log(f"  {what}: two runs bitwise equal; state bitwise the one-cell form's: "
                f"{torch.equal(got[0], cell[0])}, av bitwise: {torch.equal(got[1], cell[1])}, "
                f"max av rel diff {av_rel:.3e} (limit {TOL_AV})")
            check(torch.equal(got[0], cell[0]), f"{what}: state differs from the one-cell form")
            check(av_rel <= TOL_AV, f"{what}: av differs from the one-cell form by {av_rel}")
            if avs:
                check(torch.equal(x, got[0]) and torch.equal(torch.cat(avs), got[1]),
                      f"{name}: {len(R12_CHUNKS)} calls of {R12_CHUNKS} steps differ from one "
                      "call")
                log(f"  {name} {nx}x{ny}: {len(R12_CHUNKS)} calls of {R12_CHUNKS} steps give "
                    "the one call's state and av bit for bit")


def redesign12_attrs():
    """Registers, local memory and resident blocks per SM of each form of
    K1 and K2 (the build's ctypes handle: cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    import ctypes

    from lbm_tpu_torch.ops import _build

    lib = _build.library()
    if not hasattr(lib, "lbm_step_attrs"):
        log("  the package reports no kernel attributes")
        return
    out = (ctypes.c_int * 3)()
    kinds = {"f32": 0, "c16": 1, "bf16": 2}
    for storage, kind in kinds.items():
        for word in (0, 1) if kind else (0,):
            form = "word" if word else "one-cell"
            _build.check(lib.lbm_step_attrs(word, kind, out), "lbm_step_attrs")
            log(f"  K1 {storage} {form} form: {out[0]} registers, {out[1]} B local, {out[2]} "
                "blocks of 256 per SM")
            for odd in (0, 1):
                _build.check(lib.lbm_aa_attrs(word, odd, kind, out), "lbm_aa_attrs")
                log(f"  K2 {storage} {form} form, {'odd' if odd else 'even'} step: {out[0]} "
                    f"registers, {out[1]} B local, {out[2]} blocks of 256 per SM")


def codec_sweep(torch, gpu_line):
    """The c16 codec against its form with conversion instructions over
    every input (``csrc/codec_check.cu``: encode over all 2^32 f32 bit
    patterns, decode over all 2^16 codes, each at the 9 keys), for the
    codecs of the smoke's decks (accel 0.005) and of the 1024^2 deck
    (0.01)."""
    from lbm_tpu_torch.ops import _build
    from lbm_tpu_torch.ops.devspace import DevSpec

    lib = _build.library()
    if not hasattr(lib, "lbm_c16_sweep"):
        log("  the package has no codec sweep")
        return
    for accel in (ACCEL, DECKS["1024x1024"][0][5]):
        bad = torch.zeros(2, dtype=torch.int64, device="cuda:0")
        stream = torch.cuda.current_stream().cuda_stream
        _, ms = timed(torch, lambda: _build.check(lib.lbm_c16_sweep(
            _build.storage(DevSpec.for_params(DENSITY, accel)), bad.data_ptr(), stream),
            "codec sweep"))
        codes, values = (int(v) for v in bad.tolist())
        log(f"  c16 codec, density {DENSITY}, accel {accel}: 2^32 f32 inputs x 9 keys encoded, "
            f"{codes} codes differ from the conversion instructions'; 2^16 codes x 9 keys "
            f"decoded, {values} values differ ({ms:.1f} ms) [{gpu_line}]")
        check(codes == 0 and values == 0, "the c16 codec differs from its conversion form")


def redesign12_turns(torch, spec, gpu_line):
    """K1 and K2 at c16 and bf16 at R12_TURNS: in a package with word forms
    the word form and the one-cell form in turns, whichever the shape rule
    picks; in one without, the kernel alone. Returns {(name, n): {form: us
    per step}}."""
    from lbm_tpu_torch.ops import devspace

    out = {}
    for nx, n in R12_TURNS:
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        for name, (mod, kernel, _, dev) in redesign12_forms(spec).items():
            q = devspace.encode_state(cells, dev)
            if hasattr(mod, "launch"):
                fns = {w: (lambda w=w: mod.launch(q, nobst, DENSITY, ACCEL, OMEGA, n, 1.0, w, dev))
                       for w in (True, False)}
            else:
                fns = {False: lambda: kernel(q, nobst, DENSITY, ACCEL, OMEGA, n, 1.0, dev=dev)}
            t = out[name, nx] = turns(torch, fns, n)
            picked = word_of(mod, nx, dev)
            log(f"  {name} {nx}x{nx} (us/step in turns): "
                + ", ".join(f"{'word' if w else 'one-cell'} form {v:.3f}"
                            + (f" (ratio {v / t[False]:.3f})" if w else "")
                            + (" [the shape rule's]" if w == picked else "")
                            for w, v in t.items()) + f" [{gpu_line}]")
            del q
        del cells, nobst
    return out


def redesign12_decks(torch, cli, gpu_line, gates=True):
    """The c16 gate on the 256^2 and 1024^2 decks with ``auto`` (K1) and
    ``aa`` (K2) through ``cli.main`` (held at 1% with ``gates``, else its
    values printed only), and the loop MLUPS of both on the 1024^2 deck
    through ``run_simulation`` (no files, as phase 28's deck_mlups), with
    the launch counters of the forms that ran."""
    import numpy as np

    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import aa, step
    from lbm_tpu_torch.runtime.driver import run_simulation
    from lbm_tpu_torch.utils import geometry

    with tempfile.TemporaryDirectory() as work:
        for tag in ("256x256", "1024x1024"):
            for backend in ("auto", "aa"):
                run_deck(cli, tag, backend, work, gpu_line, precision="c16",
                         gate=1.0 if gates else None)
    fields, geo, kw = DECKS["1024x1024"]
    params = LBMParams(*fields)
    obstacles = getattr(geometry, geo)(fields[0], fields[1], **kw)
    for backend, fn in (("auto", step.run_step), ("aa", aa.run_aa)):
        fn.launches_c16 = 0
        if hasattr(fn, "launches_word_c16"):
            fn.launches_word_c16 = 0
        res = run_simulation(params, obstacles, backend=backend, dtype="c16", device="cuda:0",
                             fetch_final=False)
        check(np.isfinite(res.av_vels).all(), f"1024x1024 c16 --backend {backend}: non-finite av")
        words = getattr(fn, "launches_word_c16", 0)
        log(f"  1024x1024 x {params.max_iters} c16 --backend {backend} (route {res.route}): loop "
            f"MLUPS {res.mlups(params):.1f}; c16 steps {fn.launches_c16}, of them in the word "
            f"form {words} [{gpu_line}]")
        check(fn.launches_c16 == params.max_iters, f"c16 {backend}: not every step in its kernel")
        check(words == (params.max_iters if hasattr(fn, "launches_word_c16") else 0),
              f"c16 {backend}: not every step in the word form")


def redesign12_phase(torch, spec, cli, gpu_line, gates=True):
    """Phase 29: K1's 16-bit forms and K2's in aligned multi-cell words:
    checks, kernel attributes, timing in turns, the c16 decks (``gates``:
    through the golden gate too)."""
    codec_sweep(torch, gpu_line)
    redesign12_checks(torch, spec)
    redesign12_attrs()
    redesign12_turns(torch, spec, gpu_line)
    redesign12_decks(torch, cli, gpu_line, gates)


# Phase 32's K11 schedule sweep (block, depth, panel): T 4, 8 and 16, the
# parent's (24, 4, 56), K6's tiers and windows of one and two blocks per
# SM; at 512^2-4096^2, every storage, each with its window compiled at
# constant strides (k11_sweep_process).
K11_SWEEP = ((24, 4, 56), (28, 4, 56), (36, 4, 56), (40, 4, 48), (32, 4, 40), (24, 4, 24),
             (24, 8, 32), (32, 8, 32), (40, 8, 40), (32, 16, 32), (32, 16, 40))
# (n, steps) of phase 32's K11 timings and sweep: steps a multiple of 16.
K11_SIZES = ((512, 960), (1024, 480), (2048, 240), (4096, 64))
# (nx, ny) of phase 32's K4 checks: its global-memory form's sizes and a
# ragged grid; the chunks of a check run.
K4_AA_SIZES = ((512, 512), (768, 768), (1024, 1024), (1000, 998))
K4_AA_CHUNKS = (254, 255, 256, 511)
# (n, steps) of phase 32's K4 timings: four 255-step launches up to 1024^2
# (whole K6 passes), one above, where a step reads the state from HBM.
K4_AA_TURNS = ((512, 1020), (768, 1020), (1024, 1020), (2048, 255), (4096, 255))
# The squares at which phase 32 (``--phase 32``) times K4's global-memory
# form at two grid sizes, and from 768^2 to 1280^2 (states of 21.2-59.0 MB
# around the card's 50 MB L2) with and without its persisting-L2 window.
K4_GRID_SIZES = (512, 768, 832, 896, 960, 1024, 1088, 1152, 1216, 1280, 2048, 4096)


def k11_checks(torch, spec, skip_refused=False):
    """K11 at f32, c16 and bf16 against its plain version, two runs bitwise
    equal: at T 4, 8 and 16, full row and panel (K9_CHECKS) over 2T+3
    steps, and at the driver's 1024^2 schedule on a ragged 998 x 1000 grid
    and the 1000^2 walls mask over T and 2T+3 steps. ``skip_refused``
    (another checkout): a schedule its K11 refuses is logged, not held."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band3, devspace

    forms = {"f32": None, "c16": spec, "bf16": devspace.BF16}
    params = LBMParams(nx=1024, ny=1024, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=OMEGA)
    cfg = band3.schedule(params, torch.float32)
    cases = [(nx, ny, sched, (2 * sched[1] + 3,)) for nx, ny, sched in K9_CHECKS]
    cases += [(1000, 998, cfg, (cfg[1], 2 * cfg[1] + 3)), ("walls", 1000, cfg,
                                                           (cfg[1], 2 * cfg[1] + 3))]
    for name, dev in forms.items():
        for nx, ny, (block, depth, panel), counts in cases:
            if nx == "walls":
                cells, nobst = walls_setup(torch, ny, seed=31)
                tag = f"walls {ny}^2"
            else:
                cells, nobst = random_setup(torch, nx, ny, seed=nx + depth)
                tag = f"{nx}x{ny}"
            q = cells if dev is None else devspace.encode_state(cells, dev)
            for n in counts:
                def run(fn):
                    return fn(q, nobst, DENSITY, ACCEL, OMEGA, n, block, depth, panel=panel,
                              dev=dev)

                what = f"K11 {name} {tag} ({block}, {depth}, {panel}) {n} steps"
                try:
                    got = run(band3.run_band3)
                except (ValueError, RuntimeError) as e:
                    check(skip_refused, f"{what}: {e}")
                    log(f"  {what}: refused by this package ({e})")
                    continue
                again = run(band3.run_band3)
                torch.cuda.synchronize()
                check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                      f"{what}: two runs differ")
                want = run(band3.run_band3_plain)
                if name == "bf16":
                    bf16_compare(torch, what, got, want,
                                 TOL_BF16 if n == depth else TOL_BF16_K11_SPREAD)
                else:
                    compare(torch, what, got, want, dev)
    log("  K11 determinism: two runs of each case give bitwise-equal av and state")


def k4_grid(resident, ny, nx):
    """The blocks ``run_resident`` gives K4's global-memory form on an ny x
    nx grid in the imported package (all the card holds at once in one
    without ``grid_blocks``)."""
    import torch

    dev = torch.device("cuda", 0)
    if hasattr(resident, "grid_blocks"):
        return resident.grid_blocks(dev, ny, nx)
    return min(resident.max_blocks(dev), -(-ny * nx // resident._THREADS))


def k4_aa_checks(torch, gpu_line):
    """K4's global-memory form (``resident.launch``) against its plain
    version at K4_AA_SIZES over K4_AA_CHUNKS steps (a plain run continued
    step by step), two runs bitwise equal, bitwise K1 over 200 steps, and a
    255-step run cut at step 101 bitwise the whole run."""
    from lbm_tpu_torch.ops import resident
    from lbm_tpu_torch.ops.step import run_step

    for nx, ny in K4_AA_SIZES:
        cells, nobst = random_setup(torch, nx, ny, seed=nx + ny)
        blocks = k4_grid(resident, ny, nx)

        def run(c, n):
            return resident.launch(c, nobst, DENSITY, ACCEL, OMEGA, n, 1.0, 255, blocks)

        state, av, done = cells, [], 0
        for n in K4_AA_CHUNKS:
            state, a = resident.run_resident_plain(state, nobst, DENSITY, ACCEL, OMEGA, n - done,
                                                   1.0)
            av.append(a)
            done = n
            before = resident.run_resident.launches
            got = run(cells, n)
            check(resident.run_resident.launches == before + n,
                  f"K4 {nx}x{ny}: its global-memory form's counter did not count {n} steps")
            compare(torch, f"K4 global-memory form {nx}x{ny} {n} steps ({blocks} blocks)", got,
                    (state, torch.cat(av)))
        again = run(cells, 511)
        torch.cuda.synchronize()
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              f"K4 global-memory form {nx}x{ny}: two runs differ")
        k1 = run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 200, 1.0)
        check(torch.equal(run(cells, 200)[0], k1[0]),
              f"K4 global-memory form {nx}x{ny}: 200 steps not bitwise K1")
        head = run(cells, 101)
        tail = run(head[0], 154)
        whole = run(cells, 255)
        torch.cuda.synchronize()
        check(torch.equal(tail[0], whole[0]) and torch.equal(torch.cat([head[1], tail[1]]),
                                                             whole[1]),
              f"K4 global-memory form {nx}x{ny}: a run cut at step 101 differs from the whole")
    log("  K4 global-memory form: two 511-step runs bitwise equal, 200 steps bitwise K1, a "
        f"255-step run cut at step 101 bitwise the whole run, at every size [{gpu_line}]")


def l2_rate(torch, mib=16, calls=200):
    """GB/s of torch's in-place add on an f32 tensor of ``mib`` MiB, which
    stays in the L2: read and written once per call."""
    x = torch.zeros(mib << 18, dtype=torch.float32, device="cuda:0")
    for _ in range(10):
        x.add_(1.0)

    def go():
        for _ in range(calls):
            x.add_(1.0)

    return 2 * x.numel() * 4 * calls / (timed(torch, go)[1] * 1e-3) / 1e9


def redesign15_turns(torch, spec, gpu_line):
    """Phase 32's times with the driver's schedules of the imported package:
    K11 beside K9 and K2 of the same storage at 1024^2-4096^2 (and at the
    other schedules of its tiers); K4's global-memory form beside K2 and
    K6 at 512^2-4096^2 (f32)."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import aa, band2, band3, deep, devspace, resident
    from lbm_tpu_torch.runtime.driver import pass_schedule

    forms = {"f32": None, "c16": spec, "bf16": devspace.BF16}
    # K11 at every schedule of its tiers, where the package has a table.
    others = tuple(cfg for cfg, _ in getattr(band3, "BAND3_TIERS", ()))
    for nx, n in K11_SIZES[1:]:
        params = LBMParams(nx=nx, ny=nx, max_iters=1, reynolds_dim=10, density=DENSITY,
                           accel=ACCEL, omega=OMEGA)
        cfg = {route: pass_schedule(route, params, torch.float32)[1]
               for route in ("band2", "band3")}
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        for name, dev in forms.items():
            q = cells if dev is None else devspace.encode_state(cells, dev)

            def pas(fn, route):
                b, t, p = cfg[route]
                return lambda: fn(q, nobst, DENSITY, ACCEL, OMEGA, n, b, t, panel=p, dev=dev)

            fns = {"K11": pas(band3.run_band3, "band3"), "K9": pas(band2.run_band2, "band2"),
                   "K2": lambda: aa.run_aa(q, nobst, DENSITY, ACCEL, OMEGA, n, 1.0, dev=dev)}
            for other in others:
                if other != cfg["band3"]:
                    fns[f"K11 at {other}"] = (lambda o=other: band3.run_band3(
                        q, nobst, DENSITY, ACCEL, OMEGA, n, o[0], o[1], panel=o[2], dev=dev))
            t = turns(torch, fns, n)
            # The host's share of a K11 call: R -> S, the first forcing, S -> R.
            convert = band3._in_s_space(nobst, DENSITY, ACCEL,
                                        lambda x, _: (x, None), dev)
            convert(q, 0)
            conv_ms = timed(torch, lambda: convert(q, 0))[1]
            log(f"  K11 {name} {nx}x{nx} (K11 {cfg['band3']}, K9 {cfg['band2']}): "
                + ", ".join(f"{k} {v:.2f}" for k, v in t.items())
                + f" us/step (in turns): K11/K9 {t['K11'] / t['K9']:.3f}, K11/K2 "
                f"{t['K11'] / t['K2']:.3f}; a call's R <-> S conversion {conv_ms:.3f} ms "
                f"({1e3 * conv_ms / n:.2f} us/step over {n} steps) [{gpu_line}]")
        del cells, nobst
    for nx, n in K4_AA_TURNS:
        params = LBMParams(nx=nx, ny=nx, max_iters=1, reynolds_dim=10, density=DENSITY,
                           accel=ACCEL, omega=OMEGA)
        k6 = pass_schedule("deep", params, torch.float32)[1]
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        blocks = k4_grid(resident, nx, nx)
        fns = {"K4": lambda: resident.launch(cells, nobst, DENSITY, ACCEL, OMEGA, n, 1.0, 255,
                                             blocks),
               "K2": lambda: aa.run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, n, 1.0),
               "K6": lambda: deep.run_deep(cells, nobst, DENSITY, ACCEL, OMEGA, n, k6[0], k6[1],
                                           panel=k6[2])}
        t = turns(torch, fns, n)
        log(f"  K4 global-memory form {nx}x{nx} ({blocks} blocks; K6 {k6}; us/step in "
            "turns): " + ", ".join(f"{k} {v:.3f}" for k, v in t.items())
            + f"; K4/K6 {t['K4'] / t['K6']:.3f}, K4/K2 {t['K4'] / t['K2']:.3f} [{gpu_line}]")
        del cells, nobst


def k4_grid_window(torch, gpu_line):
    """K4's global-memory form at 3 and 4 blocks per SM, each with and
    without its persisting-L2 window from 768^2 to 1280^2, in turns, at
    K4_GRID_SIZES (1020 steps up to 1280^2, 255 above), the state of every
    variant bitwise the others (the av series on the same grid), beside
    the grid and window ``run_resident`` picks; and the L2 rate that
    PERF.md's floor of the form is written at."""
    from lbm_tpu_torch.ops import resident

    log(f"  L2 rate: {l2_rate(torch):.1f} GB/s (torch's in-place add on a 16 MiB f32 "
        f"tensor, read and written) [{gpu_line}]")
    dev = torch.device("cuda", 0)
    sms = resident.sm_count(dev)
    picker = resident.l2_window
    for nx in K4_GRID_SIZES:
        n = 1020 if nx <= 1280 else 255
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        state = 36 * nx * nx

        def run(blocks, window, steps=n):
            resident.l2_window = lambda state_bytes, device: window
            try:
                return resident.launch(cells, nobst, DENSITY, ACCEL, OMEGA, steps, 1.0, 255,
                                       blocks)
            finally:
                resident.l2_window = picker

        variants = {f"{b} blocks{', L2 window' if w else ''}": (b, w)
                    for b in sorted({min(per_sm * sms, -(-nx * nx // resident._THREADS))
                                     for per_sm in (3, 4)})
                    for w in ((False, True) if 768 <= nx <= 1280 else (False,))}
        # The state is K1's bits on any grid; the av series sums per block,
        # so it is bitwise only on the same grid.
        first = {}
        for name, (blocks, window) in variants.items():
            got = run(blocks, window, min(n, 300))
            torch.cuda.synchronize()
            cells0, av0 = first.setdefault("state", got)[0], first.setdefault(blocks, got)[1]
            check(torch.equal(got[0], cells0) and torch.equal(got[1], av0),
                  f"K4 {nx}x{nx} {name}: not bitwise the other grids and windows")
        t = turns(torch, {name: (lambda v=v: run(*v)) for name, v in variants.items()}, n)
        log(f"  K4 global-memory form {nx}x{nx} ({state / 1e6:.1f} MB state; the form picks "
            f"{k4_grid(resident, nx, nx)} blocks and "
            f"{'the window' if picker(state, dev) else 'no window'}; us/step in turns): "
            + ", ".join(f"{k} {v:.3f}" for k, v in t.items()) + f" [{gpu_line}]")
        del cells, nobst


def k11_sweep(torch, gpu_line):
    """K11's schedules (K11_SWEEP) in turns beside K9 at its driver
    schedule, at K11_SIZES and every storage."""
    from lbm_tpu_torch.models.d2q9 import LBMParams
    from lbm_tpu_torch.ops import band2, band3, devspace
    from lbm_tpu_torch.ops import band_common as BC

    forms = {"f32": None, "c16": devspace.DevSpec.for_params(DENSITY, ACCEL),
             "bf16": devspace.BF16}
    for nx, n in K11_SIZES:
        params = LBMParams(nx=nx, ny=nx, max_iters=1, reynolds_dim=10, density=DENSITY,
                           accel=ACCEL, omega=OMEGA)
        k9 = band2.schedule(params, torch.float32)
        fits = [cfg for cfg in K11_SWEEP if BC.smem_bytes(1, nx, *cfg) <= BC.SMEM_LIMIT
                and band3.band3_supported(nx, nx, *cfg)]
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        for name, dev in forms.items():
            q = cells if dev is None else devspace.encode_state(cells, dev)
            fns = {cfg: (lambda cfg=cfg: band3.run_band3(q, nobst, DENSITY, ACCEL, OMEGA, n,
                                                         cfg[0], cfg[1], panel=cfg[2], dev=dev))
                   for cfg in fits}
            fns["K9"] = lambda: band2.run_band2(q, nobst, DENSITY, ACCEL, OMEGA, n, k9[0], k9[1],
                                                panel=k9[2], dev=dev)
            t = turns(torch, fns, n)
            best = min(fits, key=t.get)
            log(f"  K11 schedules at {nx}^2 {name} ((block, depth, panel): us/step, in turns "
                f"beside K9 {k9} {t['K9']:.3f}): " + ", ".join(f"{cfg}: {t[cfg]:.3f}"
                                                                 for cfg in fits)
                + f"; fastest {best} [{gpu_line}]")
        del cells, nobst


def k11_sweep_main():
    """The body of k11_sweep_process: builds the kernels with every
    candidate's window at constant strides, as the build compiles the
    windows of the driver's schedules, and sweeps."""
    import torch

    from lbm_tpu_torch.ops import _build

    windows = _build.trap_windows
    _build.trap_windows = lambda: tuple(sorted(set(windows()) | {(p + 2 * t, b + 2 * t)
                                                                 for b, t, p in K11_SWEEP}))
    b = _build.library().build_info
    log(f"  sweep's kernels {'built' if b['built'] else 'loaded'} in {b['seconds']:.1f} s, "
        f"with constant strides for the windows {b['windows']}")
    k11_sweep(torch, nvidia_smi())
    return 0


def k11_sweep_process():
    """Runs k11_sweep_main in a process of its own, so that every candidate
    is timed under the same stride regime."""
    code = "import sys, chip_smoke; sys.exit(chip_smoke.k11_sweep_main())"
    rc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=600).returncode
    check(rc == 0, f"the K11 schedule sweep exited {rc}")


def redesign15_phase(torch, spec, gpu_line, alone=True):
    """Phase 32: K11 on the trapezoid and K4's global-memory form in one
    copy, against their plain versions, K1 and their own repeats; timed
    beside their rivals in turns. ``alone`` (``--phase 32``) also: K11's
    schedule sweep, K4 with and without its L2 window, the loop MLUPS of
    ``band3``, ``deep`` and ``auto``, and phase 25's crossover (one-off
    measurements, which the whole run leaves out to keep within its
    limit)."""
    k11_checks(torch, spec)
    k4_aa_checks(torch, gpu_line)
    redesign15_turns(torch, spec, gpu_line)
    if alone:
        k4_grid_window(torch, gpu_line)
        k11_sweep_process()
        deck_mlups(torch, gpu_line, ("band3", "deep", "auto"),
                   ("1024x1024", "walls 2048^2", "walls 4096^2"))
        crossover_phase(torch, gpu_line)


PHASE_32 = ("32. K11 on the trapezoid, its load and store fused into its first and last steps, "
            "and K4's global-memory form in one copy stepped in place: vs plain and K1, beside "
            "their rivals")


PHASE_30 = ("30. the row mesh across processes: K3 with its ring from received rows, K12 with "
            "its neighbours mapped by CUDA IPC, 2 ranks of --multihost against --mesh 2 (auto, "
            "band, pallas-overlap)")
PHASE_31 = ("31. diagnostics, profile and viz on the card: --debug --check-nan, a NaN state, "
            "--profile-dir, utils.viz")
# Phase 30: the 1024^2 deck cut to this many steps for the multi-process
# runs, and the backends run there.
MULTIHOST_ITERS = 200
MULTIHOST_BACKENDS = ("auto", "band")
# K12 across processes (``--backend pallas-overlap``, the ``ipc`` channel):
# the 1024^2 deck cut to this many steps, and the steps of its kernel check
# and of its timed run (tests/torch_multihost_worker.py ``ipc``).
MULTIHOST_ITERS_IPC = 2000
IPC_CHECK_STEPS = 50
IPC_TIMED_STEPS = 2000
# The stats of a run that the multi-process run must repeat.
SAME_STATS = ("nx", "ny", "max_iters", "backend", "route", "precision", "reynolds")
K3_ROWS = ("K3 ring filled from received rows (multi-process mesh)",
           "lbm_tpu_torch/csrc/shard_step.cu", "lbm_tpu/ops/pallas_step.py:164")
K12_IPC = ("K12 across processes (neighbour shards mapped with CUDA IPC)",
           "lbm_tpu_torch/csrc/shard_step.cu", "lbm_tpu/ops/pallas_remote.py:49")


def write_deck(work, tag, iters):
    """The official deck ``tag`` cut to ``iters`` steps, in the reference's
    files; returns (params path, obstacles path)."""
    from lbm_tpu_torch.utils import geometry

    fields, geo, kw = DECKS[tag]
    fields = (fields[0], fields[1], iters, *fields[3:])
    deck_dir = os.path.join(work, f"deck-{tag}-{iters}")
    os.makedirs(deck_dir, exist_ok=True)
    params_path = os.path.join(deck_dir, f"input_{tag}.params")
    obst_path = os.path.join(deck_dir, f"obstacles_{tag}.dat")
    geometry.write_params_file(params_path, *fields)
    geometry.write_obstacle_file(obst_path, getattr(geometry, geo)(fields[0], fields[1], **kw))
    return params_path, obst_path


def rows_kernel_phase(torch, gpu_line):
    """K3 with its ring filled from received rows (``RowShard``) on 2 row
    shards of 1024^2 on cuda:0, stepped in turns with their edge rows handed
    over on the card: against the plain shard step over 50 steps, bitwise
    K3 with the peer fill, and timed per mesh step beside it (200 steps,
    in turns) and the plain step. Returns (max_abs_err, ms, plain_ms)."""
    from lbm_tpu_torch.ops.shard_step import (RowShard, run_shard_step, run_shard_step_plain,
                                              with_ring)

    n_grid = 1024
    cells, nobst = random_setup(torch, n_grid, n_grid, seed=30)
    s, o = on_mesh(cells, nobst, 2, 1)
    rings = with_ring([[x[None] for x in row] for row in o])

    def rows_run(n):
        shards = [RowShard(s[z][0], rings[z][0][0], z, 2, n_grid, DENSITY, ACCEL, OMEGA, n)
                  for z in range(2)]
        for _ in range(n):
            edges = [x.edges() for x in shards]
            for z, x in enumerate(shards):
                dn, up = x.halos()
                dn.copy_(edges[z - 1][1])
                up.copy_(edges[(z + 1) % 2][0])
            for x in shards:
                x.step()
        return [[x.state()] for x in shards], torch.stack([x.sums for x in shards])

    got = rows_run(50)
    err = compare(torch, "K3 rows 2x1 1024x1024 50 steps", joined(torch, got),
                  joined(torch, run_shard_step_plain(s, o, DENSITY, ACCEL, OMEGA, 50, n_grid)))
    peer = run_shard_step(s, o, DENSITY, ACCEL, OMEGA, 50, n_grid)
    same = all(torch.equal(got[0][z][0], peer[0][z][0]) for z in range(2))
    check(same and torch.equal(got[1], peer[1]), "K3 with rows from a buffer is not bitwise "
          "K3 with the peer fill")
    log("  K3 rows: state and per-step sums bitwise K3 with the peer fill over 50 steps")
    n = 200
    t = turns(torch, {"rows": lambda: rows_run(n),
                      "peer": lambda: run_shard_step(s, o, DENSITY, ACCEL, OMEGA, n, n_grid)}, n)
    run_shard_step_plain(s, o, DENSITY, ACCEL, OMEGA, 2, n_grid)
    _, p_ms = timed(torch, lambda: run_shard_step_plain(s, o, DENSITY, ACCEL, OMEGA, 5, n_grid))
    log(f"  K3 2 shards of {n_grid}x{n_grid}: ring from received rows {t['rows']:.2f} us/step "
        f"(one C call per shard per step, rows copied on the card), peer fill {t['peer']:.2f} "
        f"(one call), in turns; plain {1e3 * p_ms / 5:.2f} us/step [{gpu_line}]")
    return err, t["rows"] * 1e-3, p_ms / 5


def ipc_kernel_phase(torch, gpu_line, work):
    """K12 across 2 processes on cuda:0 (``IpcRowShard``, spawned as
    tests/torch_multihost_worker.py ``ipc``) on the 1024^2 deck's two
    shards: over ``IPC_CHECK_STEPS`` steps each process's state and sums
    bitwise the one-process K12's and within the tolerance of the plain
    shard step; then a timed run of ``IPC_TIMED_STEPS`` steps. Returns
    (max_abs_err, ms per mesh step, plain ms per mesh step)."""
    import numpy as np

    from lbm_tpu_torch.ops.shard_step import run_shard_overlap, run_shard_step_plain

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_multihost_worker as worker

    cells, nob = worker.ipc_deck()
    ny = cells.shape[1]
    ry = ny // 2
    dev = torch.device("cuda", 0)
    s = [[cells[:, z * ry:(z + 1) * ry].to(dev)] for z in range(2)]
    o = [[nob[z * ry:(z + 1) * ry].to(dev)] for z in range(2)]
    scalars = (worker.DENSITY, worker.ACCEL, worker.OMEGA)
    want, want_sums = run_shard_overlap(s, o, *scalars, IPC_CHECK_STEPS, ny)
    port = free_port()
    outs = [os.path.join(work, f"ipc{rank}.npz") for rank in range(2)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_multihost_worker.py"),
                               "ipc", str(rank), "2", str(port), outs[rank], "--steps",
                               str(IPC_CHECK_STEPS), "--timed", str(IPC_TIMED_STEPS)],
                              cwd=ROOT, env=dict(env, PYTHONPATH=ROOT), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in range(2)]
    texts = []
    try:
        for proc in procs:
            texts.append(proc.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        fail("a process of K12 across processes did not end within 300 s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, text) in enumerate(zip(procs, texts)):
        check(proc.returncode == 0, f"K12 across processes, rank {rank} exited "
              f"{proc.returncode}: {text.strip()[-2000:]}")
    got = [np.load(out) for out in outs]
    same = all(np.array_equal(g["state"], want[z][0].cpu().numpy()) and
               np.array_equal(g["sums"], want_sums[z].cpu().numpy()) for z, g in enumerate(got))
    check(same, "K12 across processes is not bitwise the one-process K12")
    check(all(int(g["launches"]) == IPC_CHECK_STEPS for g in got),
          f"K12 across processes counted {[int(g['launches']) for g in got]} steps")
    log(f"  K12 across 2 processes on cuda:0: state and per-step sums bitwise the one-process "
        f"K12 over {IPC_CHECK_STEPS} steps")
    gs = [[torch.as_tensor(g["state"]).to(dev)] for g in got]
    err = compare(torch, f"K12 across processes 2x1 1024x1024 {IPC_CHECK_STEPS} steps",
                  joined(torch, (gs, torch.as_tensor(np.stack([g["sums"] for g in got])).to(dev))),
                  joined(torch, run_shard_step_plain(s, o, *scalars, IPC_CHECK_STEPS, ny)))
    ms = max(float(g["seconds"]) for g in got) * 1e3 / IPC_TIMED_STEPS
    run_shard_step_plain(s, o, *scalars, 2, ny)
    _, p_ms = timed(torch, lambda: run_shard_step_plain(s, o, *scalars, 5, ny))
    log(f"  K12 across 2 processes on cuda:0, 2 shards of 1024x1024: {1e3 * ms:.2f} us per mesh "
        f"step over {IPC_TIMED_STEPS} steps (the slower rank's run), plain "
        f"{1e3 * p_ms / 5:.2f} [{gpu_line}]")
    return err, ms, p_ms / 5


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(argv, world, devices, timeout=300):
    """``python -m lbm_tpu_torch ARGV --multihost`` as ``world`` ranks (the
    variables torchrun sets; rank r on ``devices[r]``, None: its
    LOCAL_RANK's card); returns their (stdout, stderr). Every rank is
    stopped before this returns."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                   PYTHONPATH=ROOT)
        extra = [] if devices[rank] is None else ["--device", str(devices[rank])]
        procs.append(subprocess.Popen([sys.executable, "-m", "lbm_tpu_torch", *argv, "--multihost",
                                       "-v", *extra], cwd=ROOT, env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        fail(f"a rank of the multi-process run did not end within {timeout} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, (_, err)) in enumerate(zip(procs, outs)):
        check(proc.returncode == 0, f"rank {rank} of the multi-process run exited "
              f"{proc.returncode}: {err.strip()[-2000:]}")
    return outs


def same_files(a, b, what):
    for name in ("av_vels.dat", "final_state.dat"):
        check(filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False),
              f"{what}: {name} differs from the one-process run's")


def multihost_phase(torch, cli, gpu_line, work):
    """Phase 30; returns {name: (launches, max_abs_err, ms, plain_ms)} of K3
    with its ring from received rows ("K3 rows") and K12 across processes
    ("K12 ipc"), launches the steps the ranks ran in them."""
    import contextlib
    import io

    from lbm_tpu_torch.io import read_params
    from lbm_tpu_torch.parallel.sharded import pick_shard_step

    kernels = {"K3 rows": rows_kernel_phase(torch, gpu_line),
               "K12 ipc": ipc_kernel_phase(torch, gpu_line, work)}
    decks = {n: write_deck(work, "1024x1024", n) for n in (MULTIHOST_ITERS, MULTIHOST_ITERS_IPC)}
    runs = [(b, MULTIHOST_ITERS, "f32") for b in MULTIHOST_BACKENDS] + [
        ("pallas-overlap", MULTIHOST_ITERS_IPC, "f32"), ("pallas-overlap", MULTIHOST_ITERS, "bf16")]
    layouts = [("gloo", [0, 0], ["--device", "0"])]
    if torch.cuda.device_count() >= 2:
        layouts.append(("nccl", [None, None], []))
        # The one-process mesh on cards 0 and 1 once before it is timed:
        # the second card's context and the peer mappings are made then.
        with contextlib.redirect_stdout(io.StringIO()):
            check(cli.main([*decks[MULTIHOST_ITERS], "--mesh", "2", "--out-dir",
                            os.path.join(work, "warm")]) == 0, "--mesh 2 on cards 0 and 1 failed")
    launches = dict.fromkeys(kernels, 0)
    for layout, devices, one_process in layouts:
        loop_us = {}
        for backend, iters, precision in runs:
            params_path, obst_path = decks[iters]
            channel = "ipc" if backend == "pallas-overlap" else layout
            tag = f"{backend}-{precision}-{layout}"
            one = os.path.join(work, f"one-{tag}")
            many = os.path.join(work, f"many-{tag}")
            argv = [params_path, obst_path, "--backend", backend, "--precision", precision]
            with contextlib.redirect_stderr(io.StringIO()):  # bf16's warning
                rc = cli.main([*argv, "--mesh", "2", *one_process, "--out-dir", one,
                               "--stats-json", one + ".json"])
            check(rc == 0, f"--mesh 2 {' '.join(one_process)} --backend {backend} "
                  f"--precision {precision}: rc {rc}")
            t0 = time.time()
            outs = run_ranks([*argv, "--out-dir", many, "--stats-json", many + ".json"], 2,
                             devices)
            wall = time.time() - t0
            with open(one + ".json") as f:
                want = json.load(f)
            with open(many + ".json") as f:
                got = json.load(f)
            same_files(one, many, f"--multihost --backend {backend} ({channel})")
            for key in SAME_STATS:
                check(got[key] == want[key], f"--multihost {backend}: stats {key} {got[key]} != "
                      f"{want[key]}")
            check([x["device"] for x in got["shards"]] == [x["device"] for x in want["shards"]],
                  f"--multihost {backend}: shards on {got['shards']}, not {want['shards']}")
            ranks = got["multihost"]["ranks"]
            check(got["multihost"]["channel"] == channel and
                  all(r["channel"] == channel for r in ranks),
                  f"--multihost {backend}: rows over {got['multihost']['channel']}, not {channel}")
            check(len({r["result_sha256"] for r in ranks}) == 1,
                  f"--multihost {backend}: the ranks' results differ")
            _, cfg = pick_shard_step(read_params(params_path), 2, backend, torch.float32)
            want_k8 = 0 if cfg is None else iters // cfg[1] * cfg[1]
            want_k12 = iters if backend == "pallas-overlap" else 0
            for r in ranks:
                counts = r["launches"]
                check(counts["K3 rows"] == iters - want_k8 - want_k12 and
                      counts["K8"] == want_k8 and counts["K12 ipc"] == want_k12,
                      f"--multihost {backend}: rank {r['rank']} counted {counts}")
                launches["K3 rows"] += counts["K3 rows"]
                launches["K12 ipc"] += counts["K12 ipc"]
            verbose = [line for _, e in outs for line in e.splitlines() if "halo rows over" in line]
            check(len(verbose) == 2, f"--multihost -v did not say which channel ran: {verbose}")
            us = loop_us[backend, precision] = (1e6 * want["loop_s"] / iters,
                                                1e6 * got["loop_s"] / iters)
            log(f"  --backend {backend} --precision {precision}, route {want['route']}: one "
                f"process --mesh 2 {' '.join(one_process)} loop {us[0]:.2f} us/step; 2 ranks over "
                f"{channel} ({', '.join(x['device'] for x in got['shards'])}) rank 0 loop "
                f"{us[1]:.2f} us/step over {iters} steps, {wall:.1f} s wall for "
                f"both ranks; files and Reynolds number equal, digests equal; launches "
                f"{ranks[0]['launches']} per rank [{gpu_line}]")
            for d in (one, many):
                shutil.rmtree(d)
        k12, k3 = loop_us["pallas-overlap", "f32"], loop_us["auto", "f32"]
        log(f"  1024x1024, 2 ranks ({layout} layout): K12 across processes over ipc "
            f"{k12[1]:.2f} us/step, rows over {layout} with auto (K3) {k3[1]:.2f}, one-process "
            f"K12 (--mesh 2 --backend pallas-overlap) {k12[0]:.2f} [{gpu_line}]")
    if torch.cuda.device_count() < 2:
        log(f"  the layout with a card per rank (NCCL rows, K12 over ipc between two cards) was "
            f"not run: this machine has {torch.cuda.device_count()} card")
    return {name: (launches[name], *kernels[name]) for name in kernels}


def debug_reports(text):
    lines = text.splitlines()
    steps = [int(x.strip("=").split(":")[1]) for x in lines if x.startswith("==timestep")]
    dens = [float(x.split(":")[1]) for x in lines if x.startswith("tot density")]
    return steps, dens


def union_us(spans, lo, hi):
    """Microseconds of [lo, hi) covered by the union of ``spans``."""
    total, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def trace_shares(torch, trace_path, want_kernel):
    """The device's busy and idle share of the loop's window
    (``lbm_tpu_torch.loop``) in a torch.profiler trace, and the kernels by
    name; fails unless a kernel's name holds ``want_kernel``."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    check(any(want_kernel in name for name in by_name),
          f"the trace names no {want_kernel}: {sorted(by_name)[:10]}")
    loops = [e for e in events if e.get("name") == "lbm_tpu_torch.loop"
             and e.get("cat") == "user_annotation"]
    check(len(loops) == 1, f"{len(loops)} loop spans in the trace")
    lo, hi = loops[0]["ts"], loops[0]["ts"] + loops[0]["dur"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in kernels if lo <= e["ts"] < hi]
    busy = union_us(spans, lo, hi)
    first, last = min(a for a, _ in spans), max(b for _, b in spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"window_us": hi - lo, "busy_us": busy, "device_span_us": last - first,
            "kernels": len(spans), "top": top}


def diagnostics_phase(torch, cli, gpu_line, work):
    """Phase 31."""
    import contextlib
    import glob
    import io

    import numpy as np

    from lbm_tpu_torch.io import read_obstacles, read_params
    from lbm_tpu_torch.models.d2q9 import D2Q9
    from lbm_tpu_torch.ops import resident, step
    from lbm_tpu_torch.runtime.checkpoint import save_checkpoint
    from lbm_tpu_torch.runtime.driver import run_simulation
    from lbm_tpu_torch.utils.diagnostics import total_density

    steps = 50
    params_path, obst_path = write_deck(work, "128x128", steps)
    params = read_params(params_path)
    obstacles = read_obstacles(obst_path, params)
    out_f32 = os.path.join(work, "debug-f32")
    for precision, counter, name in (("f32", (resident.run_resident, "launches_smem"), "K4"),
                                     ("c16", (step.run_step, "launches_c16"), "K1")):
        out_dir = os.path.join(work, f"debug-{precision}")
        setattr(*counter, 0)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli.main([params_path, obst_path, "--debug", "--check-nan", "--precision",
                           precision, "--out-dir", out_dir])
        check(rc == 0, f"--debug --check-nan --precision {precision}: rc {rc}")
        got_steps, dens = debug_reports(text.getvalue())
        check(got_steps == list(range(steps)), f"--debug {precision}: reports {got_steps}")
        check(getattr(*counter) == steps, f"--debug {precision}: {name} ran "
              f"{getattr(*counter)} of {steps} steps")
        plain = []
        run_simulation(params, obstacles, dtype="c16" if precision == "c16" else torch.float32,
                       device="cpu", chunk_every=1,
                       on_chunk=lambda s, cells, av: plain.append(total_density(cells)))
        rel = max(abs(a - b) / abs(b) for a, b in zip(dens, plain))
        check(rel <= 1e-5, f"--debug {precision}: tot density {rel:.3e} from the plain run's")
        log(f"  --debug --check-nan --precision {precision} on 128^2 x {steps}: {len(dens)} "
            f"reports, {name} ran every step, tot density within {rel:.3e} of the plain run's "
            f"(limit 1e-5)")

    # A state with a NaN, resumed from a checkpoint, must end the run with 1.
    cells = D2Q9.initial_state(params, dtype=torch.float32).numpy().copy()
    cells[3, 64, 64] = np.nan
    ckpt = os.path.join(work, "nan.npz")
    save_checkpoint(ckpt, params, cells, np.zeros(steps // 2, np.float32), steps // 2)
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main([params_path, obst_path, "--check-nan", "--resume", "--checkpoint-path",
                       ckpt, "--out-dir", os.path.join(work, "nan")])
    check(rc == 1 and "non-finite" in err.getvalue(),
          f"--check-nan on a NaN state: rc {rc}, {err.getvalue().strip()}")
    log(f"  --check-nan on a state seeded with a NaN: exit 1, {err.getvalue().strip()}")

    # The first trace of the port: 1024^2 under auto (K6), after the same
    # run without the profiler.
    prof_iters = 2000
    p1024, o1024 = write_deck(work, "1024x1024", prof_iters)
    prof = os.path.join(work, "profile")
    loops = {}
    for traced in (False, True):
        t0 = time.time()
        stats_path = os.path.join(work, f"prof-{traced}.json")
        rc = cli.main([p1024, o1024, "--out-dir", os.path.join(work, "prof"), "--stats-json",
                       stats_path] + (["--profile-dir", prof] if traced else []))
        check(rc == 0, f"1024^2 x {prof_iters} (profiled: {traced}): rc {rc}")
        with open(stats_path) as f:
            stats = json.load(f)
        loops[traced] = (stats["loop_s"], time.time() - t0)
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    check(len(traces) == 1, f"--profile-dir wrote {traces}")
    tr = trace_shares(torch, traces[0], "deep_kernel")
    share = tr["busy_us"] / tr["window_us"]
    log(f"  --profile-dir on 1024^2 x {prof_iters} (route {stats['route']}): trace "
        f"{os.path.getsize(traces[0])} bytes, {tr['kernels']} kernels in the loop's window of "
        f"{tr['window_us'] / 1e3:.3f} ms (the loop {1e3 * loops[True][0]:.3f} ms under the "
        f"profiler, {1e3 * loops[False][0]:.3f} ms without it; {loops[True][1]:.1f} s and "
        f"{loops[False][1]:.1f} s in all): the device busy {share:.4f} and idle {1 - share:.4f} "
        f"of the window, busy {tr['busy_us'] / tr['device_span_us']:.4f} from its first "
        f"kernel's start to its last's end; the kernels' {tr['busy_us'] / 1e3:.3f} ms over "
        f"the loop without the profiler {tr['busy_us'] / 1e6 / loops[False][0]:.4f}; kernels "
        f"by time: " + ", ".join(f"{n[:60]} {t / 1e3:.3f} ms" for n, t in tr["top"])
        + f" [{gpu_line}]")

    # The 128^2 run's final state as a picture.
    src = os.path.join(out_f32, "final_state.dat")
    dst = os.path.join(work, "final_state.png")
    proc = subprocess.run([sys.executable, "-m", "lbm_tpu_torch.utils.viz", src, dst], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"viz: {proc.stderr.strip()[-500:]}")
    ppm = dst[:-4] + ".ppm"
    if os.path.exists(ppm):
        with open(ppm, "rb") as f:
            data = f.read()
        head = b"P6\n128 128\n255\n"
        check(data.startswith(head) and len(data) == len(head) + 128 * 128 * 3,
              f"viz: a bad PPM ({len(data)} bytes)")
        log(f"  viz: {os.path.basename(ppm)}, a 128 x 128 PPM ({len(data)} bytes; no matplotlib)")
    else:
        with open(dst, "rb") as f:
            check(f.read(8) == b"\x89PNG\r\n\x1a\n", "viz: neither a PPM nor a PNG")
        log(f"  viz: {os.path.basename(dst)}, a PNG (matplotlib)")


def main():
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--phase", type=int, choices=(25, 26, 27, 28, 29, 30, 31, 32, 33),
                    help="run phases 1, 2 and this one only (no kernel report)")
    ap.add_argument("--import-from", metavar="DIR",
                    help="with --phase 26: check K9 of the lbm_tpu_torch package under DIR "
                         "(another checkout) and time it and K3 beside their rivals; with "
                         "--phase 27: check K5 and K6 of that package, time them beside K9 "
                         "and K11 and run their c16 gate decks; with --phase 28: check K7 "
                         "and K8 of that package and time them beside K9, K10 and K13; "
                         "with --phase 29: phase 29's checks, timings and decks of that "
                         "package; with --phase 32: check K11 and K4's global-memory form of "
                         "that package and time them beside K9, K2 and K6; with --phase 33: "
                         "time K5's and K6's passes of that package; nothing else")
    args = ap.parse_args()
    if args.import_from and args.phase in (None, 25, 30, 31):
        ap.error("--import-from needs --phase 26, 27, 28, 29, 32 or 33")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on a GPU")
    sys.path.insert(0, os.path.abspath(args.import_from) if args.import_from else ROOT)
    try:
        from lbm_tpu_torch import cli
        from lbm_tpu_torch.ops import _build
        from lbm_tpu_torch.ops.aa import run_aa, run_aa_plain
        from lbm_tpu_torch.ops.step import run_step, run_step_plain
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")

    phase("1. environment")
    gpu_line = nvidia_smi()
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  {gpu_line}")
    log(f"  torch.cuda: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    phase("2. build")
    b = _build.library().build_info
    check("sm_90a" in b["flags"], "kernels not built for sm_90a")
    log(f"  {'built' if b['built'] else 'loaded'} {os.path.relpath(b['path'], ROOT)} "
        f"in {b['seconds']:.1f} s with nvcc {b['flags']} from {', '.join(b['sources'])}")
    if args.phase == 33:
        if args.import_from:
            phase(f"33. K5's and K6's times per pass by rounds of blocks, the package under "
                  f"{args.import_from}")
            k56_pass_times(torch, gpu_line)
        else:
            phase("33. K5 and K6 by rounds of blocks: blocks per SM, whole-round cuts of "
                  "1024^2 beside the tier's and bitwise it, times per pass, a deck's tiles")
            waves_phase(torch, gpu_line)
        return 0
    if args.phase == 25:
        phase("25. the auto crossover: K4, K6, K7, K9 and K11 in turns at 128x256 and "
              "256^2-1024^2")
        crossover_phase(torch, gpu_line)
        return 0
    if args.phase in (30, 31):
        build_native_io()
        with tempfile.TemporaryDirectory() as work:
            if args.phase == 30:
                phase(PHASE_30)
                multihost_phase(torch, cli, gpu_line, work)
            else:
                phase(PHASE_31)
                diagnostics_phase(torch, cli, gpu_line, work)
        return 0
    if args.phase == 32:
        from lbm_tpu_torch.ops.devspace import DevSpec

        spec = DevSpec.for_params(DENSITY, ACCEL)
        if args.import_from:
            phase(f"32. K11 and K4's global-memory form vs their plain versions and K1, beside "
                  f"K9, K2 and K6, the package under {args.import_from}")
            k11_checks(torch, spec, skip_refused=True)
            k4_aa_checks(torch, gpu_line)
            redesign15_turns(torch, spec, gpu_line)
        else:
            phase(PHASE_32)
            redesign15_phase(torch, spec, gpu_line)
        return 0
    if args.phase == 29:
        from lbm_tpu_torch.ops.devspace import DevSpec

        build_native_io()
        phase("29. K1's 16-bit forms and K2's in aligned multi-cell words: vs plain and the "
              "one-cell forms, attributes, in turns, the c16 decks"
              + (f", the package under {args.import_from}" if args.import_from else ""))
        # Another checkout (a trial among them) is checked and timed, and
        # its gate values printed; the gate holds this tree.
        redesign12_phase(torch, DevSpec.for_params(DENSITY, ACCEL), cli, gpu_line,
                         gates=not args.import_from)
        return 0
    if args.phase == 28:
        from lbm_tpu_torch.ops.devspace import DevSpec

        spec = DevSpec.for_params(DENSITY, ACCEL)
        if args.import_from:
            phase(f"28. K7 and K8 vs their plain versions and K1, beside K9, K10 and K13, the "
                  f"package under {args.import_from}")
            k78_checks(torch, spec, skip_refused=True)
            redesign11_turns(torch, spec, gpu_line)
        else:
            phase("28. K7 and K8 in one window at any T: vs plain and K1, beside K9, K10 and "
                  "K13, K7's schedules, the decks' loop MLUPS")
            redesign11_phase(torch, spec, gpu_line)
        return 0
    if args.phase == 27:
        from lbm_tpu_torch.ops.devspace import DevSpec

        spec = DevSpec.for_params(DENSITY, ACCEL)
        if args.import_from:
            phase(f"27. K5 and K6 vs their plain versions and K1, beside K9 and K11, the c16 "
                  f"gate decks, the package under {args.import_from}")
            k56_checks(torch, spec, skip_refused=True)
            redesign10_turns(torch, spec, gpu_line)
            k56_gate_decks(cli, gpu_line)
        else:
            phase("27. K5 and K6 in one window: vs plain and K1, beside K9 and K11, the "
                  "schedule sweep, the c16 gate decks")
            redesign10_phase(torch, spec, cli, gpu_line)
        return 0
    if args.phase == 26:
        from lbm_tpu_torch.ops.devspace import DevSpec

        spec = DevSpec.for_params(DENSITY, ACCEL)
        if args.import_from:
            phase(f"26. K9 vs its plain version and K1, then K3 16-bit and K9 beside their "
                  f"rivals, the package under {args.import_from}")
            k9_checks(torch, spec, skip_refused=True)
            redesign9_turns(torch, spec, gpu_line)
        else:
            phase("26. K3's paired 16-bit words and K9's one window: the cluster barrier, vs "
                  "plain and K1, beside their rivals, K9's schedules")
            redesign9_phase(torch, spec, gpu_line)
        return 0
    build_native_io()

    phase("3. K1 step kernel vs step_plain")
    k1_err, k1_ms, k1_plain_ms = kernel_phase(torch, "K1", run_step, run_step_plain, (200,))

    phase("4. K2 AA kernel vs run_aa_plain")
    k2_err, k2_ms, k2_plain_ms = kernel_phase(torch, "K2", run_aa, run_aa_plain, (200, 201))
    cells, nobst = random_setup(torch, 1024, 1024, seed=11)
    compare(torch, "K2 vs K1 1024x1024 1000 steps",
            run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, 1.0),
            run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, 1.0))
    c1, a1 = run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, 301, 1.0)
    c2, a2 = run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, 301, 1.0)
    check(torch.equal(a1, a2) and torch.equal(c1, c2), "K2 is not run-to-run deterministic")
    log("  K2 determinism: two 301-step runs give bitwise-equal av series and state")

    phase("5. the K2 and K1 path: lbm_tpu_torch.cli.main on the official decks")
    run_aa.launches = 0
    run_step.launches = 0
    with tempfile.TemporaryDirectory() as work:
        for tag in DECKS:
            run_deck(cli, tag, "aa", work, gpu_line)
        run_deck(cli, "1024x1024", "pallas", work, gpu_line)
    aa_launches, step_launches = run_aa.launches, run_step.launches
    want_aa = sum(fields[2] for fields, _, _ in DECKS.values())
    want_step = DECKS["1024x1024"][0][2]
    log(f"  launch counters: K2 {aa_launches} steps (want {want_aa}), "
        f"K1 {step_launches} steps (want {want_step})")
    check(aa_launches == want_aa, "--backend aa did not run every step through K2")
    check(step_launches == want_step, "--backend pallas did not run every step through K1")

    phase("6. band kernels K7, K9, K11 vs their plain versions")
    routes = band_routes()
    aa_us = {}
    for nx, n_aa in ((2048, 800), (4096, 200)):
        cells, nobst = random_setup(torch, nx, nx, seed=7)
        run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, 10, 1.0)
        _, ms = timed(torch, lambda: run_aa(cells, nobst, DENSITY, ACCEL, OMEGA, n_aa, 1.0))
        aa_us[nx] = 1e3 * ms / n_aa
    band_res = {}
    for route, (label, kernel, plain, cfg) in routes.items():
        depth = cfg[1]
        counts = (depth, 2 * depth + 3) + ((3 * depth, 4 * depth) if route == "band3" else ())
        band_res[route] = band_phase(torch, label, kernel, plain, cfg, counts, aa_us)

    phase("7. band kernels vs K1 over 1000 steps at 2048x2048, and repeatability")
    cells, nobst = random_setup(torch, 2048, 2048, seed=13)
    k1 = run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, 1.0)
    for route, (label, kernel, _, (block, depth, panel)) in routes.items():
        def go():
            return kernel(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, block, depth, panel=panel)

        (c1, a1), (c2, a2) = go(), go()
        torch.cuda.synchronize()
        log(f"  {label} vs K1: final state bitwise equal: {torch.equal(c1, k1[0])}, max diff "
            f"{float((c1 - k1[0]).abs().max()):.3e}")
        compare(torch, f"{label} vs K1 2048x2048 1000 steps", (c1, a1), k1)
        check(torch.equal(c1, c2) and torch.equal(a1, a2), f"{label} is not run-to-run deterministic")
        log(f"  {label} determinism: two 1000-step runs give bitwise-equal av series and state")
    del cells, nobst, k1

    phase("8. the band path: lbm_tpu_torch.cli.main with band, band2, band3 and auto")
    from lbm_tpu_torch.ops import band, band2, band3, deep, resident

    counters = {"band": band.run_band, "band2": band2.run_band2, "band3": band3.run_band3}
    for fn in (*counters.values(), run_step, run_aa, resident.run_resident, deep.run_deep):
        fn.launches = 0
    resident.run_resident.launches_smem = 0
    want = dict.fromkeys((*counters, "deep"), 0)
    want_k1 = want_k2 = want_k4 = 0

    def account(stats):
        nonlocal want_k1, want_k2, want_k4
        route, n = stats["route"], stats["max_iters"]
        if route in want:
            depth = pass_depth(route, stats["ny"], stats["nx"])
            want[route] += n // depth * depth
            want_k1 += n % depth
        elif route == "resident":
            want_k4 += n
        else:
            check(route == "aa", f"unexpected route {route}")
            want_k2 += n

    # The 2048^2 walls deck and its K2 run stay for phase 11, in ``keep``.
    keep = tempfile.mkdtemp()
    walls_ref = {}
    with tempfile.TemporaryDirectory() as work:
        for tag in DECKS:
            stats = run_deck(cli, tag, "auto", work, gpu_line)
            check(stats["route"] == AUTO_ROUTES[tag],
                  f"{tag}: auto routed {stats['route']}, not {AUTO_ROUTES[tag]}")
            account(stats)
        for tag in ("256x256", "1024x1024"):
            for route in counters:
                account(run_deck(cli, tag, route, work, gpu_line))
        for n, iters in WALLS_DECKS:
            deck = write_walls_deck(keep if n == 2048 else work, n, iters)
            ref, stats = run_walls(cli, deck, "aa", keep if n == 2048 else work, n, gpu_line)
            account(stats)
            # On 4096^2 only auto: the band kernels ran that size in phase 6,
            # and writing and checking the deck's 16.7M-line outputs is most
            # of this phase's time.
            for backend in (*counters, "auto") if n < 4096 else ("auto",):
                out, stats = run_walls(cli, deck, backend, work, n, gpu_line)
                account(stats)
                check(backend != "auto" or stats["route"] == AUTO_ABOVE,
                      f"walls {n}^2: auto routed {stats['route']}, not {AUTO_ABOVE}")
                hold_against(out, ref, f"walls {n}^2 --backend {backend}")
                shutil.rmtree(out)
            if n == 2048:
                walls_ref[n] = (deck, ref)
            else:
                shutil.rmtree(ref)
    got = {route: fn.launches for route, fn in counters.items()}
    auto_deep = deep.run_deep.launches
    log(f"  launch counters: K7 {got['band']} steps (want {want['band']}), K9 {got['band2']} "
        f"(want {want['band2']}), K11 {got['band3']} (want {want['band3']}), K6 {auto_deep} "
        f"(want {want['deep']}), K1 {run_step.launches} (want {want_k1}), K2 {run_aa.launches} "
        f"(want {want_k2}), K4 shared-memory form {resident.run_resident.launches_smem} (want "
        f"{want_k4}), K4 global-memory form {resident.run_resident.launches} (want 0)")
    for route in counters:
        check(got[route] == want[route], f"--backend {route}: not every band step ran in its kernel")
    check(auto_deep == want["deep"] > 0, "auto did not run every step of the large decks in K6")
    check(run_step.launches == want_k1, "not every remainder step ran in K1")
    check(resident.run_resident.launches_smem == want_k4 and resident.run_resident.launches == 0,
          "auto did not run every K4 step of the small decks in K4's shared-memory form")
    k4_smem_launches = resident.run_resident.launches_smem
    check(run_aa.launches == want_k2, "--backend aa did not run every step through K2")

    phase("9. K4, K5, K6 vs their plain versions")
    sched = scheduled_routes()
    _, k11_run, _, k11_cfg = routes["band3"]

    def k11(c, o, n):
        return k11_run(c, o, DENSITY, ACCEL, OMEGA, n, k11_cfg[0], k11_cfg[1], panel=k11_cfg[2])

    sched_res = {}
    for route, (label, kernel, plain, depth) in sched.items():
        counts = (254, 255, 256, 511) if route == "resident" else (depth, 2 * depth + 3)
        sched_res[route] = scheduled_phase(torch, label, kernel, plain, counts, depth, k11)

    phase("10. K4, K5, K6 vs K1 over 1000 steps at 2048x2048, and repeatability")
    cells, nobst = random_setup(torch, 2048, 2048, seed=17)
    k1 = run_step(cells, nobst, DENSITY, ACCEL, OMEGA, 1000, 1.0)
    for route, (label, kernel, _, _) in sched.items():
        (c1, a1), (c2, a2) = kernel(cells, nobst, 1000), kernel(cells, nobst, 1000)
        torch.cuda.synchronize()
        log(f"  {label} vs K1: final state bitwise equal: {torch.equal(c1, k1[0])}, max diff "
            f"{float((c1 - k1[0]).abs().max()):.3e}")
        compare(torch, f"{label} vs K1 2048x2048 1000 steps", (c1, a1), k1)
        check(torch.equal(c1, c2) and torch.equal(a1, a2), f"{label} is not run-to-run deterministic")
        log(f"  {label} determinism: two 1000-step runs give bitwise-equal av series and state")
    del cells, nobst, k1, c1, c2

    phase("11. the resident, temporal and deep path: lbm_tpu_torch.cli.main, and --resume")
    from lbm_tpu_torch.ops import deep, resident, temporal

    sched_counters = {"resident": resident.run_resident, "temporal": temporal.run_temporal,
                      "deep": deep.run_deep}
    for fn in (*sched_counters.values(), run_step):
        fn.launches = 0
    resident.run_resident.launches_smem = 0
    want = dict.fromkeys(sched_counters, 0)
    want_k1 = want_smem = 0
    sms = resident.sm_count(torch.device("cuda", 0))

    def account_sched(stats):
        nonlocal want_k1, want_smem
        route, n = stats["route"], stats["max_iters"]
        check(route in sched_counters, f"unexpected route {route}")
        if route == "resident" and resident.resident_smem_config(stats["ny"], stats["nx"], sms):
            want_smem += n
            return
        depth = sched[route][3]
        want[route] += n // depth * depth
        want_k1 += n % depth

    with tempfile.TemporaryDirectory() as work:
        for tag in ("256x256", "1024x1024"):
            for route in sched_counters:
                account_sched(run_deck(cli, tag, route, work, gpu_line))
        want_smem += sum(resume_run(cli, work, gpu_line))  # 256^2: the shared-memory form
        deck, ref = walls_ref[2048]  # phase 8's deck and K2 run
        for route in sched_counters:
            out, stats = run_walls(cli, deck, route, work, 2048, gpu_line)
            account_sched(stats)
            hold_against(out, ref, f"walls 2048^2 --backend {route}")
            shutil.rmtree(out)
    got_sched = {route: fn.launches for route, fn in sched_counters.items()}
    log(f"  launch counters: K4 {got_sched['resident']} steps (want {want['resident']}), K4 "
        f"shared-memory form {resident.run_resident.launches_smem} (want {want_smem}), K5 "
        f"{got_sched['temporal']} (want {want['temporal']}), K6 {got_sched['deep']} (want "
        f"{want['deep']}), K1 {run_step.launches} (want {want_k1})")
    for route in sched_counters:
        check(got_sched[route] == want[route], f"--backend {route}: not every step ran in its kernel")
    check(resident.run_resident.launches_smem == want_smem,
          "--backend resident: not every step of a grid the shared-memory form holds ran in it")
    check(run_step.launches == want_k1, "not every remainder step ran in K1")

    shard, shard_res, got_mesh = mesh_phases(torch, cli, run_step, gpu_line)

    from lbm_tpu_torch.ops.devspace import DevSpec

    spec = DevSpec.for_params(DENSITY, ACCEL)
    phase("15. c16 kernels K1, K2, K11, K7 vs their plain versions")
    c16_res = c16_phase(torch, spec, routes)
    phase("16. K13 slab kernel at f32 and c16: vs its plain version, vs K1, the (K, S) sweep")
    slab_cfg, slab_err, slab_c16_err, sweep, slab_plain, slab_plain_c16, beside = slab_phase(
        torch, spec, routes)
    phase("17. the c16 and slab path: lbm_tpu_torch.cli.main --precision c16, "
          "LBM_ENABLE_SLAB=1 --backend slab, and --resume")
    got_c16 = c16_path_phase(torch, cli, gpu_line, walls_ref[2048])
    shutil.rmtree(keep)
    phase("18. c16 forms K9, K5, K6, K3, K8, K10 vs their plain versions and f32 forms")
    more = c16_more_forms()
    more_res = c16_more_phase(torch, spec, more)
    phase("19. the c16 path: lbm_tpu_torch.cli.main --precision c16 with band2, temporal, deep, "
          "--mesh 4 and 2x2 --device 0, and --resume")
    got_more = c16_mesh_path_phase(torch, cli, gpu_line, more)
    phase("20. the gate per T: K9 and K11 at c16 with T 4, 8 and 16 on the 256^2 and 1024^2 decks")
    gate_per_t_phase(torch, gpu_line)
    phase("21. bf16 forms K1, K2, K3, K5-K11, K13 vs their plain versions, timed beside their f32 "
          "and c16 forms")
    forms_bf16 = bf16_forms(routes, more, slab_cfg)
    bf16_res = bf16_phase(torch, spec, forms_bf16)
    phase("22. the bf16 path: lbm_tpu_torch.cli.main --precision bf16 on one card, --mesh 4 / "
          "2x2 --device 0, and --resume")
    got_bf16, _ = bf16_path_phase(torch, cli, gpu_line, forms_bf16, slab_cfg)
    phase("23. K4's shared-memory form: the barrier floor, vs its plain version, and timed beside "
          "the global-memory form and K2")
    k4s_err, k4s_per, k4s_plain = k4_smem_phase(torch, gpu_line)
    phase("24. K11 at f32, c16 and bf16 vs its plain version, and beside K2 in turns")
    k11_phase(torch, spec, gpu_line, routes["band3"][3])
    phase("25. the auto crossover: K4, K6, K7, K9 and K11 in turns at 128x256 and 256^2-1024^2")
    crossover_phase(torch, gpu_line)
    phase("26. K3's paired 16-bit words and K9's one window: the cluster barrier, vs plain and "
          "K1, beside their rivals, K9's schedules")
    redesign9_phase(torch, spec, gpu_line)
    phase("27. K5 and K6 in one window: vs plain and K1, beside K9 and K11, the schedule sweep, "
          "the c16 gate decks")
    redesign10_phase(torch, spec, cli, gpu_line)
    phase("28. K7 and K8 in one window at any T: vs plain and K1, beside K9, K10 and K13, "
          "K7's schedules, the decks' loop MLUPS")
    redesign11_phase(torch, spec, gpu_line)
    phase("29. K1's 16-bit forms and K2's in aligned multi-cell words: vs plain and the one-cell "
          "forms, attributes, in turns, the c16 decks")
    redesign12_phase(torch, spec, cli, gpu_line)
    with tempfile.TemporaryDirectory() as work:
        phase(PHASE_30)
        across = multihost_phase(torch, cli, gpu_line, work)
    with tempfile.TemporaryDirectory() as work:
        phase(PHASE_31)
        diagnostics_phase(torch, cli, gpu_line, work)
    phase(PHASE_32)
    redesign15_phase(torch, spec, gpu_line, alone=False)

    def entry(name, source, replaces, launches, err, ms, plain_ms, cells, depth=1,
              bytes_per_cell=BYTES_PER_CELL):
        bound_ms, bound_by = bound(cells, depth, bytes_per_cell)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}

    from lbm_tpu_torch.ops.resident import CHUNK_STEPS

    shard_launches = {"K3": got_mesh["pallas"], "K12": got_mesh["pallas-overlap"],
                      "K8": got_mesh["band"], "K10": got_mesh["band2"]}
    band_depth = {route: routes[route][3][1] for route in BANDS}
    kt, sb = slab_cfg[3] * slab_cfg[1], slab_cfg[4]
    slab_bytes = (sb + 2 * kt) / sb
    slab_ms = sweep[2048, slab_cfg[3], sb]
    report = {"kernels": [
        entry("K1 fused step", "lbm_tpu_torch/csrc/step.cu", "lbm_tpu/ops/pallas_step.py:164",
              step_launches, k1_err, k1_ms, k1_plain_ms, 1024 * 1024),
        entry("K2 in-place AA", "lbm_tpu_torch/csrc/aa.cu", "lbm_tpu/ops/pallas_aa.py:163",
              aa_launches, k2_err, k2_ms, k2_plain_ms, 1024 * 1024),
    ] + [
        entry(*BANDS[route], got[route], band_res[route][0], band_res[route][1][2048][0],
              band_res[route][1][2048][1], 2048 * 2048, band_depth[route])
        for route in BANDS
    ] + [
        entry(*SCHEDULED[route], got_sched[route] + (auto_deep if route == "deep" else 0),
              sched_res[route][0],
              *sched_res[route][1][1024 if route == "resident" else 2048],
              (1024 if route == "resident" else 2048) ** 2,
              CHUNK_STEPS if route == "resident" else sched[route][3])
        for route in SCHEDULED
    ] + [
        entry(*RESIDENT_SMEM, k4_smem_launches, k4s_err,
              k4s_per[256, 256]["shared-memory form"] * 1e-3, k4s_plain, 256 * 256,
              CHUNK_STEPS),
    ] + [
        entry(*SHARDED[name], shard_launches[name], shard_res[name][0],
              *shard_res[name][1][(4, 1), 2048][:2], 2048 * 2048, shard[name][4])
        for name in SHARDED
    ] + [
        entry(*C16_KERNELS[name], got_c16[name + " c16"], c16_res[name][0], c16_res[name][1],
              c16_res[name][2], (1024 if name in ("K1", "K2") else 2048) ** 2,
              1 if name in ("K1", "K2") else band_depth["band3" if name == "K11" else "band"],
              BYTES_PER_CELL_C16)
        for name in C16_KERNELS
    ] + [
        entry(*SLAB, got_c16["K13"], slab_err, slab_ms, slab_plain, 2048 * 2048, kt,
              BYTES_PER_CELL * slab_bytes),
        entry(SLAB[0] + ", c16", *SLAB[1:], got_c16["K13 c16"], slab_c16_err, beside[2048][2],
              slab_plain_c16, 2048 * 2048, kt, BYTES_PER_CELL_C16 * slab_bytes),
    ] + [
        entry(*C16_MORE[name], got_more[name + " c16"], *more_res[name][:3], 2048 * 2048,
              more[name][2], BYTES_PER_CELL_C16)
        for name in C16_MORE
    ] + [
        entry(*BF16_KERNELS[name], got_bf16[name], *bf16_res[name][:3],
              (1024 if name in ("K1", "K2") else 2048) ** 2, forms_bf16[name][2],
              BYTES_PER_CELL_BF16 * (slab_bytes if name == "K13" else 1))
        for name in BF16_KERNELS
    ] + [
        entry(*K3_ROWS, *across["K3 rows"], 1024 * 1024),
        entry(*K12_IPC, *across["K12 ipc"], 1024 * 1024),
    ]}
    log(gpu_line)
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.time()
    rc = main()
    print(f"chip_smoke: done in {time.time() - t0:.1f} s", file=sys.stderr)
    raise SystemExit(rc)
