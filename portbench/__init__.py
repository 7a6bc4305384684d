"""The benchmark of ``lbm_tpu_torch`` on one NVIDIA H100: ``python -m
portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``
(``run.py``), its cells in ``BENCHMARK.json`` at the repository's root."""
