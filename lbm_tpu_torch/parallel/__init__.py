"""Runs over a mesh of devices (counterpart of ``lbm_tpu/parallel``): in
one process, ``parallel/sharded.py``; one row shard per process,
``parallel/multihost.py``."""
