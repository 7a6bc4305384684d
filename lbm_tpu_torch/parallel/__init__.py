"""Runs over a mesh of devices in one process (counterpart of
``lbm_tpu/parallel``): ``parallel/sharded.py``."""
