"""Distributed runtime of the port (counterparts of ddp_practice_tpu/parallel)."""
