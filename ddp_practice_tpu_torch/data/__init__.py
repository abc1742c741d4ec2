"""Data pipeline of the port (counterparts of ddp_practice_tpu/data)."""
