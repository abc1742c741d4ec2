"""Host-side utilities of the port (counterparts of ddp_practice_tpu/utils)."""
