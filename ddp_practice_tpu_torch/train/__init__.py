"""Training: state, steps and the loop (counterparts of
ddp_practice_tpu/train)."""
