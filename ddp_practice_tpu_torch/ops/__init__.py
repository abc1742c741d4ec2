"""Ops of the port: attention, RoPE, and the decode-attention kernel."""
