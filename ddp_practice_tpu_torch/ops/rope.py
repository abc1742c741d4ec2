"""Rotary position embeddings (counterpart of ddp_practice_tpu/ops/rope.py).

GPT-NeoX rotate-half convention: channel pairs are (i, i + d/2). Angles
are computed in fp32 (bf16 loses position resolution past a few thousand
tokens) and the result is cast back to the input dtype.
"""

from __future__ import annotations

import torch


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate (b, s, h, d) by per-position angles; positions is (s,) or
    (b, s) integer."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {d}")
    half = d // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions.to(torch.float32)[..., None] * freqs
    if angles.ndim == 2:        # (s, half): shared across the batch
        cos = torch.cos(angles)[None, :, None, :]
        sin = torch.sin(angles)[None, :, None, :]
    elif angles.ndim == 3:      # (b, s, half): per-sequence offsets
        cos = torch.cos(angles)[:, :, None, :]
        sin = torch.sin(angles)[:, :, None, :]
    else:
        raise ValueError(
            f"positions must be (s,) or (b, s), got ndim {positions.ndim}"
        )
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
