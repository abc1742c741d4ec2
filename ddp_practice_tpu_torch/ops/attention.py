"""Attention ops (counterpart of ddp_practice_tpu/ops/attention.py).

Plain PyTorch: the reference runs these outside any Pallas kernel, so the
port writes no kernel for them. Scores accumulate in fp32, masked scores
are filled with -1e30 (not -inf, so a fully masked row stays finite), and
probabilities are rounded to the input dtype before the value product —
the reference's arithmetic, step for step.

The sequence-parallel schemes and the streaming flash kernel are later
slices of the port: `impl="flash"` and `seq_axis` raise until then.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_MASK_FILL = -1e30


def dot_product_attention(q, k, v, *, causal: bool = False,
                          seq_axis: Optional[str] = None,
                          sp_impl: str = "ring",
                          impl: str = "xla") -> torch.Tensor:
    """Multi-head attention over (batch, seq, heads, head_dim)."""
    if impl not in ("xla", "flash"):
        raise ValueError(f"unknown attention impl {impl!r} (want 'xla'|'flash')")
    if seq_axis is not None:
        raise NotImplementedError(
            f"sequence-parallel attention ({sp_impl}) is not ported yet"
        )
    if impl == "flash":
        raise NotImplementedError("impl='flash' is not ported yet")
    return _attention(q, k, v, causal=causal)


def attention_with_mask(q, k, v, mask) -> torch.Tensor:
    """Attention under an explicit boolean mask (True = attend).

    `mask` broadcasts against scores (b, h, sq, sk); a 2D (sq, sk) mask is
    promoted. This is the KV-cache prefill path (models/vit.py
    SelfAttention `decode=True`)."""
    if mask.ndim == 2:
        mask = mask[None, None]
    return _attention(q, k, v, causal=False, mask=mask)


def _attention(q, k, v, *, causal: bool, mask=None) -> torch.Tensor:
    in_dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    # (b, s, h, d) -> scores (b, h, sq, sk) in fp32
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)
    ) * scale
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        tri = torch.ones((sq, sk), dtype=torch.bool,
                         device=scores.device).tril(sk - sq)
        scores = scores.masked_fill(~tri, _MASK_FILL)
    if mask is not None:
        scores = scores.masked_fill(~mask, _MASK_FILL)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum(
        "bhqk,bkhd->bqhd",
        probs.to(in_dtype).to(torch.float32), v.to(torch.float32),
    )
    return out.to(in_dtype)
