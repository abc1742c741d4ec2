"""Decoder-only transformer language model (counterpart of
ddp_practice_tpu/models/lm.py).

The block stack is `models/vit.py EncoderBlock` (pre-LN, causal). Logits
come out in the policy compute dtype; consumers upcast. `forward(tokens)`
is the training forward; `forward(tokens, cache=...)` is KV-cache decode
(inference.py builds the cache with `init_cache`): the call appends the
tokens at the cache cursor, so one module serves prompt prefill (s =
prompt length) and single-token steps (s = 1).

Not ported in this slice: sequence parallelism (`seq_axis`), remat, MoE
blocks, the fused encoder layer (`fused=True`) and the paged cache
(`page_table`); each raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ddp_practice_tpu_torch.models.vit import EncoderBlock, LayerNorm, dense


class TransformerLM(nn.Module):
    def __init__(self, *, vocab_size: int = 256, max_len: int = 2048,
                 hidden_dim: int = 256, depth: int = 4, num_heads: int = 8,
                 mlp_dim: int = 1024, dtype=torch.float32,
                 param_dtype=torch.float32, seq_axis: Optional[str] = None,
                 sp_impl: str = "ring", attn_impl: str = "xla",
                 kv_cache_dtype=None, pos_emb: str = "learned",
                 tied_embeddings: bool = False, dropout_rate: float = 0.0,
                 moe_every: int = 0, fused="auto") -> None:
        super().__init__()
        if pos_emb not in ("learned", "rope"):
            raise ValueError(
                f"unknown pos_emb {pos_emb!r} (want 'learned'|'rope')"
            )
        if moe_every:
            raise NotImplementedError("MoE blocks are not ported yet")
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.hidden_dim = hidden_dim
        self.depth = depth
        self.num_heads = num_heads
        self.dtype = dtype
        self.pos_emb = pos_emb
        self.tied_embeddings = tied_embeddings
        self.dropout_rate = dropout_rate
        self.tok_embed = nn.Embedding(vocab_size, hidden_dim)
        if pos_emb == "learned":
            self.pos_embed = nn.Parameter(torch.zeros(1, max_len, hidden_dim))
        self.blocks = nn.ModuleList(
            EncoderBlock(
                hidden_dim, num_heads, mlp_dim, dtype=dtype,
                seq_axis=seq_axis, sp_impl=sp_impl, attn_impl=attn_impl,
                causal=True, rope=pos_emb == "rope",
                kv_cache_dtype=kv_cache_dtype, dropout_rate=dropout_rate,
                fused=fused,
            )
            for _ in range(depth)
        )
        self.ln_f = LayerNorm(hidden_dim, dtype)
        if not tied_embeddings:
            # bias-free, the GPT-2 convention (as the reference)
            self.lm_head = nn.Linear(hidden_dim, vocab_size, bias=False)
        self.to(param_dtype)

    def set_decode_impl(self, impl: str) -> None:
        """Route every block's single-token step: "auto" (the kernel for
        CUDA tensors, the plain version for CPU tensors), "kernel" or
        "plain" (ops/decode_attention.py)."""
        for blk in self.blocks:
            blk.attn.decode_impl = impl

    def init_cache(self, batch: int, total_len: int, device=None) -> dict:
        """Zero KV cache with the Flax "cache" collection's tree:
        {"block{i}": {"attn": {...}}} plus "pos_index" for learned
        positions. Cursors are host ints."""
        device = device or self.tok_embed.weight.device
        cache = {
            f"block{i}": {"attn": blk.attn.init_cache(batch, total_len,
                                                      device)}
            for i, blk in enumerate(self.blocks)
        }
        if self.pos_emb == "learned":
            cache["pos_index"] = 0
        return cache

    def forward(self, tokens: torch.Tensor, *, train: bool = False,
                cache: Optional[dict] = None,
                attn_start: Optional[torch.Tensor] = None,
                page_table=None) -> torch.Tensor:
        """tokens (b, s) int -> logits (b, s, vocab) in the compute dtype.

        `attn_start` (b,) int32, decode only: first real key position per
        sequence (left-padded prompts); needs pos_emb="rope"."""
        if page_table is not None:
            raise NotImplementedError("the paged KV cache is not ported yet")
        decode = cache is not None
        if attn_start is not None and self.pos_emb != "rope":
            raise ValueError(
                "variable-length (left-padded) prompts need pos_emb='rope' "
                "— learned absolute positions would shift with the padding"
            )
        if attn_start is not None and not decode:
            raise ValueError(
                "attn_start is a KV-cache decode feature (inference.py); "
                "the training forward has no left-padding mask"
            )
        b, s = tokens.shape
        if s > self.max_len:
            raise ValueError(f"sequence {s} exceeds max_len {self.max_len}")
        x = F.embedding(tokens, self.tok_embed.weight.to(self.dtype))
        if self.pos_emb == "learned":
            p0 = cache["pos_index"] if decode else 0
            x = x + self.pos_embed[:, p0:p0 + s].to(self.dtype)
            if decode:
                cache["pos_index"] = p0 + s
        train = train and not decode
        x = F.dropout(x, self.dropout_rate, training=train)
        for i, blk in enumerate(self.blocks):
            x = blk(x, train=train,
                    cache=cache[f"block{i}"]["attn"] if decode else None,
                    attn_start=attn_start)
        x = self.ln_f(x)
        if self.tied_embeddings:
            return x @ self.tok_embed.weight.to(self.dtype).T
        return dense(x, self.lm_head, self.dtype)


def LMTiny(**kw) -> TransformerLM:
    """Test-sized decoder (d=256, depth 4)."""
    kw.setdefault("hidden_dim", 256)
    kw.setdefault("depth", 4)
    kw.setdefault("num_heads", 8)
    kw.setdefault("mlp_dim", 1024)
    return TransformerLM(**kw)


def LMBase(**kw) -> TransformerLM:
    """GPT-2-small shape: d=768, depth 12, 12 heads, mlp 3072."""
    kw.setdefault("hidden_dim", 768)
    kw.setdefault("depth", 12)
    kw.setdefault("num_heads", 12)
    kw.setdefault("mlp_dim", 3072)
    kw.setdefault("max_len", 8192)
    return TransformerLM(**kw)
