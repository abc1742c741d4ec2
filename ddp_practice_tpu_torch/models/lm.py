"""Decoder-only transformer language model (counterpart of
ddp_practice_tpu/models/lm.py).

The block stack is `models/vit.py EncoderBlock` (pre-LN, causal). Logits
come out in the policy compute dtype; consumers upcast. `forward(tokens)`
is the training forward (`train=True` turns dropout on, its masks keyed
on `dropout_key`; `remat=True` recomputes each block's activations in
backward through torch.utils.checkpoint, which replays the same keyed
masks); `forward(tokens, cache=...)` is KV-cache decode
(inference.py builds the cache with `init_cache`): the call appends the
tokens at the cache cursor, so one module serves prompt prefill (s =
prompt length) and single-token steps (s = 1). With `page_table` and
`kv_lengths` the cache is a paged block pool (serve/kv_pages.py) and each
sequence appends at its own slot-local position.

`fused` is the blocks' tri-state (models/vit.py EncoderBlock): under the
default "auto" a plain causal block whose shape the fused kernels take
(e.g. lm_tiny with 4 heads of 64, `attn_impl="xla"`, learned positions)
runs as one kernel per direction on the card; lm_base exceeds the
kernels' limits and keeps the per-op path.

Not ported yet: sequence parallelism (`seq_axis`, ROADMAP A8) and MoE
blocks (A7); each raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ddp_practice_tpu_torch.models.vit import (
    EncoderBlock,
    LayerNorm,
    dense,
    dropout,
    subkey,
)


class TransformerLM(nn.Module):
    def __init__(self, *, vocab_size: int = 256, max_len: int = 2048,
                 hidden_dim: int = 256, depth: int = 4, num_heads: int = 8,
                 mlp_dim: int = 1024, dtype=torch.float32,
                 param_dtype=torch.float32, seq_axis: Optional[str] = None,
                 sp_impl: str = "ring", attn_impl: str = "xla",
                 kv_cache_dtype=None, pos_emb: str = "learned",
                 tied_embeddings: bool = False, dropout_rate: float = 0.0,
                 moe_every: int = 0, fused="auto",
                 remat: bool = False) -> None:
        super().__init__()
        if pos_emb not in ("learned", "rope"):
            raise ValueError(
                f"unknown pos_emb {pos_emb!r} (want 'learned'|'rope')"
            )
        if moe_every:
            raise NotImplementedError(
                "MoE blocks are not ported yet (ROADMAP A7)")
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.hidden_dim = hidden_dim
        self.depth = depth
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.remat = remat
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
                dropout_key: int = 0,
                cache: Optional[dict] = None,
                attn_start: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None,
                kv_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (b, s) int -> logits (b, s, vocab) in the compute dtype.

        `attn_start` (b,) int32, decode only: first real key position per
        sequence (left-padded prompts); needs pos_emb="rope".

        `page_table` (b, max_blocks_per_slot) + `kv_lengths` (b,) int32,
        decode only: paged KV-cache mode — `cache` is a block pool, each
        sequence writes and attends at its own slot-local position through
        its table row, and attn_start is slot-local. s == 1 is the decode
        step; s > 1 the paged prefill (models/vit.py `_paged_decode`)."""
        decode = cache is not None
        if page_table is not None and self.pos_emb != "rope":
            raise ValueError(
                "paged decode needs pos_emb='rope' — per-slot positions "
                "require relative position encoding"
            )
        if page_table is not None and not decode:
            raise ValueError("page_table is a KV-cache decode feature")
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
        # dropout only in the training forward, never in decode
        key = (dropout_key if train and not decode and self.dropout_rate
               else None)
        x = dropout(x, self.dropout_rate, subkey(key, 0))
        for i, blk in enumerate(self.blocks):
            if self.remat and not decode:
                x = checkpoint(blk, x, dropout_key=subkey(key, i + 1),
                               use_reentrant=False)
                continue
            x = blk(x, dropout_key=subkey(key, i + 1),
                    cache=cache[f"block{i}"]["attn"] if decode else None,
                    attn_start=attn_start, page_table=page_table,
                    kv_lengths=kv_lengths)
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
