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

MoE (`moe_every` > 0, the reference's GShard layout): every
`moe_every`-th block swaps its dense MLP for a routed expert MLP
(ops/moe.py `MoEMlp`, configured by the `num_experts`, `moe_top_k`,
`capacity_factor`, `moe_aux_weight`, `moe_bias_rate`, `moe_group_size`,
`moe_group_stride` and `moe_router` fields); routed blocks never fuse.
`train=True` lets them record their aux loss and router-bias update for
the training step (train/steps.py). Decode (flat cache, paged steps and
paged prefill) runs through them too: they route with their current
`router_bias` buffers and record nothing (ops/moe.py `decode`).

Tensor parallelism (parallel/mesh.py `shard_state` sets `tp`): the
blocks hold their ranks' heads and MLP features (models/vit.py), the
token embedding its vocabulary rows (a masked local lookup, summed over
the group) and the head its vocabulary outputs, gathered whole before
the loss or the sampler sees them; the tied head reads the same
vocabulary-sharded embedding. A KV cache built from a sharded model
holds the rank's heads.

Sequence parallelism (`seq_axis`; parallel/mesh.py `shard_state` sets
`sp`, the SeqGroup, on the model and its layers): `forward` takes the
rank's contiguous chunk of every sequence, (b, s / N) tokens at global
positions [rank * s / N, (rank + 1) * s / N); learned positions read the
chunk's rows of `pos_embed`, RoPE rotates at the global positions, the
attention layers cross the chunks (ring or Ulysses, `sp_impl`), dropout
draws the whole sequence's masks at the chunk's positions, and the
logits are the chunk's. Decode under `seq_axis` raises, as the
reference's. The routed blocks' MLPs take the seq group too and route
the whole sequence (ops/moe.py); under the expert axis they hold their
rank's experts (parallel/mesh.py `shard_state`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ddp_practice_tpu_torch.models.vit import (
    DropoutKey,
    EncoderBlock,
    LayerNorm,
    dense,
    dropout,
    seq_rows,
    subkey,
)
from ddp_practice_tpu_torch.parallel.tensor import (
    copy_to_tp,
    gather_from_tp,
    reduce_from_tp,
)


class TransformerLM(nn.Module):
    def __init__(self, *, vocab_size: int = 256, max_len: int = 2048,
                 hidden_dim: int = 256, depth: int = 4, num_heads: int = 8,
                 mlp_dim: int = 1024, dtype=torch.float32,
                 param_dtype=torch.float32, seq_axis: Optional[str] = None,
                 sp_impl: str = "ring", attn_impl: str = "xla",
                 kv_cache_dtype=None, pos_emb: str = "learned",
                 tied_embeddings: bool = False, dropout_rate: float = 0.0,
                 moe_every: int = 0, num_experts: int = 8,
                 moe_top_k: int = 2, capacity_factor: float = 1.25,
                 moe_aux_weight: float = 0.01, moe_bias_rate: float = 0.02,
                 moe_group_size: int = 0, moe_group_stride: bool = True,
                 moe_router: str = "topk", fused="auto",
                 remat: bool = False) -> None:
        super().__init__()
        if pos_emb not in ("learned", "rope"):
            raise ValueError(
                f"unknown pos_emb {pos_emb!r} (want 'learned'|'rope')"
            )
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
        self.moe_every = moe_every
        self.moe_top_k = moe_top_k
        self.seq_axis = seq_axis
        # the seq group under sequence parallelism (parallel/mesh.py)
        self.sp = None
        self.tok_embed = nn.Embedding(vocab_size, hidden_dim)
        if pos_emb == "learned":
            self.pos_embed = nn.Parameter(torch.zeros(1, max_len, hidden_dim))
        routed = [moe_every > 0 and i % moe_every == moe_every - 1
                  for i in range(depth)]
        self.blocks = nn.ModuleList(
            EncoderBlock(
                hidden_dim, num_heads, mlp_dim, dtype=dtype,
                seq_axis=seq_axis, sp_impl=sp_impl, attn_impl=attn_impl,
                causal=True, rope=pos_emb == "rope",
                kv_cache_dtype=kv_cache_dtype, dropout_rate=dropout_rate,
                use_moe=moe, num_experts=num_experts, moe_top_k=moe_top_k,
                capacity_factor=capacity_factor,
                moe_aux_weight=moe_aux_weight, moe_bias_rate=moe_bias_rate,
                moe_group_size=moe_group_size,
                moe_group_stride=moe_group_stride, moe_router=moe_router,
                # routed blocks never fuse (the kernels have no expert
                # dispatch): a forced fused=True fuses every dense block
                fused=False if moe else fused,
            )
            for moe in routed
        )
        self.ln_f = LayerNorm(hidden_dim, dtype)
        if not tied_embeddings:
            # bias-free, the GPT-2 convention (as the reference)
            self.lm_head = nn.Linear(hidden_dim, vocab_size, bias=False)
        # under tensor parallelism (parallel/mesh.py shard_state): the
        # group; tok_embed holds this rank's vocabulary rows, lm_head its
        # vocabulary outputs
        self.tp = None
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
                dropout_key: Optional[DropoutKey] = None,
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
        sp = self.sp
        if sp is not None and decode:
            raise ValueError(
                "decode (KV-cache) mode does not compose with sequence "
                "parallelism — generate on a data/tensor-sharded mesh"
            )
        total = s if sp is None else s * sp.size
        if total > self.max_len:
            raise ValueError(
                f"sequence {total} exceeds max_len {self.max_len}")
        x = self._embed(tokens)
        if self.pos_emb == "learned":
            p0 = cache["pos_index"] if decode else 0
            if sp is not None:
                p0 += sp.offset(s)
            x = x + self.pos_embed[:, p0:p0 + s].to(self.dtype)
            if decode:
                cache["pos_index"] = p0 + s
        # dropout only in the training forward, never in decode
        key = (dropout_key if train and not decode and self.dropout_rate
               else None)
        if train and not decode and self.dropout_rate and key is None:
            raise ValueError("a training forward with dropout needs a "
                             "dropout_key (train/steps.py step_key)")
        x = dropout(x, self.dropout_rate, subkey(key, 0),
                    rows=seq_rows(sp, x))
        for i, blk in enumerate(self.blocks):
            if self.remat and not decode:
                x = checkpoint(blk, x, dropout_key=subkey(key, i + 1),
                               train=train, use_reentrant=False)
                continue
            x = blk(x, dropout_key=subkey(key, i + 1),
                    train=train and not decode,
                    cache=cache[f"block{i}"]["attn"] if decode else None,
                    attn_start=attn_start, page_table=page_table,
                    kv_lengths=kv_lengths)
        x = copy_to_tp(self.ln_f(x), self.tp)
        if self.tied_embeddings:
            logits = x @ self.tok_embed.weight.to(self.dtype).T
        else:
            logits = dense(x, self.lm_head, self.dtype)
        # vocab-parallel logits made whole for the loss and the sampler
        return gather_from_tp(logits, self.tp)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return vocab_embed(tokens, self.tok_embed.weight, self.tp,
                           self.dtype)


def vocab_embed(tokens: torch.Tensor, weight: torch.Tensor, tp,
                dtype) -> torch.Tensor:
    """The token lookup in `dtype`; under tensor parallelism (`tp`) each
    rank looks up the tokens in its vocabulary rows (zeros elsewhere) and
    the group sums the parts."""
    w = weight.to(dtype)
    if tp is None:
        return F.embedding(tokens, w)
    rows = w.shape[0]
    local = tokens - tp.rank * rows
    mine = (local >= 0) & (local < rows)
    x = F.embedding(local.clamp(0, rows - 1), w) * mine[..., None].to(
        w.dtype)
    return reduce_from_tp(x, tp)


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
