"""Transformer blocks (counterpart of ddp_practice_tpu/models/vit.py).

This slice ports what the decoder LM runs: `MlpBlock`, `SelfAttention`
(the training forward, with the streaming flash kernels behind
`attn_impl="flash"`, and the flat KV-cache decode path, including the
int8 quantize-on-write cache) and `EncoderBlock` with the unfused path.
The fused one-kernel encoder layer is a later slice (ROADMAP B2):
`fused=True` raises, and `"auto"` resolves to the unfused path.

Dropout keys its masks on an integer (`dropout`): the LM derives one per
site from (seed, step), so a step replays its masks and a rematerialized
block (torch.utils.checkpoint) recomputes the same ones. Masks cannot
match JAX's (threefry vs Philox); parity runs at rate 0.

Parameters stay in `param_dtype` (fp32) and every layer computes in
`dtype`, casting its weights on use as Flax does. LayerNorm epsilon is
1e-6 with fp32 statistics, and GELU is the tanh approximation (Flax
`nn.gelu`). Parameter names follow the Flax tree so `convert.py` can map
one onto the other by name.

Decode state lives in a plain dict per attention layer, with the Flax
"cache" collection's leaf names: `cached_key`/`cached_value` (b, L, h*hd),
`cached_key_scale`/`cached_value_scale` (b, h, L) fp32 for an int8 cache,
and `cache_index`, a host int. The layer writes the incoming tokens' K/V
into the cache in place and advances `cache_index`.

With a `page_table` the same leaves are a paged block pool
(serve/kv_pages.py: `(num_blocks, block_size, h*hd)`, scale pages
`(num_blocks, h, block_size)`) and every sequence writes and attends at
its own slot-local position `kv_lengths[b]` (`_paged_decode`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ddp_practice_tpu_torch.ops.attention import (
    attention_with_mask,
    dot_product_attention,
)
from ddp_practice_tpu_torch.ops.decode_attention import (
    _heads_per_pack,
    decode_attention_packed,
    gather_pages,
    paged_decode_attention,
)
from ddp_practice_tpu_torch.ops.flash_attention import flash_attention_qkv
from ddp_practice_tpu_torch.ops.rope import apply_rope

LN_EPS = 1e-6


def dense(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """Flax Dense semantics: inputs, kernel and bias promoted to `dtype`."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def subkey(key: Optional[int], i: int) -> Optional[int]:
    """The i-th dropout key under `key` (None stays None)."""
    if key is None:
        return None
    return (key * 1_000_003 + i + 1) % (1 << 62)


def dropout(x: torch.Tensor, rate: float,
            key: Optional[int]) -> torch.Tensor:
    """Flax Dropout: keep with probability 1 - rate, kept values divided by
    it. The mask comes from a generator seeded with `key` on x's device;
    key None (eval, or rate 0) is the identity."""
    if key is None or rate == 0.0:
        return x
    g = torch.Generator(device=x.device)
    g.manual_seed(key)
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class LayerNorm(nn.LayerNorm):
    """Flax LayerNorm: fp32 statistics, epsilon 1e-6, output in `dtype`."""

    def __init__(self, d: int, dtype=torch.float32) -> None:
        super().__init__(d, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class MlpBlock(nn.Module):
    def __init__(self, d: int, mlp_dim: int, *, dtype=torch.float32,
                 dropout_rate: float = 0.0) -> None:
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.fc_in = nn.Linear(d, mlp_dim)
        self.fc_out = nn.Linear(mlp_dim, d)

    def forward(self, x: torch.Tensor, *,
                dropout_key: Optional[int] = None):
        x = F.gelu(dense(x, self.fc_in, self.dtype), approximate="tanh")
        x = dropout(x, self.dropout_rate, dropout_key)
        return dense(x, self.fc_out, self.dtype)


def _quantize(x4: torch.Tensor):
    """Per-(batch, token, head) symmetric int8 over (b, s, h, hd): the
    scale is that row's max |.| mapped to 127. Returns the int8 rows and
    the scales as (b, h, s). torch.round rounds half to even, as
    jnp.round does."""
    x32 = x4.float()
    scale = x32.abs().amax(dim=-1).clamp_min(1e-8) / 127.0   # (b, s, h)
    xq = torch.round(x32 / scale[..., None]).to(torch.int8)
    return xq, scale.transpose(1, 2)


class SelfAttention(nn.Module):
    def __init__(self, d: int, num_heads: int, *, dtype=torch.float32,
                 seq_axis: Optional[str] = None, sp_impl: str = "ring",
                 attn_impl: str = "xla", causal: bool = False,
                 rope: bool = False, kv_cache_dtype=None) -> None:
        super().__init__()
        if d % num_heads:
            raise ValueError(f"hidden {d} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = d // num_heads
        self.dtype = dtype
        self.seq_axis = seq_axis
        self.sp_impl = sp_impl
        self.attn_impl = attn_impl
        self.causal = causal
        self.rope = rope
        # None | torch.dtype | "int8" (see the reference's field comment)
        self.kv_cache_dtype = kv_cache_dtype
        # single-token step: "auto" (kernel on CUDA, plain on CPU) |
        # "kernel" | "plain" — ops/decode_attention.py; TransformerLM
        # set_decode_impl switches it
        self.decode_impl = "auto"
        # DenseGeneral (d -> (3, h, hd)) flattened: rows are [q | k | v]
        self.qkv = nn.Linear(d, 3 * d)
        # DenseGeneral over (h, hd) -> d
        self.out = nn.Linear(d, d)

    def cache_dtype(self):
        if self.kv_cache_dtype == "int8":
            return torch.int8
        return self.kv_cache_dtype or self.dtype

    def init_cache(self, batch: int, max_len: int, device) -> dict:
        """Zero cache for `batch` rows of `max_len` positions."""
        hd = self.num_heads * self.head_dim
        cd = self.cache_dtype()
        cache = {
            "cached_key": torch.zeros((batch, max_len, hd), dtype=cd,
                                      device=device),
            "cached_value": torch.zeros((batch, max_len, hd), dtype=cd,
                                        device=device),
            "cache_index": 0,
        }
        if self.kv_cache_dtype == "int8":
            for name in ("cached_key_scale", "cached_value_scale"):
                cache[name] = torch.zeros(
                    (batch, self.num_heads, max_len), dtype=torch.float32,
                    device=device)
        return cache

    def forward(self, x: torch.Tensor, *, cache: Optional[dict] = None,
                attn_start: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None,
                kv_lengths: Optional[torch.Tensor] = None):
        b, s, d = x.shape
        h, hd = self.num_heads, self.head_dim
        qkv_flat = dense(x, self.qkv, self.dtype)          # (b, s, 3*h*hd)
        if (cache is None and self.attn_impl == "flash" and not self.rope
                and self.seq_axis is None):
            # the raw projection goes to the kernels: its (3, h, hd)
            # feature order is the [q | k | v] column layout they window,
            # so q, k and v never materialize (unpackable heads slice
            # inside flash_attention_qkv)
            out = flash_attention_qkv(qkv_flat, h, causal=self.causal)
            return dense(out.reshape(b, s, d), self.out, self.dtype)
        qkv = qkv_flat.view(b, s, 3, h, hd)
        q, k, v = qkv.unbind(2)
        if page_table is not None:
            out = self._paged_decode(q, k, v, cache, page_table, kv_lengths,
                                     attn_start)
        elif cache is None:
            if self.rope:
                positions = torch.arange(s, device=x.device)
                q = apply_rope(q, positions)
                k = apply_rope(k, positions)
            out = dot_product_attention(
                q, k, v, causal=self.causal, seq_axis=self.seq_axis,
                sp_impl=self.sp_impl, impl=self.attn_impl,
            )
        else:
            out = self._decode(q, k, v, cache, attn_start)
        return dense(out.reshape(b, s, d), self.out, self.dtype)

    def _decode(self, q, k, v, cache, attn_start):
        if not self.causal:
            raise ValueError("decode=True requires causal attention")
        if self.seq_axis is not None:
            raise ValueError(
                "decode (KV-cache) mode does not compose with sequence "
                "parallelism"
            )
        b, s, h, hd = k.shape
        kc, vc = cache["cached_key"], cache["cached_value"]
        max_len = kc.shape[1]
        cur = int(cache["cache_index"])
        if cur + s > max_len:
            raise ValueError(
                f"cache full: writing {s} tokens at {cur} of {max_len}"
            )
        if self.rope:
            # cached keys are stored rotated: rotate only the incoming
            # block, at its absolute positions
            positions = cur + torch.arange(s, device=q.device)
            q = apply_rope(q, positions)
            k = apply_rope(k, positions)
        quant = self.kv_cache_dtype == "int8"
        if quant:
            k_store, ks_new = _quantize(k)
            v_store, vs_new = _quantize(v)
            cache["cached_key_scale"][:, :, cur:cur + s] = ks_new
            cache["cached_value_scale"][:, :, cur:cur + s] = vs_new
        else:
            k_store, v_store = k, v
        # in place: the cache is the serving memory, and a functional
        # update would copy the whole (b, L, h*hd) buffer every token
        kc[:, cur:cur + s] = k_store.reshape(b, s, h * hd).to(kc.dtype)
        vc[:, cur:cur + s] = v_store.reshape(b, s, h * hd).to(vc.dtype)
        cache["cache_index"] = cur + s
        ks = cache.get("cached_key_scale") if quant else None
        vs = cache.get("cached_value_scale") if quant else None
        if s == 1 and _heads_per_pack(h, hd) is not None:
            # token step: the packed kernel on the flat cache, O(cur) reads
            out = decode_attention_packed(
                q.reshape(b, 1, h * hd), kc, vc, cur, attn_start,
                n_heads=h, k_scale=ks, v_scale=vs, impl=self.decode_impl,
            )
            return out.reshape(b, 1, h, hd)
        # prefill (s = prompt length) or unpackable heads: the masked path
        # over the whole cache
        k4 = kc.view(b, max_len, h, hd)
        v4 = vc.view(b, max_len, h, hd)
        if quant:
            k4 = (k4.float() * ks.transpose(1, 2)[..., None]).to(q.dtype)
            v4 = (v4.float() * vs.transpose(1, 2)[..., None]).to(q.dtype)
        pos_q = cur + torch.arange(s, device=q.device)
        keys = torch.arange(max_len, device=q.device)
        mask = keys[None, :] <= pos_q[:, None]                # (sq, sk)
        if attn_start is not None:
            mask = mask[None] & (
                keys[None, None, :] >= attn_start[:, None, None]
            )
            mask = mask[:, None]                              # (b,1,sq,sk)
        return attention_with_mask(q, k4, v4, mask)

    def _paged_decode(self, q, k, v, cache, page_table, kv_lengths,
                      attn_start):
        """Paged KV-cache decode step (s == 1) or paged prefill (s > 1).

        The cache leaves are a block pool shared by every slot;
        `page_table` (b, mb) int32 maps each slot's blocks and
        `kv_lengths` (b,) int32 is each slot's write position, in
        slot-local coordinates, so RoPE rotates each slot at its own
        offset. The incoming tokens occupy positions `kv_lengths[b] + [0,
        s)`; their K/V are written in place into block
        `page_table[b, pos // block_size]`, row `pos % block_size`. A
        single-token step attends through `paged_decode_attention`; a
        prefill (prefix-cache suffix, chunk, or speculative verify window)
        gathers the slot's span once and masks causally per query row."""
        if kv_lengths is None:
            raise ValueError(
                "paged decode needs kv_lengths (per-slot write positions)"
            )
        if not self.rope:
            raise ValueError(
                "paged decode needs rope=True — slot-local positions "
                "require relative position encoding"
            )
        b, s, h, hd = k.shape
        kc, vc = cache["cached_key"], cache["cached_value"]
        block_size = kc.shape[1]
        pos0 = kv_lengths.to(torch.int32)
        positions = pos0[:, None] + torch.arange(
            s, dtype=torch.int32, device=q.device)[None, :]      # (b, s)
        q = apply_rope(q, positions)
        k = apply_rope(k, positions)
        quant = self.kv_cache_dtype == "int8"
        if quant:
            k_store, ks_new = _quantize(k)
            v_store, vs_new = _quantize(v)
        else:
            k_store, v_store = k, v
        # the clamp keeps a retired slot (table row 0, length pinned)
        # writing inside its table; active slots never reach it — the
        # engine allocates blocks for every position it dispatches
        blk_col = torch.clamp(positions // block_size,
                              max=page_table.shape[1] - 1).long()
        blk = torch.gather(page_table.long(), 1, blk_col)        # (b, s)
        off = (positions % block_size).long()
        # in place, like the flat cache; free slots all write garbage
        # block 0, and those duplicate indices are harmless because no
        # live slot ever reads block 0
        kc[blk, off] = k_store.reshape(b, s, h * hd).to(kc.dtype)
        vc[blk, off] = v_store.reshape(b, s, h * hd).to(vc.dtype)
        ks = vs = None
        if quant:
            ks, vs = cache["cached_key_scale"], cache["cached_value_scale"]
            # advanced indices (b, s) on axes 0 and 2 come first: the
            # written value is (b, s, h), the scales' (b, h, s) transposed
            ks[blk, :, off] = ks_new.transpose(1, 2)
            vs[blk, :, off] = vs_new.transpose(1, 2)
        if s == 1:
            out = paged_decode_attention(
                q.reshape(b, 1, h * hd), kc, vc, page_table, pos0,
                attn_start, n_heads=h, k_scale=ks, v_scale=vs,
                impl=self.decode_impl,
            )
            return out.reshape(b, 1, h, hd)
        k4 = gather_pages(kc, page_table, h, ks)
        v4 = gather_pages(vc, page_table, h, vs)
        kpos = torch.arange(k4.shape[1], device=q.device)
        valid = kpos[None, None, :] <= positions[:, :, None]     # (b, s, span)
        if attn_start is not None:
            valid &= kpos[None, None, :] >= attn_start[:, None, None]
        cd = q.dtype if quant else kc.dtype
        out = attention_with_mask(q.to(cd), k4.to(cd), v4.to(cd),
                                  valid[:, None])
        return out.to(q.dtype)


class EncoderBlock(nn.Module):
    def __init__(self, d: int, num_heads: int, mlp_dim: int, *,
                 dtype=torch.float32, seq_axis: Optional[str] = None,
                 sp_impl: str = "ring", attn_impl: str = "xla",
                 causal: bool = False, rope: bool = False,
                 kv_cache_dtype=None, dropout_rate: float = 0.0,
                 use_moe: bool = False, fused=False) -> None:
        super().__init__()
        if use_moe:
            raise NotImplementedError(
                "MoE blocks are not ported yet (ROADMAP A7)")
        if fused is True:
            raise NotImplementedError(
                "the fused encoder layer is not ported yet (ROADMAP B2)"
            )
        # fused="auto" is the per-op pipeline until B2 brings the kernel.
        # The reference would not pick it on this slice's path either: it
        # never combines with attn_impl="flash" (models/vit.py
        # _plain_block), and lm_base's bf16 weights (13.5 MiB) exceed its
        # 8 MiB residency limit (ops/fused_encoder.py).
        self.dropout_rate = dropout_rate
        self.ln1 = LayerNorm(d, dtype)
        self.attn = SelfAttention(
            d, num_heads, dtype=dtype, seq_axis=seq_axis, sp_impl=sp_impl,
            attn_impl=attn_impl, causal=causal, rope=rope,
            kv_cache_dtype=kv_cache_dtype,
        )
        self.ln2 = LayerNorm(d, dtype)
        self.mlp = MlpBlock(d, mlp_dim, dtype=dtype,
                            dropout_rate=dropout_rate)

    def forward(self, x, *, dropout_key: Optional[int] = None, cache=None,
                attn_start=None, page_table=None, kv_lengths=None):
        """`dropout_key` None means no dropout (eval, decode)."""
        y = self.attn(self.ln1(x), cache=cache, attn_start=attn_start,
                      page_table=page_table, kv_lengths=kv_lengths)
        x = x + dropout(y, self.dropout_rate, subkey(dropout_key, 0))
        return x + self.mlp(self.ln2(x),
                            dropout_key=subkey(dropout_key, 1))
