"""Vision Transformer and its blocks (counterpart of
ddp_practice_tpu/models/vit.py).

`MlpBlock`, `SelfAttention` (the training forward, with the streaming
flash kernels behind `attn_impl="flash"`, and the flat and paged KV-cache
decode paths, including the int8 quantize-on-write cache) and
`EncoderBlock` (dense or, with `use_moe`, routed: ops/moe.py) serve the
decoder LM too. `EncoderBlock.fused` is the
reference's tri-state: `True` runs the whole layer as one kernel per
direction (ops/fused_encoder.py) and raises on a block or a shape the
kernels do not take; `"auto"` (the models' default) fuses when the block is
plain, the shape is supported, the input is a CUDA tensor and one process
runs (the reference's single-chip gate), and takes the per-op path
otherwise (on the CPU and under multi-rank DDP always); `False` never
fuses. `ViTEmbed`,
`ViTHead`, `ViT`, `ViTTiny` and `ViTBase` are the image classifier: NHWC
images in, fp32 logits out.

Dropout draws its masks from a counter-based hash of (key, element
index) in torch integer ops (`dropout`). A key (`DropoutKey`) is the
step's 32 bits, a 0-dim int64 tensor the training step derives on the
device from (seed, device step counter) (train/steps.py `step_key`), and
a Python site number that `subkey` derives per layer on the host. So a
step replays its masks, a rematerialized block (torch.utils.checkpoint)
recomputes the same ones, and an eager step and the same step replayed
from a CUDA graph draw the same ones (a graph would bake a Python seed:
train/steps.py). Every product in the hash multiplies 32 bits by fewer
than 31, so int64 cannot overflow (`mix32`, `fold32`). Masks cannot
match JAX's (threefry vs Philox); parity runs at rate 0.

Tensor parallelism (parallel/mesh.py `shard_state` sets each layer's
`tp`): `SelfAttention` holds its rank's heads (`num_heads` local, the
qkv rows of those heads in [q | k | v] order, the out columns), `MlpBlock`
fc_in's rows and fc_out's columns; the input of each crosses into the
tensor region through `copy_to_tp` and the row-parallel output is summed
over the group (`row_parallel`), its bias added once after the sum. The
kernels see plain local tensors: `flash_attention_qkv(qkv, local heads)`
and the decode kernels run unchanged on the rank's heads, and a KV cache
holds them. Dropout inside the MLP draws the whole tensor's mask at its
columns (`dropout(cols=)`), so a shard's mask is the one-rank mask's.
`fused=True` raises under tensor parallelism (the fused layer holds a
whole layer's weights).

Sequence parallelism (`seq_axis`; parallel/mesh.py `shard_state` sets
each layer's `sp`, the SeqGroup): a block's tokens are the rank's
contiguous chunk of the sequence. `SelfAttention` rotates RoPE at the
chunk's global positions and crosses the chunks by `sp_impl` (ring or
Ulysses, ops/attention.py), never on the fused-QKV route; dropout draws
the whole sequence's mask at the chunk's rows (`dropout(rows=)`); `ViT`
embeds the whole image on every seq rank, keeps its chunk of the patch
tokens and pools over the group (`ViTHead`), so every rank returns the
whole logits. Decode under `seq_axis` raises, as the reference's, and
`fused` stays off.

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

from typing import NamedTuple, Optional, Union

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
from ddp_practice_tpu_torch.ops.fused_encoder import (
    block_params,
    fused_encoder_layer,
    fused_shape_supported,
    shape_error,
)
from ddp_practice_tpu_torch.ops.moe import MoEMlp
from ddp_practice_tpu_torch.ops.rope import apply_rope
from ddp_practice_tpu_torch.parallel.dist import process_count
from ddp_practice_tpu_torch.parallel.tensor import copy_to_tp, reduce_from_tp

LN_EPS = 1e-6


def dense(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """Flax Dense semantics: inputs, kernel and bias promoted to `dtype`."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def row_parallel(x: torch.Tensor, layer: nn.Linear, dtype, tp):
    """`dense` over a row-parallel layer: this rank's partial product,
    summed over the tensor group, then the whole bias added once."""
    if tp is None:
        return dense(x, layer, dtype)
    y = reduce_from_tp(F.linear(x.to(dtype), layer.weight.to(dtype)), tp)
    return y if layer.bias is None else y + layer.bias.to(dtype)


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


_M32 = 0xFFFFFFFF


def mix32(x):
    """A 32-bit integer hash of x in [0, 2^32), on Python ints and int64
    tensors alike: the xor-shift / multiply rounds of Wellons' "lowbias32"
    with multipliers below 2^31, each product masked back to 32 bits, so
    no product reaches 2^63 and int64 arithmetic cannot overflow."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def fold32(x):
    """A 64-bit key (int, or int64 tensor) hashed to 32 bits: the two
    halves mixed apart, so a key near 2^62 folds without overflow."""
    if isinstance(x, int):
        x &= (1 << 64) - 1
    return mix32((x & _M32) ^ mix32((x >> 32) & _M32))


class DropoutKey(NamedTuple):
    """A dropout site's key: `step`, the step's 32-bit key (a 0-dim int64
    tensor on the device on the training paths, so a CUDA graph replays
    it), and `site`, a Python int that `subkey` derives per layer."""
    step: Union[torch.Tensor, int]
    site: int = 0


def subkey(key: Optional[DropoutKey], i: int) -> Optional[DropoutKey]:
    """The i-th key under `key` (None stays None): a new site, same step."""
    if key is None:
        return None
    return DropoutKey(key.step, mix32(key.site ^ mix32(i + 1)))


def dropout(x: torch.Tensor, rate: float, key: Optional[DropoutKey],
            cols: Optional[tuple] = None,
            rows: Optional[tuple] = None) -> torch.Tensor:
    """Flax Dropout: keep with probability 1 - rate, kept values divided by
    it. Element j keeps when mix32(mix32(j ^ site) ^ step ^ t) >= rate *
    2^32, t a constant of the site (so two sites' masks share no index
    pattern); key None (eval, or rate 0) is the identity. `cols` =
    (offset, total): x's last dim is columns [offset, offset + n) of a
    tensor `total` wide (a tensor-parallel shard); `rows` = (offset,
    total) the same for the second-to-last dim (a seq rank's chunk of
    the sequence, `seq_rows`). j is the element's index in that whole
    tensor, so every shard draws its part of the whole tensor's mask."""
    if key is None or rate == 0.0:
        return x
    idx = torch.arange(x.numel(), device=x.device, dtype=torch.int64)
    if cols is not None or rows is not None:
        n = x.shape[-1]
        r, c = idx // n, idx % n
        if rows is not None:
            s = x.shape[-2]
            r = r // s * rows[1] + rows[0] + r % s
        if cols is not None:
            c, n = c + cols[0], cols[1]
        idx = r * n + c
    bits = mix32(mix32(idx ^ key.site)
                 ^ (key.step ^ mix32(key.site ^ 0x9E3779B9)))
    keep = (bits >= round(rate * (1 << 32))).view(x.shape)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def seq_rows(sp, x: torch.Tensor) -> Optional[tuple]:
    """`dropout`'s `rows` for a (..., s, d) chunk of the sequence on the
    seq group `sp` (None: the whole sequence)."""
    if sp is None:
        return None
    s = x.shape[-2]
    return (sp.offset(s), sp.size * s)


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
        # the tensor group (parallel/mesh.py shard_state): fc_in
        # column-parallel, fc_out row-parallel; the seq group: the
        # tokens are a chunk of the sequence
        self.tp = None
        self.sp = None

    def forward(self, x: torch.Tensor, *,
                dropout_key: Optional[DropoutKey] = None):
        x = copy_to_tp(x, self.tp)
        x = F.gelu(dense(x, self.fc_in, self.dtype), approximate="tanh")
        cols = None
        if self.tp is not None:
            n = x.shape[-1]
            cols = (self.tp.rank * n, self.tp.size * n)
        x = dropout(x, self.dropout_rate, dropout_key, cols,
                    seq_rows(self.sp, x))
        return row_parallel(x, self.fc_out, self.dtype, self.tp)


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
        # under tensor parallelism (parallel/mesh.py shard_state): the
        # group, `num_heads` this rank's heads, qkv's rows and out's
        # columns theirs; `qkv_bias_split` (chunks, chunk width) when
        # FSDP stores the qkv bias data chunks outermost
        # (parallel/fsdp.py)
        self.tp = None
        self.qkv_bias_split = None
        # under sequence parallelism (`seq_axis` set; parallel/mesh.py
        # shard_state): the SeqGroup, the tokens a chunk of the sequence
        self.sp = None

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
        b, s, _ = x.shape
        h, hd = self.num_heads, self.head_dim
        if self.seq_axis is not None:
            if cache is not None:
                raise ValueError(
                    "decode (KV-cache) mode does not compose with sequence "
                    "parallelism — generate on a data/tensor-sharded mesh"
                )
            if self.sp is None:
                raise ValueError(
                    f"seq_axis={self.seq_axis!r} but no seq group: lay the "
                    "model out on a mesh with a seq axis (parallel/mesh.py "
                    "shard_state)")
        qkv_flat = self._qkv(copy_to_tp(x, self.tp))       # (b, s, 3*h*hd)
        if (cache is None and self.attn_impl == "flash" and not self.rope
                and self.seq_axis is None):
            # the raw projection goes to the kernels: its (3, h, hd)
            # feature order is the [q | k | v] column layout they window,
            # so q, k and v never materialize (unpackable heads slice
            # inside flash_attention_qkv)
            out = flash_attention_qkv(qkv_flat, h, causal=self.causal)
            return row_parallel(out.reshape(b, s, h * hd), self.out,
                                self.dtype, self.tp)
        qkv = qkv_flat.view(b, s, 3, h, hd)
        q, k, v = qkv.unbind(2)
        if page_table is not None:
            out = self._paged_decode(q, k, v, cache, page_table, kv_lengths,
                                     attn_start)
        elif cache is None:
            if self.rope:
                # global positions: a seq rank's chunk starts at its
                # offset (the reference's GSPMD sees the whole sequence)
                p0 = 0 if self.sp is None else self.sp.offset(s)
                positions = p0 + torch.arange(s, device=x.device)
                q = apply_rope(q, positions)
                k = apply_rope(k, positions)
            out = dot_product_attention(
                q, k, v, causal=self.causal, seq_axis=self.sp,
                sp_impl=self.sp_impl, impl=self.attn_impl,
            )
        else:
            out = self._decode(q, k, v, cache, attn_start)
        return row_parallel(out.reshape(b, s, h * hd), self.out,
                            self.dtype, self.tp)

    def _qkv(self, x: torch.Tensor) -> torch.Tensor:
        if self.qkv_bias_split is None:
            return dense(x, self.qkv, self.dtype)
        n, width = self.qkv_bias_split
        bias = self.qkv.bias.view(n, -1, width).transpose(0, 1).reshape(-1)
        return F.linear(x.to(self.dtype), self.qkv.weight.to(self.dtype),
                        bias.to(self.dtype))

    def _decode(self, q, k, v, cache, attn_start):
        if not self.causal:
            raise ValueError("decode=True requires causal attention")
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
            # token step: the packed kernel on the flat cache, O(cur) reads;
            # without RoPE q is a strided slice of the fused projection
            # (b > 1), and the kernel reads contiguous rows
            out = decode_attention_packed(
                q.reshape(b, 1, h * hd).contiguous(), kc, vc, cur, attn_start,
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
    """Pre-LN block. `use_moe` swaps the dense MLP for a routed expert MLP
    (ops/moe.py `MoEMlp`, the submodule `moe`, its fields the `moe_*`,
    `num_experts` and `capacity_factor` arguments) followed by the
    residual-branch dropout, as the reference."""

    def __init__(self, d: int, num_heads: int, mlp_dim: int, *,
                 dtype=torch.float32, seq_axis: Optional[str] = None,
                 sp_impl: str = "ring", attn_impl: str = "xla",
                 causal: bool = False, rope: bool = False,
                 kv_cache_dtype=None, dropout_rate: float = 0.0,
                 use_moe: bool = False, num_experts: int = 8,
                 moe_top_k: int = 2, capacity_factor: float = 1.25,
                 moe_aux_weight: float = 0.01, moe_bias_rate: float = 0.02,
                 moe_group_size: int = 0, moe_group_stride: bool = True,
                 moe_router: str = "topk", fused=False) -> None:
        super().__init__()
        if fused not in (True, False, "auto"):
            raise ValueError(f"fused={fused!r} (want True|False|'auto')")
        self.fused = fused
        self.use_moe = use_moe
        self.mlp_dim = mlp_dim
        self.dropout_rate = dropout_rate
        self.ln1 = LayerNorm(d, dtype)
        self.attn = SelfAttention(
            d, num_heads, dtype=dtype, seq_axis=seq_axis, sp_impl=sp_impl,
            attn_impl=attn_impl, causal=causal, rope=rope,
            kv_cache_dtype=kv_cache_dtype,
        )
        self.ln2 = LayerNorm(d, dtype)
        if use_moe:
            self.moe = MoEMlp(
                d, num_experts=num_experts, top_k=moe_top_k,
                capacity_factor=capacity_factor, mlp_dim=mlp_dim,
                aux_loss_weight=moe_aux_weight,
                bias_update_rate=moe_bias_rate, group_size=moe_group_size,
                group_stride=moe_group_stride, dtype=dtype,
                router=moe_router)
        else:
            self.mlp = MlpBlock(d, mlp_dim, dtype=dtype,
                                dropout_rate=dropout_rate)
        # the seq group under sequence parallelism (parallel/mesh.py)
        self.sp = None

    def forward(self, x, *, dropout_key: Optional[DropoutKey] = None,
                train: bool = False, cache=None, attn_start=None,
                page_table=None, kv_lengths=None):
        """`dropout_key` None means no dropout (eval, decode); `train`
        lets a routed MLP record its aux loss and router-bias update
        (ops/moe.py)."""
        decode = cache is not None
        fused = self.fused
        if fused == "auto":
            fused = self._auto_fuse(x, decode)
        if fused:
            if not self._plain_block(decode):
                raise ValueError(
                    "fused encoder layer supports plain blocks only — "
                    "bidirectional or causal — with no decode/rope/"
                    "seq-parallel/MoE/dropout/attn_impl override; those "
                    "paths keep the per-op pipeline"
                )
            err = shape_error(x.shape[1], x.shape[2], self.mlp_dim,
                               self.attn.num_heads, self.attn.dtype)
            if err:
                raise ValueError(err)
            return fused_encoder_layer(
                x, block_params(self), num_heads=self.attn.num_heads,
                compute_dtype=self.attn.dtype, causal=self.attn.causal)
        y = self.attn(self.ln1(x), cache=cache, attn_start=attn_start,
                      page_table=page_table, kv_lengths=kv_lengths)
        rows = seq_rows(self.sp, x)
        x = x + dropout(y, self.dropout_rate, subkey(dropout_key, 0),
                        rows=rows)
        if self.use_moe:
            y = self.moe(self.ln2(x), train=train, decode=decode)
            return x + dropout(y, self.dropout_rate, subkey(dropout_key, 1),
                               rows=rows)
        return x + self.mlp(self.ln2(x),
                            dropout_key=subkey(dropout_key, 1))

    def _plain_block(self, decode: bool) -> bool:
        """What the fused kernels can express; shared by the fused=True
        gate and the "auto" choice so they cannot drift apart."""
        a = self.attn
        return not (decode or a.rope or a.seq_axis is not None
                    or self.use_moe or self.dropout_rate > 0.0
                    or a.attn_impl != "xla")

    def _auto_fuse(self, x, decode: bool) -> bool:
        """fused="auto": a plain block, a shape the kernels take, a CUDA
        tensor (on the CPU the fused layer is its plain version, slower
        than the per-op path: auto never picks it) and one process. The
        last is the reference's `single_chip_tpu()` gate
        (ddp_practice_tpu/parallel/ring.py), whose device count is the
        world size here: under multi-rank DDP auto takes the per-op path,
        and `fused=True` (`--fused on`) still forces the kernels."""
        if (not self._plain_block(decode) or not _on_card(x)
                or process_count() > 1):
            return False
        return fused_shape_supported(
            seq_len=x.shape[1], d=x.shape[2], mlp_dim=self.mlp_dim,
            num_heads=self.attn.num_heads, compute_dtype=self.attn.dtype)


class ViTEmbed(nn.Module):
    """Patch + position embedding stem: NHWC images -> (b, patches, d).
    The patch conv has stride = kernel = `patch_size`; patches flatten
    row-major; `pos_embed` is added in `dtype`."""

    def __init__(self, patch_size: int = 4, hidden_dim: int = 192, *,
                 in_channels: int = 3, num_patches: int = 64,
                 dtype=torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.patch_embed = nn.Conv2d(in_channels, hidden_dim, patch_size,
                                     stride=patch_size)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, num_patches, hidden_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)           # NHWC -> NCHW
        x = F.conv2d(x, self.patch_embed.weight.to(self.dtype),
                     self.patch_embed.bias.to(self.dtype),
                     stride=self.patch_size)               # (b, d, h, w)
        x = x.flatten(2).transpose(1, 2)                   # (b, h*w, d)
        if x.shape[1] != self.pos_embed.shape[1]:
            raise ValueError(
                f"image gives {x.shape[1]} patches, the model was built "
                f"for {self.pos_embed.shape[1]} (image_shape)")
        return x + self.pos_embed.to(self.dtype)


class ViTHead(nn.Module):
    """Final LN + global average pool + classifier; logits fp32. Under
    sequence parallelism (`sp`, the seq group) each rank holds a chunk
    of the tokens: their sum is summed over the group (differentiably)
    and divided by the whole sequence's length."""

    def __init__(self, hidden_dim: int, num_classes: int = 10, *,
                 dtype=torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.ln_f = LayerNorm(hidden_dim, dtype)
        self.head = nn.Linear(hidden_dim, num_classes)

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        x = self.ln_f(x)
        if sp is None:
            x = x.mean(dim=1)
        else:
            x = sp.sum(x.sum(dim=1)) / (x.shape[1] * sp.size)
        return dense(x, self.head, self.dtype).float()


class ViT(nn.Module):
    """`image_shape` (H, W, C) sizes the patch conv and the position
    table (Flax infers both at init from the first batch). No block is
    routed, so `num_experts` (the train loop passes it to every
    transformer, as the reference's does) is ignored."""

    def __init__(self, *, num_classes: int = 10, patch_size: int = 4,
                 hidden_dim: int = 192, depth: int = 12, num_heads: int = 3,
                 mlp_dim: int = 768, dtype=torch.float32,
                 param_dtype=torch.float32, seq_axis: Optional[str] = None,
                 sp_impl: str = "ring", attn_impl: str = "xla",
                 dropout_rate: float = 0.0, fused="auto",
                 num_experts: int = 8, image_shape=(32, 32, 3)) -> None:
        super().__init__()
        h, w, c = image_shape
        self.num_classes = num_classes
        self.patch_size = patch_size
        self.hidden_dim = hidden_dim
        self.depth = depth
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.dtype = dtype
        self.image_shape = tuple(image_shape)
        self.dropout_rate = dropout_rate
        self.embed = ViTEmbed(
            patch_size, hidden_dim, in_channels=c,
            num_patches=(h // patch_size) * (w // patch_size), dtype=dtype)
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden_dim, num_heads, mlp_dim, dtype=dtype,
                         seq_axis=seq_axis, sp_impl=sp_impl,
                         attn_impl=attn_impl, dropout_rate=dropout_rate,
                         fused=fused)
            for _ in range(depth)
        )
        self.classifier = ViTHead(hidden_dim, num_classes, dtype=dtype)
        self.seq_axis = seq_axis
        # the seq group under sequence parallelism (parallel/mesh.py)
        self.sp = None
        self.to(param_dtype)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                dropout_key: Optional[DropoutKey] = None) -> torch.Tensor:
        """x (b, H, W, C) float in [0, 1] -> logits (b, classes) fp32.
        A training forward with dropout takes its `dropout_key`. Under
        sequence parallelism every seq rank embeds the whole image and
        keeps its contiguous chunk of the patch tokens; the pool sums
        over the group, so every rank returns the whole logits."""
        key = dropout_key if train and self.dropout_rate else None
        if train and self.dropout_rate and key is None:
            raise ValueError("a training forward with dropout needs a "
                             "dropout_key (train/steps.py step_key)")
        x = self.embed(x)
        if self.sp is not None:
            x = self.sp.chunk(x, 1)
        for i, blk in enumerate(self.blocks):
            x = blk(x, dropout_key=subkey(key, i), train=train)
        return self.classifier(x, self.sp)


def ViTTiny(**kw) -> ViT:
    kw.setdefault("hidden_dim", 192)
    kw.setdefault("depth", 12)
    kw.setdefault("num_heads", 3)
    kw.setdefault("mlp_dim", 768)
    return ViT(**kw)


def ViTBase(**kw) -> ViT:
    kw.setdefault("hidden_dim", 768)
    kw.setdefault("depth", 12)
    kw.setdefault("num_heads", 12)
    kw.setdefault("mlp_dim", 3072)
    return ViT(**kw)
