"""Single-token KV-cache decode attention over the flat (b, L, h*hd) cache
and over the paged block pool (counterpart of
ddp_practice_tpu/ops/decode_attention.py `decode_attention_packed` and
`paged_decode_attention`).

On a CUDA tensor the step runs one of four CUDA kernels written by hand
for sm_90a (`csrc/decode_attention.cu`, built by `ops/cuda_build.py` and
launched through ctypes):

- kernel A, `decode_attention`: fp32 or bf16 flat caches. Replaces the
  Pallas TPU kernels `_kernel_single` (one tile, L <= 1024) and `_kernel`
  via `_online_softmax_cell` (online softmax over 256-position blocks);
- kernel B, `decode_attention_int8`: an int8 flat cache with per-(batch,
  head, position) fp32 scales. Replaces `_kernel_single_quant` and the
  reference's dequantizing branch for long caches; it computes what that
  branch computes (keys and values dequantized to the compute dtype) at
  every L;
- kernel C, `paged_decode_attention`: fp32 or bf16 block pools
  `(num_blocks, block_size, h*hd)` walked through a per-slot page table,
  with a per-slot inclusive cursor `lengths[b]`. Replaces `_paged_kernel`;
- kernel D, `paged_decode_attention_int8`: an int8 pool with per-block
  `(num_blocks, h, block_size)` fp32 scale pages, the scales folded into
  the score and probability rows as `_paged_kernel_quant` does.

Bound: HBM bytes. A step must read every valid key and value row once,
2 * sum_b (last_b - start_b + 1) * h * hd * bytes_per_elem, plus 2 * 4
bytes per valid position and head of scales for int8, over 3.35 TB/s on
an H100 SXM; paged slots that share blocks share those rows, counted
once. The kernels read only the valid range, split over the cache:
`_split_plan` picks (splits, chunk, span) from host-known ints only
(flat: cur + 1; paged: the capacity mb * block_size), persistent blocks
walk the (split, batch, head) items, a range of at most `span` keys is
one split, and the last split of a longer one merges the partials in
the same launch (see the source for the design). At S > 1 the wrapper
allocates the (b, h, S, d + 2) fp32 partials with `torch.empty` and
passes a per-device int32 counter buffer (`_counters`), zeroed once when
allocated and left at zero by every launch; calls that share it are
ordered on one stream, as the engines issue them.

On a CPU tensor a wrapper runs the plain PyTorch version of its kernels'
arithmetic (`decode_attention_plain`, `paged_decode_attention_plain`); the
CPU tests compare it with the JAX package. `impl="plain"` asks for the
plain version on any device (the chip smoke's fp32 cross-checks); there
is no fallback from a kernel to its plain version. The paged op routes as
the reference does: unpackable heads (or a block size that is not a
multiple of 8) take the gather reference `paged_attention_reference` on
every device. The cursors (`lengths`, `attn_start`, `page_table`) stay on
the device: the paged wrapper never reads them on the host. `LAUNCHES`
counts kernel launches per kernel name.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ddp_practice_tpu_torch.ops.attention import attention_with_mask
# the model routes a single-token step to the kernel exactly when the heads
# pack, as the reference does; q is scaled by 1/sqrt(d) rounded to q's
# dtype, as the reference's weakly typed Python float is (`_scales`)
from ddp_practice_tpu_torch.ops.flash_attention import _heads_per_pack, _scales

# launches per kernel, counted where the wrapper launches it and nowhere
# else; chip_smoke.py zeroes them before the main path and reads them after
LAUNCHES = {"decode_attention": 0, "decode_attention_int8": 0,
            "paged_decode_attention": 0, "paged_decode_attention_int8": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {
    -1: "head_dim not compiled (64, 128 or 256)",
    -2: "split plan outside the kernel's shared memory or grid",
    -3: "unsupported dtype combination",
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ the split plan
# csrc/decode_attention.cu's block: 8 warps; `_key_group` and `_smem_bytes`
# mirror its `Layout<TKV, D>::NGROUPS` and `Smem::total`
_WARPS = 8
_THREADS = 32 * _WARPS
_RED_FLOATS = 40
_SMS = 132                       # the H100 SXM's streaming multiprocessors
_SMEM_PER_SM = 233472            # its shared memory an SM (228 KB)
_SMEM_RESERVED = 1024            # the runtime's share of each block
_BLOCKS_PER_SM = 4               # 64 registers a thread x 256 threads
_SPLIT_SMEM = 112 * 1024         # a split's shared memory: two blocks an SM
_MIN_SPLIT_BYTES = 32 * 1024     # K and V rows a split moves at least
_SHORT_BYTES = 64 * 1024         # K and V rows a split holds at least
_BLOCK_COST = 64 * 1024          # an item's latency, in bytes an SM streams
_COMBINE_COST = 32 * 1024        # the combine's round trips, the same
_MAX_SMEM = 232448               # a block's opt-in shared memory (227 KB)


def _key_group(d: int, kv_bytes: int) -> int:
    """Keys a block covers per step: a lane group reads one key row in
    16-byte loads (at most 32 lanes a group), 8 warps side by side."""
    lanes = min(d * kv_bytes // 16, 32)
    return _WARPS * (32 // lanes)


def _smem_bytes(span: int, d: int, kv_bytes: int, quant: bool,
                bs: int = 0) -> int:
    """Shared memory of a split holding up to `span` keys (the .cu's
    `Smem::total`): K and V rows, int8 scales, scores, reductions, the
    per-warp sums (or the combine's lanes) and, paged, the staged table
    entries."""
    total = span * (2 * d * kv_bytes + 4 + (8 if quant else 0))
    total += 4 * (_RED_FLOATS + max(_WARPS * d, 4 * _THREADS))
    return total + (4 * (span // bs + 2) if bs else 0)


def _plan_cost(n: int, bh: int, chunk: int, span: int, *, d: int,
               kv_bytes: int, quant: bool, bs: int = 0,
               sms: int = _SMS) -> float:
    """The plan's model of a launch over a full range, in bytes one SM
    streams: each round of the persistent blocks' items pays `_BLOCK_COST`
    of latency plus the rows of the items that share its busiest SM;
    several splits add the combine."""
    splits, rows = (-(-n // chunk), chunk) if n > span else (1, n)
    blocks = bh * splits
    per_sm = min(_BLOCKS_PER_SM, _SMEM_PER_SM // (
        _smem_bytes(span, d, kv_bytes, quant, bs) + _SMEM_RESERVED))
    waves = -(-blocks // (sms * per_sm))
    share = min(per_sm, -(-blocks // sms))
    cost = waves * (_BLOCK_COST + share * rows * 2 * d * kv_bytes)
    return cost + (_COMBINE_COST if splits > 1 else 0)


def _split_plan(n: int, bh: int, *, d: int, kv_bytes: int, quant: bool,
                bs: int = 0, sms: int = _SMS, whole: bool = False) -> tuple:
    """(splits, chunk, span) for ranges within positions [0, n) of `bh`
    (batch, head) pairs, from host-known ints only (flat: n = cur + 1;
    paged: n = the capacity mb * bs, with `bs` the block size), never from
    the device cursors. A (batch, head)'s valid keys go to one split when
    there are at most `span` (the keys a split's shared memory holds),
    else to splits of `chunk` keys from its first valid key on; `splits` =
    ceil(n / chunk) covers the longest range.

    - n within `_SPLIT_SMEM` (~112 KB of K and V rows, two blocks an SM):
      one split, span n (the serve shapes: no combine). So too when the
      pairs' blocks already cover half the SMs (2 * bh >= sms) and a
      block's shared memory (227 KB) holds n: one block a (batch, head),
      as the TPU kernel's grid has, and a split would add the combine's
      round trips to each long range.
    - Else a chunk is a multiple of the block's key group; paged, of `bs`
      too (or, for a page larger than a split, a divisor of it). It holds
      at least `_MIN_SPLIT_BYTES` of K and V rows (else a split is only
      launch latency), and the span at least `_SHORT_BYTES`, so a short
      range is still one split. The plan takes the chunk of least
      `_plan_cost` over a full range (rounds of the persistent blocks'
      items, at the occupancy the span's shared memory allows, against
      the rows each SM streams), the smaller chunk on a tie: batch 1
      splits into about a wave of blocks.
    - `whole`: one split wherever a block's shared memory holds the
      range, at any bh. Kernel C with fp32 queries over a bf16 pool rounds
      p to bf16 inside an fp32 result; a split's max would move that
      rounding off the plain version's, so it splits only a range too
      long for one block.
    No n is refused: a longer range is more splits."""
    if n < 1 or bh < 1:
        raise ValueError(f"empty plan: n={n}, bh={bh}")

    def fits(chunk, limit=_SPLIT_SMEM):
        return _smem_bytes(chunk, d, kv_bytes, quant, bs) <= limit

    def keys(nbytes):   # the unit multiple holding nbytes of K and V rows
        return -(-nbytes // (2 * d * kv_bytes * unit)) * unit

    unit, grow = _key_group(d, kv_bytes), True
    one = -(-n // unit) * unit
    if (whole or 2 * bh >= sms) and fits(one, _MAX_SMEM):
        return 1, one, one
    if bs:
        unit = unit * bs // math.gcd(unit, bs)       # whole pages
        if not fits(unit):
            unit = bs
        if not fits(bs):             # a page too large: splits inside it
            unit = max(u for u in range(8, bs, 8) if bs % u == 0 and fits(u))
            grow = False
    top = unit
    while grow and fits(top + unit) and top < n:
        top += unit
    if n <= top:
        return 1, top, top
    short = min(top, keys(_SHORT_BYTES))

    def cost(chunk):
        return _plan_cost(n, bh, chunk, max(chunk, short), d=d,
                          kv_bytes=kv_bytes, quant=quant, bs=bs, sms=sms)

    chunk = min(range(min(top, keys(_MIN_SPLIT_BYTES)), top + 1, unit),
                key=lambda c: (cost(c), c))
    return -(-n // chunk), chunk, max(chunk, short)


def _plan_args(plan, n):
    """(splits, chunk, span) of a plan; a (splits, chunk) override holds
    chunk keys a split. Its splits must cover the longest range."""
    splits, chunk, span = (*plan, plan[1])[:3]
    if splits * chunk < n and n > span:
        raise ValueError(f"plan {plan} does not cover {n} positions")
    return splits, chunk, span


_COUNTERS: dict = {}   # device -> int32 arrival counters, zero between calls


def _counters(device, n: int) -> torch.Tensor:
    """At least `n` arrival counters on `device`: zeroed once when
    allocated (or grown), left at zero by every launch."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _scratch(q, n_heads, d, splits):
    """One launch's (b, h, S, d + 2) fp32 partials and its arrival counters
    (None, None at S = 1)."""
    if splits == 1:
        return None, None
    b = q.shape[0]
    part = torch.empty((b, n_heads, splits, d + 2), dtype=torch.float32,
                       device=q.device)
    return part, _counters(q.device, b * n_heads)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_call(q, k_cache, n_heads, k_scale, v_scale):
    b, sq, hd_total = q.shape
    if sq != 1:
        raise ValueError(
            f"decode_attention_packed is the single-token step kernel "
            f"(got {sq} query rows); prefill takes the masked path"
        )
    d = hd_total // n_heads
    if _heads_per_pack(n_heads, d) is None:
        raise ValueError(
            f"heads={n_heads}, head_dim={d} don't pack into 128-lane tiles"
        )
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 cache needs BOTH k_scale and v_scale")
    return b, k_cache.shape[1], d


def decode_attention_packed(
    q: torch.Tensor,        # (b, 1, h*hd): the current token's queries
    k_cache: torch.Tensor,  # (b, L, h*hd) flat cache
    v_cache: torch.Tensor,
    cur: int,               # position of the current token (host int)
    attn_start: Optional[torch.Tensor] = None,  # (b,) int32 first valid key
    *,
    n_heads: int,
    k_scale: Optional[torch.Tensor] = None,     # (b, h, L) fp32, int8 cache
    v_scale: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """One decode step of masked attention over the flat KV cache.

    Valid keys are positions [attn_start[b], cur] (cur inclusive: the
    caller writes the current token's K/V at `cur` first). Returns
    (b, 1, h*hd) in q's dtype. `impl`: "auto" launches the kernel for CUDA
    tensors and runs the plain version for CPU tensors; "kernel" launches
    the kernel or raises; "plain" runs the plain version."""
    b, L, d = _check_call(q, k_cache, n_heads, k_scale, v_scale)
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r} (want auto|kernel|plain)")
    if impl == "plain" or (impl == "auto" and q.device.type == "cpu"):
        return decode_attention_plain(
            q, k_cache, v_cache, cur, attn_start, n_heads=n_heads,
            k_scale=k_scale, v_scale=v_scale,
        )
    return _launch(q, k_cache, v_cache, int(cur), attn_start, n_heads, d,
                   k_scale, v_scale)


def decode_attention_plain(q, k_cache, v_cache, cur: int, attn_start=None,
                           *, n_heads: int, k_scale=None, v_scale=None):
    """The kernels' arithmetic in plain PyTorch: scores in fp32 from
    round(q * scale) and the keys (dequantized to q's dtype for an int8
    cache), softmax over [attn_start, cur] with the exact max, p rounded to
    q's dtype before p.v, output in q's dtype. An empty range gives
    zeros."""
    b, L, d = _check_call(q, k_cache, n_heads, k_scale, v_scale)
    h = n_heads
    span = int(cur) + 1
    k = k_cache[:, :span].reshape(b, span, h, d)
    v = v_cache[:, :span].reshape(b, span, h, d)
    if k_scale is not None:
        ks = k_scale[:, :, :span].transpose(1, 2)[..., None]
        vs = v_scale[:, :, :span].transpose(1, 2)[..., None]
        k = (k.float() * ks).to(q.dtype)
        v = (v.float() * vs).to(q.dtype)
    qs = (q.reshape(b, h, d).float() * _scales(d, q.dtype)[0]).to(q.dtype)
    s = torch.einsum("bhd,blhd->bhl", qs.float(), k.float())
    pos = torch.arange(span, device=q.device)
    valid = torch.ones((b, span), dtype=torch.bool, device=q.device)
    if attn_start is not None:
        valid = pos[None, :] >= attn_start.to(q.device)[:, None]
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhl,blhd->bhd", p.to(q.dtype).float(), v.float())
    out = torch.where(l > 0, pv / l.clamp_min(1e-30), torch.zeros_like(pv))
    return out.to(q.dtype).reshape(b, 1, h * d)


def _check_tensor(name, t, dtypes, shape, align=16):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, want one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _launch(q, k_cache, v_cache, cur, attn_start, n_heads, d,
            k_scale, v_scale, plan=None):
    """Launch kernel A or B. `plan` (splits, chunk) overrides
    `_split_plan` (measurement and the card tests)."""
    b, _, hd_total = q.shape
    L = k_cache.shape[1]
    if not 0 <= cur < L:
        raise ValueError(f"cur={cur} outside the cache [0, {L})")
    quant = k_scale is not None
    floats = (torch.float32, torch.bfloat16)
    _check_tensor("q", q, floats, (b, 1, hd_total))
    kv_dtypes = (torch.int8,) if quant else floats
    _check_tensor("k_cache", k_cache, kv_dtypes, (b, L, hd_total))
    _check_tensor("v_cache", v_cache, (k_cache.dtype,), (b, L, hd_total))
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    start_ptr = None
    if attn_start is not None:
        _check_tensor("attn_start", attn_start, (torch.int32,), (b,))
        start_ptr = attn_start.data_ptr()
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check_tensor(name, t, (torch.float32,), (b, n_heads, L))
    splits, chunk, span = _plan_args(plan or _split_plan(
        cur + 1, b * n_heads, d=d, kv_bytes=k_cache.element_size(),
        quant=quant), cur + 1)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = _scales(d, q.dtype)[0]
    lib = _library()
    with torch.cuda.device(q.device):
        part, count = _scratch(q, n_heads, d, splits)
        if quant:
            rc = lib.decode_attention_int8(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
                start_ptr, _ptr(part), _ptr(count), b, L, n_heads, d, cur,
                splits, chunk, span, scale, _DTYPE_CODE[q.dtype], stream,
            )
            name = "decode_attention_int8"
        else:
            rc = lib.decode_attention(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                out.data_ptr(), start_ptr, _ptr(part), _ptr(count), b, L,
                n_heads, d, cur, splits, chunk, span, scale,
                _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype], stream,
            )
            name = "decode_attention"
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: "
            + _ERRORS.get(rc, f"cudaError_t {rc}")
            + f" (b={b}, L={L}, h={n_heads}, d={d}, cur={cur}, "
              f"splits={splits}x{chunk} (span {span}), q {q.dtype}, cache "
              f"{k_cache.dtype})"
        )
    LAUNCHES[name] += 1
    return out


# --------------------------------------------------------------------- paged
# Paged decode (serve/kv_pages.py): K/V live in a pool of fixed-size blocks
# shared by every slot; position p of slot b lives in pool block
# page_table[b, p // block_size] at row p % block_size. Positions are
# slot-local and each slot has its own cursor `lengths[b]` (inclusive: the
# caller writes the current token's K/V at that position first).


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor,
                 n_heads: int, k_scale=None) -> torch.Tensor:
    """Each slot's pages as one contiguous span: a (num_blocks, block_size,
    h*hd) pool and a (b, mb) table give (b, mb*block_size, h, d). With
    `k_scale` ((num_blocks, h, block_size) fp32 scale pages) the span is
    dequantized per (position, head) in fp32. Shared by the reference
    attention and the model's paged prefill (models/vit.py)."""
    b, mb = page_table.shape
    bs, hh = pages.shape[1], pages.shape[2]
    idx = page_table.long()
    k = pages[idx].reshape(b, mb * bs, n_heads, hh // n_heads)
    if k_scale is not None:
        # (b, mb, h, bs) -> per position (b, span, h)
        sc = k_scale[idx].transpose(2, 3).reshape(b, mb * bs, n_heads)
        k = k.float() * sc[..., None]
    return k


def paged_attention_reference(q, k_pages, v_pages, page_table, lengths,
                              attn_start=None, *, n_heads: int,
                              k_scale=None, v_scale=None) -> torch.Tensor:
    """The reference's gather path: materialize each slot's span (its
    per-slot capacity, mb * block_size) and run masked attention over
    [attn_start[b], lengths[b]]. The route for head shapes the kernels do
    not take, on every device; an int8 pool dequantizes in fp32 during
    the gather."""
    b = q.shape[0]
    hh = k_pages.shape[2]
    k = gather_pages(k_pages, page_table, n_heads, k_scale)
    v = gather_pages(v_pages, page_table, n_heads, v_scale)
    pos = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = pos <= lengths.to(q.device).long()[:, None]
    if attn_start is not None:
        valid &= pos >= attn_start.to(q.device).long()[:, None]
    cd = k_pages.dtype if k_scale is None else torch.float32
    out = attention_with_mask(
        q.reshape(b, 1, n_heads, hh // n_heads).to(cd), k.to(cd), v.to(cd),
        valid[:, None, None, :],
    )
    return out.reshape(b, 1, hh).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,           # (b, 1, h*hd)
    k_pages: torch.Tensor,     # (num_blocks, block_size, h*hd) pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (b, mb) int32
    lengths: torch.Tensor,     # (b,) int32: each slot's current position
    attn_start: Optional[torch.Tensor] = None,  # (b,) int32 first valid key
    *,
    n_heads: int,
    k_scale: Optional[torch.Tensor] = None,  # (num_blocks, h, block_size)
    v_scale: Optional[torch.Tensor] = None,  # fp32 scale pages, int8 pool
    impl: str = "auto",
) -> torch.Tensor:
    """One paged decode step; returns (b, 1, h*hd) in q's dtype.

    `impl`: "auto" routes as the reference does — the gather reference
    when the heads do not pack into 128-lane tiles or the block size is
    not a multiple of 8, else the kernel for CUDA tensors and the plain
    version for CPU tensors; "kernel" launches the kernel or raises;
    "plain" runs the kernel's arithmetic in plain PyTorch; "reference"
    runs the gather reference."""
    b, sq, hd_total = q.shape
    if sq != 1:
        raise ValueError(
            f"paged_decode_attention is the single-token step (got {sq} "
            f"query rows); prefill runs through the gathered span "
            f"(models/vit.py)"
        )
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 page pool needs BOTH k_scale and v_scale")
    if impl not in ("auto", "kernel", "plain", "reference"):
        raise ValueError(
            f"unknown impl {impl!r} (want auto|kernel|plain|reference)")
    bs = k_pages.shape[1]
    d = hd_total // n_heads
    packable = _heads_per_pack(n_heads, d) is not None and bs % 8 == 0
    kw = dict(n_heads=n_heads, k_scale=k_scale, v_scale=v_scale)
    if impl == "reference" or (impl == "auto" and not packable):
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         lengths, attn_start, **kw)
    if impl == "plain" or (impl == "auto" and q.device.type == "cpu"):
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            lengths, attn_start, **kw)
    if not packable:
        raise ValueError(
            f"impl='kernel' needs packable heads (h={n_heads}, d={d}) "
            f"and a block_size multiple of 8 (got {bs})"
        )
    return _launch_paged(q, k_pages, v_pages, page_table, lengths,
                         attn_start, n_heads, d, k_scale, v_scale)


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths,
                                 attn_start=None, *, n_heads: int,
                                 k_scale=None, v_scale=None):
    """Kernels C and D's arithmetic in plain PyTorch: valid keys
    [attn_start[b], min(lengths[b], mb*block_size - 1)]; scores in fp32
    from round(q * scale) and the keys (int8 keys as their integer
    values, the score then times the key scale); the exact max; p rounded
    to the pool's dtype before p.v (int8: p * value scale rounded to q's
    dtype, against the integer values); the denominator sums the
    unrounded p. An empty range gives zeros."""
    b, _, hd_total = q.shape
    h = n_heads
    d = hd_total // h
    idx = page_table.long()
    k = gather_pages(k_pages, page_table, h)     # int8 stays int8
    v = gather_pages(v_pages, page_table, h)
    span = k.shape[1]
    qs = (q.reshape(b, h, d).float() * _scales(d, q.dtype)[0]).to(q.dtype)
    s = torch.einsum("bhd,blhd->bhl", qs.float(), k.float())
    if k_scale is not None:
        # (b, mb, h, bs) scale pages -> (b, h, span)
        s = s * k_scale[idx].transpose(1, 2).reshape(b, h, span)
    pos = torch.arange(span, device=q.device)
    valid = pos[None, :] <= lengths.to(q.device).long()[:, None]
    if attn_start is not None:
        valid &= pos[None, :] >= attn_start.to(q.device).long()[:, None]
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        vs = v_scale[idx].transpose(1, 2).reshape(b, h, span)
        pr = (p * vs).to(q.dtype)
    else:
        pr = p.to(v_pages.dtype)
    pv = torch.einsum("bhl,blhd->bhd", pr.float(), v.float())
    out = torch.where(l > 0, pv / l.clamp_min(1e-30), torch.zeros_like(pv))
    return out.to(q.dtype).reshape(b, 1, h * d)


def _launch_paged(q, k_pages, v_pages, page_table, lengths, attn_start,
                  n_heads, d, k_scale, v_scale, plan=None):
    """Launch kernel C or D. Shapes, dtypes and devices are checked here;
    the cursors' VALUES are device data that the kernel reads itself (no
    host sync), so the splits cover the host-known per-slot capacity
    mb * block_size and a split past a slot's cursor loads nothing.
    `plan` (splits, chunk) overrides `_split_plan`."""
    b, _, hd_total = q.shape
    nb, bs = k_pages.shape[:2]
    mb = page_table.shape[1]
    quant = k_scale is not None
    floats = (torch.float32, torch.bfloat16)
    _check_tensor("q", q, floats, (b, 1, hd_total))
    kv_dtypes = (torch.int8,) if quant else floats
    _check_tensor("k_pages", k_pages, kv_dtypes, (nb, bs, hd_total))
    _check_tensor("v_pages", v_pages, (k_pages.dtype,), (nb, bs, hd_total))
    _check_tensor("page_table", page_table, (torch.int32,), (b, mb), 4)
    _check_tensor("lengths", lengths, (torch.int32,), (b,), 4)
    tensors = [k_pages, v_pages, page_table, lengths]
    start_ptr = None
    if attn_start is not None:
        _check_tensor("attn_start", attn_start, (torch.int32,), (b,), 4)
        start_ptr = attn_start.data_ptr()
        tensors.append(attn_start)
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check_tensor(name, t, (torch.float32,), (nb, n_heads, bs), 4)
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"a paged operand is on {t.device}, q on "
                             f"{q.device}")
    if mb * bs >= 2 ** 31:
        raise ValueError(f"per-slot capacity {mb}x{bs} past int32")
    splits, chunk, span = _plan_args(plan or _split_plan(
        mb * bs, b * n_heads, d=d, kv_bytes=k_pages.element_size(),
        quant=quant, bs=bs, whole=not quant and k_pages.dtype != q.dtype),
        mb * bs)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = _scales(d, q.dtype)[0]
    lib = _library()
    with torch.cuda.device(q.device):
        part, count = _scratch(q, n_heads, d, splits)
        if quant:
            rc = lib.paged_decode_attention_int8(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(), start_ptr,
                _ptr(part), _ptr(count), b, bs, mb, n_heads, d, splits,
                chunk, span, scale, _DTYPE_CODE[q.dtype], stream,
            )
            name = "paged_decode_attention_int8"
        else:
            rc = lib.paged_decode_attention(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                out.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
                start_ptr, _ptr(part), _ptr(count), b, bs, mb, n_heads, d,
                splits, chunk, span, scale, _DTYPE_CODE[q.dtype],
                _DTYPE_CODE[k_pages.dtype], stream,
            )
            name = "paged_decode_attention"
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: "
            + _ERRORS.get(rc, f"cudaError_t {rc}")
            + f" (b={b}, blocks={nb}x{bs}, mb={mb}, h={n_heads}, d={d}, "
              f"splits={splits}x{chunk} (span {span}), q {q.dtype}, pool "
              f"{k_pages.dtype})"
        )
    LAUNCHES[name] += 1
    return out


def _library() -> ctypes.CDLL:
    """The decode-attention library with every pointer and the stream
    declared `c_void_p` (a bare Python int would pass as a 32-bit int)."""
    from ddp_practice_tpu_torch.ops.cuda_build import load_library

    lib = load_library("decode_attention")
    if not getattr(lib, "_signatures_set", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_attention.argtypes = [
            P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, I, P]
        lib.decode_attention.restype = I
        lib.decode_attention_int8.argtypes = [
            P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, P]
        lib.decode_attention_int8.restype = I
        lib.paged_decode_attention.argtypes = [
            P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, I, P]
        lib.paged_decode_attention.restype = I
        lib.paged_decode_attention_int8.argtypes = [
            P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, P]
        lib.paged_decode_attention_int8.restype = I
        lib._signatures_set = True
    return lib
