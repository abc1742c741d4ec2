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
once. The kernels read only the valid range; see the source for the
design.

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
    -2: "valid span too long for the score buffer in shared memory",
    -3: "unsupported dtype combination",
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
            k_scale, v_scale):
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
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = _scales(d, q.dtype)[0]
    lib = _library()
    with torch.cuda.device(q.device):
        if quant:
            rc = lib.decode_attention_int8(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
                start_ptr, b, L, n_heads, d, cur, scale,
                _DTYPE_CODE[q.dtype], stream,
            )
            name = "decode_attention_int8"
        else:
            rc = lib.decode_attention(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                out.data_ptr(), start_ptr, b, L, n_heads, d, cur, scale,
                _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype], stream,
            )
            name = "decode_attention"
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: "
            + _ERRORS.get(rc, f"cudaError_t {rc}")
            + f" (b={b}, L={L}, h={n_heads}, d={d}, cur={cur}, "
              f"q {q.dtype}, cache {k_cache.dtype})"
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
                  n_heads, d, k_scale, v_scale):
    """Launch kernel C or D. Shapes, dtypes and devices are checked here;
    the cursors' VALUES are device data that the kernel reads itself (no
    host sync), so the shared-memory score buffer is sized from the
    host-known per-slot capacity mb * block_size."""
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
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = _scales(d, q.dtype)[0]
    lib = _library()
    with torch.cuda.device(q.device):
        if quant:
            rc = lib.paged_decode_attention_int8(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(), start_ptr,
                b, bs, mb, n_heads, d, scale, _DTYPE_CODE[q.dtype], stream,
            )
            name = "paged_decode_attention_int8"
        else:
            rc = lib.paged_decode_attention(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                out.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
                start_ptr, b, bs, mb, n_heads, d, scale,
                _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], stream,
            )
            name = "paged_decode_attention"
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: "
            + _ERRORS.get(rc, f"cudaError_t {rc}")
            + f" (b={b}, blocks={nb}x{bs}, mb={mb}, h={n_heads}, d={d}, "
              f"q {q.dtype}, pool {k_pages.dtype})"
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
            P, P, P, P, P, I, I, I, I, I, F, I, I, P]
        lib.decode_attention.restype = I
        lib.decode_attention_int8.argtypes = [
            P, P, P, P, P, P, P, I, I, I, I, I, F, I, P]
        lib.decode_attention_int8.restype = I
        lib.paged_decode_attention.argtypes = [
            P, P, P, P, P, P, P, I, I, I, I, I, F, I, I, P]
        lib.paged_decode_attention.restype = I
        lib.paged_decode_attention_int8.argtypes = [
            P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, I, P]
        lib.paged_decode_attention_int8.restype = I
        lib._signatures_set = True
    return lib
