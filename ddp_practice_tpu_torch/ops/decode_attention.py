"""Single-token KV-cache decode attention over the flat (b, L, h*hd) cache
(counterpart of ddp_practice_tpu/ops/decode_attention.py
`decode_attention_packed`).

On a CUDA tensor the step runs one of two CUDA kernels written by hand for
sm_90a (`csrc/decode_attention.cu`, built by `ops/cuda_build.py` and
launched through ctypes):

- kernel A, `decode_attention`: fp32 or bf16 caches. Replaces the Pallas
  TPU kernels `_kernel_single` (one tile, L <= 1024) and `_kernel` via
  `_online_softmax_cell` (online softmax over 256-position blocks);
- kernel B, `decode_attention_int8`: an int8 cache with per-(batch, head,
  position) fp32 scales. Replaces `_kernel_single_quant` and the
  reference's dequantizing branch for long caches; it computes what that
  branch computes (keys and values dequantized to the compute dtype) at
  every L.

Bound: HBM bytes. A step must read every valid key and value row once,
2 * sum_b (cur - start_b + 1) * h * hd * bytes_per_elem, plus 2 * 4 bytes
per valid position and head of scales for int8, over 3.35 TB/s on an H100
SXM. The kernel reads only the valid range [attn_start[b], cur]; see the
source for the design.

On a CPU tensor the wrapper runs the plain PyTorch version of the same
arithmetic (`decode_attention_plain`); the CPU tests compare it with the
JAX package. `impl="plain"` asks for the plain version on any device (the
chip smoke's fp32 cross-check); there is no fallback from the kernel to
the plain version. `LAUNCHES` counts kernel launches per kernel name.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

# launches per kernel, counted where the wrapper launches it and nowhere
# else; chip_smoke.py zeroes them before the main path and reads them after
LAUNCHES = {"decode_attention": 0, "decode_attention_int8": 0}

_LANES = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {
    -1: "head_dim not compiled (64, 128 or 256)",
    -2: "valid span too long for the score buffer in shared memory",
    -3: "unsupported dtype combination",
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _heads_per_pack(h: int, d: int):
    """Copy of ddp_practice_tpu/ops/flash_attention.py `_heads_per_pack`:
    how many heads share one 128-lane tile, None when the shapes don't
    pack. The model routes a single-token step to the kernel exactly when
    this holds, as the reference does."""
    if d >= _LANES:
        return 1 if d % _LANES == 0 else None
    if d < 64 or _LANES % d:
        return None
    hpc = _LANES // d
    return hpc if h % hpc == 0 else None


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
    qs = (q.reshape(b, h, d).float() * (1.0 / math.sqrt(d))).to(q.dtype)
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


def _check_tensor(name, t, dtypes, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, want one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


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
    scale = 1.0 / math.sqrt(d)
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
        lib._signatures_set = True
    return lib
