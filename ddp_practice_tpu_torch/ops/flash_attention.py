"""Streaming (flash) attention, forward and backward (counterpart of
ddp_practice_tpu/ops/flash_attention.py).

Public entries keep the reference's signatures and layouts:

- `flash_attention(q, k, v)`, (b, s, h, d): heads that pack into 128-lane
  tiles (`_heads_per_pack`) take the packed route on the flat (b, s, h*d)
  activations, other head shapes the folded route (rows #7/#8 and #5/#6 of
  the kernel table, counted apart in `LAUNCHES`);
- `flash_attention_qkv(qkv, n_heads)`: self-attention straight off the
  (b, s, 3*h*d) projection, [q heads | k heads | v heads]; unpackable heads
  slice q, k, v and call `flash_attention`, as the reference does;
- `flash_attention_with_lse(q, k, v)`, folded (b*h, s, d), or (b, s, h,
  d) on its strides: returns (out, lse) with lse differentiable (the lse
  cotangent folds into delta).

On a CUDA tensor each entry runs three CUDA kernels written by hand for
sm_90a (`csrc/flash_attention.cu`, built by `ops/cuda_build.py`, launched
through ctypes): kernel E forward; backward kernel G (dQ, and delta =
rowsum(do * o) - g_lse and the scaled queries into scratches) then kernel
F (dK/dV, reading them), two launches on one stream. One kernel per pass
serves every layout: each operand reaches it as a
(batch, head, position, head_dim) view with element strides, so the folded
layout, the packed layout and the three column windows of the fused QKV
projection differ only in strides, and F and G write dq, dk and dv straight
into the windows of one (b, s, 3*h*d) gradient (the reference concatenates
three arrays there). Replaces `_flash_fwd` (:236) and `_flash_fwd_packed`
(:541) with E, `_flash_bwd` (:375) and `_flash_bwd_packed` (:730) with F+G.

Bound: the forward's 4*b*h*s_q*s_k*d flops and the backward's
10*b*h*s_q*s_k*d (halved under causal masking: masked tiles are skipped)
over the card's peak for the dtype (H100 SXM: 989.4e12 dense bf16 on the
tensor cores, 67e12 fp32 outside them), against the bytes moved (each
operand read once, each result written once) over 3.35 TB/s: at the
training shapes operations bound it. bf16 operands run the products on
the tensor cores with fp32 accumulation (E, F and G designed for Hopper:
scores and accumulators in registers, mma.sync m16n8k16 fed by ldmatrix,
a two-stage cp.async ring, p on ex2.approx), fp32 operands as FMAs on the
CUDA cores (TF32 would break the fp32 tolerances). Times against the
bound: PERF.md.

The reference's ablations of the forward (experiments/flash_variants.py,
flash_ablate.py, flash_4d.py; row #12 of the kernel table) are here too:
`flash_forward_variant` runs compile-time variants of E
(`flash_fwd_tc_kernel<64, NH, KIND>`: v2, v3, v4, v5, nomax; E's kernel
with one lever changed, see that section of the .cu) on folded bf16
operands at head_dim 64, on the tiles of `VARIANT_TILES`; their launches
are counted in `VARIANT_LAUNCHES` and their plain version is
`flash_forward_variant_plain`. The reference's 4D-grid forward needs no
entry of its own: `flash_attention` already runs E on the (b, s, h, d)
strides.

On a CPU tensor an entry runs the plain PyTorch version of the kernels'
arithmetic (`flash_attention_plain`, `flash_attention_plain_bwd`): tile by
tile over `block_q` x `block_k` tiles with the same online softmax and the
same rounding points — q*scale rounded to q's dtype, fp32 scores, m, l and
lse, p rounded to v's dtype before p.v and to do's dtype before p^T.do, ds
rounded to q's dtype before ds^T.qs and ds.k, dq scaled once at the end,
an exact final divide. `block_q` and `block_k` are upper bounds fitted to
divisors of the sequence length (`_fit_block`), as in the reference; they
change only the plain version's summation order. The kernels choose their
own tiles and take any length. `impl`: "auto" (the kernels for CUDA
tensors, the plain version for CPU tensors; never a fallback), "kernel"
(the kernels or raise) or "plain" (the plain version on any device).
`forced_impl` overrides every entry's `impl` inside a block, so a whole
model step can run once on the kernels and once on the plain versions.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch

# launches per row of the kernel table, counted where a wrapper launches
# its kernels and nowhere else (a backward launch is G then F)
LAUNCHES = {"flash_fwd_folded": 0, "flash_bwd_folded": 0,
            "flash_fwd_packed": 0, "flash_bwd_packed": 0}
# the same for the forward variants (v5 per heads-per-block)
VARIANT_LAUNCHES = {"flash_fwd_v2": 0, "flash_fwd_v3": 0, "flash_fwd_v4": 0,
                    "flash_fwd_v5h2": 0, "flash_fwd_v5h4": 0,
                    "flash_fwd_nomax": 0}

_LANES = 128
_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {-1: "head_dim not compiled (32, 64, 128 or 256; variants 64)",
           -3: "unsupported dtype", -4: "variant not compiled",
           -5: "b*h not divisible by the heads per block",
           -6: "not a pass of E, G or F"}
_IMPLS = ("auto", "kernel", "plain")
_forced: Optional[str] = None     # set by `forced_impl`


def reset_launches() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _heads_per_pack(h: int, d: int):
    """Copy of the reference's `_heads_per_pack`: how many heads share one
    128-lane tile, None when the shapes don't pack. The routes follow it,
    so `LAUNCHES` shows which row of the kernel table ran."""
    if d >= _LANES:
        return 1 if d % _LANES == 0 else None
    if d < 64 or _LANES % d:
        return None
    hpc = _LANES // d
    return hpc if h % hpc == 0 else None


def _fit_block(seq: int, block: int) -> int:
    """Largest block <= the requested size that divides seq."""
    block = min(block, seq)
    while seq % block:
        block //= 2
    return max(block, 1)


def _check_blocks(seq_q, seq_k, block_q, block_k, causal):
    block_q = _fit_block(seq_q, block_q)
    block_k = _fit_block(seq_k, block_k)
    if causal and seq_q > seq_k:
        raise ValueError(
            f"causal flash attention needs seq_q <= seq_k (bottom-right "
            f"alignment); got seq_q={seq_q}, seq_k={seq_k} — early query "
            f"rows would attend to nothing"
        )
    return block_q, block_k


def _scales(d: int, dtype) -> tuple:
    """(q_scale, dq_scale). The reference multiplies a q tile by the
    Python float 1/sqrt(d), which JAX rounds to the tile's dtype first;
    dq is scaled in fp32."""
    sm_scale = 1.0 / (d ** 0.5)
    return float(torch.tensor(sm_scale, dtype=dtype)), sm_scale


# --------------------------------------------------------- plain versions
def flash_attention_plain(q4, k4, v4, *, causal: bool = False,
                          block_q: int = 512, block_k: int = 1024):
    """Kernel E's arithmetic in plain PyTorch over (b, h, s, d) operands
    (any strides): returns (out in q's dtype, lse fp32 (b, h, s_q))."""
    b, h, sq, d = q4.shape
    sk = k4.shape[2]
    bq, bk = _check_blocks(sq, sk, block_q, block_k, causal)
    dtype, dev = q4.dtype, q4.device
    q_scale, _ = _scales(d, dtype)
    qs = (q4.float() * q_scale).to(dtype).float()
    kf, vf = k4.float(), v4.float()
    offset = sk - sq if causal else 0
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    for i0 in range(0, sq, bq):
        m = torch.full((b, h, bq), float("-inf"), device=dev)
        l = torch.zeros((b, h, bq), device=dev)
        acc = torch.zeros((b, h, bq, d), device=dev)
        for j0 in range(0, sk, bk):
            if causal and i0 + bq - 1 + offset < j0:
                continue      # wholly above the diagonal: skipped
            s = torch.einsum("bhqd,bhkd->bhqk", qs[:, :, i0:i0 + bq],
                             kf[:, :, j0:j0 + bk])
            if causal:
                s = s.masked_fill(_masked(i0, bq, j0, bk, offset, dev),
                                  _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v4.dtype).float(),
                vf[:, :, j0:j0 + bk])
            m = m_new
        out[:, :, i0:i0 + bq] = torch.where(
            l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None],
            torch.zeros_like(acc))
        lse[:, :, i0:i0 + bq] = m + torch.log(l.clamp_min(1e-30))
    return out.to(dtype), lse


def flash_attention_plain_bwd(q4, k4, v4, o4, do4, lse,
                              g_lse: Optional[torch.Tensor] = None, *,
                              causal: bool = False, block_q: int = 512,
                              block_k: int = 1024):
    """Kernels F and G's arithmetic in plain PyTorch: (dq, dk, dv) as
    (b, h, s, d) in the operands' dtypes. `do4` is already in q's dtype;
    `g_lse` (b, h, s_q) is the lse cotangent (delta -= g_lse)."""
    b, h, sq, d = q4.shape
    sk = k4.shape[2]
    bq, bk = _check_blocks(sq, sk, block_q, block_k, causal)
    dev = q4.device
    q_scale, dq_scale = _scales(d, q4.dtype)
    qs = (q4.float() * q_scale).to(q4.dtype).float()
    kf, vf, dof = k4.float(), v4.float(), do4.float()
    delta = (dof * o4.float()).sum(dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    offset = sk - sq if causal else 0
    dq = torch.zeros((b, h, sq, d), device=dev)
    dk = torch.zeros((b, h, sk, d), device=dev)
    dv = torch.zeros((b, h, sk, d), device=dev)
    for i0 in range(0, sq, bq):
        qi, doi = qs[:, :, i0:i0 + bq], dof[:, :, i0:i0 + bq]
        for j0 in range(0, sk, bk):
            if causal and i0 + bq - 1 + offset < j0:
                continue
            kj, vj = kf[:, :, j0:j0 + bk], vf[:, :, j0:j0 + bk]
            s = torch.einsum("bhqd,bhkd->bhqk", qi, kj)
            if causal:
                s = s.masked_fill(_masked(i0, bq, j0, bk, offset, dev),
                                  _NEG_INF)
            p = torch.exp(s - lse[:, :, i0:i0 + bq, None])
            dv[:, :, j0:j0 + bk] += torch.einsum(
                "bhqk,bhqd->bhkd", p.to(do4.dtype).float(), doi)
            dp = torch.einsum("bhqd,bhkd->bhqk", doi, vj)
            ds = (p * (dp - delta[:, :, i0:i0 + bq, None])).to(
                q4.dtype).float()
            dk[:, :, j0:j0 + bk] += torch.einsum("bhqk,bhqd->bhkd", ds, qi)
            dq[:, :, i0:i0 + bq] += torch.einsum("bhqk,bhkd->bhqd", ds, kj)
    return ((dq * dq_scale).to(q4.dtype), dk.to(k4.dtype),
            dv.to(v4.dtype))


def _masked(i0, bq, j0, bk, offset, dev):
    """True where key j0+c is hidden from query i0+r (j > i + offset)."""
    rows = torch.arange(i0, i0 + bq, device=dev)[:, None]
    cols = torch.arange(j0, j0 + bk, device=dev)[None, :]
    return cols > rows + offset


# the forward variants: {name: (kernel code, heads per block allowed)}
VARIANTS = {"v2": (0, (1,)), "v3": (1, (1,)), "v4": (2, (2,)),
            "v5": (3, (2, 4)), "nomax": (4, (1,))}
# the kind of E itself in the .cu's flash_fwd_tc_kernel<D, NH, KIND>
# (kFwdE); the variants' kinds are their codes above
E_KIND = 5
# their kernels' tiles, the .cu's FwdPlan<64, NH, KIND> (E's at d = 64,
# one 16-row tile a warp at four heads a block): {row: (heads a block,
# queries a head, keys a tile)}
VARIANT_TILES = {"v2": (1, 128, 64), "v3": (1, 128, 64), "v4": (2, 128, 64),
                 "v5h2": (2, 128, 64), "v5h4": (4, 64, 64),
                 "nomax": (1, 128, 64)}
_LOG2E = 1.4426950408889634


def fwd_kernel_name(d: int, n_heads: int = 1, kind: int = E_KIND) -> str:
    """The bf16 forward kernel's name as ptxas and the profiler print it:
    E at head_dim d by default, a variant with its heads a block and
    kind."""
    return f"flash_fwd_tc_kernel<{d}, {n_heads}, {kind}>"


def _variant_heads(variant: str, n_heads: Optional[int]) -> int:
    """Heads per block of a variant: v4 takes 2, v5 2 or 4 (default 2),
    the others 1."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (want one of "
                         f"{', '.join(VARIANTS)})")
    allowed = VARIANTS[variant][1]
    n = allowed[0] if n_heads is None else n_heads
    if n not in allowed:
        raise ValueError(f"variant {variant} takes n_heads in {allowed}, "
                         f"got {n_heads}")
    return n


def _score_scale(variant: str, d: int) -> float:
    """The Python float the reference multiplies the fp32 scores by (JAX
    and torch both take it as fp32); v5 folds log2(e) in for exp2."""
    sm_scale = 1.0 / (d ** 0.5)
    return sm_scale * _LOG2E if variant == "v5" else sm_scale


def _variant_forward(q, k, v, *, variant, causal, block_q, block_k):
    """A variant's arithmetic over folded (bh, s, d) operands, tile by
    tile over block_q x block_k tiles as the reference's grid runs (a
    ragged last tile where a block does not divide the length, as the
    kernel's 64-key tiles): returns (out before its bf16 rounding, lse),
    both fp32."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    bq, bk = min(block_q, sq), min(block_k, sk)
    sumfold, base2 = variant in ("v3", "v5"), variant == "v5"
    nomax = variant == "nomax"
    exp = torch.exp2 if base2 else torch.exp
    scale = _score_scale(variant, d)
    qf, kf, vf = q.float(), k.float(), v.float()
    if sumfold:   # [v | 1]: column d of the P.V product is the row sum
        vf = torch.cat([vf, torch.ones_like(vf[..., :1])], dim=-1)
    offset = sk - sq if causal else 0
    dev = q.device
    out = torch.empty((bh, sq, d), dtype=torch.float32, device=dev)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=dev)
    for i0 in range(0, sq, bq):
        nq = min(bq, sq - i0)
        m = torch.full((bh, nq), _NEG_INF, device=dev)
        l = torch.zeros((bh, nq), device=dev)
        acc = torch.zeros((bh, nq, vf.shape[-1]), device=dev)
        for j0 in range(0, sk, bk):
            if causal and i0 + nq - 1 + offset < j0:
                continue      # wholly above the diagonal: skipped
            nk = min(bk, sk - j0)
            s = torch.einsum("bqd,bkd->bqk", qf[:, i0:i0 + nq],
                             kf[:, j0:j0 + nk]) * scale
            if causal:
                s = s.masked_fill(_masked(i0, nq, j0, nk, offset, dev),
                                  _NEG_INF)
            if nomax:     # unguarded: a cost probe, overflows past ~88
                p, alpha = exp(s), torch.ones_like(l)
            else:
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = exp(s - m_new[..., None])
                alpha = exp(m - m_new)
                m = m_new
            pb = p.to(torch.bfloat16).float()
            acc = acc * alpha[..., None] + torch.einsum(
                "bqk,bkd->bqd", pb, vf[:, j0:j0 + nk])
            if not sumfold:
                l = alpha * l + p.sum(dim=-1)
        if sumfold:
            l = acc[..., d]
        l_safe = l.clamp_min(1e-30)
        out[:, i0:i0 + nq] = acc[..., :d] / l_safe[..., None]
        if nomax:
            lse[:, i0:i0 + nq] = torch.log(l_safe)
        elif base2:
            lse[:, i0:i0 + nq] = (m + torch.log2(l_safe)) * (1.0 / _LOG2E)
        else:
            lse[:, i0:i0 + nq] = m + torch.log(l_safe)
    return out, lse


def flash_forward_variant_plain(q, k, v, *, variant: str,
                                causal: bool = True,
                                n_heads: Optional[int] = None,
                                block_q: int = 512, block_k: int = 1024):
    """The plain PyTorch version of a forward variant over folded (bh, s,
    d) bf16 operands: (out bf16 (bh, s_q, d), lse fp32 (bh, s_q)). Heads
    per block change only the kernel's grid, so v4 computes v2's function
    and v5's heads do not enter here; v3 and v5 take l as the column d of
    bf16(p).[v | 1] (a sum of rounded p), the others as the fp32 sum of
    p; v5 works in base 2; nomax has no running max."""
    _check_variant_operands(q, k, v, variant, n_heads, causal)
    out, lse = _variant_forward(q, k, v, variant=variant, causal=causal,
                                block_q=block_q, block_k=block_k)
    return out.to(q.dtype), lse


def _check_variant_operands(q, k, v, variant, n_heads, causal) -> int:
    """Refuse what the variants do not take; returns the heads per
    block."""
    nh = _variant_heads(variant, n_heads)
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("the variants take folded (b*h, s, d) operands")
    bh, sq, d = q.shape
    sk = k.shape[1]
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (bh, sk, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{(bh, sk, d)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {t.dtype}: the variants take bf16 "
                             f"operands only (the reference's ablations)")
    if bh % nh:
        raise ValueError(f"variant {variant} runs {nh} heads per block: "
                         f"b*h={bh} is not a multiple")
    if causal and sq > sk:
        raise ValueError(f"causal variants need seq_q <= seq_k (bottom-"
                         f"right alignment); got {sq} > {sk}")
    return nh


# --------------------------------------------------------------- layouts
# How each route's tensors become (b, h, s, d) views, with no copy:
#   "folded": q, k, v (b*h, s, d)      -> (b*h, 1, s, d)
#   "heads":  q, k, v (b, s, h, d)     -> (b, h, s, d)   [flash_attention's
#             unpackable heads: the folded row, minus the reference's
#             transposes]
#   "packed": q, k, v (b, s, h*d)      -> (b, h, s, d)
#   "qkv":    one qkv (b, s, 3*h*d)    -> three column windows
_ROW = {"folded": "folded", "heads": "folded", "packed": "packed",
        "qkv": "packed"}
# the layout of a route's output (and of its cotangent)
_OUT_LAYOUT = {"folded": "folded", "heads": "heads", "packed": "packed",
               "qkv": "packed"}


def _to4(layout: str, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    if layout == "folded":
        return x.unsqueeze(1)
    if layout == "heads":
        return x.transpose(1, 2)
    return x.unflatten(-1, (n_heads, -1)).transpose(1, 2)   # (b, s, h*d)


def _operands4(layout, tensors, n_heads):
    if layout == "qkv":
        (qkv,) = tensors
        w = qkv.unflatten(-1, (3, n_heads, -1))            # (b, s, 3, h, d)
        return tuple(w[:, :, i].transpose(1, 2) for i in range(3))
    return tuple(_to4(layout, t, n_heads) for t in tensors)


def _out_shape(layout, tensors, n_heads):
    q = tensors[0]
    if layout == "qkv":
        return (*q.shape[:2], q.shape[2] // 3)
    return tuple(q.shape)


def _stats_shape(layout, q4):
    b, h, sq, _ = q4.shape
    return (b, sq) if layout == "folded" else (b, h, sq)


# -------------------------------------------------------------- autograd
class _FlashAttention(torch.autograd.Function):
    """(out, lse) of one route; saves the inputs, out and lse (the
    reference's residuals) and runs F+G (or their plain version) in
    backward. lse is differentiable: its cotangent folds into delta."""

    @staticmethod
    def forward(ctx, layout, n_heads, causal, block_q, block_k, impl,
                *tensors):
        use_kernel = _use_kernel(impl, tensors[0])
        q4, k4, v4 = _operands4(layout, tensors, n_heads)
        _check_blocks(q4.shape[2], k4.shape[2], block_q, block_k, causal)
        out = torch.empty(_out_shape(layout, tensors, n_heads),
                          dtype=q4.dtype, device=q4.device)
        out4 = _to4(_OUT_LAYOUT[layout], out, n_heads)
        row = _ROW[layout]
        if use_kernel:
            lse = _launch_fwd(q4, k4, v4, out4, causal)
            LAUNCHES[f"flash_fwd_{row}"] += 1
        else:
            o, lse = flash_attention_plain(q4, k4, v4, causal=causal,
                                           block_q=block_q, block_k=block_k)
            out4.copy_(o)
        lse = lse.view(_stats_shape(layout, q4))
        ctx.meta = (layout, n_heads, causal, block_q, block_k, use_kernel)
        ctx.save_for_backward(*tensors, out, lse)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        layout, n_heads, causal, block_q, block_k, use_kernel = ctx.meta
        *tensors, out, lse = ctx.saved_tensors
        dtype = tensors[0].dtype
        if g_out is None:
            g_out = torch.zeros_like(out)
        # the reference casts the cotangent to q's dtype; autograd may hand
        # over a non-contiguous view (an expanded scalar, a transpose)
        g_out = g_out.to(dtype).contiguous()
        q4, k4, v4 = _operands4(layout, tensors, n_heads)
        o4 = _to4(_OUT_LAYOUT[layout], out, n_heads)
        do4 = _to4(_OUT_LAYOUT[layout], g_out, n_heads)
        lse4 = lse.view(q4.shape[:3])
        glse4 = (None if g_lse is None else
                 g_lse.float().contiguous().view(q4.shape[:3]))
        grads = [torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in tensors]
        dq4, dk4, dv4 = _operands4(layout, grads, n_heads)
        if use_kernel:
            _launch_bwd(q4, k4, v4, o4, do4, lse4, glse4, dq4, dk4, dv4,
                        causal)
            LAUNCHES[f"flash_bwd_{_ROW[layout]}"] += 1
        else:
            for dst, src in zip((dq4, dk4, dv4), flash_attention_plain_bwd(
                    q4, k4, v4, o4, do4, lse4, glse4, causal=causal,
                    block_q=block_q, block_k=block_k)):
                dst.copy_(src)
        return (None,) * 6 + tuple(grads)


@contextlib.contextmanager
def forced_impl(impl: str):
    """Inside the block every entry runs `impl`, whatever its own `impl`
    argument (a backward follows its forward's choice)."""
    global _forced
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want auto|kernel|plain)")
    previous, _forced = _forced, impl
    try:
        yield
    finally:
        _forced = previous


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    impl = _forced or impl
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want auto|kernel|plain)")
    if impl == "plain" or (impl == "auto" and x.device.type == "cpu"):
        return False
    if x.device.type != "cuda":
        raise ValueError(
            f"impl={impl!r} launches the CUDA kernels; got a tensor on "
            f"{x.device}")
    return True


# ------------------------------------------------------------ public API
def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             block_q: int = 512, block_k: int = 1024,
                             impl: str = "auto"):
    """Fused attention over the folded (b*h, s, d) layout, returning
    (out, lse); lse (b*h, s_q) fp32 is differentiable. On (b, s, h, d)
    operands (ring attention's chunks, parallel/ring.py) the same
    kernels run on their strides (the folded row, as `flash_attention`'s
    unpackable heads) and lse is (b, h, s_q)."""
    layout = "heads" if q.dim() == 4 else "folded"
    return _FlashAttention.apply(layout, q.shape[2] if q.dim() == 4 else 1,
                                 causal, block_q, block_k, impl, q, k, v)


def flash_attention(q, k, v, *, causal: bool = False, block_q: int = 512,
                    block_k: int = 1024, impl: str = "auto"):
    """Fused multi-head attention over (b, s, h, d), like
    ops/attention.py. Packable heads take the packed route on the flat
    (b, s, h*d) activations; other shapes the folded route (on strided
    views: no transposes)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if _heads_per_pack(h, d) is not None:
        out, _ = _FlashAttention.apply(
            "packed", h, causal, block_q, block_k, impl,
            q.reshape(b, sq, h * d), k.reshape(b, sk, h * d),
            v.reshape(b, sk, h * d))
        return out.view(b, sq, h, d)
    out, _ = _FlashAttention.apply("heads", h, causal, block_q, block_k,
                                   impl, q, k, v)
    return out


def flash_attention_qkv(qkv, n_heads: int, *, causal: bool = False,
                        block_q: int = 512, block_k: int = 1024,
                        impl: str = "auto"):
    """Self-attention straight off the (b, s, 3*h*d) QKV projection
    ([q heads | k heads | v heads]); returns (b, s, h, d). Packable heads
    read q, k and v as column windows of `qkv` and return one (b, s,
    3*h*d) gradient; other shapes slice and call `flash_attention`."""
    b, s, three_hd = qkv.shape
    if three_hd % 3:
        raise ValueError(f"qkv last dim {three_hd} is not 3*h*d")
    hd = three_hd // 3
    d = hd // n_heads
    if _heads_per_pack(n_heads, d) is None:
        q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
        return flash_attention(
            q.reshape(b, s, n_heads, d), k.reshape(b, s, n_heads, d),
            v.reshape(b, s, n_heads, d), causal=causal, block_q=block_q,
            block_k=block_k, impl=impl)
    out, _ = _FlashAttention.apply("qkv", n_heads, causal, block_q, block_k,
                                   impl, qkv)
    return out.view(b, s, n_heads, d)


def flash_forward_variant(q, k, v, *, variant: str, causal: bool = True,
                          n_heads: Optional[int] = None, block_q: int = 512,
                          block_k: int = 1024, impl: str = "auto"):
    """One forward variant of kernel E (the reference's ablations, row #12)
    over folded (bh, s, d) bf16 operands: returns (out, lse). `variant` is
    "v2", "v3", "v4", "v5" or "nomax"; `n_heads` is v5's heads per block
    (2 or 4; v4 runs 2). No autograd: the ablations time the forward.
    `block_q`/`block_k` tile the plain version only (the kernel's tiles
    are `VARIANT_TILES`); "nomax" overflows once a score passes ~88 (a
    cost probe)."""
    nh = _check_variant_operands(q, k, v, variant, n_heads, causal)
    if not _use_kernel(impl, q):
        return flash_forward_variant_plain(
            q, k, v, variant=variant, causal=causal, n_heads=n_heads,
            block_q=block_q, block_k=block_k)
    if variant == "v5":   # padded once, outside the kernel, as fwd_v5_call
        pad = torch.zeros((*v.shape[:2], 64), dtype=v.dtype, device=v.device)
        pad[..., 0] = 1.0
        v = torch.cat([v, pad], dim=-1)
    out, lse = _launch_variant(q, k, v, variant, nh, causal)
    VARIANT_LAUNCHES[f"flash_fwd_{variant}"
                     + (f"h{nh}" if variant == "v5" else "")] += 1
    return out, lse


# -------------------------------------------------------------- launches
def _check_operands(q4, k4, v4):
    b, h, sq, d = q4.shape
    sk = k4.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(
            f"the flash kernels take head_dim {_HEAD_DIMS}; got {d}")
    for name, t, shape in (("k", k4, (b, h, sk, d)), ("v", v4, (b, h, sk, d))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shape} (b, h, s, d)")
    for name, t in (("q", q4), ("k", k4), ("v", v4)):
        if t.dtype not in _DTYPE_CODE or t.dtype != q4.dtype:
            raise ValueError(
                f"{name} has dtype {t.dtype}; the kernels take q, k, v of "
                f"one dtype in (float32, bfloat16)")
        if t.device != q4.device:
            raise ValueError(f"{name} is on {t.device}, q on {q4.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit head_dim stride")


def _strides(*views) -> ctypes.Array:
    vals = [s for t in views for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch_fwd(q4, k4, v4, out4, causal):
    """Kernel E into `out4`; returns lse (b, h, s_q) fp32."""
    _check_operands(q4, k4, v4)
    b, h, sq, d = q4.shape
    sk = k4.shape[2]
    if causal and sq > sk:
        raise ValueError("causal flash attention needs seq_q <= seq_k")
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q4.device)
    q_scale, _ = _scales(d, q4.dtype)
    lib = _library()
    with torch.cuda.device(q4.device):
        rc = lib.flash_attention_fwd(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out4.data_ptr(),
            lse.data_ptr(), _strides(q4, k4, v4, out4), b, h, sq, sk, d,
            int(causal), q_scale, _DTYPE_CODE[q4.dtype], _stream(q4))
    _raise_on(rc, "flash_attention_fwd", q4, sk)
    return lse


def _launch_bwd(q4, k4, v4, o4, do4, lse, glse, dq4, dk4, dv4, causal):
    """Kernel G, then kernel F on the same stream, into dq4, dk4, dv4. G
    writes delta = rowsum(do * o) - g_lse once per query row into a
    (b, h, s_q) fp32 scratch, and qs = round(q * scale) once into a
    (b, h, s_q, d) one, which F reads beside lse (the bf16 kernels; the
    fp32 ones compute both themselves and leave the scratches unwritten)."""
    _check_operands(q4, k4, v4)
    b, h, sq, d = q4.shape
    for name, t in (("out", o4), ("dout", do4), ("dq", dq4), ("dk", dk4),
                    ("dv", dv4)):
        if t.dtype != q4.dtype or t.stride(-1) != 1:
            raise ValueError(f"{name} must be {q4.dtype} with a unit "
                             f"head_dim stride")
    for name, t in (("lse", lse), ("g_lse", glse)):
        if t is not None and (t.dtype != torch.float32
                              or not t.is_contiguous()
                              or tuple(t.shape) != (b, h, sq)):
            raise ValueError(f"{name} must be contiguous fp32 (b, h, s_q)")
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q4.device)
    qs = torch.empty((b, h, sq, d), dtype=q4.dtype, device=q4.device)
    args = (q4, k4, v4, o4, do4, lse, glse, delta, qs, dq4, dk4, dv4,
            causal)
    _launch_dq(*args)
    _launch_dkdv(*args)


def _launch_dq(*args):
    """Kernel G: dq, and the delta and qs scratches (bf16)."""
    _bwd_entry("flash_attention_bwd_dq", *args)


def _launch_dkdv(*args):
    """Kernel F: dk and dv, reading G's delta and qs (bf16)."""
    _bwd_entry("flash_attention_bwd_dkdv", *args)


def _bwd_entry(entry, q4, k4, v4, o4, do4, lse, glse, delta, qs, dq4, dk4,
               dv4, causal):
    b, h, sq, d = q4.shape
    sk = k4.shape[2]
    q_scale, dq_scale = _scales(d, q4.dtype)
    lib = _library()
    with torch.cuda.device(q4.device):
        rc = getattr(lib, entry)(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
            do4.data_ptr(), lse.data_ptr(),
            None if glse is None else glse.data_ptr(), delta.data_ptr(),
            qs.data_ptr(), dq4.data_ptr(), dk4.data_ptr(), dv4.data_ptr(),
            _strides(q4, k4, v4, o4, do4, dq4, dk4, dv4), b, h, sq, sk, d,
            int(causal), q_scale, dq_scale, _DTYPE_CODE[q4.dtype],
            _stream(q4))
    _raise_on(rc, entry, q4, sk)


def occupancy(d: int) -> dict:
    """The bf16 kernels' footprint at head_dim `d` on this card:
    {"E": ..., "G": ..., "F": ...}, each {"smem_bytes", "threads",
    "blocks_per_sm"} (dynamic shared memory a block, threads a block, and
    the blocks an SM holds by the runtime's occupancy calculator)."""
    lib = _library()
    out = {}
    for name, code in (("E", 0), ("G", 1), ("F", 2)):
        vals = [ctypes.c_int() for _ in range(3)]
        rc = lib.flash_attention_occupancy(
            d, code, *(ctypes.byref(v) for v in vals))
        if rc != 0:
            raise RuntimeError(f"flash_attention_occupancy(d={d}): "
                               + _ERRORS.get(rc, f"cudaError_t {rc}"))
        out[name] = dict(zip(("smem_bytes", "threads", "blocks_per_sm"),
                             (v.value for v in vals)))
    return out


def variant_occupancy(variant: str, n_heads: int) -> dict:
    """A variant kernel's footprint on this card, as `occupancy`'s:
    {"smem_bytes", "threads", "blocks_per_sm"}."""
    lib = _library()
    entry = lib.flash_fwd_variant_occupancy
    entry.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    entry.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(3)]
    rc = entry(
        VARIANTS[variant][0], n_heads, *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"flash_fwd_variant_occupancy({variant}, "
                           f"{n_heads}): "
                           + _ERRORS.get(rc, f"cudaError_t {rc}"))
    return dict(zip(("smem_bytes", "threads", "blocks_per_sm"),
                    (v.value for v in vals)))


def _launch_variant(q, k, v, variant, n_heads, causal):
    """A forward variant's kernel on (bh, s, d) operands (v5: v padded to
    d+64); returns (out (bh, s_q, d), lse (bh, s_q) fp32)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d != 64:
        raise ValueError(f"the variant kernels take head_dim 64; got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"{name} must be on {q.device} with a unit "
                             f"head_dim stride")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    vals = [s for t in (q, k, v, out) for s in t.stride()[:2]]
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd_variant(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), (ctypes.c_longlong * 8)(*vals), bh, sq, sk, d,
            int(causal), VARIANTS[variant][0], n_heads,
            _score_scale(variant, d), _stream(q))
    _raise_on(rc, f"flash_fwd_variant[{variant}]", q.unsqueeze(1), sk)
    return out, lse


def _raise_on(rc, name, q4, sk):
    if rc != 0:
        b, h, sq, d = q4.shape
        raise RuntimeError(
            f"{name} launch failed: " + _ERRORS.get(rc, f"cudaError_t {rc}")
            + f" (b={b}, h={h}, s_q={sq}, s_k={sk}, d={d}, {q4.dtype})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _library() -> ctypes.CDLL:
    """The flash-attention library with every pointer and the stream
    declared `c_void_p` (a bare Python int would pass as a 32-bit int)."""
    from ddp_practice_tpu_torch.ops.cuda_build import load_library

    lib = load_library("flash_attention")
    if not getattr(lib, "_signatures_set", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        S = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_fwd.argtypes = [
            P, P, P, P, P, S, I, I, I, I, I, I, F, I, P]
        lib.flash_attention_fwd.restype = I
        for entry in (lib.flash_attention_bwd_dq,
                      lib.flash_attention_bwd_dkdv):
            entry.argtypes = [P, P, P, P, P, P, P, P, P, P, P, P, S, I, I,
                              I, I, I, I, F, F, I, P]
            entry.restype = I
        lib.flash_fwd_variant.argtypes = [
            P, P, P, P, P, S, I, I, I, I, I, I, I, F, P]
        lib.flash_fwd_variant.restype = I
        IP = ctypes.POINTER(ctypes.c_int)
        lib.flash_attention_occupancy.argtypes = [I, I, IP, IP, IP]
        lib.flash_attention_occupancy.restype = I
        lib._signatures_set = True
    return lib
