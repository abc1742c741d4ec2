"""Ring attention: sequence parallelism over the mesh's `seq` axis
(counterpart of ddp_practice_tpu/parallel/ring.py).

Each seq rank holds a contiguous chunk of every sequence (its queries,
keys and values, global positions [rank * s, (rank + 1) * s)). The K/V
chunks travel round the ring, one neighbour a step, and each rank
attends its resident queries to every chunk in turn, accumulating an
online softmax, so the result is exact attention over the whole
sequence (the Ring Attention construction, Liu et al.).

`ring_attention(q, k, v, group=, causal=, impl=)` takes (batch, s_local,
heads, head_dim) chunks and the rank's `SeqGroup` (parallel/mesh.py) and
runs one of the reference's two locals:

- `_ring_xla_local`, the plain version: blockwise einsums and the online
  softmax in fp32, masked with -1e30 (every block computed, future ones
  fully masked);
- `_ring_flash_local`: per block the flash kernels
  (ops/flash_attention.py `flash_attention_with_lse`: E forward, G+F
  backward on a CUDA tensor, their plain version on a CPU tensor) give
  (o_i, lse_i), merged exactly in logsumexp space; lse is differentiated
  through (its cotangent enters G's delta). Causality is by block index:
  earlier blocks run non-causal, the diagonal block causal, later blocks
  are skipped with no launch, so rank r launches r + 1 forwards a layer.

The rotation is `_RingKV`: K and V stacked into one buffer, rotated N - 1
times (the reference's scan rotates N times; the last result is never
read), each a `ppermute` to rank + 1 written as an `all_to_all_single`
whose only non-empty split goes to the neighbour (torch's threaded
process group, which runs ranks as threads on one card or the CPU, has
no send/recv; gloo and NCCL take the same call). One autograd function
returns every step's K/V, so its backward, the same rotations reversed
(cotangents to rank - 1), runs on every rank whichever blocks that rank
read: a causal rank that skips the later blocks still passes the others'
cotangents on.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as tdist

_NEG_INF = -1e30


def ppermute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send `x` to the rank `shift` places on round the group's ring and
    return what arrives from the rank `shift` places back."""
    n, me = tdist.get_world_size(group), tdist.get_rank(group)
    flat = x.contiguous().view(-1)
    out = torch.empty_like(flat)
    send, recv = [0] * n, [0] * n
    send[(me + shift) % n] = flat.numel()
    recv[(me - shift) % n] = flat.numel()
    tdist.all_to_all_single(out, flat, recv, send, group=group)
    return out.view(x.shape)


class _RingKV(torch.autograd.Function):
    """kv -> (kv_0, ..., kv_{N-1}): kv_t is the K/V chunk this rank
    holds at ring step t, rank (rank - t) mod N's. Backward passes the
    cotangents back round the ring: each step's, plus what arrived from
    the later steps, goes to rank - 1 (zeros where this rank read none
    of them)."""

    @staticmethod
    def forward(ctx, kv, group, size):
        ctx.group = group
        ctx.like = (kv.shape, kv.dtype, kv.device)
        out = [kv]
        for _ in range(size - 1):
            out.append(ppermute(out[-1], group, 1))
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        shape, dtype, device = ctx.like
        g = None
        for gt in reversed(grads[1:]):
            if gt is not None:
                g = gt if g is None else g + gt
            if g is None:
                g = torch.zeros(shape, dtype=dtype, device=device)
            g = ppermute(g, ctx.group, -1)
        if grads[0] is not None:
            g = grads[0] if g is None else g + grads[0]
        return g, None, None


def _ring_kv(k, v, sp):
    """Every ring step's (k, v) chunk, the rank's own first."""
    kvs = _RingKV.apply(torch.stack([k, v]), sp.group, sp.size)
    return [(kv[0], kv[1]) for kv in kvs]


def ring_attention(q, k, v, *, group, causal: bool = False,
                   impl: str = "xla") -> torch.Tensor:
    """Attention of this rank's (batch, s_local, heads, head_dim) chunk
    over the whole sequence, the chunks cut over `group` (a SeqGroup).
    `impl`: "xla" (the plain blockwise version) or "flash" (the flash
    kernels per block, merged in logsumexp space)."""
    if impl == "flash":
        return _ring_flash_local(q, k, v, sp=group, causal=causal)[0]
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r} (want 'xla'|'flash')")
    return _ring_xla_local(q, k, v, sp=group, causal=causal)[0]


def _ring_flash_local(q, k, v, *, sp, causal: bool):
    """Per ring step the flash kernels give the resident queries'
    normalized (o_i, lse_i) against the held K/V chunk; the partials
    merge exactly:

        m = max(lse, lse_i); w = exp(lse - m); w_i = exp(lse_i - m)
        o <- (w*o + w_i*o_i) / (w + w_i);  lse <- m + log(w + w_i)

    in fp32 (the reference's). The first step is the rank's own chunk:
    merging it into the empty accumulator (o = 0, lse = -1e30) gives it
    back exactly, so it starts the accumulator. The kernels run on the
    (b, s, h, d) strides ("heads" route of ops/flash_attention.py), where
    the reference folds to (b*h, s, d): the same kernel arithmetic
    without the transposes. Returns (out, lse), lse (b, s, h) fp32
    (ring_attention returns out; a check of the merge reads both)."""
    from ddp_practice_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse,
    )

    in_dtype = q.dtype
    o = lse = None
    for step, (kb, vb) in enumerate(_ring_kv(k, v, sp)):
        kblock = (sp.rank - step) % sp.size
        if causal and kblock > sp.rank:
            continue                    # a later block: nothing visible
        oi, lsei = flash_attention_with_lse(
            q, kb, vb, causal=causal and kblock == sp.rank)
        oi, lsei = oi.float(), lsei.transpose(1, 2)        # (b, s, h)
        if o is None:
            o, lse = oi, lsei
            continue
        m = torch.maximum(lse, lsei)
        w1 = torch.exp(lse - m)
        w2 = torch.exp(lsei - m)
        denom = w1 + w2
        o = (o * w1[..., None] + oi * w2[..., None]) / denom[..., None]
        lse = m + torch.log(denom)
    return o.to(in_dtype), lse


def _ring_xla_local(q, k, v, *, sp, causal: bool):
    """Blockwise attention on the local chunks, K/V rotated each step:
    fp32 scores and accumulators, future keys masked with -1e30.
    Returns (out, lse), lse (b, s, h) fp32."""
    in_dtype = q.dtype
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf = q.transpose(1, 2).float()                       # (b, h, sq, d)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    q_pos = sp.offset(sq) + torch.arange(sq, device=q.device)
    for step, (kb, vb) in enumerate(_ring_kv(k, v, sp)):
        kblock = (sp.rank - step) % sp.size
        kf, vf = kb.transpose(1, 2).float(), vb.transpose(1, 2).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
        if causal:
            k_pos = kblock * sk + torch.arange(sk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = s.masked_fill(~mask, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vf)
        m = m_new
    l = l.clamp_min(1e-30)
    o = o / l[..., None]
    return (o.transpose(1, 2).to(in_dtype),
            (m + torch.log(l)).transpose(1, 2))
