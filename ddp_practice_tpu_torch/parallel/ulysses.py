"""Ulysses (DeepSpeed-style) sequence parallelism: the all-to-all head
scatter (counterpart of ddp_practice_tpu/parallel/ulysses.py).

Where ring attention (parallel/ring.py) keeps the queries local and
rotates K/V chunks, Ulysses re-shards with two all-to-alls over the seq
group:

    (batch, seq/N, heads, d) --all_to_all--> (batch, seq, heads/N, d)
      ... attention over the WHOLE sequence at heads/N heads ...
    (batch, seq, heads/N, d) --all_to_all--> (batch, seq/N, heads, d)

The local attention is the plain `ops/attention._attention`
(`impl="xla"`) or `ops/flash_attention.flash_attention`
(`impl="flash"`: the packed route when the rank's heads pack, e.g.
lm_base's 6 heads of 64 at seq 2, the "heads" route otherwise, e.g. its
3 heads at seq 4 or tensor 2 x seq 2). q, k and v cross in one
all-to-all, stacked; each all-to-all is an autograd function whose
backward is the other. `all_to_all_single` splits dim 0, so the split
axis (N groups of heads, or N chunks of the sequence) is moved outermost
and made contiguous before each call.

The rank's heads must divide by the seq size (heads are already divided
by the tensor size under tensor parallelism: heads % (tensor * seq) ==
0), with the reference's message.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block j of dim 0 to rank j; block j of the result from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    tdist.all_to_all_single(out, x, group=group)
    return out


def _scatter_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(..., b, s/N, h, d) -> (..., b, s, h/N, d) over the leading dims
    `lead` (q, k, v stacked)."""
    *lead, b, sl, h, d = x.shape
    y = x.reshape(*lead, b, sl, n, h // n, d).movedim(-3, 0)
    y = _all_to_all(y, group)                # [j] = rank j's chunk
    return y.movedim(0, -4).reshape(*lead, b, n * sl, h // n, d)


def _gather_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(..., b, s, h/N, d) -> (..., b, s/N, h, d): the inverse."""
    *lead, b, s, hn, d = x.shape
    y = x.reshape(*lead, b, n, s // n, hn, d).movedim(-4, 0)
    y = _all_to_all(y, group)                # [j] = rank j's heads
    return y.movedim(0, -3).reshape(*lead, b, s // n, n * hn, d)


class _ScatterHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _scatter_heads(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _gather_heads(g, ctx.group, ctx.n), None, None


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _gather_heads(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter_heads(g, ctx.group, ctx.n), None, None


def ulysses_attention(q, k, v, *, group, causal: bool = False,
                      impl: str = "xla") -> torch.Tensor:
    """Attention of this rank's (batch, s_local, heads, head_dim) chunk
    over the whole sequence, the chunks cut over `group` (a SeqGroup);
    the same signature as ring_attention."""
    from ddp_practice_tpu_torch.ops.attention import _attention

    n, heads = group.size, q.shape[2]
    if heads % n != 0:
        raise ValueError(
            f"ulysses needs local heads ({heads}) divisible by "
            f"'seq' axis size ({n})"
        )
    if impl not in ("xla", "flash"):
        raise ValueError(f"unknown attention impl {impl!r} (want 'xla'|'flash')")
    qg, kg, vg = _ScatterHeads.apply(torch.stack([q, k, v]), group.group,
                                     n).unbind(0)
    if impl == "flash":
        from ddp_practice_tpu_torch.ops.flash_attention import (
            flash_attention,
        )

        out = flash_attention(qg, kg, vg, causal=causal)
    else:
        out = _attention(qg, kg, vg, causal=causal)
    return _GatherHeads.apply(out, group.group, n)
