"""Pipeline parallelism: the GPipe schedule over the mesh's `pipe` axis
(counterpart of ddp_practice_tpu/parallel/pipeline.py).

The reference runs the pipeline as one jitted SPMD program: a scan over
M + P - 1 ticks in which every stage applies its blocks and activations
hop stage to stage with `lax.ppermute`; XLA differentiates the scan.
Here each stage is a rank of the pipe group (`PipeGroup`,
parallel/mesh.py: threads on one card or the CPU, processes under
torchrun) and runs the same ticks eagerly:

- at tick t stage i applies its blocks to microbatch m = t - i (its
  idle ticks, m outside [0, M), skip the work: eager torch has no SPMD
  lock-step to keep), stage 0 reading the fresh microbatch, the others
  what arrived from stage i - 1 at the end of the previous tick;
- then every rank hops its tick's output to stage + 1 round the ring
  (`_Hop`: the port's `ppermute`, an `all_to_all_single`, which the
  threaded group, gloo and NCCL all take; the threaded group has no
  send/recv), with a buffer of the same shape on every rank, idle or
  not: the wrap-around link and the idle ranks carry values no stage
  reads;
- the last stage's M outputs are then summed over the group with the
  others' zeros (`_PipeOut`), so every rank holds them, as the
  reference's masked psum leaves them.

Autograd through the ticks gives the backward, as XLA's differentiated
scan: the hop's backward is the reverse hop. Every collective of the
schedule is an autograd node on every rank, so each rank's backward
runs the same collectives in the same order: the reverse hops from the
last tick to the first, then `_PipeIn`'s sum of the embedding's
cotangent over the group (only stage 0 reads the input, so the others'
part is zero and every rank ends with stage 0's, so equal embedding
grads on every stage, as the reference's psum of a replicated input's
cotangent). For that, each tick's stage input is `_Input`: the one it
takes gets the cotangent and the other zeros, so the arrivals stage 0
does not read and the fresh microbatches the others do not read stay in
every rank's graph; an idle tick passes its arrival through, and each
rank's last output enters `_PipeOut` (zeros back), so the chain of hops
reaches each rank's loss.

`remat` wraps each stage application in `torch.utils.checkpoint`, the
reference's checkpointed block_fn: the stage's blocks are
recomputed once in the backward.

Boundary values stay fp32, as the reference keeps them
(parallel/pipeline.py:86-100 there, an XLA workaround for sub-fp32
psums under a partial-manual shard_map): the input is upcast before the
first tick and every hop carries fp32, while the blocks compute in the
model's dtype, so a bf16 run's first block of each stage sees an fp32
residual, as the reference's does. The price is twice a bf16 hop's
bytes; dropping it is a later speed PR's choice (ROADMAP "Also open").
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as tdist
from torch.utils.checkpoint import checkpoint

from ddp_practice_tpu_torch.parallel.ring import ppermute


class _Hop(torch.autograd.Function):
    """y to stage + 1, what stage - 1 sent back; backward the cotangent
    to stage - 1."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return ppermute(y, group, 1)

    @staticmethod
    def backward(ctx, g):
        return ppermute(g, ctx.group, -1), None


class _Input(torch.autograd.Function):
    """A tick's stage input: `fresh` (stage 0's microbatch) or `arrived`
    (the hop's delivery); backward the cotangent to the one taken and
    zeros to the other, which keeps both in the rank's graph."""

    @staticmethod
    def forward(ctx, fresh, arrived, take_fresh):
        ctx.take_fresh = take_fresh
        return (fresh if take_fresh else arrived).view_as(arrived)

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros_like(g)
        return (g, zero, None) if ctx.take_fresh else (zero, g, None)


class _PipeIn(torch.autograd.Function):
    """The pipeline's input, as it is; backward its cotangent summed over
    the pipe group (stage 0's: the others read none of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        tdist.all_reduce(g, op=tdist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _PipeOut(torch.autograd.Function):
    """The last stage's (M, ...) outputs on every rank: summed over the
    group with the other ranks' zeros. `tail` is the rank's last tick's
    output (the end of its chain of hops); backward the last stage's own
    cotangent to its outputs (each rank's objective reads its own copy)
    and zeros to `tail`."""

    @staticmethod
    def forward(ctx, outs, tail, group, last):
        ctx.last = last
        buf = outs.detach().clone() if last else torch.zeros_like(outs)
        tdist.all_reduce(buf, op=tdist.ReduceOp.SUM, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else None), torch.zeros_like(g[0]), None, None


def pipeline_apply(stage_fn: Callable[[torch.Tensor], torch.Tensor],
                   x: torch.Tensor, *, pipe, num_microbatches: int,
                   remat: bool = True,
                   trace: Optional[List[tuple]] = None) -> torch.Tensor:
    """`x` (batch, ...) through the pipeline with the GPipe schedule.

    stage_fn(x_mb) -> y_mb applies THIS rank's stage (its blocks) to one
    microbatch, the same shape out. `x` is the pipeline's input on every
    pipe rank (stage 0 reads it); `pipe` the rank's PipeGroup;
    num_microbatches M must divide the batch. Returns the last stage's
    output on every rank, in x's dtype. `trace`, when given, gets a
    (tick, "F", microbatch) for each stage application (the tests hold
    the schedule to it)."""
    P, i, M = pipe.size, pipe.rank, num_microbatches
    b = x.shape[0]
    if b % M:
        raise ValueError(
            f"per-shard batch {b} not divisible by microbatches {M}")
    in_dtype = x.dtype
    xs = _PipeIn.apply(x.float(), pipe.group)
    xs = xs.reshape((M, b // M) + tuple(x.shape[1:])).unbind(0)
    apply = stage_fn
    if remat and torch.is_grad_enabled():
        def apply(inp):
            return checkpoint(stage_fn, inp, use_reentrant=False)
    state = torch.zeros_like(xs[0])
    outs: List[torch.Tensor] = []
    y = state
    for t in range(M + P - 1):
        m = t - i
        inp = _Input.apply(xs[min(max(m, 0), M - 1)], state, i == 0)
        if 0 <= m < M:
            y = apply(inp).float()
            if trace is not None:
                trace.append((t, "F", m))
            if pipe.last:
                outs.append(y)
        else:
            y = inp
        if t < M + P - 2:
            state = _Hop.apply(y, pipe.group)
    stacked = torch.stack(outs) if pipe.last else torch.zeros(
        (M,) + tuple(xs[0].shape), dtype=torch.float32, device=x.device)
    out = _PipeOut.apply(stacked, y, pipe.group, pipe.last)
    return out.reshape((b,) + tuple(x.shape[1:])).to(in_dtype)


def stack_stages(leaves: Dict[str, torch.Tensor],
                 n: int) -> Dict[str, torch.Tensor]:
    """A depth-stacked {name: (depth, ...)} as {name: (n, depth / n,
    ...)}: n stages (or a rank's n chunks) of consecutive blocks."""
    out = {}
    for name, leaf in leaves.items():
        depth = leaf.shape[0]
        if depth % n:
            raise ValueError(f"depth {depth} not divisible by {n} stages")
        out[name] = leaf.reshape((n, depth // n) + tuple(leaf.shape[1:]))
    return out
