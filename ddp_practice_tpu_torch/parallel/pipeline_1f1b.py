"""1F1B and interleaved pipeline schedules: memory-bounded training over
the mesh's `pipe` axis (counterpart of
ddp_practice_tpu/parallel/pipeline_1f1b.py).

GPipe (parallel/pipeline.py) keeps every tick's stage input for the
backward, O(M + P) microbatch activations a rank. Here the backward is
not autograd through the forward ticks: each backward microbatch runs as
an explicit recompute-and-backward inside the schedule (the reference's
vjp: `torch.autograd.backward` of the stage re-run on its stashed
input, which frees that graph at once), so the only state across ticks
is the stash of stage INPUTS, at most 2P - 1 a rank, whatever M.

Plain 1F1B ("eager 1F1B", one combined F + B tick, the reference's):

- F(i, m) at tick i + m, for the stages but the last;
- B(i, m) at tick 2(P - 1) - i + m: the last stage runs its forward,
  head and loss and their backward in the tick its input arrives
  (`head_loss_fn`, the loss cotangent 1), stage i one tick after stage
  i + 1 with the cotangent stage i + 1 sent back;
- T = M + 2(P - 1) ticks in three phases of fixed membership: fill
  (ticks [0, P - 1): F only), steady ([P - 1, M + P - 2): F and B) and
  drain (the rest: B only). Every rank enters a phase's hops, forward
  activations to stage + 1 and cotangents to stage - 1, each tick, with
  a buffer of the mb's shape (zeros where its own op is idle); a rank
  skips the work of its idle ticks.

Interleaved (Megatron's virtual stages, parallel/interleave.py): rank i
holds chunks v P + i (v < V); the constant tables give each rank its op
(F or B), chunk and microbatch per tick, and the executor walks them.
Activations and cotangents ride one forward and one backward hop a tick
(left out on a tick where no rank sends one); the wrap carries F across
a chunk boundary from rank P - 1 to rank 0, and B back, and the
receiver files each arrival under the sender's row of the table. The
buffers key on (chunk, microbatch): chunk 0's backwards all run last,
so a rank's in-flight state reaches M V microbatches, Megatron's trade
for the V-fold smaller bubble.

Both differentiate the loss SUM (the caller rescales by its weight sum),
accumulate the stage's and the head's grads in their `.grad` in tick
order and return the summed loss, the summed scalar metrics (`aux`) and,
on stage 0, the cotangents of its M inputs, the embedding's backward to
close. The loss and metrics come from the last stage, summed over the
pipe group so every rank holds them. Hops and stash are fp32, as
GPipe's boundary (parallel/pipeline.py).

`trace`, when given, gets (tick, "F" | "B", chunk, microbatch, stash
size) for every op the rank runs: the tests hold the schedules to the
reference's formulas with it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ddp_practice_tpu_torch.parallel.fsdp import sum_over
from ddp_practice_tpu_torch.parallel.ring import ppermute

StageFn = Callable[[torch.Tensor, int], torch.Tensor]
HeadLossFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], tuple]


def _sum_over_pipe(pipe, loss: torch.Tensor, aux: Dict[str, torch.Tensor]):
    """(loss, aux) summed over the pipe group: the last stage's values,
    zeros elsewhere, so every rank ends with the last stage's."""
    if pipe is not None:
        sum_over([loss, *aux.values()], pipe.group)
    return loss, aux


def _backward_tick(stage_fn: StageFn, head_loss_fn: HeadLossFn, x, chunk,
                   dy, head: bool, tgt, wgt, need_dx: bool):
    """One B op: the stage (chunk) re-run on its stashed input `x` with
    grad, then the backward of the loss sum (`head`: the head and loss
    of `tgt`, `wgt`) or of `dy`, the cotangent that arrived. Returns
    (dx or None, loss sum or None, aux or None)."""
    x = x.detach().requires_grad_(need_dx)
    with torch.enable_grad():
        y = stage_fn(x, chunk).float()
        if head:
            loss, aux = head_loss_fn(y, tgt, wgt)
            torch.autograd.backward(loss)
        else:
            loss, aux = None, None
            torch.autograd.backward(y, dy)
    return (x.grad if need_dx else None), loss, aux


def pipeline_1f1b_loss_and_grad(stage_fn: StageFn, head_loss_fn: HeadLossFn,
                                xs: Optional[Sequence[torch.Tensor]],
                                targets: Sequence[torch.Tensor],
                                weights: Sequence[torch.Tensor], *, pipe,
                                mb_shape: tuple, device,
                                aux_keys: Sequence[str] = ("weight",),
                                trace: Optional[List[tuple]] = None):
    """The 1F1B schedule on this rank; see the module docstring.

    stage_fn(x, 0) -> y: this rank's stage on one fp32 microbatch.
    head_loss_fn(y, targets_mb, weights_mb) -> (loss_sum, aux): the head
    and the SUM-reduced loss of one microbatch, `aux` a dict of 0-dim
    fp32 metrics (weight and accuracy counts), whose keys every rank
    names in `aux_keys`. xs: the M fp32 microbatch inputs of shape
    `mb_shape` (stage 0 reads them; others may pass None). `pipe` is the
    PipeGroup (None: one stage). Returns (loss_sum, aux, dxs): dxs the
    cotangents of xs on stage 0, else None."""
    P = 1 if pipe is None else pipe.size
    i = 0 if pipe is None else pipe.rank
    M = len(targets)
    last, first = i == P - 1, i == 0
    T = M + 2 * (P - 1)
    zeros = torch.zeros(mb_shape, dtype=torch.float32, device=device)
    stash: Dict[int, torch.Tensor] = {}
    y_in = dy_in = zeros
    loss_sum = torch.zeros((), device=device)
    aux_sum = {k: torch.zeros((), device=device) for k in aux_keys}
    dxs: List[Optional[torch.Tensor]] = [None] * M
    for t in range(T):
        do_f, do_b = t < M + P - 2, t >= P - 1
        y_next = y_in
        if do_f:
            fm = t - i
            y_f = zeros
            if 0 <= fm < M and not last:
                x_f = xs[fm] if first else y_in
                stash[fm] = x_f
                with torch.no_grad():
                    y_f = stage_fn(x_f, 0).float()
                if trace is not None:
                    trace.append((t, "F", 0, fm, len(stash)))
            if P > 1:
                y_next = ppermute(y_f, pipe.group, 1)
        if not do_b:
            y_in = y_next
            continue
        bm = t - (2 * (P - 1) - i)
        dx = zeros
        if 0 <= bm < M:
            x_b = (xs[bm] if first else y_in) if last else stash.pop(bm)
            if trace is not None:
                trace.append((t, "B", 0, bm, len(stash)))
            g, loss, aux = _backward_tick(
                stage_fn, head_loss_fn, x_b, 0, dy_in, last, targets[bm],
                weights[bm], need_dx=P > 1 or first)
            if loss is not None:
                loss_sum = loss_sum + loss.detach().float()
                for k, v in aux.items():
                    aux_sum[k] = aux_sum[k] + v.detach().float()
            if first:
                dxs[bm] = g
            if g is not None:
                dx = g.float()
        dy_next = ppermute(dx, pipe.group, -1) if P > 1 else dy_in
        y_in, dy_in = y_next, dy_next
    loss_sum, aux_sum = _sum_over_pipe(pipe, loss_sum, aux_sum)
    return loss_sum, aux_sum, (dxs if first else None)


def pipeline_interleaved_loss_and_grad(stage_fn: StageFn,
                                       head_loss_fn: HeadLossFn,
                                       xs: Optional[Sequence[torch.Tensor]],
                                       targets: Sequence[torch.Tensor],
                                       weights: Sequence[torch.Tensor], *,
                                       pipe, num_virtual: int,
                                       mb_shape: tuple, device,
                                       aux_keys: Sequence[str] = ("weight",),
                                       trace: Optional[List[tuple]] = None):
    """The interleaved schedule on this rank: the contract of
    `pipeline_1f1b_loss_and_grad`, with stage_fn(x, v) running this
    rank's chunk v (logical stage v P + i) and the ops from
    `interleave.build_tables(P, V, M)`."""
    from ddp_practice_tpu_torch.parallel.interleave import build_tables

    P = 1 if pipe is None else pipe.size
    i = 0 if pipe is None else pipe.rank
    V, M = num_virtual, len(targets)
    tables = build_tables(P, V, M)
    kind, chunk, mb = (tables.kind.tolist(), tables.chunk.tolist(),
                       tables.mb.tolist())
    zeros = torch.zeros(mb_shape, dtype=torch.float32, device=device)
    acts: Dict[tuple, torch.Tensor] = {}     # (v, m) -> arrived input
    dys: Dict[tuple, torch.Tensor] = {}      # (v, m) -> arrived cotangent
    stash: Dict[tuple, torch.Tensor] = {}
    loss_sum = torch.zeros((), device=device)
    aux_sum = {k: torch.zeros((), device=device) for k in aux_keys}
    dxs: List[Optional[torch.Tensor]] = [None] * M
    prev, nxt = (i - 1) % P, (i + 1) % P
    for t in range(tables.ticks):
        k, v, m = kind[t][i], chunk[t][i], mb[t][i]
        y = zeros
        if k == 1:
            x = xs[m] if (v == 0 and i == 0) else acts.pop((v, m))
            stash[(v, m)] = x
            with torch.no_grad():
                y = stage_fn(x, v).float()
            if trace is not None:
                trace.append((t, "F", v, m, len(stash)))
        if 1 in kind[t] and P > 1:
            y = ppermute(y, pipe.group, 1)
        if kind[t][prev] == 1:
            # the sender's row: its chunk, one on past the wrap
            rv = chunk[t][prev] + (1 if i == 0 else 0)
            if rv < V:
                acts[(rv, mb[t][prev])] = y
        dx = zeros
        if k == 2:
            head = i == P - 1 and v == V - 1
            x = stash.pop((v, m))
            if trace is not None:
                trace.append((t, "B", v, m, len(stash)))
            g, loss, aux = _backward_tick(
                stage_fn, head_loss_fn, x, v,
                None if head else dys.pop((v, m)), head, targets[m],
                weights[m], need_dx=True)
            if loss is not None:
                loss_sum = loss_sum + loss.detach().float()
                for key, val in aux.items():
                    aux_sum[key] = aux_sum[key] + val.detach().float()
            if i == 0 and v == 0:
                dxs[m] = g
            dx = g.float()
        if 2 in kind[t] and P > 1:
            dx = ppermute(dx, pipe.group, -1)
        if kind[t][nxt] == 2:
            rv = chunk[t][nxt] - (1 if i == P - 1 else 0)
            if rv >= 0:
                dys[(rv, mb[t][nxt])] = dx
    loss_sum, aux_sum = _sum_over_pipe(pipe, loss_sum, aux_sum)
    return loss_sum, aux_sum, (dxs if i == 0 else None)
