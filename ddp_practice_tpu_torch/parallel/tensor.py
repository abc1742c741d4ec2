"""Megatron tensor parallelism over the mesh's `tensor` axis: the
collectives at the boundaries of a tensor-parallel region.

The reference states tensor parallelism as PartitionSpecs on parameter
leaves and lets GSPMD place the collectives. The port calls its weights
functionally (`F.linear(x, layer.weight)`), so module hooks such as
torch's ColwiseParallel never see them; instead each rank holds plain
local shards (parallel/mesh.py `shard_model`) and the modules cross the
region's boundaries through the autograd functions here, over the
tensor group (`TensorGroup`):

- `copy_to_tp`: identity forward, all-reduce backward: the input of a
  column-parallel product, whose grad is the sum of every rank's partial
  grads;
- `reduce_from_tp`: all-reduce forward, identity backward: the output of
  a row-parallel product (attention `out`, MLP `fc_out`) or of the
  vocab-sharded embedding lookup; each row-parallel bias is added once,
  after it;
- `gather_from_tp`: all-gather of the last dim forward, this rank's
  slice of the grad backward: the vocab-parallel logits made whole for
  the loss and the sampler (every rank then computes the same loss, so
  the grad of the whole logits is the same on every rank).

A module with `tp = None` (one rank on the axis) calls none of these.

`copy_to_tp` and `reduce_from_tp` read only the group object's `group`:
the routed MLP (ops/moe.py) crosses its expert region through them over
the expert axis (parallel/mesh.py `ExpertGroup`), where each rank
computes its local experts' part of every token's output.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as tdist


@dataclasses.dataclass(frozen=True)
class TensorGroup:
    """This rank's place on the tensor axis: the process group, the
    axis size and this rank's coordinate on it."""
    group: object
    size: int
    rank: int

    def part(self, n: int) -> slice:
        """This rank's contiguous part of `n` items cut in `size`."""
        if n % self.size:
            raise ValueError(f"{n} does not split over tensor={self.size}")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def _all_reduce(t: torch.Tensor, tp: TensorGroup) -> torch.Tensor:
    out = t.contiguous().clone()
    tdist.all_reduce(out, op=tdist.ReduceOp.SUM, group=tp.group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        parts = [torch.empty_like(x) for _ in range(tp.size)]
        tdist.all_gather(parts, x.contiguous(), group=tp.group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.tp.part(g.shape[-1])].contiguous(), None


def copy_to_tp(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else _Copy.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else _Reduce.apply(x, tp)


def gather_from_tp(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else _Gather.apply(x, tp)
