"""BatchNorm with Flax `nn.BatchNorm` semantics, synchronised over the
data-parallel ranks (counterpart of the BatchNorm that
ddp_practice_tpu/models/convnet.py builds with `axis_name`).

A stock `torch.nn.BatchNorm2d` (or `SyncBatchNorm`) is not the
reference's layer, in three ways this module follows:

- the running variance moves towards the *biased* batch variance (torch's
  stock layers take the unbiased one: 36 samples a channel give Flax
  1.0222816 against torch 1.0257753 after one step, and the gap grows
  with every step);
- the momentum is Flax's 0.9 on the running value (torch's 0.1 on the
  batch value), epsilon 1e-5 on both;
- the statistics are reduced in fp32 whatever the compute dtype, as Flax
  promotes them, with the variance as max(0, E[x^2] - E[x]^2) (Flax's
  fast variance), and the normalisation runs in fp32 before the output
  is cast to the compute dtype.

Cross-replica statistics: in train mode with more than one process the
per-rank mean and mean of squares are averaged over every rank (the
reference's `pmean` over the data axis). For equal per-rank batches that
is the global batch's statistics. The all-reduce is differentiable
(`all_reduce_mean`: its backward all-reduces the gradient too), so the
gradient through the global statistics is the global batch's, not each
rank's share of it.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist
from torch import nn

from ddp_practice_tpu_torch.parallel import dist


class _AllReduceSum(torch.autograd.Function):
    """SUM over every rank, forward and backward: d(sum_r x_r)/dx_r = 1,
    so rank r's input gradient is the sum of every rank's output
    gradient."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        tdist.all_reduce(out, op=tdist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        tdist.all_reduce(grad, op=tdist.ReduceOp.SUM)
        return grad


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over every rank, differentiable (the identity on
    one rank)."""
    n = dist.process_count()
    if n == 1:
        return x
    return _AllReduceSum.apply(x) / n


class BatchNorm(nn.Module):
    """Normalise over every axis but dim 1 (the channels of an NCHW
    tensor). `weight`/`bias` are Flax's `scale`/`bias`; the running
    statistics are fp32 buffers (`running_mean`, `running_var`), updated
    in train mode only."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype=torch.float32) -> None:
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def batch_stats(self, x: torch.Tensor):
        """(mean, var) of x over every axis but 1, in fp32, averaged
        over the ranks when more than one runs."""
        axes = [0] + list(range(2, x.ndim))
        xf = x.float()
        stats = torch.stack([xf.mean(axes), xf.square().mean(axes)])
        mean, mean2 = all_reduce_mean(stats).unbind(0)
        return mean, torch.clamp_min(mean2 - mean.square(), 0.0)

    def forward(self, x: torch.Tensor, *, train: bool = False):
        if train:
            mean, var = self.batch_stats(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(
                    m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(
                    m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.ndim - 2)
        # Flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + self.epsilon) * self.weight.float()
        y = (x.float() - mean.view(shape)) * mul.view(shape)
        return (y + self.bias.float().view(shape)).to(self.dtype)
