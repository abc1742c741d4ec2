"""Loss and metric ops (counterpart of ddp_practice_tpu/ops/losses.py).

Plain PyTorch: the reference computes these in XLA, not in a Pallas
kernel. Loss math runs in fp32 whatever the logits' dtype; the logits
stay in the compute dtype (models/lm.py) and are read in fp32 here.
"""

from __future__ import annotations

from typing import Optional

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  weight: Optional[torch.Tensor] = None,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch; `weight` masks padded
    positions (0.0) out of the mean."""
    loss_sum, weight_sum = cross_entropy_sum(
        logits, labels, weight=weight, label_smoothing=label_smoothing)
    if weight is None:
        return loss_sum / weight_sum
    return loss_sum / torch.clamp(weight_sum, min=1.0)


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor, *,
                      weight: Optional[torch.Tensor] = None,
                      label_smoothing: float = 0.0) -> tuple:
    """(loss_sum, weight_sum): the un-normalized pieces of cross_entropy."""
    nll = _NLL.apply(logits, labels, float(label_smoothing))
    if weight is None:
        # a fill on the device, not a copy from the host: a CUDA graph
        # cannot capture a copy from pageable memory
        return nll.sum(), torch.full((), float(nll.numel()),
                                     device=nll.device)
    return (nll * weight).sum(), weight.sum()


def _nll_forward(logits, labels, label_smoothing: float):
    """Per-position nll = lse - logits[target] without a (..., V)
    log-probability tensor: the max and the shift in the logits' dtype,
    exp and sum in fp32, the target logit gathered from the raw logits.
    Smoothing folds in as ls * (lse - mean(logits))."""
    m = logits.amax(dim=-1)
    lse = m.float() + torch.log(
        torch.exp((logits - m[..., None]).float()).sum(dim=-1))
    tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0].float()
    nll = lse - tgt
    if label_smoothing > 0.0:
        mean_logits = logits.float().mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (
            lse - mean_logits)
    return nll, lse


class _NLL(torch.autograd.Function):
    """Per-position nll with the reference's closed-form backward:
    d nll / d logits = g * (softmax(logits) - y_smooth), softmax
    recomputed from the saved lse, cast to the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, labels, label_smoothing):
        nll, lse = _nll_forward(logits, labels, label_smoothing)
        ctx.save_for_backward(logits, labels, lse)
        ctx.label_smoothing = label_smoothing
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        ls = ctx.label_smoothing
        p = torch.exp(logits.float() - lse[..., None])
        vocab = logits.shape[-1]
        onehot = (labels[..., None].long() == torch.arange(
            vocab, device=labels.device)).float()
        y = (1.0 - ls) * onehot + ls / vocab if ls > 0.0 else onehot
        return (g[..., None] * (p - y)).to(logits.dtype), None, None


def accuracy_counts(logits: torch.Tensor, labels: torch.Tensor, *,
                    weight: Optional[torch.Tensor] = None) -> tuple:
    """(correct, total) counts as fp32 scalars; ties take the first
    maximum, as jnp.argmax does."""
    match = (logits.argmax(dim=-1) == labels).float()
    if weight is None:
        return match.sum(), torch.full((), float(match.numel()),
                                       device=match.device)
    return (match * weight).sum(), weight.sum()
