"""Train state and the optimizer (counterpart of
ddp_practice_tpu/train/state.py).

The reference chains gradient transformations: [clip by global norm] ->
[decayed weights added, SGD only] -> sgd | adam | adamw over a schedule
-> [multi-step accumulation over k]. `Optimizer` is that chain over a
torch optimizer, with the reference's forms where torch's differ:

- clipping scales by c / norm when norm >= c (the reference), not
  c / (norm + 1e-6) (`clip_grad_norm_`), and sees the grads the inner
  optimizer sees (under accumulation, the k-step mean);
- AdamW's weight decay is passed explicitly (torch defaults to 0.01,
  the reference to `config.weight_decay`, 0.0 by default); both decay the
  old parameter. SGD's weight decay is torch's `weight_decay` (the
  reference's add_decayed_weights before the momentum trace), and Adam
  takes none (the reference applies it to SGD only);
- the schedule is evaluated at the count of optimizer applies, from 0,
  with the horizons divided by `accum_steps` (`schedule_lr`);
- accumulation averages the micro-step grads with the reference's
  Welford update (acc += (g - acc) / (n + 1)) and applies on the k-th;
  between applies the parameters do not move. `TrainState.step` counts
  micro-steps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn

from ddp_practice_tpu_torch.config import TrainConfig


@dataclasses.dataclass
class TrainState:
    """`step` counts micro-steps on the host (no device readback);
    `model` is the bare module (the loop may run it through DDP)."""
    step: int
    model: nn.Module
    optimizer: "Optimizer"


def schedule_lr(config: TrainConfig, steps_per_epoch: int,
                lr: float) -> Callable[[int], float]:
    """The reference's schedule as a function of the apply count."""
    accum = max(config.accum_steps, 1)
    total = max(steps_per_epoch * config.epochs // accum, 1)
    warmup = config.warmup_steps // accum

    def cosine(t: int, horizon: int) -> float:
        t = min(t, horizon)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t / horizon))

    if config.lr_schedule == "constant":
        return lambda t: lr
    if config.lr_schedule == "cosine":
        return lambda t: cosine(t, total)
    if config.lr_schedule == "warmup_cosine":
        def warmup_cosine(t: int) -> float:
            if t < warmup:   # the reference's linear ramp from 0 to lr
                return (0.0 - lr) * (1.0 - t / warmup) + lr
            return cosine(t - warmup, max(total - warmup, 1))
        return warmup_cosine
    raise ValueError(f"unknown lr_schedule {config.lr_schedule!r}")


class Optimizer:
    """The reference's optimizer chain over the parameters' `.grad`."""

    def __init__(self, params, config: TrainConfig, steps_per_epoch: int,
                 world_size: int = 1):
        self.params = [p for p in params if p.requires_grad]
        lr = config.learning_rate
        if config.scale_lr_by_replicas:
            lr *= world_size
        self.schedule = schedule_lr(config, steps_per_epoch, lr)
        name = config.optimizer
        if name == "sgd":
            self.inner = torch.optim.SGD(
                self.params, lr=lr, momentum=config.momentum,
                weight_decay=config.weight_decay)
        elif name == "adam":
            self.inner = torch.optim.Adam(self.params, lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        elif name == "adamw":
            self.inner = torch.optim.AdamW(
                self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=config.weight_decay)
        else:
            raise ValueError(f"unknown optimizer {name!r}")
        self.clip_norm = config.clip_norm
        self.k = max(config.accum_steps, 1)
        self.micro = 0        # micro-steps since the last apply
        self.applies = 0      # the schedule's count
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.k > 1 else None)

    def step(self) -> bool:
        """Consume this micro-step's grads; returns whether it applied."""
        if self.acc is not None:
            n = self.micro
            for acc, p in zip(self.acc, self.params):
                acc.add_((p.grad - acc) / (n + 1))
            self.micro += 1
            if self.micro < self.k:
                return False
            self.micro = 0
            for acc, p in zip(self.acc, self.params):
                p.grad = acc.clone()
                acc.zero_()
        if self.clip_norm:
            grads = [p.grad for p in self.params]
            norm = global_norm(grads)
            # the reference: t stays below the limit, else t / norm * limit
            scale = torch.where(norm < self.clip_norm, 1.0,
                                self.clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(self.applies)
        self.inner.step()
        self.applies += 1
        return True


def global_norm(tensors) -> torch.Tensor:
    """The reference's global norm: the L2 norm over every element, fp32,
    on the device (no readback)."""
    return torch.linalg.vector_norm(torch.stack(
        [n.float() for n in torch._foreach_norm(list(tensors))]))


def make_optimizer(config: TrainConfig, model: nn.Module,
                   steps_per_epoch: int = 0,
                   world_size: int = 1) -> Optimizer:
    return Optimizer(model.parameters(), config, steps_per_epoch,
                     world_size)


def create_state(model: nn.Module, optimizer: Optional[Optimizer] = None,
                 config: Optional[TrainConfig] = None,
                 steps_per_epoch: int = 0) -> TrainState:
    """Step 0 over an initialised model (models.create_model seeds it)."""
    if optimizer is None:
        optimizer = make_optimizer(config or TrainConfig(), model,
                                   steps_per_epoch)
    return TrainState(step=0, model=model, optimizer=optimizer)
