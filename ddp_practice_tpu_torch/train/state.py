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

Under a CUDA graph (utils/graphs.py) a step is captured once and
replayed, so nothing the step reads may be a Python number that changes
from step to step:

- the learning rate is a 0-dim fp32 tensor on the device, `lr`, that
  every apply sets from a per-apply table of `schedule_lr`'s values
  (`lr_table`) at a device apply counter; the torch optimizers read it as
  a tensor (Adam and AdamW built `capturable=True` on the card, which
  keeps their step counts on the device too);
- SGD's update is written here in foreach ops (`_sgd`) over torch SGD's
  state, because torch's SGD reads a tensor lr as a Python number
  (`alpha=-lr`, a device-to-host read a graph cannot capture); it is the
  reference's chain: decayed weights added, the momentum trace (the
  first apply's trace is the grad itself), then p -= lr * update;
- `TrainState.step` and `Optimizer.applies` stay Python ints (the
  checkpoint, the logs and the schedule's host side read them), each
  mirrored by a device counter (`device_step`, `device_applies`) that the
  step advances in place; a mirror is written from its Python count only
  when the two are known to differ (after a restore, or before the first
  read), so a captured step reads and advances the device counter and
  bakes no Python value. `accum_steps > 1` branches in Python on `micro`:
  a graph unit is one whole apply (utils/graphs.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.distributed as tdist
from torch import nn

from ddp_practice_tpu_torch.config import TrainConfig
from ddp_practice_tpu_torch.parallel.mesh import local_tensor as _local


@dataclasses.dataclass
class TrainState:
    """`step` counts micro-steps on the host (no device readback);
    `model` is the bare module (the loop may run it through DDP).
    `device_step()` is the same count as a 0-dim int64 tensor on the
    model's device (the dropout keys' counter, train/steps.py)."""
    step: int
    model: nn.Module
    optimizer: "Optimizer"
    _step_t: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False)
    _step_at: int = dataclasses.field(default=-1, repr=False)

    def device_step(self) -> torch.Tensor:
        """The step counter on the device, written from `step` first if
        they may differ (never inside a capture: the graph runner syncs
        before it captures)."""
        if self._step_t is None:
            device = next(self.model.parameters()).device
            self._step_t = torch.zeros((), dtype=torch.int64, device=device)
        if self._step_at != self.step:
            self._step_t.fill_(self.step)
            self._step_at = self.step
        return self._step_t

    def advance(self) -> None:
        """One micro-step done: `step` + 1, and the device counter + 1 in
        place while it mirrors `step`."""
        if self._step_t is not None and self._step_at == self.step:
            self._step_t.add_(1)
            self._step_at += 1
        self.step += 1

    def sync_device(self) -> None:
        """Write every device counter from its Python count (the apply
        counter only where the schedule reads it)."""
        self.device_step()
        if len(self.optimizer.lr_table) > 1:
            self.optimizer.device_applies()


def schedule_length(config: TrainConfig, steps_per_epoch: int) -> int:
    """Applies after which `schedule_lr` stays constant (1 for the
    constant schedule): the length of `Optimizer.lr_table`."""
    if config.lr_schedule == "constant":
        return 1
    accum = max(config.accum_steps, 1)
    total = max(steps_per_epoch * config.epochs // accum, 1)
    warmup = config.warmup_steps // accum
    return warmup + max(total - warmup, 1) + 1


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
                 world_size: int = 1, norm_groups=None):
        """`world_size` is the data-parallel degree (what
        `scale_lr_by_replicas` multiplies by); `norm_groups`, one tuple
        of process groups per parameter, the groups each is sharded
        over (`global_norm`)."""
        self.params = [p for p in params if p.requires_grad]
        self.norm_groups = norm_groups
        # what the torch optimizer updates: each parameter, or an FSDP
        # parameter's local shard (torch's foreach Adam cannot mix a
        # DTensor with its plain lr tensor); the state is then the
        # shard's, which is the ZeRO partition
        self.inner_params = [_local(p) for p in self.params]
        self._shards = any(q is not p for q, p in
                           zip(self.inner_params, self.params))
        device = self.params[0].device
        lr = config.learning_rate
        if config.scale_lr_by_replicas:
            lr *= world_size
        self.schedule = schedule_lr(config, steps_per_epoch, lr)
        self.lr_table = torch.tensor(
            [self.schedule(t) for t in range(schedule_length(
                config, steps_per_epoch))],
            dtype=torch.float32, device=device)
        self.lr = self.lr_table[0].clone()
        self._applies_t = torch.zeros((), dtype=torch.int64, device=device)
        self._applies_at = 0
        name = config.optimizer
        # on the card Adam's step counts live on the device and it reads
        # the tensor lr there (capturable); on the CPU torch reads it as a
        # number (no graph runs there)
        capturable = device.type == "cuda"
        if name == "sgd":
            self.inner = torch.optim.SGD(
                self.inner_params, lr=self.lr, momentum=config.momentum,
                weight_decay=config.weight_decay)
        elif name == "adam":
            self.inner = torch.optim.Adam(
                self.inner_params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                capturable=capturable)
        elif name == "adamw":
            self.inner = torch.optim.AdamW(
                self.inner_params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=config.weight_decay, capturable=capturable)
        else:
            raise ValueError(f"unknown optimizer {name!r}")
        self.clip_norm = config.clip_norm
        self.k = max(config.accum_steps, 1)
        self.micro = 0        # micro-steps since the last apply
        self.applies = 0      # the schedule's count
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.k > 1 else None)

    def device_applies(self) -> torch.Tensor:
        """The apply count on the device, written from `applies` first if
        they may differ (a restore sets `applies`)."""
        if self._applies_at != self.applies:
            self._applies_t.fill_(self.applies)
            self._applies_at = self.applies
        return self._applies_t

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
            norm = global_norm([p.grad for p in self.params],
                               self.norm_groups)
            grads = [_local(p.grad) for p in self.params]
            # the reference: t stays below the limit, else t / norm * limit
            scale = torch.where(norm < self.clip_norm, 1.0,
                                self.clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        if len(self.lr_table) > 1:   # a constant schedule keeps lr as built
            # index_select, not table[t]: indexing by a 0-dim tensor reads
            # it on the host, which a graph cannot capture
            applies = self.device_applies()
            last = len(self.lr_table) - 1
            self.lr.copy_(self.lr_table.index_select(
                0, applies.clamp(max=last).view(1)).view(()))
            applies.add_(1)
            self._applies_at += 1
        if isinstance(self.inner, torch.optim.SGD):
            self._sgd()
        else:
            if self._shards:
                for q, p in zip(self.inner_params, self.params):
                    q.grad = _local(p.grad)
            self.inner.step()
        self.applies += 1
        return True

    @torch.no_grad()
    def _sgd(self) -> None:
        """torch SGD's update on its own state (`momentum_buffer`), with
        the lr read as a tensor: update = g (+ wd * p); trace = momentum *
        trace + update (the first apply: update); p -= lr * trace."""
        group = self.inner.param_groups[0]
        params = self.inner_params
        grads = [_local(p.grad) for p in self.params]
        if group["weight_decay"]:
            grads = torch._foreach_add(grads, params,
                                       alpha=group["weight_decay"])
        if group["momentum"]:
            state = [self.inner.state[p] for p in params]
            if all("momentum_buffer" in st for st in state):
                bufs = [st["momentum_buffer"] for st in state]
                torch._foreach_mul_(bufs, group["momentum"])
                torch._foreach_add_(bufs, grads)
            else:
                bufs = [g.detach().clone() for g in grads]
                for st, buf in zip(state, bufs):
                    st["momentum_buffer"] = buf
            grads = bufs
        torch._foreach_sub_(params, torch._foreach_mul(grads, self.lr))


def global_norm(tensors, groups=None) -> torch.Tensor:
    """The reference's global norm: the L2 norm over every element, fp32,
    on the device (no readback). With `groups` (one tuple of process
    groups per tensor: those it is sharded over) each tensor is a shard
    (a DTensor's local shard under FSDP): the squared norms are summed
    over the ranks of its groups, so each leaf counts once whatever its
    layout, and every rank gets the same norm."""
    tensors = list(tensors)
    if groups is None:
        return torch.linalg.vector_norm(torch.stack(
            [n.float() for n in torch._foreach_norm(tensors)]))
    by_groups: dict = {}
    for t, g in zip(tensors, groups):
        by_groups.setdefault(tuple(g), []).append(_local(t))
    total = None
    for g, ts in by_groups.items():
        sq = torch.stack([n.float() for n in torch._foreach_norm(ts)])
        sq = (sq * sq).sum()
        for pg in g:
            tdist.all_reduce(sq, op=tdist.ReduceOp.SUM, group=pg)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def make_optimizer(config: TrainConfig, model: nn.Module,
                   steps_per_epoch: int = 0,
                   world_size: int = 1) -> Optimizer:
    """The optimizer over `model`'s parameters, as they stand (build it
    after parallel/ has laid them out: its state then mirrors their
    layout); `world_size` is the data-parallel degree."""
    return Optimizer(model.parameters(), config, steps_per_epoch,
                     world_size, norm_groups(model))


def norm_groups(model: nn.Module):
    """For each trainable parameter of a model laid out over ranks
    (parallel/mesh.py `model.sharding`), the process groups it is cut
    over (`global_norm`'s `groups`); None for a model that is not."""
    sharding = getattr(model, "sharding", None)
    if sharding is None:
        return None
    return [tuple(sharding.groups[a] for a in sharding.sharded_axes(n))
            for n, p in model.named_parameters() if p.requires_grad]


def create_state(model: nn.Module, optimizer: Optional[Optimizer] = None,
                 config: Optional[TrainConfig] = None,
                 steps_per_epoch: int = 0) -> TrainState:
    """Step 0 over an initialised model (models.create_model seeds it)."""
    if optimizer is None:
        optimizer = make_optimizer(config or TrainConfig(), model,
                                   steps_per_epoch)
    return TrainState(step=0, model=model, optimizer=optimizer)
