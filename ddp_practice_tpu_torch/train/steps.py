"""Train and eval steps (counterpart of ddp_practice_tpu/train/steps.py:
`make_train_step` and `make_eval_step` for the image task,
`make_lm_train_step` and `make_lm_eval_step` for the LM).

One LM step: forward (train mode, dropout keyed on (seed, step)), the
cross-entropy of position t predicting t + 1, backward, the optimizer
chain (train/state.py). Metrics match the reference's: `loss`,
`perplexity` = exp(loss), `grad_norm` of the raw grads (before clipping
and accumulation) and `accuracy` (next-token, over the batch). They stay
on the device as 0-dim tensors: the loop reads them back only at its
log steps.

Under data parallelism the loop passes the model wrapped in
DistributedDataParallel: DDP averages the ranks' grads of their local
mean losses, which is the reference's grad of the global mean for equal
local batches, and the step all-reduces (loss, correct, total) so the
metrics are the global batch's.

The image step is the same with `prepare_image` (uint8 -> [0, 1] fp32 on
the device) in front, class logits, and metrics `loss`, `accuracy` and
`grad_norm`; the eval step returns weighted (correct, total) so a
wrap-padded last batch counts its real samples only. BatchNorm models
(ROADMAP A1) and `augment` (A2, ops/augment.py) are not ported; the
chunked and device-resident steps are A3.

MoE models (lm_moe, vit_tiny_moe): both training steps add the summed aux
loss of every routed layer to the objective (`_sown_aux_loss`; the loss
metric includes it, as the reference's), report `moe_load_max`,
`moe_load_min` and `moe_drop_rate` (`_moe_metrics`, already global under
data parallelism: ops/moe.py all-reduces them), and commit each router's
balancing-bias update once, after backward. Eval routes with the current
bias and never moves it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ddp_practice_tpu_torch.ops.losses import accuracy_counts, cross_entropy
from ddp_practice_tpu_torch.ops.moe import moe_layers
from ddp_practice_tpu_torch.parallel import dist
from ddp_practice_tpu_torch.train.state import TrainState, global_norm


def step_key(seed: int, step: int) -> int:
    """The dropout key of a global step: deterministic for a given seed,
    so a step replays its masks (the reference's fold_in(seed, step))."""
    return (seed * 1_000_003 + step) % (1 << 62)


def _sown_aux_loss(layers) -> torch.Tensor | float:
    """The sum of the routed layers' sown aux losses (0.0 without any)."""
    return sum(m.sown["moe_aux_loss"] for m in layers if m.sown)


def _moe_metrics(layers) -> dict:
    """Router health over the routed layers: the worst and best expert
    share of routed tokens (ideal 1/E) and the mean drop rate."""
    sown = [m.sown for m in layers if m.sown]
    if not sown:
        return {}
    with torch.no_grad():
        fracs = torch.cat([s["moe_load_frac"].reshape(-1) for s in sown])
        drops = torch.stack([s["moe_drop_rate"].reshape(()) for s in sown])
        return {"moe_load_max": fracs.max(), "moe_load_min": fracs.min(),
                "moe_drop_rate": drops.float().mean()}


def _commit_router_bias(layers) -> None:
    for m in layers:
        m.commit_bias()


def make_lm_train_step(model: nn.Module, *, label_smoothing: float = 0.0,
                       seed: int = 0, with_accuracy: bool = True,
                       forward: Optional[nn.Module] = None):
    """(state, batch) -> (state, metrics). batch["tokens"] is (b, s+1)
    int on the model's device; optional batch["weight"] (b, s) masks
    positions out of the mean loss. `forward` is what runs the model (its
    DDP wrapper under data parallelism; `model` itself by default)."""
    net = forward if forward is not None else model
    params = [p for p in model.parameters() if p.requires_grad]
    moes = moe_layers(model)

    def train_step(state: TrainState, batch: dict):
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        weight = batch.get("weight")
        for p in params:
            p.grad = None
        logits = net(inputs, train=True,
                     dropout_key=step_key(seed, state.step))
        loss = cross_entropy(logits, targets, weight=weight,
                             label_smoothing=label_smoothing)
        loss = loss + _sown_aux_loss(moes)
        moe_metrics = _moe_metrics(moes)
        loss.backward()
        _commit_router_bias(moes)
        grad_norm = global_norm([p.grad for p in params])
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            sums = [loss.detach().float()]
            if with_accuracy:
                sums += list(accuracy_counts(logits, targets, weight=weight))
            sums = torch.stack(sums)
            if dist.process_count() > 1:
                dist.all_reduce_sum(sums)
                sums[0] /= dist.process_count()
            metrics = {"loss": sums[0], "perplexity": torch.exp(sums[0]),
                       "grad_norm": grad_norm, **moe_metrics}
            if with_accuracy:
                metrics["accuracy"] = sums[1] / torch.clamp(sums[2], min=1.0)
        return state, metrics

    return train_step


def make_lm_eval_step(model: nn.Module):
    """(state, batch) -> (correct, total, nll) summed over the batch, as
    0-dim fp32 tensors on the device (the loop all-reduces them)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        logits = model(inputs, train=False)
        correct, total = accuracy_counts(logits, targets)
        nll = cross_entropy(logits, targets) * total
        return correct, total, nll

    return eval_step


def prepare_image(img: torch.Tensor) -> torch.Tensor:
    """On-device ToTensor: uint8 batches cross to the device at a quarter
    of the bytes and become [0, 1] fp32 here; float batches pass through.
    True division, not *(1/255): the two differ by 1 ulp for 168 of the
    256 uint8 values, and bit-identity with a host-side
    .astype(float32) / 255.0 is part of the storage contract
    (data/datasets.py)."""
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img


def make_train_step(model: nn.Module, *, label_smoothing: float = 0.0,
                    seed: int = 0, augment=False,
                    forward: Optional[nn.Module] = None):
    """(state, batch) -> (state, metrics) for the image task.
    batch["image"] is (b, H, W, C) uint8 or float, batch["label"] (b,) int,
    both on the model's device."""
    if augment:
        raise NotImplementedError(
            "augment is not ported yet (ROADMAP A2: ops/augment.py)")
    net = forward if forward is not None else model
    params = [p for p in model.parameters() if p.requires_grad]
    moes = moe_layers(model)

    def train_step(state: TrainState, batch: dict):
        images = prepare_image(batch["image"])
        labels = batch["label"]
        for p in params:
            p.grad = None
        logits = net(images, train=True,
                     dropout_key=step_key(seed, state.step))
        loss = cross_entropy(logits, labels,
                             label_smoothing=label_smoothing)
        loss = loss + _sown_aux_loss(moes)
        moe_metrics = _moe_metrics(moes)
        loss.backward()
        _commit_router_bias(moes)
        grad_norm = global_norm([p.grad for p in params])
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            sums = torch.stack([loss.detach().float(),
                                *accuracy_counts(logits, labels)])
            if dist.process_count() > 1:
                dist.all_reduce_sum(sums)
                sums[0] /= dist.process_count()
            metrics = {"loss": sums[0], "accuracy": sums[1] / sums[2],
                       "grad_norm": grad_norm, **moe_metrics}
        return state, metrics

    return train_step


def make_eval_step(model: nn.Module):
    """(state, batch) -> weighted (correct, total) as 0-dim fp32 tensors on
    the device; batch["weight"] is 0.0 for wrap-padded samples."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        logits = model(prepare_image(batch["image"]), train=False)
        return accuracy_counts(logits, batch["label"],
                               weight=batch["weight"])

    return eval_step
