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

Under sequence parallelism (the model's `sp`, parallel/mesh.py) each
seq rank keeps its contiguous chunk of the shifted inputs and targets
(`_seq_chunk`) and takes the mean loss of its chunk; the chunks are equal,
so the mean over data x seq (DDP's, or FSDP's with the seq mean) is the
dense mean and its grads the dense grads. A weighted loss divides each
chunk's weighted sum by the whole sequences' weight instead. The metrics
all-reduce over every rank as above, so each rank reports the dense
loss; eval sums (correct, total, nll) over the seq group.

The image step is the same with `prepare_image` (uint8 -> [0, 1] fp32 on
the device) in front, class logits, and metrics `loss`, `accuracy` and
`grad_norm`; the eval step returns weighted (correct, total) so a
wrap-padded last batch counts its real samples only. `augment` (a kind:
False, True or "crop_flip", "rrc"; ops/augment.py) transforms the
training images after `prepare_image`, keyed on the device step counter
(`augment_rng`), so the eager, chunked and resident steps, and their
CUDA-graph replays, crop alike at the same global step; eval never
augments.

The step's Python side (`state.step`, the optimizer's counts) is
mirrored on the device (train/state.py), and the dropout key is
derived there from the device step counter (`step_key`), so the same
step runs eagerly or captured as a CUDA graph and replayed.

K steps a call (the reference's `lax.scan` steps, ROADMAP A3):
`make_chunked_train_step` and `make_chunked_lm_train_step` take K
batches stacked on a leading axis; the device-resident steps
(`make_resident_train_step`, `make_resident_lm_train_step` and their
eval steps) take the whole corpus on the device (`data`) and a (G, B)
grid of sample indices or LM window starts, and gather each batch on the
device (`_resident_gather`, `_lm_window_gather`). Each runs the
per-batch step above as its body, so resident and chunked equal the
per-batch steps by construction, for every layout of parallel/: on the
card as replays of one captured step where `utils/graphs.py graphed`
allows it (utils/graphs.py `StepGraph`: one optimizer apply a unit, a
remainder eager), eagerly, row by row, elsewhere (the CPU, gloo, ranks
as threads). Train steps return the last step's metrics, eval steps the
summed weighted (correct, total), or (correct, total, nll) for the LM.

The pipelined LM under the 1F1B or interleaved schedule (`schedule` of
models/pipeline_lm.py) runs its own forward-backward interleaving:
`make_lm_train_step` calls its `loss_and_grad`, which leaves the grads of
the mean loss in `.grad` and returns the loss and the accuracy counts,
as the reference's step dispatches to it. Under GPipe, and for the
pipelined ViT, the step is the plain one: the model's forward is the
GPipe schedule and autograd its backward. Either way every pipe rank
holds the last stage's loss and counts, so the metrics' mean over the
ranks is the replicas' mean.

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
import torch.distributed as tdist
from torch import nn

from ddp_practice_tpu_torch.models.vit import DropoutKey, fold32, mix32
from ddp_practice_tpu_torch.ops.augment import (
    apply_augment,
    augment_rng,
    check_kind,
)
from ddp_practice_tpu_torch.ops.losses import (
    accuracy_counts,
    cross_entropy,
    cross_entropy_sum,
)
from ddp_practice_tpu_torch.ops.moe import moe_layers
from ddp_practice_tpu_torch.parallel import dist
from ddp_practice_tpu_torch.train.state import (
    TrainState,
    global_norm,
    norm_groups,
)
from ddp_practice_tpu_torch.utils.graphs import StepGraph


def step_key(seed: int, step) -> DropoutKey:
    """The dropout key of a global step (the reference's fold_in(seed,
    step)): 32 bits hashed from the seed and the step, so a step replays
    its masks. `step` is the device step counter (a 0-dim int64 tensor:
    the key is then computed on the device, and a CUDA graph replays it)
    or an int; both give the same bits. No product overflows int64
    (models/vit.py `fold32`), whatever the step. The hash is chained
    (the seed's key, then the step), so swapping seed and step gives
    another key."""
    return DropoutKey(mix32(fold32(step) ^ mix32(fold32(seed))))


def _dropout_key(model: nn.Module, seed: int, state: TrainState):
    """The step's key, or None for a model without dropout (no device
    ops)."""
    if getattr(model, "dropout_rate", 0.0) > 0.0:
        return step_key(seed, state.device_step())
    return None


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


def _seq_chunk(sp, inputs, targets, weight=None):
    """The seq rank's contiguous chunk of the shifted (b, s) inputs,
    targets and weight (all of them without a seq group); s = seq_len
    must split into equal chunks."""
    if sp is None:
        return inputs, targets, weight
    return (sp.chunk(inputs), sp.chunk(targets),
            None if weight is None else sp.chunk(weight))


def _seq_weighted_loss(sp, logits, targets, weight, label_smoothing):
    """The chunk's part of the whole sequences' weighted mean, times the
    seq size (the seq mean of the ranks' losses is then the mean)."""
    loss_sum, weight_sum = cross_entropy_sum(
        logits, targets, weight=weight, label_smoothing=label_smoothing)
    total = weight_sum.detach().clone()
    tdist.all_reduce(total, op=tdist.ReduceOp.SUM, group=sp.group)
    return loss_sum * sp.size / torch.clamp(total, min=1.0)


def make_lm_train_step(model: nn.Module, *, label_smoothing: float = 0.0,
                       seed: int = 0, with_accuracy: bool = True,
                       forward: Optional[nn.Module] = None,
                       after_backward=None):
    """(state, batch) -> (state, metrics). batch["tokens"] is (b, s+1)
    int on the model's device; optional batch["weight"] (b, s) masks
    positions out of the mean loss. `forward` is what runs the model (its
    DDP wrapper under data parallelism; `model` itself by default);
    `after_backward`, when given, runs after each backward (FSDP's
    average of its replicated leaves' grads, parallel/fsdp.py)."""
    net = forward if forward is not None else model
    params = [p for p in model.parameters() if p.requires_grad]
    groups = norm_groups(model)
    moes = moe_layers(model)
    sp = getattr(model, "sp", None)
    scheduled = getattr(model, "schedule", "gpipe") != "gpipe"

    def train_step(state: TrainState, batch: dict):
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        weight = batch.get("weight")
        inputs, targets, weight = _seq_chunk(sp, inputs, targets, weight)
        for p in params:
            p.grad = None
        counts = None
        if scheduled:
            loss, counts = model.loss_and_grad(
                inputs, targets, weight=weight,
                label_smoothing=label_smoothing, with_accuracy=with_accuracy)
            moe_metrics = {}
        else:
            logits = net(inputs, train=True,
                         dropout_key=_dropout_key(model, seed, state))
            if sp is not None and weight is not None:
                loss = _seq_weighted_loss(sp, logits, targets, weight,
                                          label_smoothing)
            else:
                loss = cross_entropy(logits, targets, weight=weight,
                                     label_smoothing=label_smoothing)
            loss = loss + _sown_aux_loss(moes)
            moe_metrics = _moe_metrics(moes)
            loss.backward()
        if after_backward is not None:
            after_backward()
        _commit_router_bias(moes)
        grad_norm = global_norm([p.grad for p in params], groups)
        state.optimizer.step()
        state.advance()
        with torch.no_grad():
            sums = [loss.detach().float()]
            if counts is not None:
                sums += [counts["correct"], counts["total"]]
            elif with_accuracy:
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
    0-dim fp32 tensors on the device (the loop all-reduces them over the
    data ranks; under sequence parallelism summed here over the seq
    group first, so every seq rank returns the whole sequences' sums)."""
    sp = getattr(model, "sp", None)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        tokens = batch["tokens"]
        inputs, targets, _ = _seq_chunk(sp, tokens[:, :-1], tokens[:, 1:])
        logits = model(inputs, train=False)
        correct, total = accuracy_counts(logits, targets)
        nll = cross_entropy(logits, targets) * total
        if sp is None:
            return correct, total, nll
        sums = torch.stack([correct, total, nll])
        tdist.all_reduce(sums, op=tdist.ReduceOp.SUM, group=sp.group)
        return tuple(sums.unbind(0))

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
                    forward: Optional[nn.Module] = None,
                    after_backward=None):
    """(state, batch) -> (state, metrics) for the image task.
    batch["image"] is (b, H, W, C) uint8 or float, batch["label"] (b,) int,
    both on the model's device. `augment` is an augmentation kind
    (ops/augment.py `apply_augment`); `forward` and `after_backward` as
    in `make_lm_train_step`."""
    check_kind(augment)
    net = forward if forward is not None else model
    params = [p for p in model.parameters() if p.requires_grad]
    groups = norm_groups(model)
    moes = moe_layers(model)

    def train_step(state: TrainState, batch: dict):
        images = prepare_image(batch["image"])
        if augment:
            images = apply_augment(
                images, augment_rng(seed, state.device_step()), augment)
        labels = batch["label"]
        for p in params:
            p.grad = None
        logits = net(images, train=True,
                     dropout_key=_dropout_key(model, seed, state))
        loss = cross_entropy(logits, labels,
                             label_smoothing=label_smoothing)
        loss = loss + _sown_aux_loss(moes)
        moe_metrics = _moe_metrics(moes)
        loss.backward()
        if after_backward is not None:
            after_backward()
        _commit_router_bias(moes)
        grad_norm = global_norm([p.grad for p in params], groups)
        state.optimizer.step()
        state.advance()
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


# ------------------------------------------------------ K steps a call
def _stacked(batches: dict, num_steps: int) -> dict:
    """The chunk's leaves, checked to hold `num_steps` batches."""
    for key, value in batches.items():
        if len(value) != num_steps:
            raise ValueError(f"chunk leaf {key!r} holds {len(value)} "
                             f"batches; the step was built for "
                             f"{num_steps}")
    return batches


def _train_rows(name: str, model: nn.Module, body):
    """run(state, rows, batch_of, bind) -> (state, the last step's
    metrics): `body` over `batch_of(row)` for each row, through one
    StepGraph (one optimizer apply a graph unit)."""
    graph = StepGraph(name, model)

    def run(state, rows, batch_of, bind=()):
        return graph(state, rows, lambda st, row: body(st, batch_of(row)),
                     unit=state.optimizer.k, bind=bind)

    run.graph = graph
    return run


def _eval_rows(name: str, model: nn.Module, body, n: int):
    """run(state, rows, batch_of, bind) -> the `n` sums of `body` over
    `batch_of(row)` for each row, added on the device into one tensor (a
    graph adds into it at one address: one tensor per device)."""
    graph = StepGraph(name, model)
    store: dict = {}

    def run(state, rows, batch_of, bind=()):
        device = next(model.parameters()).device
        sums = store.get(device)
        if sums is None:
            sums = store[device] = torch.zeros(n, device=device)
        sums.zero_()

        def step(state, row):
            sums.add_(torch.stack(body(state, batch_of(row))))
            return state, sums

        graph(state, rows, step, bind=(*bind, sums))
        return tuple(sums.clone().unbind(0))

    run.graph = graph
    return run


def _with_graph(fn, run):
    fn.graph = run.graph
    return fn


def make_chunked_train_step(model: nn.Module, *, num_steps: int,
                            label_smoothing: float = 0.0, seed: int = 0,
                            augment=False,
                            forward: Optional[nn.Module] = None,
                            after_backward=None):
    """(state, batches) -> (state, the last step's metrics): K =
    `num_steps` image steps over batches stacked on a leading (K, b, ...)
    axis (data/loader.py `prefetch_chunked`), the same math as K calls of
    `make_train_step` (`forward` and `after_backward` as there)."""
    run = _train_rows("chunked train", model, make_train_step(
        model, label_smoothing=label_smoothing, seed=seed, augment=augment,
        forward=forward, after_backward=after_backward))
    return _with_graph(lambda state, batches: run(
        state, _stacked(batches, num_steps), lambda row: row), run)


def make_chunked_lm_train_step(model: nn.Module, *, num_steps: int,
                               label_smoothing: float = 0.0, seed: int = 0,
                               forward: Optional[nn.Module] = None,
                               after_backward=None):
    """K LM steps a call over stacked (K, b, s + 1) token batches: the
    scheme of `make_chunked_train_step` for the LM objective."""
    run = _train_rows("chunked lm train", model, make_lm_train_step(
        model, label_smoothing=label_smoothing, seed=seed, forward=forward,
        after_backward=after_backward))
    return _with_graph(lambda state, batches: run(
        state, _stacked(batches, num_steps), lambda row: row), run)


def make_chunked_eval_step(model: nn.Module, *, num_steps: int):
    """(state, batches) -> weighted (correct, total) summed over K =
    `num_steps` stacked eval batches: the per-batch step's sums, exact
    under wrap-padding (the weight leaf)."""
    run = _eval_rows("chunked eval", model, make_eval_step(model), 2)
    return _with_graph(lambda state, batches: run(
        state, _stacked(batches, num_steps), lambda row: row), run)


def _resident_gather(data: dict, idx: torch.Tensor) -> dict:
    """One batch from the device-resident corpus: rows `idx` (B,) of each
    (N, ...) leaf; labels as int64, as a host batch's (train/loop.py
    `_to_device`)."""
    batch = {k: v.index_select(0, idx) for k, v in data.items()}
    if "label" in batch:
        batch["label"] = batch["label"].long()
    return batch


def make_resident_train_step(model: nn.Module, *,
                             label_smoothing: float = 0.0, seed: int = 0,
                             augment=False,
                             forward: Optional[nn.Module] = None,
                             after_backward=None):
    """(state, data, idx) -> (state, the last step's metrics): G image
    steps against a device-resident corpus. `data` = {"image": (N, H, W,
    C) uint8, "label": (N,)} on the device, uploaded once; `idx` a (G, B)
    index grid (DataLoader.epoch_plan), one row a step, so a step's only
    host-to-device traffic is its row of the grid. G is the grid's; each
    step is `make_train_step` on the gathered batch."""
    run = _train_rows("resident train", model, make_train_step(
        model, label_smoothing=label_smoothing, seed=seed, augment=augment,
        forward=forward, after_backward=after_backward))
    return _with_graph(lambda state, data, idx: run(
        state, {"idx": idx}, lambda row: _resident_gather(data, row["idx"]),
        bind=tuple(data.values())), run)


def make_resident_eval_step(model: nn.Module):
    """(state, data, idx, weight) -> weighted (correct, total) summed
    over the (G, B) grids of indices and weights (wrap-padded samples
    weigh 0.0): the host eval's sums, from the resident corpus."""
    run = _eval_rows("resident eval", model, make_eval_step(model), 2)
    return _with_graph(lambda state, data, idx, weight: run(
        state, {"idx": idx, "weight": weight},
        lambda row: {**_resident_gather(data, row["idx"]),
                     "weight": row["weight"]},
        bind=tuple(data.values())), run)


def _lm_window_gather(tokens: torch.Tensor, starts: torch.Tensor,
                      window: int) -> torch.Tensor:
    """One (B, window) int64 token batch from the resident stream: the
    windows at `starts` (B,)."""
    offsets = torch.arange(window, device=tokens.device)
    return tokens[starts.long()[:, None] + offsets[None, :]].long()


def make_resident_lm_train_step(model: nn.Module, *, window: int,
                                label_smoothing: float = 0.0, seed: int = 0,
                                with_accuracy: bool = True,
                                forward: Optional[nn.Module] = None,
                                after_backward=None):
    """(state, data, starts) -> (state, the last step's metrics): the LM
    counterpart of `make_resident_train_step`. data = {"tokens": the 1-D
    int token stream on the device}; `starts` a (G, B) grid of window
    starts (LMDataLoader.epoch_plan), each step gathering its (B, seq + 1)
    windows on the device. `with_accuracy=False` leaves out the accuracy
    metric's argmax over the logits (the bench's loss-only steps)."""
    run = _train_rows("resident lm train", model, make_lm_train_step(
        model, label_smoothing=label_smoothing, seed=seed,
        with_accuracy=with_accuracy, forward=forward,
        after_backward=after_backward))
    return _with_graph(lambda state, data, starts: run(
        state, {"starts": starts}, lambda row: {"tokens": _lm_window_gather(
            data["tokens"], row["starts"], window)},
        bind=(data["tokens"],)), run)


def make_resident_lm_eval_step(model: nn.Module, *, window: int):
    """(state, data, starts) -> (correct, total, nll) summed over the
    grid's batches: the resident analogue of `make_lm_eval_step`."""
    run = _eval_rows("resident lm eval", model, make_lm_eval_step(model), 3)
    return _with_graph(lambda state, data, starts: run(
        state, {"starts": starts}, lambda row: {"tokens": _lm_window_gather(
            data["tokens"], row["starts"], window)},
        bind=(data["tokens"],)), run)
