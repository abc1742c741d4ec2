"""FSDP / ZeRO-3: parameters and optimizer state sharded over the `data`
axis (counterpart of ddp_practice_tpu/parallel/fsdp.py).

`fsdp_rules` is the reference's algorithm, unchanged: the base rules
first (tensor parallelism claims its sub-dims), then the largest free
dim divisible by the data degree, searched in the reference's (Flax) dim
order over the leaf's Layout, so the port picks the dim the reference
picks; a leaf under `min_leaf_size` elements stays as the base rules put
it.

`apply_fsdp` carries the layout out with FSDP2 (`fully_shard`) on the
data sub-mesh: each transformer block, then the root, with
`shard_placement_fn` putting every leaf's data cut on its torch dim.
FSDP2 all-gathers a block's parameters in its pre-forward hook (so the
model's functional reads see whole tensors), reduce-scatters the grads
(the mean over the data ranks, as DDP's) and leaves each rank its
shards, on which the optimizer and its state live (ZeRO). Leaves the
rules leave whole on the data axis are FSDP2's `ignored_params`: they
stay replicated, and `apply_fsdp`'s returned hook all-reduces their
grads (the mean) over the data group after each backward. Under a seq
axis FSDP2 shards over data and replicates over seq: the hook then
averages every rank's stored grads over the seq group as well.

One leaf needs a storage order of its own: FSDP2 cuts a torch dim into
contiguous chunks, and the attention `qkv` bias (Flax (3, h, hd), one
torch dim) is cut by the reference on `hd`, inside the dim. Its rank
storage is then the `data` chunks outermost ((dp, 3, h, hd / dp)), and
the attention layer reads it back in order (`SelfAttention.qkv_bias_split`).

The pipelined families (lm_pipe, vit_tiny_pipe) take `DataShards`
instead of FSDP2: their stacked blocks run through one module's
functional calls, and the 1F1B and interleaved schedules run many
forwards and backwards a step outside any module's forward, so FSDP2's
per-module hooks would gather and reduce at the wrong points. Each rank
stores its data region of every cut leaf (the rules' region, as
`shard_state` takes it, so the checkpoint and `full_parameters` read it
as any other cut); the stage's leaves are all-gathered once, before the
step's first forward (the model's forward pre-hook, or its
`loss_and_grad`), and their grads reduce-scattered once, after the
schedule (the mean over the data ranks, as FSDP2's), leaving each rank
its shards and their grads for the optimizer (ZeRO-3 over a step). Eval
gathers in the same hook and goes back to the shards after its forward.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as tdist
from torch import nn

from ddp_practice_tpu_torch.config import MeshConfig
from ddp_practice_tpu_torch.parallel.sharding_rules import Layout

D = MeshConfig.AXIS_DATA


def fsdp_rules(data_axis_size: int, base_rules: Optional[Callable] = None,
               *, min_leaf_size: int = 1024) -> Callable:
    """rules(name, layout) -> Spec | None adding the `data` cut."""

    def rules(name: str, layout: Layout):
        base = base_rules(name, layout) if base_rules is not None else None
        shape = layout.shape
        if data_axis_size <= 1 or not shape:
            return base
        if math.prod(shape) < min_leaf_size:
            return base
        spec = [list(d) for d in (base or layout.unsharded())]
        best, best_size = None, 0
        for t, j in layout.ref_dims:
            size = layout.dims[t][j]
            if (spec[t][j] is None and size % data_axis_size == 0
                    and size > best_size):
                best, best_size = (t, j), size
        if best is None:
            return base
        spec[best[0]][best[1]] = D
        return tuple(tuple(d) for d in spec)

    return rules


def data_dim(spec) -> Optional[int]:
    """The torch dim a spec cuts over `data`, or None."""
    for t, axes in enumerate(spec or ()):
        if D in axes:
            return t
    return None


def needs_split(layout: Layout, spec, tensor_size: int) -> bool:
    """True when the data cut is not the outermost non-trivial sub-dim of
    its torch dim (after the tensor cut): FSDP2's contiguous chunks would
    then not be the reference's regions."""
    t = data_dim(spec)
    if t is None:
        return False
    for size, axis in zip(layout.dims[t], spec[t]):
        if axis == D:
            return False
        local = size // tensor_size if axis else size
        if local > 1:
            return True
    return False


def apply_fsdp(model: nn.Module, data_mesh, specs: dict,
               data_group, seq_group=None) -> Callable[[], None]:
    """fully_shard `model` (its `blocks`, then the root) over
    `data_mesh`, each parameter on the torch dim its spec cuts over
    `data`; the rest ignored. Returns the after-backward hook that
    averages the ignored parameters' grads over `data_group`, then, with
    a `seq_group` (the seq ranks hold the same shards, each the grads of
    its chunk of the sequences), every rank's stored grads over it."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    names = {id(p): n for n, p in model.named_parameters()}
    replicated = [p for p in model.parameters()
                  if data_dim(specs.get(names[id(p)])) is None]
    ignored = set(replicated)

    def placement(p):
        return Shard(data_dim(specs[names[id(p)]]))

    for blk in getattr(model, "blocks", ()):
        fully_shard(blk, mesh=data_mesh, shard_placement_fn=placement,
                    ignored_params=ignored)
    fully_shard(model, mesh=data_mesh, shard_placement_fn=placement,
                ignored_params=ignored)
    params = list(model.parameters())

    @torch.no_grad()
    def sync_grads() -> None:
        _mean_over([p.grad for p in replicated], data_group)
        if seq_group is not None:
            _mean_over([getattr(p.grad, "_local_tensor", p.grad)
                        for p in params], seq_group)

    return sync_grads


class DataShards:
    """The data cut of a pipelined model's leaves (module docstring):
    `gather` puts every cut leaf whole (over the data ranks) in place of
    its shard, `reduce_grads` (the train step's after-backward hook)
    reduce-scatters their grads to the shards, averages the uncut
    leaves' grads over `data_group` and, with a `seq_group`, every
    rank's grads over it, and puts the shards back."""

    def __init__(self, model: nn.Module, sharding, data_group,
                 seq_group=None):
        self.data_group, self.seq_group = data_group, seq_group
        self.rank, self.dp = sharding.coords[D]
        # (param, its sub-dim sizes, the data sub-dim, its torch dim)
        self.leaves = []
        self.replicated = []
        for name, p in model.named_parameters():
            spec = sharding.specs.get(name)
            if data_dim(spec) is None:
                self.replicated.append(p)
                continue
            subs, k = [], None
            for sizes, axes in zip(sharding.layouts[name].dims, spec):
                for size, axis in zip(sizes, axes):
                    if axis == D:
                        k = len(subs)
                    elif axis:
                        size //= sharding.coords[axis][1]
                    subs.append(size)
            self.leaves.append((p, subs, k, data_dim(spec)))
        self.params = list(model.parameters())
        self.shards = None      # the stored shards while gathered
        model.register_forward_pre_hook(lambda m, args: self.gather())
        model.register_forward_hook(self._after_forward)
        if hasattr(model, "loss_and_grad"):
            inner = model.loss_and_grad

            def loss_and_grad(*args, **kw):
                self.gather()
                return inner(*args, **kw)

            model.loss_and_grad = loss_and_grad

    def _chunks(self, t: torch.Tensor, subs, k):
        """The data ranks' parts of a whole leaf `t`, in rank order."""
        n = subs[k] // self.dp
        view = t.reshape(subs)
        return [view.narrow(k, c * n, n) for c in range(self.dp)]

    @torch.no_grad()
    def gather(self) -> None:
        """Every cut leaf whole over the data ranks (one all-gather)."""
        if self.shards is not None:
            return
        flat = torch.cat([p.data.reshape(-1) for p, *_ in self.leaves])
        parts = [torch.empty_like(flat) for _ in range(self.dp)]
        tdist.all_gather(parts, flat, group=self.data_group)
        self.shards = [p.data for p, *_ in self.leaves]
        off = 0
        for p, subs, k, t in self.leaves:
            n = p.numel()
            shape = list(p.shape)
            shape[t] *= self.dp
            whole = torch.empty(shape, dtype=p.dtype, device=p.device)
            for c, dst in enumerate(self._chunks(whole, subs, k)):
                dst.copy_(parts[c][off:off + n].view(dst.shape))
            p.data = whole
            off += n

    def reshard(self) -> None:
        """Every cut leaf back to this rank's shard."""
        if self.shards is None:
            return
        for (p, *_), shard in zip(self.leaves, self.shards):
            p.data = shard
        self.shards = None

    def _after_forward(self, module, args, out):
        if not torch.is_grad_enabled():
            self.reshard()          # eval: no backward follows

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """After the step's backward: each cut leaf's grad reduce-scattered
        to its shard (the mean over the data ranks, in one collective),
        the uncut leaves' grads averaged over the data ranks, then every
        grad over the seq ranks; the shards back in place."""
        parts = [[] for _ in range(self.dp)]
        for p, subs, k, _ in self.leaves:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            for c, chunk in enumerate(self._chunks(g, subs, k)):
                parts[c].append(chunk.reshape(-1))
        parts = [torch.cat(x) for x in parts]
        mine = torch.empty_like(parts[0])
        tdist.reduce_scatter(mine, parts, group=self.data_group)
        mine /= self.dp
        self.reshard()
        off = 0
        for p, *_ in self.leaves:
            p.grad = mine[off:off + p.numel()].view(p.shape).clone()
            off += p.numel()
        _mean_over([p.grad for p in self.replicated], self.data_group)
        if self.seq_group is not None:
            _mean_over([p.grad for p in self.params], self.seq_group)


def sum_over(tensors, group, mean: bool = False) -> list:
    """Each of `tensors` (None skipped) replaced in place by its sum (its
    mean with `mean`) over `group`, in one all-reduce; returns them."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    tdist.all_reduce(flat, op=tdist.ReduceOp.SUM, group=group)
    if mean:
        flat /= tdist.get_world_size(group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return tensors


def _mean_over(grads, group) -> None:
    """Each of `grads` (None skipped) replaced in place by its mean over
    `group`, in one all-reduce."""
    sum_over(grads, group, mean=True)
