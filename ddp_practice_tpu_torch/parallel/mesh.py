"""The rank mesh and parameter placement (counterpart of
ddp_practice_tpu/parallel/mesh.py).

`build_mesh` lays the world's ranks out as a torch DeviceMesh with the
reference's axes in its order, (data, seq, tensor, pipe, expert): data
outermost, tensor inside it, so the ranks of one tensor group are
consecutive (NVLink neighbours on one node under torchrun). `coords`
gives a rank's (coordinate, size) on every axis and `batch_shard` its
slice of each global batch, the counterpart of `batch_sharding`: the
ranks of one tensor group, and the seq ranks of one data replica, read
the same rows.

The seq axis cuts no parameter: it cuts every sequence into contiguous
chunks, one a rank (`SeqGroup`: the group, the rank's coordinate and
the size, set on the model's layers by `shard_state` as `sp`), and the
attention layers cross the chunks (parallel/ring.py, parallel/ulysses.py).
The seq ranks of one data replica each take the mean loss of their
chunk, so the gradients are averaged over data x seq (`parallelize`).
A routed MLP under a seq group routes the whole sequence (ops/moe.py):
it gathers the router logits over the group (`SeqGroup.gather`) and
dispatches and combines its chunk's tokens alone.

The expert axis cuts the routed MLPs' stacked `expert_*` leaves on their
expert dim (`ExpertGroup`: a rank holds experts [c E / ep, (c + 1) E /
ep)), as the reference's GSPMD layout does; batches shard over data
only, so the expert ranks of one data replica read the same rows, route
them alike and each computes its local experts' part of every token's
output, summed over the group (ops/moe.py). The expert ranks are not
replicas: a replicated leaf's grad is exact on each of them and an
expert leaf's is its own, so grads are averaged over data x seq only.

The pipe axis cuts a pipelined model's stacked blocks into stages
(`PipeGroup`: the group, this rank's stage and the stage count, set on
the model as `pipe` by `shard_state`; parallel/pipeline.py runs the
schedules over it). The pipe ranks of one data replica read the same
rows (`batch_shard`: data coordinate only). They are not replicas: a
stage's block grads are its own, and the embed and head leaves, whole on
every stage, end with equal grads on every one (the schedules make them
so), so grads are averaged over data x seq only, as without pipe.

`shard_state` puts each parameter in the layout the rules give it
(parallel/sharding_rules.py): the tensor cut is taken here, leaving
each rank plain local tensors and each attention, MLP and LM its
`TensorGroup` (parallel/tensor.py), the data cut by FSDP2
(parallel/fsdp.py `apply_fsdp`), or for a pipelined model here too,
gathered and reduced once a step by `DataShards`. `parallelize` is the
whole layout as the train loop runs it (rules, `shard_state`, FSDP2 or
`DataShards` over the data ranks and a mean of the grads over the seq
ranks, or DDP over data x seq).
An optimizer built afterwards mirrors every parameter's layout in its
state. The model keeps its `Sharding` (`model.sharding`): every
leaf's Layout and Spec and the rank's coordinates, which the sharded
global norm (train/state.py), the sharded checkpoint (checkpoint/) and
`full_parameters` read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.distributed as tdist
from torch import nn

from ddp_practice_tpu_torch.config import MeshConfig
from ddp_practice_tpu_torch.data.sharding import ShardSpec
from ddp_practice_tpu_torch.parallel import dist
from ddp_practice_tpu_torch.parallel.fsdp import (
    DataShards,
    apply_fsdp,
    data_dim,
    fsdp_rules,
    needs_split,
)
from ddp_practice_tpu_torch.parallel.sharding_rules import (
    Layout,
    axes_of,
    layouts,
    param_sharding_rules,
    region,
    take_region,
)
from ddp_practice_tpu_torch.parallel.tensor import TensorGroup

DATA = MeshConfig.AXIS_DATA
SEQ = MeshConfig.AXIS_SEQ
TENSOR = MeshConfig.AXIS_TENSOR
PIPE = MeshConfig.AXIS_PIPE
EXPERT = MeshConfig.AXIS_EXPERT


def build_mesh(config: Optional[MeshConfig] = None, device_type: str = "cuda"):
    """A DeviceMesh over every rank with the reference's axis names and
    order; None for a world of one rank (nothing to lay out)."""
    config = config or MeshConfig()
    shape = config.resolve(dist.process_count())
    if dist.process_count() == 1:
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape,
                            mesh_dim_names=config.axis_names)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def coords(mesh) -> Dict[str, tuple]:
    """{axis: (this rank's coordinate, axis size)} for every axis."""
    if mesh is None:
        return {a: (0, 1) for a in MeshConfig().axis_names}
    return {a: (mesh.get_local_rank(a), axis_size(mesh, a))
            for a in mesh.mesh_dim_names}


def group(mesh, axis: str):
    """The process group of `axis` through this rank (None: size 1)."""
    return None if axis_size(mesh, axis) == 1 else mesh.get_group(axis)


def batch_shard(mesh) -> ShardSpec:
    """This rank's slice of every global batch: its data coordinate of
    the data degree (the seq, tensor, pipe and expert ranks of one data
    replica read the same rows)."""
    c, n = coords(mesh)[DATA]
    return ShardSpec(c, n)


def tensor_group(mesh) -> Optional[TensorGroup]:
    c, n = coords(mesh)[TENSOR]
    return None if n == 1 else TensorGroup(group(mesh, TENSOR), n, c)


@dataclasses.dataclass(frozen=True)
class PipeGroup:
    """This rank's place on the pipe axis: the process group, the stage
    count and this rank's stage. The hops (parallel/pipeline.py) send to
    stage + 1 and back to stage - 1 round the group's ring."""
    group: object
    size: int
    rank: int

    @property
    def first(self) -> bool:
        return self.rank == 0

    @property
    def last(self) -> bool:
        return self.rank == self.size - 1


def pipe_group(mesh) -> Optional[PipeGroup]:
    c, n = coords(mesh)[PIPE]
    return None if n == 1 else PipeGroup(group(mesh, PIPE), n, c)


def check_experts(num_experts: int, ep: int) -> None:
    """The reference's error when the experts do not split over the
    expert axis."""
    if num_experts % ep:
        raise ValueError(
            f"num_experts={num_experts} not divisible by expert axis {ep}")


@dataclasses.dataclass(frozen=True)
class ExpertGroup:
    """This rank's place on the expert axis (the counterpart of
    TensorGroup): the process group, the axis size and this rank's
    coordinate, whose local experts are [c E / size, (c + 1) E / size)."""
    group: object
    size: int
    rank: int

    def experts(self, n: int) -> tuple:
        """(first, end) of this rank's local experts of `n` (a multiple
        of the size: `shard_state` checks)."""
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k


def expert_group(mesh) -> Optional[ExpertGroup]:
    c, n = coords(mesh)[EXPERT]
    return None if n == 1 else ExpertGroup(group(mesh, EXPERT), n, c)


class _SeqSum(torch.autograd.Function):
    """All-reduce (sum) over the seq group, forward and backward: each
    seq rank's objective reads the sum, so the grad of a rank's part is
    the sum of every rank's cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        tdist.all_reduce(out, op=tdist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        tdist.all_reduce(g, op=tdist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _SeqGather(torch.autograd.Function):
    """The seq ranks' chunks concatenated along `dim`, forward; backward
    every rank's cotangent of the whole summed over the group, this
    rank's chunk of the sum (each rank's objective reads the whole)."""

    @staticmethod
    def forward(ctx, x, sp, dim):
        ctx.sp, ctx.dim = sp, dim
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(sp.size)]
        tdist.all_gather(parts, x.contiguous(), group=sp.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        tdist.all_reduce(g, op=tdist.ReduceOp.SUM, group=ctx.sp.group)
        return ctx.sp.chunk(g, ctx.dim).contiguous(), None, None


@dataclasses.dataclass(frozen=True)
class SeqGroup:
    """This rank's place on the seq axis (the counterpart of
    TensorGroup): the process group, the axis size and this rank's
    coordinate, which is the index of its chunk of every sequence."""
    group: object
    size: int
    rank: int

    def offset(self, n: int) -> int:
        """The global position of the first item of this rank's chunk,
        the chunk `n` long."""
        return self.rank * n

    def chunk(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's contiguous chunk of `x` along `dim`."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(
                f"sequence length {n} does not split into seq={self.size} "
                "equal chunks")
        k = n // self.size
        return x.narrow(dim, self.rank * k, k)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """`x` summed over the seq ranks, differentiably."""
        return _SeqSum.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence of every rank's chunk `x`, differentiably."""
        return _SeqGather.apply(x, self, dim)


def seq_group(mesh) -> Optional[SeqGroup]:
    c, n = coords(mesh)[SEQ]
    return None if n == 1 else SeqGroup(group(mesh, SEQ), n, c)


def replica_group(mesh):
    """The group of the ranks that hold the same parameters and average
    their grads: data x seq (None: one rank)."""
    dp, sp = axis_size(mesh, DATA), axis_size(mesh, SEQ)
    if dp > 1 and sp > 1:
        return mesh[DATA, SEQ]._flatten().get_group()
    return group(mesh, SEQ if sp > 1 else DATA)


@dataclasses.dataclass
class Sharding:
    """Where every parameter of a sharded model lives: its Layout and
    Spec by name, this rank's coordinates and the axes' groups."""
    layouts: Dict[str, Layout]
    specs: Dict[str, object]
    coords: Dict[str, tuple]
    groups: Dict[str, object]

    def spec(self, name: str):
        return self.specs.get(name) or self.layouts[name].unsharded()

    def sharded_axes(self, name: str) -> tuple:
        """The axes of more than one rank the leaf is cut over."""
        return tuple(a for a in axes_of(self.specs.get(name))
                     if self.coords[a][1] > 1)

    def region(self, name: str) -> list:
        """This rank's [(global box, local box)] of the leaf."""
        return region(self.layouts[name], self.spec(name), self.coords)


def check_heads(model_name: str, model: nn.Module, tensor: int) -> None:
    """The reference's error when the heads do not split over `tensor`."""
    heads = getattr(model, "num_heads", None)
    if tensor > 1 and heads is not None and heads % tensor:
        raise ValueError(
            f"tensor parallelism shards attention heads: "
            f"{model_name} has {heads} heads, not divisible by "
            f"--tensor {tensor} — pass --num_heads (e.g. "
            f"{((heads // tensor) + 1) * tensor}) or a different degree"
        )


@torch.no_grad()
def shard_state(model: nn.Module, mesh, rules: Optional[Callable],
                model_name: str = "", *, data_cut: bool = False) -> Sharding:
    """Lay `model` (built whole, the same weights on every rank) out on
    `mesh` by `rules(name, layout) -> Spec | None`: each parameter cut to
    this rank's tensor and expert region, the attention layers left with
    their local heads and every tensor-parallel layer with the
    TensorGroup, every routed MLP with the ExpertGroup; under a seq axis
    every layer with an `sp` attribute gets the SeqGroup, under a pipe
    axis the pipelined model its PipeGroup (each rank keeps its stage's
    blocks). With `data_cut` the data cut is taken here too (the
    pipelined families' `DataShards`, parallel/fsdp.py), else it is
    FSDP2's. Returns the Sharding (also `model.sharding`)."""
    from ddp_practice_tpu_torch.models.lm import TransformerLM
    from ddp_practice_tpu_torch.models.pipeline_lm import (
        LMEmbed,
        LMHead,
        PipelinedLM,
    )
    from ddp_practice_tpu_torch.models.vit import (
        EncoderBlock,
        MlpBlock,
        SelfAttention,
    )
    from ddp_practice_tpu_torch.ops.moe import MoEMlp

    lay = layouts(model)
    specs = {n: s for n in lay if rules is not None
             and (s := rules(n, lay[n])) is not None}
    where = coords(mesh)
    tp = tensor_group(mesh)
    sharding = Sharding(lay, specs, where,
                        {a: group(mesh, a) for a in where})
    sp = seq_group(mesh)
    if sp is not None:
        attach_seq(model, sp, model_name)
    pp = pipe_group(mesh)
    if pp is not None:
        attach_pipe(model, pp, model_name)
    if tp is not None:
        check_heads(model_name, model, tp.size)
        for mod in model.modules():
            if isinstance(mod, EncoderBlock) and mod.fused is True:
                raise ValueError(
                    "the fused encoder layer (ops/fused_encoder.py) holds "
                    "a whole layer's weights: it does not run under "
                    f"tensor={tp.size}")
            if isinstance(mod, SelfAttention):
                mod.tp = tp
                mod.num_heads //= tp.size
            elif isinstance(mod, (MlpBlock, TransformerLM, LMEmbed,
                                  LMHead)):
                mod.tp = tp
        if (isinstance(model, (TransformerLM, PipelinedLM))
                and model.vocab_size % tp.size):
            raise ValueError(
                f"vocabulary {model.vocab_size} does not split over "
                f"--tensor {tp.size} (the embedding and head shard it)")
    ep = expert_group(mesh)
    if ep is not None:
        for mod in model.modules():
            if isinstance(mod, MoEMlp):
                check_experts(mod.num_experts, ep.size)
                mod.ep = ep
    cut = {a: where[a] for a in (TENSOR, PIPE, EXPERT)
           + ((DATA,) if data_cut else ()) if where[a][1] > 1}
    params = dict(model.named_parameters())
    for name, spec in specs.items():
        if set(cut) & set(axes_of(spec)):
            p = params[name]
            p.data = take_region(p.data, lay[name], spec, cut).contiguous()
    dp = where[DATA][1]
    tsize = where[TENSOR][1]
    for name, spec in specs.items():
        if data_cut or not needs_split(lay[name], spec, tsize):
            continue
        owner, leaf = name.rsplit(".", 1)
        attn = model.get_submodule(owner.rsplit(".", 1)[0])
        if not (isinstance(attn, SelfAttention) and name.endswith(
                "qkv.bias")):
            raise NotImplementedError(
                f"{name}: its data cut lies inside a torch dim, which "
                "only the attention qkv bias's storage order handles")
        # the local sub-dims, the data chunks moved outermost
        sizes = [n // tsize if a == TENSOR else n
                 for n, a in zip(lay[name].dims[0], spec[0])]
        m = spec[0].index(DATA)
        rest = sizes[m] // dp * math.prod(sizes[m + 1:])
        p = dict(model.named_parameters())[name]
        p.data = p.data.view(-1, dp, rest).transpose(0, 1).reshape(
            -1).contiguous()
        attn.qkv_bias_split = (dp, rest)
    model.sharding = sharding
    return sharding


def attach_seq(model: nn.Module, sp: SeqGroup, model_name: str = "") -> None:
    """Give every layer of `model` built for sequence parallelism (an
    `sp` attribute: the attention layers, the blocks, a routed MLP,
    which routes the whole sequence) the seq group. A model built
    without `seq_axis` raises."""
    layers = [m for m in model.modules() if hasattr(m, "sp")]
    if not any(getattr(m, "seq_axis", None) for m in layers):
        raise ValueError(
            f"{model_name or type(model).__name__} was built without "
            f"seq_axis: it cannot run under seq={sp.size}")
    for m in layers:
        m.sp = sp


def attach_pipe(model: nn.Module, pp: PipeGroup,
                model_name: str = "") -> None:
    """Give a pipelined model (a `pipe` attribute: models/pipeline_lm.py,
    models/pipeline_vit.py) the pipe group; it must have been built for
    as many stages. Any other model raises, as the reference's trainer
    does for a family without stages."""
    if not hasattr(model, "pipe"):
        raise ValueError(
            f"pipe={pp.size}: {model_name or type(model).__name__} has no "
            "pipeline stages (the pipelined families are lm_pipe and "
            "vit_tiny_pipe)")
    if model.num_stages != pp.size:
        raise ValueError(
            f"{model_name or type(model).__name__} was built for "
            f"num_stages={model.num_stages}; the pipe axis has {pp.size}")
    model.pipe = pp


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The rank's stored part of a leaf: a DTensor's (FSDP's) local
    shard, a plain tensor itself."""
    return getattr(t, "_local_tensor", t)


def is_replica0(sharding: Sharding, name: str) -> bool:
    """True on the one rank of each region that writes it: coordinate 0
    on every axis the leaf is not cut over."""
    cut = sharding.sharded_axes(name)
    return all(c == 0 for a, (c, n) in sharding.coords.items()
               if n > 1 and a not in cut)


def place(local: torch.Tensor, sharding: Sharding, name: str,
          out: torch.Tensor) -> None:
    """Write this rank's region of leaf `name` from its stored `local`
    tensor into `out`, the whole leaf."""
    for gbox, lbox in sharding.region(name):
        out[tuple(slice(a, b) for a, b in gbox)] = local[
            tuple(slice(a, b) for a, b in lbox)]


@torch.no_grad()
def full_parameters(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter of a sharded model whole, in the single-rank
    layout, on every rank: each region written by its replica 0 and the
    world summed (a collective: every rank calls it)."""
    import torch.distributed as tdist

    sharding: Sharding = model.sharding
    out = {}
    for name, p in model.named_parameters():
        whole = torch.zeros(sharding.layouts[name].shape, dtype=p.dtype,
                            device=p.device)
        if is_replica0(sharding, name):
            place(local_tensor(p.detach()), sharding, name, whole)
        tdist.all_reduce(whole, op=tdist.ReduceOp.SUM)
        out[name] = whole
    return out


def parallelize(model: nn.Module, mesh, *, model_name: str, fsdp: bool,
                min_leaf_size: int = 1024):
    """The reference's layout of `model` on `mesh`, as the train loop
    runs it: the tensor, pipe and expert rules of `model_name` (with
    FSDP's data cut when `fsdp`) laid out by `shard_state` when the
    tensor, seq, pipe or expert axis or FSDP's data axis has more than
    one rank, FSDP2 over the data ranks when a leaf is cut over them
    (its grads then averaged over the seq ranks too; a pipelined model's
    cut leaves take `DataShards` instead, under every schedule), else DDP
    over the data x seq ranks when there are several. Returns (forward,
    after_backward): what runs the model, and the hook a train step
    calls after each backward (None but under FSDP and the explicit
    pipeline schedules). The tensor, pipe and
    expert groups' grads need no synchronisation: a replicated leaf's is
    exact on every rank of them, a cut leaf's is the rank's own.

    A pipelined model under the 1F1B or interleaved schedule runs many
    backwards a step inside `loss_and_grad` (parallel/pipeline_1f1b.py),
    not through a wrapper's forward: it gets no DDP, and its hook
    averages every grad over data x seq once, after the schedule."""
    c = coords(mesh)
    dp, sp, tp, ep = c[DATA][1], c[SEQ][1], c[TENSOR][1], c[EXPERT][1]
    pp = c[PIPE][1]
    forward, after_backward = model, None
    if tp > 1 or sp > 1 or ep > 1 or pp > 1 or (fsdp and dp > 1):
        rules = param_sharding_rules(model_name)
        if fsdp:
            rules = fsdp_rules(dp, rules, min_leaf_size=min_leaf_size)
        sharding = shard_state(model, mesh, rules, model_name,
                               data_cut=pp > 1)
        if any(data_dim(s) is not None for s in sharding.specs.values()):
            if pp > 1:
                shards = DataShards(model, sharding, sharding.groups[DATA],
                                    sharding.groups[SEQ])
                return model, shards.reduce_grads
            after_backward = apply_fsdp(model, mesh[DATA], sharding.specs,
                                        sharding.groups[DATA],
                                        sharding.groups[SEQ])
    if dp * sp > 1 and getattr(model, "schedule", "gpipe") != "gpipe":
        from ddp_practice_tpu_torch.parallel.fsdp import sum_over

        replicas = replica_group(mesh)
        params = [p for p in model.parameters() if p.requires_grad]

        @torch.no_grad()
        def mean_grads() -> None:
            sum_over([p.grad for p in params], replicas, mean=True)

        return model, mean_grads
    if dp * sp > 1 and after_backward is None:
        from torch.nn.parallel import DistributedDataParallel

        from ddp_practice_tpu_torch.ops.batchnorm import BatchNorm

        device = next(model.parameters()).device
        # BatchNorm's statistics are all-reduced (SyncBN): every rank
        # holds the same running buffers, so DDP's per-forward broadcast
        # of rank 0's would move nothing
        synced = any(isinstance(m, BatchNorm) for m in model.modules())
        kw = dict(device_ids=[device.index] if device.type == "cuda"
                  else None, broadcast_buffers=not synced,
                  process_group=replica_group(mesh))
        if device.type != "cuda":
            return DistributedDataParallel(model, **kw), after_backward
        # built on a side stream, as PyTorch's notes on CUDA graphs ask of
        # a DDP whose backward is captured (utils/graphs.py)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            forward = DistributedDataParallel(model, **kw)
        torch.cuda.current_stream(device).wait_stream(side)
    return forward, after_backward
