"""Tensor-parallel parameter rules (counterpart of
ddp_practice_tpu/parallel/sharding_rules.py), keyed on the port's
parameter names, in the torch layout.

The reference writes a rule as a PartitionSpec over a Flax leaf's dims.
A torch leaf merges some of those dims (the attention `qkv` weight is
(3*h*hd, d) where Flax holds (d, 3, h, hd)), so a port leaf is described
by its `Layout`: per torch dim, the sizes of the Flax dims merged into
it, outer to inner, and where each Flax dim went (convert.py's mapping).
A `Spec` names the mesh axis (or None) of every such sub-dim: the
reference's spec, mapped through the converter, is a Spec, and a rank's
region of a leaf is a slice of each sub-dim (`region`). Sharding the
heads sub-dim of `qkv` gives a rank its heads of q, of k and of v,
which a plain row split of the torch weight would not.

Megatron over the transformer families, as the reference's table:
column-parallel (output features over `tensor`) attention `qkv` (its
heads) and MLP `fc_in`; row-parallel (input features) attention `out`
and MLP `fc_out`, whose biases stay whole; the LM's `tok_embed` shards
its vocabulary rows and `lm_head` its vocabulary outputs; `pos_embed`,
LayerNorms and the row-parallel biases are replicated. MoE leaves: the
stacked `expert_*` tensors shard their expert dim over `expert` and
nothing over `tensor` (a rank holds its experts whole), the router is
replicated. The conv families have no rules (replicated).

The pipelined families (models/pipeline_lm.py, models/pipeline_vit.py)
hold their blocks stacked: one leaf per block leaf with a leading depth
dim, as the reference's vmapped init. That dim's Layout is the three
sub-dims (V, P, L) of logical depth (virtual chunks, stages, blocks a
stage chunk; V = 1 but under the interleaved schedule) and its Flax dim
is recorded at the P sub-dim (`Layout.stacked`), so the reference's
`pipe` on the depth dim cuts the stages: rank i holds blocks
[i L, (i + 1) L) of every chunk v, which is its contiguous stage at
V = 1 and its chunks v P + i under interleaving. The inner dims take
the plain ViT Megatron spec; embed and head take the dense rules (the
LM's vocabulary cut, the ViT's nothing).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

from torch import nn

from ddp_practice_tpu_torch.config import MeshConfig

T = MeshConfig.AXIS_TENSOR
E = MeshConfig.AXIS_EXPERT
PIPE = MeshConfig.AXIS_PIPE

# per torch dim, per merged sub-dim: a mesh axis name or None
Spec = Tuple[Tuple[Optional[str], ...], ...]


@dataclasses.dataclass(frozen=True)
class Layout:
    """A port leaf against its Flax leaf: `dims[t]` are the Flax dim
    sizes merged into torch dim t (outer to inner) and `ref_dims[i]` is
    (t, j), where Flax dim i sits. A `stacked` leaf's torch dim 0 is the
    depth stack (V, P, L), Flax dim 0 their product, recorded at the
    stage sub-dim (0, 1)."""
    dims: Tuple[Tuple[int, ...], ...]
    ref_dims: Tuple[Tuple[int, int], ...]
    stacked: bool = False

    @property
    def shape(self) -> tuple:
        return tuple(math.prod(d) for d in self.dims)

    @property
    def ref_shape(self) -> tuple:
        return tuple(math.prod(self.dims[0]) if self.stacked and i == 0
                     else self.dims[t][j]
                     for i, (t, j) in enumerate(self.ref_dims))

    def unsharded(self) -> Spec:
        return tuple((None,) * len(d) for d in self.dims)

    def from_ref(self, pspec) -> Spec:
        """A reference PartitionSpec (its entries, one per Flax dim)
        mapped onto this leaf's sub-dims."""
        out = [list(d) for d in self.unsharded()]
        for (t, j), axis in zip(self.ref_dims, tuple(pspec or ())):
            out[t][j] = axis
        return tuple(tuple(d) for d in out)


def _plain(shape) -> Layout:
    return Layout(tuple((s,) for s in shape),
                  tuple((i, 0) for i in range(len(shape))))


def _transposed(shape) -> Layout:
    """A Dense kernel: Flax (in, out), torch (out, in)."""
    return Layout(((shape[0],), (shape[1],)), ((1, 0), (0, 0)))


def _conv(shape) -> Layout:
    """A Conv kernel: Flax HWIO, torch OIHW."""
    o, i, kh, kw = shape
    return Layout(((o,), (i,), (kh,), (kw,)), ((2, 0), (3, 0), (1, 0),
                                               (0, 0)))


def _stack(inner: Layout, stack: tuple) -> Layout:
    """A block leaf's Layout under the depth stack (V, P, L)."""
    return Layout((tuple(stack),) + inner.dims,
                  ((0, 1),) + tuple((t + 1, j) for t, j in inner.ref_dims),
                  stacked=True)


def layouts(model: nn.Module) -> Dict[str, Layout]:
    """Every parameter's Layout, by name (the model as built: whole
    leaves). A pipelined model's `block_stack` (V, P, L) stacks the
    leaves under `blocks.`."""
    from ddp_practice_tpu_torch.models.vit import SelfAttention

    stack = getattr(model, "block_stack", None)
    out = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            stacked = stack is not None and name.startswith("blocks.")
            shape = tuple(p.shape)[1:] if stacked else tuple(p.shape)
            parent = mname.rsplit(".", 1)
            owner = (model.get_submodule(parent[0])
                     if len(parent) == 2 else None)
            if isinstance(owner, SelfAttention) and parent[1] == "qkv":
                h, hd = owner.num_heads, owner.head_dim
                lay = (Layout(((3, h, hd), (shape[1],)),
                              ((1, 0), (0, 0), (0, 1), (0, 2)))
                       if pname == "weight" else
                       Layout(((3, h, hd),), ((0, 0), (0, 1), (0, 2))))
            elif (isinstance(owner, SelfAttention) and parent[1] == "out"
                  and pname == "weight"):
                h, hd = owner.num_heads, owner.head_dim
                lay = Layout(((shape[0],), (h, hd)),
                             ((1, 0), (1, 1), (0, 0)))
            elif isinstance(mod, nn.Linear) and pname == "weight":
                lay = _transposed(shape)
            elif isinstance(mod, nn.Conv2d) and pname == "weight":
                lay = _conv(shape)
            else:
                lay = _plain(shape)
            out[name] = _stack(lay, stack) if stacked else lay
    return out


def _vit_rule(name: str, layout: Layout) -> Optional[Spec]:
    leaf = name.rsplit(".", 2)
    owner, what = (leaf[-2], leaf[-1]) if len(leaf) >= 2 else ("", name)
    if ".attn." in f".{name}" and owner == "qkv":
        # heads of (3, h, hd); columns d whole
        return ((None, T, None), (None,)) if what == "weight" else \
            ((None, T, None),)
    if ".attn." in f".{name}" and owner == "out":
        # row-parallel over (h, hd)'s heads; the bias stays whole
        return ((None,), (T, None)) if what == "weight" else None
    if owner == "fc_in":
        return ((T,), (None,)) if what == "weight" else ((T,),)
    if owner == "fc_out":
        return ((None,), (T,)) if what == "weight" else None
    return None


def _moe_rule(dense_rule: Callable) -> Callable:
    """Stacked expert tensors over `expert`, the router replicated, the
    rest by `dense_rule`."""

    def rule(name: str, layout: Layout) -> Optional[Spec]:
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("expert_"):
            spec = [list(d) for d in layout.unsharded()]
            spec[0][0] = E
            return tuple(tuple(d) for d in spec)
        if ".router." in f".{name}":
            return None
        return dense_rule(name, layout)

    return rule


def _lm_rule(name: str, layout: Layout) -> Optional[Spec]:
    """The decoder: the vocabulary rows of `tok_embed` and the
    vocabulary outputs of `lm_head` (bias-free) over `tensor`, on top of
    the block rules; `pos_embed` replicated."""
    if name == "tok_embed.weight" or name == "lm_head.weight":
        return ((T,), (None,))
    if name == "pos_embed":
        return None
    return _vit_rule(name, layout)


def _vit_pipe_rule(name: str, layout: Layout) -> Optional[Spec]:
    """The pipelined ViT: a stacked block leaf's stages over `pipe`, its
    inner dims by the ViT's Megatron rule; embed and head replicated."""
    if not name.startswith("blocks."):
        return None
    inner = _vit_rule(name, layout) or tuple(
        (None,) * len(d) for d in layout.dims[1:])
    return ((None, PIPE, None),) + inner


def _lm_pipe_rule(name: str, layout: Layout) -> Optional[Spec]:
    """The pipelined LM: the stacked blocks as the pipelined ViT's; the
    embed and head leaves (`embed.tok_embed.weight`, `head.lm_head.weight`
    ...) by the dense LM's rule on their own names."""
    if name.startswith("blocks."):
        return _vit_pipe_rule(name, layout)
    return _lm_rule(name.split(".", 1)[1], layout)


_RULES: dict = {
    "vit": _vit_rule,
    "vit_tiny": _vit_rule,
    "vit_base": _vit_rule,
    "vit_tiny_pipe": _vit_pipe_rule,
    "vit_tiny_moe": _moe_rule(_vit_rule),
    "lm_tiny": _lm_rule,
    "lm_base": _lm_rule,
    "lm_moe": _moe_rule(_lm_rule),
    "lm_pipe": _lm_pipe_rule,
}


def param_sharding_rules(model_name: str) -> Optional[Callable]:
    """rules(name, layout) -> Spec | None (None: replicated) for a model
    family; None for the families without tensor parallelism (the conv
    nets: fully replicated, the reference's DDP contract)."""
    return _RULES.get(model_name.lower())


def region(layout: Layout, spec: Spec, coords: dict) -> list:
    """A rank's region of a leaf as [(global box, local box)] in the
    torch layout (each box a tuple of (start, stop) per dim), its local
    tensor holding the region's elements in the leaf's order. `coords`
    maps an axis to (this rank's coordinate, axis size); axes it lacks
    do not cut the leaf."""
    per_dim = []
    for sizes, axes in zip(layout.dims, spec):
        cuts = []
        for size, axis in zip(sizes, axes):
            c, n = coords.get(axis, (0, 1)) if axis else (0, 1)
            if size % n:
                raise ValueError(f"dim of {size} does not split over "
                                 f"{axis}={n}")
            k = size // n
            cuts.append((c * k, (c + 1) * k))
        # the innermost cut sub-dim: everything inside it is whole, so
        # each run spans it; the sub-dims outside it index the runs
        m = max((j for j, (a, b) in enumerate(cuts)
                 if (a, b) != (0, sizes[j])), default=-1)
        inner = math.prod(sizes[m + 1:]) if m >= 0 else math.prod(sizes)
        if m < 0:
            per_dim.append([((0, inner), (0, inner))])
            continue
        run = (cuts[m][1] - cuts[m][0]) * inner
        runs, local = [], 0
        outer = [range(a, b) for a, b in cuts[:m]]
        for idx in _product(outer):
            start = 0
            for j, i in enumerate(idx):
                start += i * math.prod(sizes[j + 1:])
            start += cuts[m][0] * inner
            runs.append(((start, start + run), (local, local + run)))
            local += run
        per_dim.append(runs)
    return [tuple(zip(*box)) for box in _product(per_dim)]


def _product(lists):
    out = [()]
    for items in lists:
        out = [o + (i,) for o in out for i in items]
    return out


def local_shape(layout: Layout, spec: Spec, coords: dict) -> tuple:
    out = []
    for sizes, axes in zip(layout.dims, spec):
        n = 1
        for size, axis in zip(sizes, axes):
            n *= size // (coords.get(axis, (0, 1))[1] if axis else 1)
        out.append(n)
    return tuple(out)


def take_region(full, layout: Layout, spec: Spec, coords: dict):
    """A rank's local tensor cut from the whole leaf `full` (a tensor in
    the torch layout): each sub-dim sliced, merged back in order."""
    subs = [s for d in layout.dims for s in d]
    t = full.reshape(subs)
    k = 0
    for sizes, axes in zip(layout.dims, spec):
        for size, axis in zip(sizes, axes):
            if axis and axis in coords:
                c, n = coords[axis]
                t = t.narrow(k, c * (size // n), size // n)
            k += 1
    return t.reshape(local_shape(layout, spec, coords))


def axes_of(spec: Optional[Spec]) -> tuple:
    """The mesh axes a spec cuts a leaf over, in first-use order."""
    seen = []
    for axes in spec or ():
        for a in axes:
            if a and a not in seen:
                seen.append(a)
    return tuple(seen)
