"""Flax parameter tree <-> the port's `state_dict`.

Works on nested dicts of numpy arrays (what a device_get of the JAX
params gives), so the port needs no JAX to load converted weights. The layout
rules, by Flax leaf:

- Dense `kernel` (in, out) -> Linear `weight` (out, in);
- the attention `qkv` DenseGeneral kernel (d, 3, h, hd) -> (3*h*hd, d),
  rows ordered [q | k | v] by head; its bias (3, h, hd) -> (3*h*hd,);
- the attention `out` DenseGeneral kernel (h, hd, d) -> (d, h*hd);
- LayerNorm `scale` -> `weight` (epsilon is 1e-6 on both sides);
- Embed `embedding` (vocab, d) -> `weight` unchanged;
- `pos_embed` (1, max_len, d) unchanged; `lm_head` has no bias;
- Conv kernels, HWIO (kh, kw, c, d) -> OIHW (d, c, kh, kw): the ViT's
  `patch_embed` and the ConvNet's `Conv_{i}`. They are 4-D like the qkv
  kernel: the two are told apart by path;
- the ConvNet's Flax auto-names `Conv_{i}`, `BatchNorm_{i}` and `Dense_0`
  become `conv{i}`, `bn{i}` and `head`; a BatchNorm's `scale`/`bias`
  become `weight`/`bias` and its `batch_stats` `mean`/`var` the buffers
  `running_mean`/`running_var`. The Dense kernel needs no row
  permutation: models/convnet.py flattens in the reference's NHWC order;
- the ResNet's names are Flax's own but for the auto-names above:
  `stem_conv`, `stem_bn`, `BasicBlock_{i}` / `BottleneckBlock_{i}` (kept
  as they are) with `Conv_{j}` -> `conv{j}`, `BatchNorm_{j}` -> `bn{j}`,
  `proj` (a Conv) and `proj_bn` (a BatchNorm), then `Dense_0` -> `head`;
- the MoE `router` Dense kernel (d, E) -> Linear weight (E, d); the
  stacked expert tensors (`expert_w_in` (E, d, f), `expert_b_in`,
  `expert_w_out`, `expert_b_out`) are copied unchanged.

Block `block{i}` becomes `blocks.{i}`. The pipelined families' tree
(`embed`, `blocks`, `head`) holds each block leaf stacked on a leading
depth dim: each block's slice is laid out as above and the slices are
stacked again (models/pipeline_lm.py keeps them so); the whole model's
tensors load on every rank, and `shard_state` cuts each rank's stage
(or its chunks under the interleaved schedule). `batch_stats` (the reference's
non-parameter state: each router's `router_bias`, each BatchNorm's
running statistics) maps by the same names onto the model's buffers.

`state_dict_to_flax` is the way back: the port's tensors laid out as a
given Flax tree (its names and shapes), every leaf of that tree filled.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional

import numpy as np
import torch


_CONV = re.compile(r"^Conv_(\d+)$")
# the ConvNet's Flax auto-names -> the port's module names
_AUTO_NAMES = ((_CONV, "conv{}"),
               (re.compile(r"^BatchNorm_(\d+)$"), "bn{}"),
               (re.compile(r"^Dense_0$"), "head"))
_BN_STATS = {"mean": "running_mean", "var": "running_var"}
_BN = re.compile(r"^(BatchNorm_\d+|stem_bn|proj_bn)$")
# named Flax Conv modules (besides the auto-named `Conv_{i}`)
_NAMED_CONVS = ("patch_embed", "stem_conv", "proj")


def _is_conv(path: tuple) -> bool:
    return len(path) >= 2 and (path[-2] in _NAMED_CONVS
                               or bool(_CONV.match(path[-2])))


def _leaf(path: tuple, value: np.ndarray) -> np.ndarray:
    name = path[-1]
    if name == "kernel":
        if _is_conv(path):                          # Conv HWIO -> OIHW
            return value.transpose(3, 2, 0, 1)
        if value.ndim == 4:          # qkv (d, 3, h, hd)
            return value.reshape(value.shape[0], -1).T
        if value.ndim == 3:          # out (h, hd, d)
            return value.reshape(-1, value.shape[-1]).T
        return value.T
    if name == "bias":
        return value.reshape(-1)
    return value


def _torch_name(path: tuple) -> str:
    parts = []
    for i, p in enumerate(path):
        auto = [fmt.format(*m.groups()) for rx, fmt in _AUTO_NAMES
                if (m := rx.match(p))]
        if auto:
            parts.append(auto[0])
        elif p.startswith("block") and p[5:].isdigit():
            parts += ["blocks", p[5:]]
        elif p in ("scale", "embedding", "kernel"):
            parts.append("weight")
        elif p in _BN_STATS and i and _BN.match(path[i - 1]):
            parts.append(_BN_STATS[p])
        else:
            parts.append(p)
    return ".".join(parts)


def _stacked(path: tuple) -> bool:
    """A pipelined model's stacked block leaf (depth first)."""
    return bool(path) and path[0] == "blocks"


def flax_to_state_dict(params: Mapping) -> dict:
    """Nested Flax params (numpy leaves) -> {torch name: fp32 tensor}."""
    out = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
            else:
                arr = np.asarray(value)
                arr = (np.stack([_leaf(path + (key,), a) for a in arr])
                       if _stacked(path) else _leaf(path + (key,), arr))
                out[_torch_name(path + (key,))] = torch.tensor(
                    np.ascontiguousarray(arr), dtype=torch.float32)

    walk(params, ())
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping,
                     batch_stats: Optional[Mapping] = None):
    """Copy a Flax param tree, and `batch_stats` when given, into `model`
    (strict: every name must match) and return the model. Without
    `batch_stats` the model keeps its current buffers (router biases,
    BatchNorm running statistics: their init values, as the
    reference's)."""
    state = flax_to_state_dict(params)
    if batch_stats is not None:
        state.update(flax_to_state_dict(batch_stats))
    else:
        params_only = set(dict(model.named_parameters()))
        state.update({k: v for k, v in model.state_dict().items()
                      if k not in params_only})
    model.load_state_dict(state, strict=True)
    return model


def _to_flax_leaf(path: tuple, value: np.ndarray, shape: tuple):
    """The inverse of `_leaf`: a port tensor in the Flax leaf's layout."""
    if path[-1] == "kernel":
        if _is_conv(path):                          # OIHW -> HWIO
            return value.transpose(2, 3, 1, 0)
        return value.T.reshape(shape)
    return value.reshape(shape)


def state_dict_to_flax(state: Mapping, template: Mapping) -> dict:
    """The port's {name: tensor} (a `state_dict`) -> a nested numpy tree
    shaped as `template` (a Flax params or batch_stats tree, or anything
    with the same names and leaf shapes), fp32 (float64 stays float64).
    Raises naming a template leaf the state lacks, or one whose converted
    shape differs."""

    def walk(tree, path):
        out = {}
        for key, value in tree.items():
            if isinstance(value, Mapping):
                out[key] = walk(value, path + (key,))
                continue
            name = _torch_name(path + (key,))
            if name not in state:
                raise KeyError(f"{'/'.join(path + (key,))}: the port's "
                               f"state has no {name!r}")
            shape = tuple(np.shape(value))
            t = state[name].detach().cpu()
            arr = (t if t.dtype == torch.float64 else t.float()).numpy()
            if _stacked(path):
                arr = np.stack([_to_flax_leaf(path + (key,), a, shape[1:])
                                for a in arr])
            else:
                arr = _to_flax_leaf(path + (key,), arr, shape)
            if arr.shape != shape:
                raise ValueError(f"{name}: {arr.shape} as Flax's "
                                 f"{'/'.join(path + (key,))}, want {shape}")
            out[key] = np.ascontiguousarray(arr)
        return out

    return walk(template, ())
