"""Flax parameter tree -> the port's `state_dict`.

Works on nested dicts of numpy arrays (what a device_get of the JAX
params gives), so the port needs no JAX to load converted weights. The layout
rules, by Flax leaf:

- Dense `kernel` (in, out) -> Linear `weight` (out, in);
- the attention `qkv` DenseGeneral kernel (d, 3, h, hd) -> (3*h*hd, d),
  rows ordered [q | k | v] by head; its bias (3, h, hd) -> (3*h*hd,);
- the attention `out` DenseGeneral kernel (h, hd, d) -> (d, h*hd);
- LayerNorm `scale` -> `weight` (epsilon is 1e-6 on both sides);
- Embed `embedding` (vocab, d) -> `weight` unchanged;
- `pos_embed` (1, max_len, d) unchanged; `lm_head` has no bias.

Block `block{i}` becomes `blocks.{i}`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _leaf(path: tuple, value: np.ndarray) -> np.ndarray:
    name = path[-1]
    if name == "kernel":
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
    for p in path:
        if p.startswith("block") and p[5:].isdigit():
            parts += ["blocks", p[5:]]
        elif p in ("scale", "embedding", "kernel"):
            parts.append("weight")
        else:
            parts.append(p)
    return ".".join(parts)


def flax_to_state_dict(params: Mapping) -> dict:
    """Nested Flax params (numpy leaves) -> {torch name: fp32 tensor}."""
    out = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
            else:
                arr = _leaf(path + (key,), np.asarray(value))
                out[_torch_name(path + (key,))] = torch.tensor(
                    arr, dtype=torch.float32)

    walk(params, ())
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping):
    """Copy a Flax param tree into `model` (strict: every name must
    match) and return the model."""
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model
