"""Model registry (counterpart of ddp_practice_tpu/models/__init__.py).

The port registers the decoder LMs that serve and train: `lm_tiny` and
`lm_base`. The reference's other names raise NotImplementedError naming
the ROADMAP item that ports them. `create_model` builds the module on `device` (the card by
default; it raises when none is present) with weights drawn from `seed`
on the CPU, so a seed gives the same weights on every device. The init
follows the reference's Flax defaults in scale: Dense kernels and the
token embedding normal with std 1/sqrt(fan_in), biases zero, LayerNorm
scale one, learned positions normal(0.02).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ddp_practice_tpu_torch.config import PrecisionPolicy, resolve_device
from ddp_practice_tpu_torch.models.lm import LMBase, LMTiny, TransformerLM

_REGISTRY = {"lm_tiny": LMTiny, "lm_base": LMBase}
# the reference's other registry names -> the ROADMAP item that ports them
_NOT_PORTED = {
    "convnet": "A1", "resnet18": "A2", "resnet50": "A2",
    "vit_tiny": "A2 and B2", "vit_base": "A2 and B2",
    "vit_tiny_moe": "A7", "lm_moe": "A7",
    "vit_tiny_pipe": "A8", "lm_pipe": "A8",
}


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init in place, drawn on the CPU in parameter order."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("pos_embed"):
            w = torch.randn(p.shape, generator=g) * 0.02
        elif leaf == "bias":
            w = torch.zeros(p.shape)
        elif ".ln" in f".{name}":   # ln1 / ln2 / ln_f scale
            w = torch.ones(p.shape)
        else:                       # Linear (out, in) and Embedding (v, d)
            w = torch.randn(p.shape, generator=g) / math.sqrt(p.shape[1])
        p.copy_(w.to(p.dtype))
    return model


def create_model(name: str, *, policy: Optional[PrecisionPolicy] = None,
                 device="cuda", seed: int = 0, **kwargs) -> TransformerLM:
    """Instantiate a registered model on `device`, initialised from
    `seed`. `kwargs` are TransformerLM fields (attn_impl, remat, pos_emb,
    tied_embeddings, num_heads, dropout_rate, vocab_size, max_len, ...)."""
    policy = policy or PrecisionPolicy.fp32()
    name = name.lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP {_NOT_PORTED[name]})")
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    dev = resolve_device(device)
    model = _REGISTRY[name](dtype=policy.compute_dtype,
                            param_dtype=policy.param_dtype, **kwargs)
    return init_weights(model, seed).to(dev)


__all__ = ["create_model", "init_weights", "TransformerLM", "LMTiny",
           "LMBase"]
