"""Model registry (counterpart of ddp_practice_tpu/models/__init__.py).

The port registers the reference's ConvNet (`convnet`, models/convnet.py),
the decoder LMs that serve and train (`lm_tiny`, `lm_base`), their MoE
variant `lm_moe` (lm_tiny's dims, every second block routed, capacity
factor 2.0), the image transformers (`vit_tiny`, `vit_base`) and
`vit_tiny_moe` (models/vit_moe.py). The transformers but `vit_tiny_moe`
take the tri-state `fused` argument (`accepts_fused`). The reference's
other names raise NotImplementedError naming the ROADMAP item that ports
them. `create_model` builds the module on `device` (the card by default; it
raises when none is present) with weights drawn from `seed` on the CPU, so
a seed gives the same weights on every device. The init follows the
reference's Flax defaults in scale: Dense and Conv kernels and the token
embedding normal with std 1/sqrt(fan_in), the stacked expert kernels (E,
fan_in, fan_out) likewise per expert, biases zero, LayerNorm and BatchNorm
scale one, learned positions normal(0.02).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ddp_practice_tpu_torch.config import PrecisionPolicy, resolve_device
from ddp_practice_tpu_torch.models.convnet import ConvNet
from ddp_practice_tpu_torch.models.lm import LMBase, LMTiny, TransformerLM
from ddp_practice_tpu_torch.models.vit import ViT, ViTBase, ViTTiny
from ddp_practice_tpu_torch.models.vit_moe import ViTMoE


def LMMoE(**kw) -> TransformerLM:
    """lm_tiny's dims with a routed expert MLP in every second block; top-2
    capacity headroom 2.0 (the reference registry's defaults)."""
    kw.setdefault("moe_every", 2)
    kw.setdefault("capacity_factor", 2.0)
    return LMTiny(**kw)


def ViTTinyMoE(**kw) -> ViTMoE:
    """ViT-Tiny's dims (d=192, depth 12, 3 heads, mlp 768) with every
    second block routed."""
    kw.setdefault("hidden_dim", 192)
    kw.setdefault("depth", 12)
    kw.setdefault("num_heads", 3)
    kw.setdefault("mlp_dim", 768)
    return ViTMoE(**kw)


_REGISTRY = {"convnet": ConvNet, "lm_tiny": LMTiny, "lm_base": LMBase,
             "lm_moe": LMMoE, "vit_tiny": ViTTiny, "vit_base": ViTBase,
             "vit_tiny_moe": ViTTinyMoE}
# registry names whose module takes the tri-state `fused` argument
# (models/vit.py EncoderBlock); ViTMoE's blocks never fuse, and the
# ConvNet has no encoder block
_FUSED_CAPABLE = frozenset(_REGISTRY) - {"vit_tiny_moe", "convnet"}
# the reference's other registry names -> the ROADMAP item that ports them
_NOT_PORTED = {
    "resnet18": "A2", "resnet50": "A2",
    "vit_tiny_pipe": "A8", "lm_pipe": "A8",
}


def accepts_fused(name: str) -> bool:
    """True when `create_model(name, fused=...)` is a valid call."""
    return name.lower() in _FUSED_CAPABLE


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init in place, drawn on the CPU in parameter order."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pos_embed":
            w = torch.randn(p.shape, generator=g) * 0.02
        elif leaf == "bias":
            w = torch.zeros(p.shape)
        elif ".ln" in f".{name}" or ".bn" in f".{name}":
            # LayerNorm (ln1 / ln2 / ln_f) and BatchNorm (bn{i}) scale
            w = torch.ones(p.shape)
        elif leaf.startswith("expert_b"):
            w = torch.zeros(p.shape)
        elif leaf.startswith("expert_w"):   # (E, fan_in, fan_out)
            w = torch.randn(p.shape, generator=g) / math.sqrt(p.shape[1])
        else:       # Linear (out, in), Embedding (v, d), Conv (o, i, kh, kw)
            w = torch.randn(p.shape, generator=g) / math.sqrt(
                p[0].numel())
        p.copy_(w.to(p.dtype))
    return model


def create_model(name: str, *, policy: Optional[PrecisionPolicy] = None,
                 device="cuda", seed: int = 0, **kwargs) -> nn.Module:
    """Instantiate a registered model on `device`, initialised from
    `seed`. `kwargs` are the model's fields: TransformerLM's (attn_impl,
    remat, pos_emb, tied_embeddings, num_heads, dropout_rate, vocab_size,
    max_len, fused, moe_every, num_experts, capacity_factor, ...), ViT's
    (num_classes, image_shape, patch_size, depth, num_heads, attn_impl,
    dropout_rate, fused, ...) or ViTMoE's (ViT's without dropout_rate and
    fused, plus num_experts, top_k, capacity_factor, moe_every,
    moe_router)."""
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


__all__ = ["accepts_fused", "create_model", "init_weights", "ConvNet",
           "TransformerLM", "LMTiny", "LMBase", "LMMoE", "ViT", "ViTTiny",
           "ViTBase", "ViTMoE", "ViTTinyMoE"]
