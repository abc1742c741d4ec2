"""Model registry (counterpart of ddp_practice_tpu/models/__init__.py).

The port registers the reference's ConvNet (`convnet`, models/convnet.py),
ResNet-18 and ResNet-50 (`resnet18`, `resnet50`, models/resnet.py), the
decoder LMs that serve and train (`lm_tiny`, `lm_base`), their MoE
variant `lm_moe` (lm_tiny's dims, every second block routed, capacity
factor 2.0), the image transformers (`vit_tiny`, `vit_base`),
`vit_tiny_moe` (models/vit_moe.py) and the pipelined families `lm_pipe`
(lm_tiny's dims, models/pipeline_lm.py) and `vit_tiny_pipe` (vit_tiny's,
models/pipeline_vit.py). The dense transformers take the tri-state
`fused` argument (`accepts_fused`); `vit_tiny_moe` and the pipelined
families do not, as the reference registers them. `create_model` builds the module on `device` (the card by default; it
raises when none is present) with weights drawn from `seed` on the CPU, so
a seed gives the same weights on every device. The init follows the
reference's Flax defaults in scale: Dense and Conv kernels and the token
embedding normal with std 1/sqrt(fan_in), the stacked expert kernels (E,
fan_in, fan_out) likewise per expert, biases zero, LayerNorm and BatchNorm
scale one (zero for a BatchNorm built with `zero_scale`, the last of each
ResNet block, as the reference's `scale_init=zeros`), learned positions
normal(0.02). A pipelined model's stacked block leaves are drawn a block
at a time by the same rules.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ddp_practice_tpu_torch.config import PrecisionPolicy, resolve_device
from ddp_practice_tpu_torch.models.convnet import ConvNet
from ddp_practice_tpu_torch.models.lm import LMBase, LMTiny, TransformerLM
from ddp_practice_tpu_torch.models.pipeline_lm import PipelinedLM
from ddp_practice_tpu_torch.models.pipeline_vit import PipelinedViT
from ddp_practice_tpu_torch.models.resnet import ResNet, ResNet18, ResNet50
from ddp_practice_tpu_torch.models.vit import ViT, ViTBase, ViTTiny
from ddp_practice_tpu_torch.models.vit_moe import ViTMoE
from ddp_practice_tpu_torch.ops.batchnorm import BatchNorm


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


_REGISTRY = {"convnet": ConvNet, "resnet18": ResNet18,
             "resnet50": ResNet50, "lm_tiny": LMTiny, "lm_base": LMBase,
             "lm_moe": LMMoE, "vit_tiny": ViTTiny, "vit_base": ViTBase,
             "vit_tiny_moe": ViTTinyMoE, "lm_pipe": PipelinedLM,
             "vit_tiny_pipe": PipelinedViT}
# registry names whose module takes the tri-state `fused` argument
# (models/vit.py EncoderBlock); ViTMoE's blocks never fuse, the
# pipelined families build the plain block, and the conv nets have no
# encoder block
_FUSED_CAPABLE = frozenset(_REGISTRY) - {"vit_tiny_moe", "lm_pipe",
                                         "vit_tiny_pipe", "convnet",
                                         "resnet18", "resnet50"}


def accepts_fused(name: str) -> bool:
    """True when `create_model(name, fused=...)` is a valid call."""
    return name.lower() in _FUSED_CAPABLE


def _draw(name: str, shape: tuple, g, bn_scale) -> torch.Tensor:
    """One leaf's init (`bn_scale`: None, or whether the BatchNorm
    scale is zero)."""
    leaf = name.rsplit(".", 1)[-1]
    if bn_scale is not None:
        return torch.zeros(shape) if bn_scale else torch.ones(shape)
    if leaf == "pos_embed":
        return torch.randn(shape, generator=g) * 0.02
    if leaf == "bias" or leaf.startswith("expert_b"):
        return torch.zeros(shape)
    if ".ln" in f".{name}":     # LayerNorm (ln1 / ln2 / ln_f) scale
        return torch.ones(shape)
    if leaf.startswith("expert_w"):   # (E, fan_in, fan_out)
        return torch.randn(shape, generator=g) / math.sqrt(shape[1])
    # Linear (out, in), Embedding (v, d), Conv (o, i, kh, kw)
    return torch.randn(shape, generator=g) / math.sqrt(
        math.prod(shape[1:]))


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init in place, drawn on the CPU in parameter order."""
    g = torch.Generator().manual_seed(seed)
    bn_scales = {f"{n}.weight": m.zero_scale for n, m in
                 model.named_modules() if isinstance(m, BatchNorm)}
    stacked = getattr(model, "block_stack", None) is not None
    for name, p in model.named_parameters():
        bn = bn_scales.get(name)
        if stacked and name.startswith("blocks."):
            w = torch.stack([_draw(name, tuple(p.shape[1:]), g, bn)
                             for _ in range(p.shape[0])])
        else:
            w = _draw(name, tuple(p.shape), g, bn)
        p.copy_(w.to(p.dtype))
    return model


def create_model(name: str, *, policy: Optional[PrecisionPolicy] = None,
                 device="cuda", seed: int = 0, **kwargs) -> nn.Module:
    """Instantiate a registered model on `device`, initialised from
    `seed`. `kwargs` are the model's fields: TransformerLM's (attn_impl,
    remat, pos_emb, tied_embeddings, num_heads, dropout_rate, vocab_size,
    max_len, fused, moe_every, num_experts, capacity_factor, ...), ViT's
    (num_classes, image_shape, patch_size, depth, num_heads, attn_impl,
    dropout_rate, fused, ...), ViTMoE's (ViT's without dropout_rate and
    fused, plus num_experts, top_k, capacity_factor, moe_every,
    moe_router) or ResNet's (num_classes, num_filters, image_shape,
    stage_sizes, small_images)."""
    policy = policy or PrecisionPolicy.fp32()
    name = name.lower()
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    dev = resolve_device(device)
    model = _REGISTRY[name](dtype=policy.compute_dtype,
                            param_dtype=policy.param_dtype, **kwargs)
    return init_weights(model, seed).to(dev)


__all__ = ["accepts_fused", "create_model", "init_weights", "ConvNet",
           "ResNet", "ResNet18", "ResNet50", "TransformerLM", "LMTiny",
           "LMBase", "LMMoE", "ViT", "ViTTiny", "ViTBase", "ViTMoE",
           "ViTTinyMoE", "PipelinedLM", "PipelinedViT"]
