"""ViT-MoE: the Vision Transformer with routed expert MLPs (counterpart of
ddp_practice_tpu/models/vit_moe.py).

Every `moe_every`-th encoder block swaps its dense MLP for
`ops/moe.py MoEMlp` (models/vit.py `EncoderBlock` with `use_moe`); the
other blocks are the plain ones, unfused (the reference's blocks here keep
`fused=False`). Embedding, head and the NHWC-in, fp32-logits-out contract
are the ViT's. The reference's model has no dropout field, so neither has
this one.

Sequence parallelism (`seq_axis`; parallel/mesh.py sets `sp`) is the
ViT's: every seq rank embeds the whole image, keeps its chunk of the
patch tokens and pools over the group; the routed blocks route the whole
sequence (ops/moe.py). Expert parallelism cuts the routed blocks' experts
(parallel/mesh.py `shard_state`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ddp_practice_tpu_torch.models.vit import EncoderBlock, ViTEmbed, ViTHead


class ViTMoE(nn.Module):
    def __init__(self, *, num_classes: int = 10, patch_size: int = 4,
                 hidden_dim: int = 192, depth: int = 12, num_heads: int = 3,
                 mlp_dim: int = 768, num_experts: int = 8, top_k: int = 2,
                 capacity_factor: float = 1.25, moe_every: int = 2,
                 moe_router: str = "topk", dtype=torch.float32,
                 param_dtype=torch.float32, seq_axis: Optional[str] = None,
                 sp_impl: str = "ring", attn_impl: str = "xla",
                 image_shape=(32, 32, 3)) -> None:
        super().__init__()
        h, w, c = image_shape
        self.num_classes = num_classes
        self.patch_size = patch_size
        self.hidden_dim = hidden_dim
        self.depth = depth
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.dtype = dtype
        self.image_shape = tuple(image_shape)
        self.embed = ViTEmbed(
            patch_size, hidden_dim, in_channels=c,
            num_patches=(h // patch_size) * (w // patch_size), dtype=dtype)
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden_dim, num_heads, mlp_dim, dtype=dtype,
                         seq_axis=seq_axis, sp_impl=sp_impl,
                         attn_impl=attn_impl,
                         use_moe=i % moe_every == moe_every - 1,
                         num_experts=num_experts, moe_top_k=top_k,
                         capacity_factor=capacity_factor,
                         moe_router=moe_router)
            for i in range(depth)
        )
        self.classifier = ViTHead(hidden_dim, num_classes, dtype=dtype)
        self.seq_axis = seq_axis
        # the seq group under sequence parallelism (parallel/mesh.py)
        self.sp = None
        self.to(param_dtype)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                dropout_key=None) -> torch.Tensor:
        """x (b, H, W, C) float in [0, 1] -> logits (b, classes) fp32.
        `dropout_key` is accepted for the image step's call and unused."""
        x = self.embed(x)
        if self.sp is not None:
            x = self.sp.chunk(x, 1)
        for blk in self.blocks:
            x = blk(x, train=train)
        return self.classifier(x, self.sp)
