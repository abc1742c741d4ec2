"""Pipeline-parallel ViT (counterpart of
ddp_practice_tpu/models/pipeline_vit.py): the ViT's patch embedding and
head around a stage-sharded, stacked encoder stack (models/pipeline_lm.py
`StageStack`), trained with GPipe only (parallel/pipeline.py), as the
reference's. Under sequence parallelism every seq rank embeds the whole
image and keeps its contiguous chunk of the patch tokens; the blocks'
attention crosses the chunks and the head pools over the group, as in
the dense ViT. Tensor parallelism cuts the stacked blocks' inner dims;
embed and head stay whole. The pipelined blocks have no dropout (the
trainer refuses --dropout for this family, as the reference's).
"""

from __future__ import annotations

from typing import Optional

import torch

from ddp_practice_tpu_torch.models.pipeline_lm import (
    StageStack,
    stack_leaves,
)
from ddp_practice_tpu_torch.models.vit import EncoderBlock, ViTEmbed, ViTHead


class PipelinedViT(StageStack):
    """The reference's PipelinedViT (vit_tiny's dims by default);
    `image_shape` (H, W, C) sizes the patch conv and the position table,
    as the port's ViT."""

    def __init__(self, *, num_classes: int = 10, patch_size: int = 4,
                 hidden_dim: int = 192, depth: int = 12, num_heads: int = 3,
                 mlp_dim: int = 768, dtype=torch.float32,
                 param_dtype=torch.float32, num_stages: int = 1,
                 num_microbatches: int = 4, remat: bool = True,
                 seq_axis: Optional[str] = None, sp_impl: str = "ring",
                 attn_impl: str = "xla", image_shape=(32, 32, 3)) -> None:
        super().__init__()
        h, w, c = image_shape
        self.num_classes = num_classes
        self.patch_size = patch_size
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.dtype = dtype
        self.image_shape = tuple(image_shape)
        self.seq_axis = seq_axis
        self.sp = None
        self.embed = ViTEmbed(
            patch_size, hidden_dim, in_channels=c,
            num_patches=(h // patch_size) * (w // patch_size), dtype=dtype)
        self.blocks = stack_leaves(EncoderBlock(
            hidden_dim, num_heads, mlp_dim, dtype=dtype, seq_axis=seq_axis,
            sp_impl=sp_impl, attn_impl=attn_impl), depth)
        self.head = ViTHead(hidden_dim, num_classes, dtype=dtype)
        self._init_stack(depth=depth, num_stages=num_stages, num_virtual=1,
                         num_microbatches=num_microbatches, remat=remat)
        self.to(param_dtype)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                dropout_key=None) -> torch.Tensor:
        """x (b, H, W, C) float in [0, 1] -> fp32 logits (b, classes) on
        every rank."""
        x = self.embed(x)
        if self.sp is not None:
            x = self.sp.chunk(x, 1)
        return self.head(self.run_blocks(x), self.sp)
