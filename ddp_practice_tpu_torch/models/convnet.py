"""The reference ConvNet (counterpart of ddp_practice_tpu/models/convnet.py).

Two blocks of [Conv 5x5 pad 2 -> BatchNorm -> ReLU -> MaxPool 2x2]
(channels 1 -> 16 -> 32), flatten, Dense to `num_classes`. Under the
precision policy it computes in `dtype`, keeps parameters in
`param_dtype` (fp32) and returns fp32 logits, as the reference does.

Batches arrive NHWC, as the reference's. The input becomes an NCHW view
of the same memory (channels-last: cuDNN takes it as is), and the last
block's output is permuted back to NHWC before the flatten, so the Dense
rows are in the reference's (h, w, c) order and its kernel converts by a
plain transpose (`convert.py`).

BatchNorm is the port's own (ops/batchnorm.py): Flax's running-variance
rule and momentum, and, when more than one process trains, statistics
averaged over the ranks (the reference's `axis_name`, SyncBatchNorm).
Submodules are `conv{i}`, `bn{i}` and `head`: Flax's auto-names
`Conv_{i}`, `BatchNorm_{i}` and `Dense_0`. The convolutions, pooling and
normalisation are library calls (cuDNN and ATen on the card), as the
reference's are XLA ops: no TPU kernel lies on this model's path.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ddp_practice_tpu_torch.models.vit import dense
from ddp_practice_tpu_torch.ops.batchnorm import BatchNorm


class ConvNet(nn.Module):
    def __init__(self, *, num_classes: int = 10,
                 features: Sequence[int] = (16, 32), dtype=torch.float32,
                 param_dtype=torch.float32, image_shape=(28, 28, 1)) -> None:
        super().__init__()
        h, w, c = image_shape
        self.num_classes = num_classes
        self.features = tuple(features)
        self.dtype = dtype
        self.image_shape = tuple(image_shape)
        for i, feat in enumerate(self.features):
            self.add_module(f"conv{i}", nn.Conv2d(c, feat, 5, padding=2))
            self.add_module(f"bn{i}", BatchNorm(feat, dtype=dtype))
            c, h, w = feat, h // 2, w // 2
        self.head = nn.Linear(h * w * c, num_classes)
        self.to(param_dtype)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                dropout_key=None) -> torch.Tensor:
        """x (b, H, W, C) float in [0, 1] -> logits (b, classes) fp32.
        `dropout_key` is the image steps' common argument (no dropout
        here)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)         # NHWC -> NCHW view
        for i in range(len(self.features)):
            conv = getattr(self, f"conv{i}")
            x = F.conv2d(x, conv.weight.to(self.dtype),
                         conv.bias.to(self.dtype), padding=2)
            x = getattr(self, f"bn{i}")(x, train=train)
            x = F.max_pool2d(F.relu(x), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flatten NHWC
        return dense(x, self.head, self.dtype).float()
