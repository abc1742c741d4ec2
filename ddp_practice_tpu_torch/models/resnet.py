"""ResNet v1.5 (counterpart of ddp_practice_tpu/models/resnet.py):
ResNet-18 on CIFAR-sized images (3x3 stem) and ResNet-50 on ImageNet
(7x7 stride-2 stem and a 3x3 stride-2 max pool), the stride of a
downsampling bottleneck on its 3x3 conv.

Batches arrive NHWC, as the reference's; the network runs on the NCHW
view of the same memory (channels-last, which cuDNN takes as is) and
returns fp32 logits. Under the precision policy it computes in `dtype`
and keeps its parameters in `param_dtype`.

Flax's `padding="SAME"` pads `total = max((ceil(n/s) - 1) s + k - n, 0)`
with `total // 2` before and the rest after: at stride 2 on an even size
that is one more after than before (a 3x3 conv on 32 pads (0, 1), the
7x7 stem on 224 (2, 3), the 3x3 max pool on 112 (0, 1) with -inf).
torch's symmetric `padding=` gives the same output shape with every
window shifted, so each conv and the pool pad explicitly from their
input's size (`same_pads`), and a symmetric pad goes to the conv itself.

BatchNorm is the port's (ops/batchnorm.py: Flax's momentum 0.9, epsilon
1e-5, running variance and fp32 statistics, all-reduced over the ranks
when several train: the reference's `axis_name`). The last BatchNorm of
each block starts with scale zero (`zero_scale`, the reference's
`scale_init=zeros`), so every block starts as the identity on its
shortcut.

Module names mirror the Flax tree so that convert.py maps it: `stem_conv`,
`stem_bn`, then `BasicBlock_{i}` or `BottleneckBlock_{i}` numbered across
the stages, each with `conv{j}` and `bn{j}` (Flax's `Conv_{j}` and
`BatchNorm_{j}`) and, where the shape changes, `proj` and `proj_bn`; the
head `head` (`Dense_0`). The convolutions, pooling and normalisation are
library calls (cuDNN and ATen on the card), as the reference's are XLA
ops: no TPU kernel lies on this model's path.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddp_practice_tpu_torch.models.vit import dense
from ddp_practice_tpu_torch.ops.batchnorm import BatchNorm


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """(before, after) padding of Flax's SAME for size n, window k,
    stride s."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """x (b, c, h, w) padded as SAME would for window k, stride s, and the
    symmetric padding still left for the op itself."""
    (top, bottom), (left, right) = (same_pads(x.shape[2], k, s),
                                    same_pads(x.shape[3], k, s))
    if top == bottom == left == right:
        return x, top
    return F.pad(x, (left, right, top, bottom), value=value), 0


class Conv(nn.Conv2d):
    """A bias-free Flax `nn.Conv` with SAME padding, computing in
    `dtype`."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, *,
                 dtype=torch.float32) -> None:
        super().__init__(cin, cout, k, stride, bias=False)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = _pad_same(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, self.weight.to(self.compute_dtype),
                        stride=self.stride, padding=pad)


def _max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2):
    """Flax `nn.max_pool(x, (k, k), strides=(s, s), padding="SAME")`:
    padding is -inf, so it never wins a window."""
    x, pad = _pad_same(x, k, s, value=-math.inf)
    return F.max_pool2d(x, k, s, padding=pad)


class BasicBlock(nn.Module):
    """Two 3x3 convs (the first strided), the second BatchNorm
    zero-initialised; a 1x1 projection where the shape changes."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, *,
                 dtype=torch.float32) -> None:
        super().__init__()
        self.conv0 = Conv(cin, filters, 3, stride, dtype=dtype)
        self.bn0 = BatchNorm(filters, dtype=dtype)
        self.conv1 = Conv(filters, filters, 3, dtype=dtype)
        self.bn1 = BatchNorm(filters, dtype=dtype, zero_scale=True)
        if cin != filters or stride != 1:
            self.proj = Conv(cin, filters, 1, stride, dtype=dtype)
            self.proj_bn = BatchNorm(filters, dtype=dtype)

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x), train=train))
        y = self.bn1(self.conv1(y), train=train)
        if hasattr(self, "proj"):
            x = self.proj_bn(self.proj(x), train=train)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1 down, 3x3 (strided: v1.5), 1x1 up to 4 x filters, the last
    BatchNorm zero-initialised; a strided 1x1 projection where the shape
    changes."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, *,
                 dtype=torch.float32) -> None:
        super().__init__()
        out = filters * 4
        self.conv0 = Conv(cin, filters, 1, dtype=dtype)
        self.bn0 = BatchNorm(filters, dtype=dtype)
        self.conv1 = Conv(filters, filters, 3, stride, dtype=dtype)
        self.bn1 = BatchNorm(filters, dtype=dtype)
        self.conv2 = Conv(filters, out, 1, dtype=dtype)
        self.bn2 = BatchNorm(out, dtype=dtype, zero_scale=True)
        if cin != out or stride != 1:
            self.proj = Conv(cin, out, 1, stride, dtype=dtype)
            self.proj_bn = BatchNorm(out, dtype=dtype)

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x), train=train))
        y = F.relu(self.bn1(self.conv1(y), train=train))
        y = self.bn2(self.conv2(y), train=train)
        if hasattr(self, "proj"):
            x = self.proj_bn(self.proj(x), train=train)
        return F.relu(x + y)


class ResNet(nn.Module):
    """`stage_sizes` blocks a stage, `num_filters` x 2^i filters in stage
    i, stride 2 on the first block of every stage but the first. Takes
    images of any size: `image_shape` is only the channel count's
    source."""

    def __init__(self, *, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 10, num_filters: int = 64,
                 small_images: bool = True, dtype=torch.float32,
                 param_dtype=torch.float32, image_shape=(32, 32, 3)) -> None:
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.num_classes = num_classes
        self.num_filters = num_filters
        self.small_images = small_images
        self.dtype = dtype
        self.image_shape = tuple(image_shape)
        c = self.image_shape[-1]
        k, s = (3, 1) if small_images else (7, 2)
        self.stem_conv = Conv(c, num_filters, k, s, dtype=dtype)
        self.stem_bn = BatchNorm(num_filters, dtype=dtype)
        self.block_names = []
        c = num_filters
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                block = block_cls(c, num_filters * 2 ** i,
                                  2 if i > 0 and j == 0 else 1, dtype=dtype)
                self.add_module(name, block)
                self.block_names.append(name)
                c = num_filters * 2 ** i * block_cls.expansion
        self.head = nn.Linear(c, num_classes)
        self.to(param_dtype)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                dropout_key=None) -> torch.Tensor:
        """x (b, H, W, C) float -> logits (b, classes) fp32.
        `dropout_key` is the image steps' common argument (no dropout
        here)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)         # NHWC -> NCHW view
        x = F.relu(self.stem_bn(self.stem_conv(x), train=train))
        if not self.small_images:
            x = _max_pool_same(x)
        for name in self.block_names:
            x = getattr(self, name)(x, train=train)
        return dense(x.mean((2, 3)), self.head, self.dtype).float()


def ResNet18(**kw) -> ResNet:
    kw.setdefault("stage_sizes", (2, 2, 2, 2))
    return ResNet(block_cls=BasicBlock, **kw)


def ResNet50(**kw) -> ResNet:
    kw.setdefault("stage_sizes", (3, 4, 6, 3))
    kw.setdefault("small_images", False)
    return ResNet(block_cls=BottleneckBlock, **kw)
