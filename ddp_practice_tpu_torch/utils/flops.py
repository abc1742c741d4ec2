"""Analytic FLOP counts and the card's peak rate, for MFU, and its
device-memory bandwidth, for bytes bounds (counterpart of
ddp_practice_tpu/utils/flops.py: the ConvNet, LM and ViT parts,
`chip_peak_flops` and `chip_hbm_bandwidth`; the ResNet counts are
ROADMAP A2).

MFU is the model's analytic training FLOPs per step (3x forward: backward
~= 2x forward, the standard accounting) over the measured step time and
the card's peak dense bf16 rate. Elementwise and normalization FLOPs are
left out (<2% here), so MFU is slightly conservative.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple


def conv2d(h: int, w: int, cin: int, cout: int, kh: int, kw: int,
           stride: int = 1) -> Tuple[float, int, int]:
    """FLOPs of a SAME-padded conv (as the equivalent im2col matmul),
    plus its output's spatial dims."""
    ho = math.ceil(h / stride)
    wo = math.ceil(w / stride)
    return 2.0 * ho * wo * cout * cin * kh * kw, ho, wo


def convnet_forward_flops(image_shape=(28, 28, 1), num_classes: int = 10,
                          features=(16, 32)) -> float:
    """The reference ConvNet (models/convnet.py): [conv5x5 -> BN -> relu
    -> maxpool2] per feature block, then one dense head."""
    h, w, c = image_shape
    total = 0.0
    for feat in features:
        f, h, w = conv2d(h, w, c, feat, 5, 5)
        total += f
        h, w, c = h // 2, w // 2, feat
    return total + 2.0 * (h * w * c) * num_classes


def lm_forward_flops_per_token(*, hidden_dim: int, depth: int, mlp_dim: int,
                               vocab_size: int, seq_len: int,
                               causal: bool = True, moe_every: int = 0,
                               moe_top_k: int = 2) -> float:
    """Decoder LM (models/lm.py) forward FLOPs per token. Per layer:
    8*d^2 (qkv + out projections) + 4*d*mlp (MLP) + the attention score
    and value products 4*s*d, halved under causal masking (the flash
    kernels skip the masked tiles). Plus the 2*d*V lm_head.

    moe_every > 0 (lm_moe): every moe_every-th layer's MLP routes each
    token through top_k experts, so its active MLP FLOPs are top_k x the
    dense MLP's (the d*E router is left out). Dropped tokens make this an
    upper bound on the active FLOPs, so MoE MFU is conservative."""
    d, m, v, s = hidden_dim, mlp_dim, vocab_size, seq_len
    attn = 4.0 * s * d * (0.5 if causal else 1.0)
    mlp = 4.0 * d * m
    total = depth * (8.0 * d * d + attn) + 2.0 * d * v
    n_moe = depth // moe_every if moe_every > 0 else 0
    return total + (depth - n_moe) * mlp + n_moe * moe_top_k * mlp


def lm_train_flops_per_token(**kw) -> float:
    """fwd + bwd FLOPs per token: 3x forward (bwd ~= 2x fwd)."""
    return 3.0 * lm_forward_flops_per_token(**kw)


def vit_forward_flops(image_shape=(32, 32, 3), *, patch_size: int = 4,
                      hidden_dim: int = 192, depth: int = 12,
                      mlp_dim: int = 768, num_classes: int = 10) -> float:
    """ViT as built in models/vit.py: patch-embed conv, `depth` encoder
    blocks, dense head. Per layer per image: 8*s*d^2 (attention
    projections) + 4*s^2*d (score and value products) + 4*s*d*mlp (MLP)."""
    h, w, c = image_shape
    s = (h // patch_size) * (w // patch_size)
    d = hidden_dim
    embed = 2.0 * s * d * (patch_size * patch_size * c)
    per_layer = 8.0 * s * d * d + 4.0 * s * s * d + 4.0 * s * d * mlp_dim
    head = 2.0 * d * num_classes
    return embed + depth * per_layer + head


def train_flops_per_image(model: str, image_shape, num_classes: int = 10,
                          **kw) -> Optional[float]:
    """fwd + bwd FLOPs per image: 3x forward; `kw` are the ViT's own
    dims (patch_size, hidden_dim, depth, mlp_dim). None for a model whose
    count is not ported (resnet: ROADMAP A2)."""
    if model.lower() == "convnet":
        return 3.0 * convnet_forward_flops(image_shape, num_classes)
    if model.lower().startswith("vit"):
        return 3.0 * vit_forward_flops(image_shape, num_classes=num_classes,
                                       **kw)
    return None


# Peak dense bf16 tensor-core FLOP/s by the name torch.cuda reports.
# H100 SXM5: 989.4 TFLOP/s dense bf16 (NVIDIA H100 Tensor Core GPU data
# sheet; 1,979 with structured sparsity), at its 700 W limit.
_PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def chip_peak_flops(device_name: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s for `torch.cuda.get_device_name()`, or None
    for a card (or the CPU) the table does not know."""
    return _PEAK_BF16.get(device_name.strip())


# Device-memory bandwidth by the name torch.cuda reports (bytes/s): the
# roofline of decode attention, which streams the KV cache once a step.
# H100 SXM5: 3.35 TB/s of HBM3 (NVIDIA H100 Tensor Core GPU data sheet).
_HBM_BYTES = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def chip_hbm_bandwidth(device_name: str) -> Optional[float]:
    """Device-memory bytes/s for `torch.cuda.get_device_name()`, or None
    for a card (or the CPU) the table does not know."""
    return _HBM_BYTES.get(device_name.strip())
