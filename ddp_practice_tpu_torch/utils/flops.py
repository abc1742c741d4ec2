"""Analytic FLOP counts and the card's peak rate, for MFU (counterpart of
ddp_practice_tpu/utils/flops.py, the LM and ViT parts).

MFU is the model's analytic training FLOPs per step (3x forward: backward
~= 2x forward, the standard accounting) over the measured step time and
the card's peak dense bf16 rate. Elementwise and normalization FLOPs are
left out (<2% here), so MFU is slightly conservative.
"""

from __future__ import annotations

from typing import Optional


def lm_forward_flops_per_token(*, hidden_dim: int, depth: int, mlp_dim: int,
                               vocab_size: int, seq_len: int,
                               causal: bool = True) -> float:
    """Decoder LM (models/lm.py) forward FLOPs per token. Per layer:
    8*d^2 (qkv + out projections) + 4*d*mlp (MLP) + the attention score
    and value products 4*s*d, halved under causal masking (the flash
    kernels skip the masked tiles). Plus the 2*d*V lm_head."""
    d, m, v, s = hidden_dim, mlp_dim, vocab_size, seq_len
    attn = 4.0 * s * d * (0.5 if causal else 1.0)
    return depth * (8.0 * d * d + attn + 4.0 * d * m) + 2.0 * d * v


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
    """fwd + bwd FLOPs per image: 3x forward; `kw` are the model's own
    dims (patch_size, hidden_dim, depth, mlp_dim). None for a model whose
    count is not ported (convnet and resnet: ROADMAP A1)."""
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
