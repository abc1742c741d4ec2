"""Analytic FLOP counts and the card's peak rate, for MFU (counterpart of
ddp_practice_tpu/utils/flops.py, LM part).

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
