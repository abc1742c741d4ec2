"""Precision policy and device selection for the PyTorch port.

Counterpart of `ddp_practice_tpu/config.py` `PrecisionPolicy`: parameters
stay fp32 and compute runs in `compute_dtype` (bf16 under the bf16
policy). bf16 has fp32's exponent range, so no loss scaling is needed.

`resolve_device` is the one place an entry point turns its `device=`
argument into a `torch.device`: the default is the card, and asking for
the card on a machine without one raises instead of quietly running on
the CPU. Only an explicit `device="cpu"` runs there (the tests pass it).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    @staticmethod
    def fp32() -> "PrecisionPolicy":
        return PrecisionPolicy()

    @staticmethod
    def bf16() -> "PrecisionPolicy":
        return PrecisionPolicy(compute_dtype=torch.bfloat16)

    @staticmethod
    def from_name(name: str) -> "PrecisionPolicy":
        name = name.lower()
        if name in ("fp32", "float32", "f32"):
            return PrecisionPolicy.fp32()
        if name in ("bf16", "bfloat16", "mixed"):
            return PrecisionPolicy.bf16()
        raise ValueError(f"unknown precision policy {name!r}")


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is present; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (want cuda|cpu)")
    return dev
