"""ddp_practice_tpu_torch — the PyTorch/CUDA port of the JAX package.

The reference package (`ddp_practice_tpu/`) is written for a TPU; this
package runs the same system on an NVIDIA H100. Module names follow the
reference so each counterpart is easy to find. The first slice is the
serving path: `serve/bench.py` → `serve/scheduler.py` →
`serve/engine.py` SlotEngine → `inference.py` → `models/lm.py` →
`models/vit.py` → `ops/decode_attention.py`, whose single-token step is a
CUDA kernel written by hand for sm_90a (`csrc/decode_attention.cu`).

Entry points run on the card by default and raise when none is present;
pass `device="cpu"` to run the plain PyTorch versions on the CPU.
"""

from ddp_practice_tpu_torch.config import PrecisionPolicy, resolve_device

__all__ = ["PrecisionPolicy", "resolve_device"]
