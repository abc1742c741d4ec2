"""Precision policy, device selection and the training configuration of
the PyTorch port (counterpart of ddp_practice_tpu/config.py).

Counterpart of `ddp_practice_tpu/config.py` `PrecisionPolicy`: parameters
stay fp32 and compute runs in `compute_dtype` (bf16 under the bf16
policy). bf16 has fp32's exponent range, so no loss scaling is needed.

`resolve_device` is the one place an entry point turns its `device=`
argument into a `torch.device`: the default is the card, and asking for
the card on a machine without one raises instead of quietly running on
the CPU. Only an explicit `device="cpu"` runs there (the tests pass it).

`MeshConfig` and `TrainConfig` keep the reference's fields and defaults,
plus `TrainConfig.device`. Data parallelism is the one mesh axis the port
runs (torch DDP over the processes torchrun starts); the other axes and
every flag this slice does not port raise NotImplementedError naming the
ROADMAP item that brings them, when set to anything but the default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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

    @property
    def name(self) -> str:
        return "bf16" if self.compute_dtype == torch.bfloat16 else "fp32"


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


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Shape of the device mesh: `data` (-1 = every process) is data
    parallelism; `seq`, `tensor`, `pipe` and `expert` are not ported."""

    data: int = -1
    seq: int = 1
    tensor: int = 1
    pipe: int = 1
    expert: int = 1

    def __post_init__(self):
        for axis, item in (("seq", "A8"), ("tensor", "A8"), ("pipe", "A8"),
                           ("expert", "A8")):
            if getattr(self, axis) != 1:
                raise NotImplementedError(
                    f"mesh axis {axis}={getattr(self, axis)} is not ported "
                    f"yet (ROADMAP {item}); only data parallelism runs")

    def resolve(self, n_processes: int) -> int:
        """The data-parallel degree over `n_processes` ranks."""
        data = n_processes if self.data == -1 else self.data
        if data != n_processes:
            raise ValueError(f"mesh data={data} != {n_processes} processes")
        return data


# TrainConfig fields this slice does not port -> the ROADMAP item that
# does; setting one to anything but its default raises
_NOT_PORTED = {
    "fsdp": "A8", "pipe_schedule": "A8", "num_microbatches": "A8",
    "num_virtual": "A8", "sp_impl": "A8", "max_restarts": "A8",
    "watchdog_timeout_s": "A8", "sync_check_every_steps": "A8",
    "augment": "A2", "augment_kind": "A2",
    "num_classes": "A2", "loader_backend": "A2",
    "watchdog_probe_every_steps": "A8",
    "steps_per_call": "A3", "resident_max_bytes": "A3",
    "compilation_cache": "A3",
    "trace_out": "A6", "metrics_port": "A6", "telemetry_out": "A6",
    "slo": "A6", "alert_sinks": "A6",
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Full training-run configuration: the reference's fields and
    defaults (3 epochs, per-replica batch 32, SGD lr 1e-4, seed 3407),
    plus `device` ("cuda" by default; "cpu" runs the plain versions).

    Differences the port documents rather than hides:
    - `data_placement`: "auto" means host here (the reference picks its
      device-resident path when the corpus fits; both feed the same
      batches); "device" is ROADMAP A3.
    - `compilation_cache` (the reference's persistent compile cache; the
      port's eager steps compile nothing), `loader_backend` (the native
      C++ gather), `num_classes` (the datasets carry their own; the
      override belongs to the imagenet corpus),
      `watchdog_probe_every_steps` and `resident_max_bytes` have no
      counterpart yet: any value but the default raises.
    - checkpointing (`checkpoint_dir`, `checkpoint_every_epochs`,
      `checkpoint_every_steps`, `checkpoint_async`, `resume`) has the
      reference's semantics (train/loop.py, checkpoint/).
    - `coordinator_address`/`num_processes`/`process_id`: a tcp://
      rendezvous for torch.distributed, in place of torchrun's
      environment.
    """

    # model / data
    model: str = "convnet"
    dataset: str = "mnist"
    data_dir: str = "./data"
    num_classes: int = 10
    synthetic_size: int = 0
    seq_len: int = 256
    remat: bool = False
    pos_emb: str = "learned"
    tied_embeddings: bool = False

    # optimization
    epochs: int = 3
    batch_size: int = 32          # per data-parallel replica
    learning_rate: float = 1e-4
    optimizer: str = "sgd"
    momentum: float = 0.0
    clip_norm: float = 0.0
    dropout: float = 0.0
    weight_decay: float = 0.0
    lr_schedule: str = "constant"     # constant | cosine | warmup_cosine
    warmup_steps: int = 0
    scale_lr_by_replicas: bool = False
    label_smoothing: float = 0.0
    accum_steps: int = 1

    seed: int = 3407
    precision: str = "fp32"

    # distribution
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    fsdp: bool = False
    sp_impl: str = "ring"
    attn_impl: str = "xla"            # xla | flash
    num_microbatches: int = 4
    pipe_schedule: str = "gpipe"
    num_virtual: int = 2
    augment: bool = False
    augment_kind: str = "crop_flip"
    fused_encoder: object = "auto"    # "auto" | "on"/True | "off"/False
    num_experts: int = 0
    moe_router: str = "topk"
    num_heads: int = 0
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    # checkpointing
    checkpoint_dir: Optional[str] = None
    checkpoint_every_epochs: int = 0
    checkpoint_every_steps: int = 0
    checkpoint_async: bool = True
    resume: bool = False

    # failure detection
    max_restarts: int = 0
    watchdog_timeout_s: float = 0.0
    watchdog_probe_every_steps: int = 50
    sync_check_every_steps: int = 0

    # eval / logging
    max_steps_per_epoch: int = 0
    eval_every_epochs: int = 0
    log_every_steps: int = 100
    profile_dir: Optional[str] = None
    trace_out: Optional[str] = None
    metrics_file: Optional[str] = None
    metrics_port: Optional[int] = None
    telemetry_out: Optional[str] = None
    slo: Optional[str] = None
    alert_sinks: Optional[tuple] = None

    # input pipeline
    loader_backend: str = "auto"
    prefetch: int = 2
    steps_per_call: int = 1
    data_placement: str = "auto"      # auto (= host here) | host
    resident_max_bytes: int = 256 * 1024 * 1024
    compilation_cache: str = "auto"
    shuffle_eval: bool = False

    # the port's own: where the run executes
    device: str = "cuda"

    def __post_init__(self):
        defaults = TrainConfig.__dataclass_fields__
        for name, item in _NOT_PORTED.items():
            if getattr(self, name) != defaults[name].default:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet "
                    f"(ROADMAP {item})")
        if self.fused_encoder not in ("auto", "on", "off", True, False):
            raise ValueError(f"fused_encoder={self.fused_encoder!r} "
                             "(want 'auto'|'on'|'off')")
        if self.data_placement == "device":
            raise NotImplementedError(
                "data_placement='device' is not ported yet (ROADMAP A3)")
        if self.data_placement not in ("auto", "host"):
            raise ValueError(f"unknown data_placement "
                             f"{self.data_placement!r} (auto | host)")

    def precision_policy(self) -> PrecisionPolicy:
        return PrecisionPolicy.from_name(self.precision)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
