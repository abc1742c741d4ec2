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
plus `TrainConfig.device`. The port runs every mesh axis, `fsdp` (under
`pipe` too), `sp_impl`, the pipeline flags (`num_microbatches`,
`pipe_schedule`, `num_virtual`; parallel/) and the failure detection
(`max_restarts`, `watchdog_timeout_s`, `watchdog_probe_every_steps`,
`sync_check_every_steps`; train/elastic.py); every flag it does not
port raises NotImplementedError naming the ROADMAP item that brings it,
when set to anything but the default.
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
    """Shape of the rank mesh, the reference's axes in its order: `data`
    (data parallelism; -1 = the ranks the other axes leave), `seq`
    (sequence parallelism: ring or Ulysses attention, parallel/ring.py
    and parallel/ulysses.py), `tensor` (Megatron tensor parallelism over
    attention heads and MLP features, parallel/tensor.py), `pipe` (the
    pipelined families' stages, parallel/pipeline.py) and
    `expert` (the routed MLPs' stacked experts cut over its ranks,
    ops/moe.py)."""

    data: int = -1
    seq: int = 1
    tensor: int = 1
    pipe: int = 1
    expert: int = 1

    AXIS_DATA = "data"
    AXIS_SEQ = "seq"
    AXIS_TENSOR = "tensor"
    AXIS_PIPE = "pipe"
    AXIS_EXPERT = "expert"

    def __post_init__(self):
        for axis in ("seq", "tensor", "pipe", "expert"):
            if getattr(self, axis) < 1:
                raise ValueError(
                    f"mesh {axis}={getattr(self, axis)} (want >= 1)")

    @property
    def axis_names(self) -> tuple:
        return (self.AXIS_DATA, self.AXIS_SEQ, self.AXIS_TENSOR,
                self.AXIS_PIPE, self.AXIS_EXPERT)

    def resolve(self, n_devices: int) -> tuple:
        """Concrete (data, seq, tensor, pipe, expert) sizes over
        `n_devices` ranks."""
        rest = self.seq * self.tensor * self.pipe * self.expert
        data = self.data
        if data == -1:
            if n_devices % rest != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"seq*tensor*pipe*expert={rest}"
                )
            data = n_devices // rest
        if data * rest != n_devices:
            raise ValueError(
                f"mesh {data}x{self.seq}x{self.tensor}x{self.pipe}"
                f"x{self.expert} != {n_devices} devices"
            )
        return (data, self.seq, self.tensor, self.pipe, self.expert)


# TrainConfig fields this slice does not port -> the ROADMAP item that
# does; setting one to anything but its default raises
_NOT_PORTED = {
    "trace_out": "A6", "metrics_port": "A6", "telemetry_out": "A6",
    "slo": "A6", "alert_sinks": "A6",
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Full training-run configuration: the reference's fields and
    defaults (3 epochs, per-replica batch 32, SGD lr 1e-4, seed 3407),
    plus `device` ("cuda" by default; "cpu" runs the plain versions).

    Differences the port documents rather than hides:
    - `steps_per_call` (K >= 1 steps a call, or -1: the whole epoch, with
      device-resident data only) and `data_placement` (auto | host |
      device; "auto" takes the device-resident corpus when one process
      runs and the corpus fits `resident_max_bytes`, as the reference's
      does) pick the reference's step variants (train/steps.py); on the
      card one step is captured as a CUDA graph and replayed
      (utils/graphs.py), where the reference compiles a `lax.scan`.
    - `compilation_cache` (the reference's persistent XLA compile cache)
      has no counterpart: the port compiles no step, and its kernels
      build once into the ignored `build/` directory, keyed by their
      sources' hash (ops/cuda_build.py). Any value but "auto" raises.
    - `num_classes` is accepted and not read: the reference's loop and
      the port's size the head from the dataset.
    - `loader_backend` is the reference's: "auto" (the native C++ gather
      where it builds, else numpy, bit-identical), "native" (raises when
      the library cannot be built or loaded) or "python" (numpy).
    - `augment` / `augment_kind` ("crop_flip" | "rrc") augment the image
      task's training batches on the device (ops/augment.py).
    - `max_restarts`, `watchdog_timeout_s`, `watchdog_probe_every_steps`
      and `sync_check_every_steps` are the reference's (train/elastic.py);
      the watchdog's probes wait on CUDA events recorded after each call,
      where the reference fetches a step's scalar.
    - checkpointing (`checkpoint_dir`, `checkpoint_every_epochs`,
      `checkpoint_every_steps`, `checkpoint_async`, `resume`) has the
      reference's semantics (train/loop.py, checkpoint/).
    - `coordinator_address`/`num_processes`/`process_id`: a tcp://
      rendezvous for torch.distributed, in place of torchrun's
      environment.
    - `mesh` (data x seq x tensor x pipe x expert) and `fsdp` lay the
      model out over the ranks as the reference's rules do
      (parallel/mesh.py `parallelize`);
      `batch_size` is per data replica, so the global batch is
      `batch_size` x the data degree. Under `mesh.seq` > 1 each seq rank
      of a data replica takes the same rows and its contiguous chunk of
      every sequence, and attention crosses the chunks by `sp_impl`
      ("ring" | "ulysses", the reference's values).
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
    steps_per_call: int = 1           # K >= 1, or -1 (a whole epoch)
    data_placement: str = "auto"      # auto | host | device
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
        if self.compilation_cache != "auto":
            raise NotImplementedError(
                f"compilation_cache={self.compilation_cache!r}: the port "
                "has no compile cache; it compiles no step, and its CUDA "
                "kernels build once into build/, keyed by their sources' "
                "hash (ops/cuda_build.py)")
        if not (self.steps_per_call == -1 or self.steps_per_call >= 1):
            raise ValueError(
                f"steps_per_call={self.steps_per_call}: must be >= 1 (K "
                "steps per dispatch) or exactly -1 (whole epoch per "
                "dispatch, device-resident data only)")
        if self.augment_kind not in ("crop_flip", "rrc"):
            raise ValueError(f"unknown augment_kind {self.augment_kind!r} "
                             "(crop_flip | rrc)")
        if self.loader_backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown loader_backend "
                             f"{self.loader_backend!r} (auto | native | "
                             "python)")
        if self.data_placement not in ("auto", "host", "device"):
            raise ValueError(f"unknown data_placement "
                             f"{self.data_placement!r} (auto | host | "
                             "device)")

    def precision_policy(self) -> PrecisionPolicy:
        return PrecisionPolicy.from_name(self.precision)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
