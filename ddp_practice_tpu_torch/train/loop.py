"""Training loop (counterpart of ddp_practice_tpu/train/loop.py, the LM
and the image task).

`Trainer` builds the loaders (LM: `_build_lm_data`, text from `data_dir`
or the synthetic Markov corpus, the last 10% held out; image: the train
and test splits of `data/datasets.py load_dataset`, which falls back to a
seeded synthetic set of the dataset's shape when no files are present,
behind `data/loader.py DataLoader`), the model on the card (`config.device`), the optimizer chain and the steps,
and `fit` runs the reference's loop contract: epochs with a per-epoch
reshuffle, `max_steps_per_epoch`, a log line every `log_every_steps`,
eval at the end (or every `eval_every_epochs`), and the three
parity-visible lines ("Accuracy is XX.XX%", "time elapsed", "throughput")
plus the reference's summary keys. Side effects (logs, `metrics_file`)
happen on process 0 only.

Where the data lives and how many steps a call runs are the reference's
choices (`data_placement`, `steps_per_call`; train/steps.py):
- device-resident (`_use_resident_data`: "device", or "auto" with one
  process and a corpus within `resident_max_bytes`, as the reference's):
  the corpus is uploaded once (uint8 images and labels, or the int32
  token stream) and each epoch sends only its index grid
  (`DataLoader.epoch_plan`), cut into groups of `steps_per_call` rows
  (the whole epoch at -1, `_resident_group`);
- host-fed: batches are pinned and copied with `non_blocking=True`,
  `prefetch` ahead of the step; with `steps_per_call` K > 1, K batches
  stacked into one copy (data/loader.py `prefetch_chunked`) and one call
  of the chunked step (a chunk the step cap cuts runs as single steps).
On the card a resident or chunked call is replays of one captured CUDA
graph where `utils/graphs.py eager_reason` allows it (one process, or
NCCL ranks, one process a card, whatever the layout); on the CPU, under
gloo and for ranks as threads, the same factories run the per-batch
step K times, with the same math. Every layout below takes K
steps a call, and resident data wherever the corpus is addressable
(`_use_resident_data`).
Logs, metrics records and periodic checkpoints fall at group boundaries
(`_after_train_group`: boundary-crossing tests, not modulo). The step's
metrics stay on the device and are read back only at log steps and at
the end of an epoch, so the host runs ahead of the card between them.

Data parallelism: run one process per card under torchrun (or pass
`coordinator_address`, `num_processes` and `process_id`; on one card, the
ranks as threads, parallel/threads.py). The ranks form the reference's
mesh (`config.mesh`, parallel/mesh.py `build_mesh`); the global batch is
`batch_size x` the data degree, each rank takes its data coordinate's
`ShardSpec.local_slice` of every global batch (the ranks of one tensor
group read the same rows), and the model is laid out by
`parallel.mesh.parallelize`: tensor parallelism over `mesh.tensor`
(Megatron, parallel/tensor.py), sequence parallelism over `mesh.seq`
(`seq_axis`/`sp_impl` in the model's arguments, as the reference's: the
seq ranks of a data replica read the same rows and each trains on its
chunk of the sequences, attention crossing the chunks by ring or
Ulysses), expert parallelism over `mesh.expert` (the routed MLPs' experts
cut over its ranks, which read the same rows: ops/moe.py; `num_experts`
defaults to the reference's 8 rounded up to a multiple of the axis and
must divide over it, the reference's error), pipeline parallelism over
`mesh.pipe` for the pipelined families (lm_pipe, vit_tiny_pipe: the
stage count from the mesh, `num_microbatches`, and for the LM
`pipe_schedule` gpipe | 1f1b | interleaved with `num_virtual` chunks;
parallel/pipeline.py, parallel/pipeline_1f1b.py; the reference's errors
for a schedule without --pipe, a non-GPipe schedule off the LM, an LM
other than lm_pipe under --pipe, and --dropout or --tied for the
pipelined LM), `fsdp` over the data ranks (FSDP2, and the grads averaged
over the seq ranks; under pipe the stage's shards gathered once a step
and the grads reduce-scattered once after the schedule, parallel/fsdp.py
`DataShards`), else DistributedDataParallel over the data x seq ranks
(under the explicit pipeline schedules one average of the grads after
the schedule instead); eval sums are all-reduced over the data ranks.
The tensor, pipe and expert groups' grads are exact without a
collective. MFU and the per-chip rates divide by every rank.

Failure detection (train/elastic.py), the reference's: with
`watchdog_timeout_s` a `StepWatchdog` runs during `fit`; every call puts
a rung (a CUDA event) on the progress ladder, the log readback, eval's
readback, checkpoint IO and the epoch's fence beat it, and a probe waits
on the oldest unconfirmed rung every `watchdog_probe_every_steps` steps
or when half the timeout passed without a beat (the resident groups are
capped at that interval). `sync_check_every_steps` all-gathers the
driver's step count over the ranks and raises on drift. Module-level
`fit` with `max_restarts` > 0 rebuilds the trainer after a failure,
resuming from the newest checkpoint (`run_with_restarts`).

`fused_encoder` ("auto" | "on" | "off") is the reference's flag: "on"
forces the fused encoder layer and raises for a model that does not take
it or a shape the kernels refuse. The image task
trains the ConvNet (the default: `convnet` on `mnist`), ResNet-18 and
ResNet-50 (their BatchNorm statistics averaged over the ranks, so DDP
does not broadcast buffers for them) and the image transformers
(vit_tiny, vit_base, vit_tiny_moe). `augment` (with `augment_kind`)
augments the image task's training batches on the device
(ops/augment.py) and raises for the LM task, as the reference's; the
head has the dataset's classes, and `num_classes` is not read, as in
the reference's loop. `loader_backend` picks the batch gather
(data/loader.py: the native C++ one, numpy, or "auto"). `num_experts`
and `moe_router` pass to the MoE families as the reference's loop
passes them (expert choice sets the capacity factor to 1.0 unless
given), and the summary gains the last step's `moe_load_max`,
`moe_load_min` and `moe_drop_rate`.

Checkpoints (`checkpoint_dir`, checkpoint/): a save every
`checkpoint_every_steps` steps of an epoch (asynchronous in a
single-process run unless `checkpoint_async` is off; each waits on the
one before) and every `checkpoint_every_epochs` epochs, and one at the
end of the fit, each with the reference's manifest `extra` (the run's
state-shaping knobs, and the LM's seq_len, vocabulary and embedding
options, which generate.py rebuilds the model from). Every rank takes
part and rank 0 writes. `resume` restores the newest complete
checkpoint (a truncated manifest falls back to the one before) and the
fit takes up again at the start of the epoch the restored step falls
in: the data order is the epoch's own, so a resume from an epoch
boundary continues the run as if it had not stopped.

The summary adds `mfu`: the analytic training FLOPs (utils/flops.py) of
the images or tokens trained over the train seconds and the card's peak
dense bf16 rate, None where the peak is unknown (the CPU).

`profile_dir` traces the reference's steady-state window of epoch 0
(steps min(10, n - 10) to 10 past it, n capped by `max_steps_per_epoch`)
into one Kineto trace (`utils/profiling.py`; read it with
`python -m ddp_practice_tpu_torch.utils.xprof DIR STEPS`): every call
(one step, or a group) runs under a `train#<its first step>` annotation
and eval under an "eval" one, the trace stops after a
`torch.cuda.synchronize()` at the window's end, and a short or failing
epoch closes it on the way out. The resident epoch cuts its groups at
the window's edges, so it traces the same steps; the reference traces
the whole first epoch in resident mode. A chunked host epoch starts and
stops at the first chunk boundary past each edge, as the reference's.
"""

from __future__ import annotations

import collections
import json
import logging
import math
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

import ddp_practice_tpu_torch.checkpoint as ckpt
from ddp_practice_tpu_torch.config import (
    MeshConfig,
    TrainConfig,
    resolve_device,
)
from ddp_practice_tpu_torch.data.datasets import load_dataset
from ddp_practice_tpu_torch.data.loader import DataLoader, prefetch_chunked
from ddp_practice_tpu_torch.data.lm_corpus import (
    LMDataLoader,
    TokenCorpus,
    load_text_corpus,
    synthetic_token_corpus,
)
from ddp_practice_tpu_torch.models import accepts_fused, create_model
from ddp_practice_tpu_torch.parallel import dist
from ddp_practice_tpu_torch.parallel.mesh import (
    axis_size,
    batch_shard,
    build_mesh,
    check_experts,
    parallelize,
)
from ddp_practice_tpu_torch.parallel.mesh import group as mesh_group
from ddp_practice_tpu_torch.train.elastic import (
    Rung,
    StepWatchdog,
    assert_in_sync,
    future_ready,
    run_with_restarts,
)
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
from ddp_practice_tpu_torch.train.steps import (
    make_chunked_eval_step,
    make_chunked_lm_train_step,
    make_chunked_train_step,
    make_eval_step,
    make_lm_eval_step,
    make_lm_train_step,
    make_resident_eval_step,
    make_resident_lm_eval_step,
    make_resident_lm_train_step,
    make_resident_train_step,
    make_train_step,
)
from ddp_practice_tpu_torch.utils import flops, profiling
from ddp_practice_tpu_torch.utils.timing import Timer


def get_logger(name: str = "ddp_practice_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


log = get_logger()


def info0(msg: str, *args) -> None:
    """Log on process 0 only (the reference's rank-0 gate)."""
    if dist.is_main_process():
        log.info(msg, *args)


class Trainer:
    def __init__(self, config: TrainConfig):
        self.config = config
        device = resolve_device(config.device)
        init_method = (f"tcp://{config.coordinator_address}"
                       if config.coordinator_address else None)
        dist.initialize(device, init_method=init_method,
                        world_size=config.num_processes,
                        rank=config.process_id)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.world = dist.process_count()
        self.mesh = build_mesh(config.mesh, device.type)
        self.dp = axis_size(self.mesh, MeshConfig.AXIS_DATA)
        self.sp = axis_size(self.mesh, MeshConfig.AXIS_SEQ)
        self.tp = axis_size(self.mesh, MeshConfig.AXIS_TENSOR)
        self.pp = axis_size(self.mesh, MeshConfig.AXIS_PIPE)
        self.ep = axis_size(self.mesh, MeshConfig.AXIS_EXPERT)
        self.global_batch = config.batch_size * self.dp
        self.task = "lm" if config.model.lower().startswith("lm") else "image"
        name = config.model.lower()
        if config.augment and self.task == "lm":
            raise ValueError(
                "--augment is image-input augmentation (random crop + "
                "flip, ops/augment.py); it does not apply to token "
                "streams")
        # the ranks of one tensor group read the same rows
        shard = self._batch_shard = batch_shard(self.mesh)
        model_kwargs = {}
        if self.task == "lm":
            self.train_ds = self.eval_ds = None
            (self.train_loader, self.eval_loader,
             self._vocab_size) = self._build_lm_data(shard)
            model_kwargs.update(vocab_size=self._vocab_size,
                                max_len=config.seq_len)
        else:
            self.train_ds = load_dataset(
                config.dataset, config.data_dir, "train", seed=config.seed,
                synthetic_size=config.synthetic_size or None)
            self.eval_ds = load_dataset(
                config.dataset, config.data_dir, "test", seed=config.seed,
                synthetic_size=(max(config.synthetic_size // 6, 1)
                                if config.synthetic_size else None))
            self.train_loader = DataLoader(
                self.train_ds, global_batch_size=self.global_batch,
                shard=shard, seed=config.seed, shuffle=True,
                backend=config.loader_backend)
            self.eval_loader = DataLoader(
                self.eval_ds, global_batch_size=self.global_batch,
                shard=shard, seed=config.seed, shuffle=config.shuffle_eval,
                backend=config.loader_backend)
            model_kwargs.update(num_classes=self.train_ds.num_classes,
                                image_shape=self.train_ds.image_shape)
            for flag, what in ((config.remat, "remat"),
                               (config.tied_embeddings, "--tied"),
                               (config.pos_emb != "learned", "--pos_emb")):
                if flag:
                    raise ValueError(f"{what} applies to the LM family "
                                     f"(lm_*), not {config.model!r}")
        if name in ("convnet", "resnet18", "resnet50"):
            for flag, what in ((config.num_heads, "--num_heads"),
                               (config.dropout, "--dropout"),
                               (config.attn_impl != "xla", "--attn_impl"),
                               (config.num_experts, "--num_experts"),
                               (self.ep > 1, "--expert")):
                if flag:
                    raise ValueError(f"{what} applies to the transformer "
                                     f"families, not {name!r}")
        if config.num_heads:
            model_kwargs["num_heads"] = config.num_heads
        if config.dropout:
            if not 0.0 < config.dropout < 1.0:
                raise ValueError(
                    f"--dropout must be in [0, 1), got {config.dropout}")
            if name in ("lm_pipe", "vit_tiny_pipe"):
                raise ValueError(
                    "--dropout is wired for the dense transformer families "
                    f"(vit_tiny, vit_base, lm_tiny/lm_base), not "
                    f"{config.model!r}")
            model_kwargs["dropout_rate"] = config.dropout
        if self.sp > 1:
            if name == "convnet" or name.startswith("resnet"):
                raise ValueError(
                    f"--seq {self.sp} cuts a transformer's token sequence; "
                    f"{config.model!r} has none")
            model_kwargs["seq_axis"] = MeshConfig.AXIS_SEQ
            model_kwargs["sp_impl"] = config.sp_impl
        if config.attn_impl != "xla":
            model_kwargs["attn_impl"] = config.attn_impl
        if self.ep > 1 or config.num_experts:
            # the reference's default: its 8 experts rounded up to a
            # multiple of the expert axis
            n_exp = config.num_experts or -(-8 // self.ep) * self.ep
            check_experts(n_exp, self.ep)
            # a dense transformer takes it and ignores it
            model_kwargs["num_experts"] = n_exp
        if config.moe_router != "topk":
            if name not in ("vit_tiny_moe", "lm_moe"):
                raise ValueError(
                    "--moe_router applies to the MoE model families "
                    f"(vit_tiny_moe, lm_moe), not {config.model!r}")
            model_kwargs["moe_router"] = config.moe_router
            # expert choice fills its buffers by construction: cf 1.0 is
            # executed == active FLOPs (lm_moe's token-choice default 2.0
            # would double the expert compute)
            model_kwargs.setdefault("capacity_factor", 1.0)
        fused_req = config.fused_encoder
        if fused_req in (True, "on"):
            if not accepts_fused(config.model):
                raise ValueError(
                    "--fused on is the small-d fused encoder-layer kernel "
                    "(ops/fused_encoder.py) for the dense transformer "
                    f"families, not {config.model!r} (conv/pipelined/"
                    "ViT-MoE keep their paths). Note wide models "
                    "(vit_base, lm_base) will then fail the kernel's "
                    "weight-size check loudly, and lm_tiny needs "
                    "--num_heads 4 (head_dim must be a multiple of 64)"
                )
            model_kwargs["fused"] = True
        elif fused_req in (False, "off"):
            if accepts_fused(config.model):
                model_kwargs["fused"] = False
        # "auto": the models default to fused="auto" and resolve per block
        self._pipeline_kwargs(name, model_kwargs)
        if config.remat:
            model_kwargs["remat"] = True
        if config.pos_emb != "learned":
            model_kwargs["pos_emb"] = config.pos_emb
        if config.tied_embeddings:
            if name == "lm_pipe":
                raise ValueError(
                    "--tied is not wired for the pipelined LM — use "
                    "lm_tiny/lm_base for weight tying")
            model_kwargs["tied_embeddings"] = True
        self.model = create_model(config.model,
                                  policy=config.precision_policy(),
                                  device=self.device, seed=config.seed,
                                  **model_kwargs)
        self.forward, self.after_backward = parallelize(
            self.model, self.mesh, model_name=config.model,
            fsdp=config.fsdp)
        optimizer = make_optimizer(config, self.model,
                                   self.train_loader.steps_per_epoch,
                                   self.dp)
        self.state = TrainState(step=0, model=self.model,
                                optimizer=optimizer)
        if (config.resume and config.checkpoint_dir
                and ckpt.exists(config.checkpoint_dir)):
            self.state = ckpt.restore(config.checkpoint_dir, self.state)
            info0("resumed from %s at step %d", config.checkpoint_dir,
                  self.state.step)
        self._pending_save: Optional[ckpt.AsyncSave] = None
        # the step watchdog (fit, with watchdog_timeout_s) and its
        # progress ladder: one rung a dispatched call (`_track`)
        self._watchdog = None
        self._pending: collections.deque = collections.deque()
        self._build_steps()
        self._train_images = 0
        self._train_seconds = 0.0
        self._last_moe: dict = {}
        self.eval_perplexity: Optional[float] = None
        self._metrics_fh = None
        if config.metrics_file and dist.is_main_process():
            import os

            d = os.path.dirname(config.metrics_file)
            if d:
                os.makedirs(d, exist_ok=True)
            self._metrics_fh = open(config.metrics_file, "a")

    def _pipeline_kwargs(self, name: str, model_kwargs: dict) -> None:
        """The reference's pipeline checks (a schedule needs a pipe axis
        and is the LM's; an LM pipelines as lm_pipe, an image model as
        vit_tiny_pipe) and the pipelined model's stage arguments: the
        stage count from the mesh, the microbatches and the schedule."""
        cfg = self.config
        if cfg.pipe_schedule != "gpipe":
            if self.pp <= 1:
                raise ValueError(
                    f"--pipe_schedule {cfg.pipe_schedule} needs a pipeline "
                    "mesh axis (--pipe > 1)")
            if not name.startswith("lm_"):
                raise ValueError(
                    f"--pipe_schedule {cfg.pipe_schedule} is an LM pipeline "
                    f"feature (models/pipeline_lm.py); {cfg.model} "
                    "schedules with GPipe only")
        if self.pp <= 1:
            return
        if self.task == "lm" and name != "lm_pipe":
            raise ValueError(
                "pipeline parallelism for language models uses the "
                "stage-sharded variant: --model lm_pipe")
        if name not in ("lm_pipe", "vit_tiny_pipe"):
            raise ValueError(
                f"--pipe {self.pp}: {cfg.model!r} has no pipeline stages "
                "(the pipelined families are lm_pipe and vit_tiny_pipe)")
        model_kwargs.update(num_stages=self.pp,
                            num_microbatches=cfg.num_microbatches)
        if cfg.pipe_schedule != "gpipe":
            model_kwargs["schedule"] = cfg.pipe_schedule
        if cfg.pipe_schedule == "interleaved":
            model_kwargs["num_virtual"] = cfg.num_virtual

    # ------------------------------------------------------------------ #

    def _build_steps(self) -> None:
        """The per-batch steps, the chunked ones at steps_per_call K > 1
        (K steps a call over stacked host batches; chunked eval for the
        image task, as the reference's), and with device-resident data the
        resident steps over the uploaded corpus."""
        cfg = self.config
        common = dict(label_smoothing=cfg.label_smoothing, seed=cfg.seed,
                      forward=self.forward)
        if self.task == "image":
            common["augment"] = cfg.augment_kind if cfg.augment else False
        k = cfg.steps_per_call
        if self.after_backward is not None:
            common["after_backward"] = self.after_backward
        if self.task == "lm":
            self.train_step = make_lm_train_step(self.model, **common)
            self.eval_step = make_lm_eval_step(self.model)
            chunk_factory = make_chunked_lm_train_step
        else:
            self.train_step = make_train_step(self.model, **common)
            self.eval_step = make_eval_step(self.model)
            chunk_factory = make_chunked_train_step
        self.chunk_step = self.chunk_eval_step = None
        if k > 1:
            self.chunk_step = chunk_factory(self.model, num_steps=k, **common)
            if self.task == "image":
                self.chunk_eval_step = make_chunked_eval_step(
                    self.model, num_steps=k)
        self.resident_train_step = self.resident_eval_step = None
        if self._use_resident_data():
            # this rank's columns of the epoch's global grids
            self._grid_cols = self._batch_shard.local_slice(
                self.global_batch)
            if self.task == "lm":
                window = cfg.seq_len + 1
                self._train_data = {"tokens": self._upload(
                    self.train_loader.corpus.tokens, np.int32)}
                self._eval_data = {"tokens": self._upload(
                    self.eval_loader.corpus.tokens, np.int32)}
                self.resident_train_step = make_resident_lm_train_step(
                    self.model, window=window, **common)
                self.resident_eval_step = make_resident_lm_eval_step(
                    self.model, window=window)
            else:
                self._train_data = {
                    "image": self._upload(self.train_ds.images),
                    "label": self._upload(self.train_ds.labels)}
                self._eval_data = {
                    "image": self._upload(self.eval_ds.images),
                    "label": self._upload(self.eval_ds.labels)}
                self.resident_train_step = make_resident_train_step(
                    self.model, **common)
                self.resident_eval_step = make_resident_eval_step(
                    self.model)
        elif k == -1:
            raise ValueError(
                "steps_per_call=-1 (whole epoch per dispatch) needs "
                "device-resident data; got data_placement="
                f"{cfg.data_placement!r}"
                + (" in a multi-process run"
                   if dist.host_processes() > 1 else "")
                + " — use data_placement='device' (single process) or a "
                "positive steps_per_call")

    def _use_resident_data(self) -> bool:
        """The corpus's home (the reference's rule): 'device' demands it
        (and a single process, which must address the whole corpus);
        'auto' takes it when one process runs and it fits
        `resident_max_bytes` (token streams counted as int32); 'host'
        never. Ranks as threads are one process: each uploads the corpus
        and gathers its own columns of every grid."""
        cfg = self.config
        if cfg.data_placement == "host":
            return False
        multi = dist.host_processes() > 1
        if cfg.data_placement == "device":
            if multi:
                raise ValueError(
                    "data_placement='device' requires a single process: "
                    "the whole corpus must be addressable to upload it; "
                    "multi-process runs stream with data_placement='host'")
            return True
        if self.task == "lm":
            nbytes = 4 * (len(self.train_loader.corpus)
                          + len(self.eval_loader.corpus))
        else:
            nbytes = sum(ds.images.nbytes + ds.labels.nbytes
                         for ds in (self.train_ds, self.eval_ds))
        return not multi and nbytes <= cfg.resident_max_bytes

    def _resident_group(self, total_steps: int) -> int:
        """Steps a dispatch in resident mode: the whole epoch at
        steps_per_call=-1, else the configured K (at least 1). With a
        watchdog the group is capped at `watchdog_probe_every_steps`, as
        the reference's: a probe waits for at most about one group of
        device time (`_probe_if_due`), and a whole-epoch group would make
        every probe an epoch-long wait without a beat."""
        cfg = self.config
        k = cfg.steps_per_call
        g = max(total_steps, 1) if k == -1 else max(k, 1)
        if cfg.watchdog_timeout_s:
            g = min(g, max(cfg.watchdog_probe_every_steps, 1))
        return g

    def _upload(self, array, dtype=None) -> torch.Tensor:
        """A host array on the device, once (the resident corpus and the
        epoch's grids)."""
        return torch.from_numpy(np.array(array, dtype=dtype)).to(
            self.device)

    def _build_lm_data(self, shard):
        """Token loaders: dataset='text' reads bytes from data_dir, anything
        else (or no readable file) takes the synthetic Markov corpus, sized
        so both splits hold at least one global batch. The last 10% of the
        stream is the eval split."""
        cfg = self.config
        window = cfg.seq_len + 1
        batch_tokens = self.global_batch * window
        corpus = None
        if cfg.dataset == "text":
            try:
                corpus = load_text_corpus(cfg.data_dir)
            except FileNotFoundError:
                if dist.is_main_process():
                    log.warning("no readable files under %s — using the "
                                "synthetic Markov corpus", cfg.data_dir)
        if corpus is None:
            corpus = synthetic_token_corpus(
                cfg.synthetic_size or max(262144, 16 * batch_tokens),
                seed=cfg.seed,
            )
        n_eval = max(len(corpus) - int(len(corpus) * 0.9), batch_tokens)
        n_train = len(corpus) - n_eval
        if n_train < batch_tokens:
            raise ValueError(
                f"corpus {corpus.name} has {len(corpus)} tokens — too few "
                f"for one train + one eval batch of {batch_tokens} tokens "
                f"each (global_batch {self.global_batch} x window {window}); "
                "grow the corpus or shrink batch_size/seq_len"
            )
        train_c = TokenCorpus(corpus.tokens[:n_train], corpus.vocab_size,
                              f"{corpus.name}-train")
        eval_c = TokenCorpus(corpus.tokens[n_train:], corpus.vocab_size,
                             f"{corpus.name}-eval")

        def make(c, shuffle):
            return LMDataLoader(
                c, seq_len=cfg.seq_len, global_batch_size=self.global_batch,
                shard=shard, seed=cfg.seed, shuffle=shuffle,
            )

        return (make(train_c, True), make(eval_c, cfg.shuffle_eval),
                corpus.vocab_size)

    def _to_device(self, batch: dict) -> dict:
        """A host batch's arrays on the device: pinned and copied with
        `non_blocking=True` on the card. Tokens and labels become int64
        (images stay uint8 until `prepare_image`)."""
        out = {}
        for key, value in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(value))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[key] = t.long() if key in ("tokens", "label") else t
        return out

    def _device_batches(self, loader):
        """Host batches staged `prefetch` ahead on the device."""
        depth = max(self.config.prefetch, 1)
        staged = collections.deque()
        for batch in loader:
            staged.append(self._to_device(batch))
            if len(staged) > depth:
                yield staged.popleft()
        while staged:
            yield staged.popleft()

    def _tagged_batches(self, loader, k: int):
        """("chunk", K stacked batches) and ("single", batch) on the
        device: chunks when k > 1, single batches otherwise."""
        if k > 1:
            return prefetch_chunked(iter(loader), k, self._to_device,
                                    size=self.config.prefetch)
        return (("single", b) for b in self._device_batches(loader))

    def _track(self) -> None:
        """A rung on the progress ladder after the call just dispatched
        (train/elastic.py `Rung`: an event on the card, resolved at once
        on the CPU)."""
        if self._watchdog is not None:
            self._pending.append(Rung(self.device))

    def _probe_if_due(self, prev: int, cur: int) -> None:
        """The watchdog's probe on confirmed device progress, when due:
        half the timeout without a beat, or a boundary of
        `watchdog_probe_every_steps` crossed between `prev` and `cur`
        (crossing, not modulo: calls advance by K). The probe waits on
        the OLDEST unconfirmed rung, never the newest: the host runs
        ahead of the card, and waiting on the newest would wait for the
        whole in-flight backlog, so a healthy card that is behind would
        look hung. One rung past the last confirmed point waits for at
        most one call of device time, so the watchdog fires exactly when
        no call completes within the timeout. Rungs already done are
        skipped (`future_ready`)."""
        n = self.config.watchdog_probe_every_steps
        if self._watchdog is None or not self._pending:
            return
        if self._watchdog.probe_due() or (n and prev // n != cur // n):
            while len(self._pending) > 1 and future_ready(self._pending[0]):
                self._pending.popleft()
            self._watchdog.probe(self._pending.popleft())

    def _drain_pending(self) -> None:
        """Confirm every remaining rung, beating on each, before an
        end-of-phase fence: the fence waits on the whole backlog, and
        without beats between a healthy card that is behind would look
        hung."""
        if self._watchdog is None:
            self._pending.clear()
            return
        while self._pending:
            self._watchdog.probe(self._pending.popleft())

    def _beat(self) -> None:
        if self._watchdog is not None:
            self._watchdog.beat()

    def _write_metrics(self, record: dict) -> None:
        if self._metrics_fh is None:
            return
        record.setdefault("time", time.time())
        self._metrics_fh.write(json.dumps(record) + "\n")
        self._metrics_fh.flush()

    # ------------------------------------------------------------------ #

    def _profile_window(self, epoch: int):
        """The reference's traced window: a steady-state stretch of epoch
        0, (start, stop) in steps, shrunk to fit a short epoch; None when
        there is nothing to trace."""
        cfg = self.config
        if not cfg.profile_dir or epoch != 0:
            return None
        n = self.train_loader.steps_per_epoch
        if cfg.max_steps_per_epoch:
            n = min(n, cfg.max_steps_per_epoch)
        start = min(10, max(0, n - 10))
        stop = min(start + 10, n)
        if stop <= start:
            log.warning("profile_dir set but the epoch has %d steps: no "
                        "trace", n)
            return None
        return start, stop

    def _trace_edge(self, tracing: bool, window, steps_done: int):
        """Stop the profile window once `steps_done` reaches its end, start
        it once past its start; returns the new (tracing, window)."""
        if tracing and steps_done >= window[1]:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            info0("profile: wrote %s (steps %d-%d)",
                  profiling.stop_capture(), window[0], window[1] - 1)
            return False, None
        if window and not tracing and steps_done >= window[0]:
            return profiling.start_capture(self.config.profile_dir), window
        return tracing, window

    def _close_trace(self) -> None:
        """A short epoch or a failing step: close the open trace."""
        failing = sys.exc_info()[0] is not None
        if not failing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        info0("profile: wrote %s", profiling.stop_capture(swallow=failing))

    def train_epoch(self, epoch: int) -> dict:
        if self.resident_train_step is not None:
            return self._train_epoch_resident(epoch)
        cfg = self.config
        self.train_loader.set_epoch(epoch)
        k = cfg.steps_per_call if self.chunk_step is not None else 1
        timer = Timer()
        steps_done = 0
        final = None
        # host-side step base for the trace's step annotations
        step_base = self.state.step
        window = self._profile_window(epoch)
        tracing = False
        self._pending.clear()
        try:
            for tag, batch in self._tagged_batches(self.train_loader, k):
                if (cfg.max_steps_per_epoch
                        and steps_done >= cfg.max_steps_per_epoch):
                    break
                tracing, window = self._trace_edge(tracing, window,
                                                   steps_done)
                remaining = (cfg.max_steps_per_epoch - steps_done
                             if cfg.max_steps_per_epoch else k)
                with profiling.step_annotation(step_base + steps_done):
                    if tag == "chunk" and remaining >= k:
                        self.state, metrics = self.chunk_step(self.state,
                                                              batch)
                        inc = k
                    elif tag == "chunk":
                        # the step cap cuts the chunk: its head as single
                        # steps, so the cap (and the resume math) is exact
                        for j in range(remaining):
                            self.state, metrics = self.train_step(
                                self.state, {n: v[j] for n, v in
                                             batch.items()})
                        inc = remaining
                    else:
                        self.state, metrics = self.train_step(self.state,
                                                              batch)
                        inc = 1
                prev = steps_done
                steps_done += inc
                final = metrics
                self._after_train_group(epoch, prev, steps_done, metrics)
        finally:
            if tracing:
                self._close_trace()
        return self._close_train_epoch(final, steps_done, timer)

    def _train_epoch_resident(self, epoch: int) -> dict:
        """One epoch against the device-resident corpus: the epoch's index
        grid (DataLoader.epoch_plan, the host path's batches in the host
        path's order) is uploaded once and cut into groups of
        `_resident_group` rows, each one call of the resident step (on
        the card, replays of its graph); the profile window's edges cut
        groups too."""
        cfg = self.config
        self.train_loader.set_epoch(epoch)
        idx, _ = self.train_loader.epoch_plan()
        if cfg.max_steps_per_epoch:
            idx = idx[:cfg.max_steps_per_epoch]
        total = len(idx)
        grid = self._upload(idx[:, self._grid_cols])
        window = self._profile_window(epoch)
        cuts = set(range(0, total, self._resident_group(total)))
        cuts |= {c for c in window or () if c < total}
        bounds = sorted(cuts) + [total]
        timer = Timer()
        step_base = self.state.step
        steps_done = 0
        final = None
        tracing = False
        self._pending.clear()
        try:
            for g0, g1 in zip(bounds, bounds[1:]):
                tracing, window = self._trace_edge(tracing, window, g0)
                with profiling.step_annotation(step_base + g0):
                    self.state, metrics = self.resident_train_step(
                        self.state, self._train_data, grid[g0:g1])
                steps_done = g1
                final = metrics
                self._after_train_group(epoch, g0, g1, metrics)
        finally:
            if tracing:
                self._close_trace()
        return self._close_train_epoch(final, steps_done, timer)

    def _after_train_group(self, epoch: int, prev: int, steps_done: int,
                           metrics: dict) -> None:
        """Bookkeeping after a call that took the epoch from `prev` to
        `steps_done` steps: the progress rung and the watchdog's probe,
        the driver sync check across ranks, the log readback (a beat: it
        confirms progress) and its metrics record, and the periodic
        checkpoint, each where the call crossed its boundary (calls
        advance by K, so the tests are not modulo)."""
        cfg = self.config
        self._track()
        self._probe_if_due(prev, steps_done)
        every = cfg.sync_check_every_steps
        if every and prev // every != steps_done // every:
            # a host counter, not device state: it catches driver-loop
            # drift (skewed data exhaustion, a missed batch)
            assert_in_sync(
                epoch * self.train_loader.steps_per_epoch + steps_done,
                what="driver step")
        if cfg.log_every_steps and (prev // cfg.log_every_steps
                                    != steps_done // cfg.log_every_steps):
            m = {k: float(v) for k, v in metrics.items()}   # readback
            self._beat()
            info0("epoch %d step %d loss %.4f acc %.3f", epoch, steps_done,
                  m["loss"], m["accuracy"])
            self._write_metrics({"kind": "train", "epoch": epoch,
                                 "step": self.state.step, **m})
        every = cfg.checkpoint_every_steps
        if cfg.checkpoint_dir and every and (prev // every
                                             != steps_done // every):
            self.save(periodic=True)

    def _close_train_epoch(self, final, steps_done: int,
                           timer: Timer) -> dict:
        """The epoch's fence (the ladder drained rung by rung, then a
        scalar readback of its last metrics) and its time and images."""
        self._drain_pending()
        if final is not None:
            float(final["loss"])     # fence: the epoch's steps are done
            self._beat()
            self._last_moe = {k: float(v) for k, v in final.items()
                              if k.startswith("moe_")}
        dt = timer.elapsed()
        images = self.global_batch * steps_done
        self._train_images += images
        self._train_seconds += dt
        return {"epoch_seconds": dt, "images": images}

    def evaluate(self) -> float:
        """Held-out accuracy; every rank takes part in the all-reduce of
        the sums. Image task: exact under wrap-padding (weighted counts).
        LM: next-token accuracy, and perplexity (exp of the mean token
        NLL, on `eval_perplexity`). Resident data: grouped grids of the
        eval plan against the resident corpus; host data: K batches a
        call with steps_per_call K > 1 (the image task's chunked eval),
        else one."""
        # an annotation: eval apart from train on the device timeline
        self._pending.clear()
        with profiling.profile_region("eval"):
            if self.resident_eval_step is not None:
                sums = self._evaluate_resident()
            else:
                sums = torch.zeros(2 if self.task == "image" else 3,
                                   device=self.device)
                k = (self.config.steps_per_call
                     if self.chunk_eval_step is not None else 1)
                n_eval = 0
                for tag, batch in self._tagged_batches(self.eval_loader, k):
                    step = (self.chunk_eval_step if tag == "chunk"
                            else self.eval_step)
                    sums += torch.stack(step(self.state, batch))
                    prev, n_eval = n_eval, n_eval + (
                        k if tag == "chunk" else 1)
                    self._track()
                    self._probe_if_due(prev, n_eval)
        self._drain_pending()
        # over the data ranks: a tensor group's ranks hold the same sums,
        # and so do a data replica's seq ranks (the LM eval step sums
        # over them, the ViT pools over them)
        data = mesh_group(self.mesh, MeshConfig.AXIS_DATA)
        if data is not None:
            tdist.all_reduce(sums, op=tdist.ReduceOp.SUM, group=data)
        sums = sums.tolist()    # readback: progress confirmed
        self._beat()
        if self.task == "image":
            correct, total = sums
            return correct / max(total, 1.0)
        correct, total, nll = sums
        t = max(total, 1.0)
        self.eval_perplexity = math.exp(min(nll / t, 30.0))
        return correct / t

    def _evaluate_resident(self) -> torch.Tensor:
        """The eval sums from the resident corpus: the eval plan's grids
        (for images with the zero weights of the wrap-padded tail, so the
        counts equal the host path's) in groups of `_resident_group`
        rows."""
        idx, weight = self.eval_loader.epoch_plan()
        g = self._resident_group(len(idx))
        grid = self._upload(idx[:, self._grid_cols])
        sums = torch.zeros(2 if self.task == "image" else 3,
                           device=self.device)
        if self.task == "image":
            weights = self._upload(weight[:, self._grid_cols])
        for g0 in range(0, len(idx), g):
            if self.task == "image":
                out = self.resident_eval_step(
                    self.state, self._eval_data, grid[g0:g0 + g],
                    weights[g0:g0 + g])
            else:
                out = self.resident_eval_step(self.state, self._eval_data,
                                              grid[g0:g0 + g])
            sums += torch.stack(out)
            self._track()
            self._probe_if_due(g0, min(g0 + g, len(idx)))
        return sums

    def _write_eval_record(self, epoch: int, accuracy: float) -> None:
        record = {"kind": "eval", "epoch": epoch, "step": self.state.step,
                  "accuracy": accuracy}
        if self.eval_perplexity is not None:
            record["perplexity"] = self.eval_perplexity
        self._write_metrics(record)

    def save(self, *, periodic: bool = False) -> None:
        """Checkpoint the current state under `checkpoint_dir` (a no-op
        without one). The previous asynchronous write is waited on first
        (it re-raises its error); `periodic` saves of a single-process
        run write asynchronously unless `checkpoint_async` is off.
        Checkpoint IO is progress, not a hang: it beats the watchdog."""
        self._beat()
        if self._pending_save is not None:
            self._pending_save.wait()
            self._pending_save = None
        cfg = self.config
        if not cfg.checkpoint_dir:
            return
        # what generate.py needs to rebuild the model and the optimizer
        # state's structure without the training command line
        extra = {
            "step": int(self.state.step),
            "precision_policy": cfg.precision_policy().name,
            "model": cfg.model,
            "optimizer": cfg.optimizer,
            "momentum": cfg.momentum,
            "clip_norm": cfg.clip_norm,
            "weight_decay": cfg.weight_decay,
            "accum_steps": cfg.accum_steps,
        }
        if self.task == "lm":
            extra["seq_len"] = cfg.seq_len
            extra["vocab_size"] = self._vocab_size
            extra["remat"] = bool(cfg.remat)
            extra["pos_emb"] = cfg.pos_emb
            extra["tied_embeddings"] = bool(cfg.tied_embeddings)
        if periodic and cfg.checkpoint_async and self.world == 1:
            self._pending_save = ckpt.save_async(cfg.checkpoint_dir,
                                                 self.state, extra=extra)
        else:
            ckpt.save(cfg.checkpoint_dir, self.state, extra=extra)

    def _mfu(self) -> Optional[float]:
        """Analytic train FLOPs per second over the card's peak dense bf16
        rate (per card), or None where either is unknown."""
        if self.device.type != "cuda":
            return None
        peak = flops.chip_peak_flops(torch.cuda.get_device_name(self.device))
        m, name = self.model, self.config.model.lower()
        if self.task == "lm":
            per_sample = flops.lm_train_flops_per_token(
                hidden_dim=m.hidden_dim, depth=m.depth, mlp_dim=m.mlp_dim,
                vocab_size=m.vocab_size, seq_len=self.config.seq_len,
                moe_every=getattr(m, "moe_every", 0),
                moe_top_k=getattr(m, "moe_top_k", 2)) * self.config.seq_len
        else:
            dims = {} if not name.startswith("vit") else dict(
                patch_size=m.patch_size, hidden_dim=m.hidden_dim,
                depth=m.depth, mlp_dim=m.mlp_dim)
            per_sample = flops.train_flops_per_image(
                name, self.train_ds.image_shape, m.num_classes, **dims)
        if not (peak and per_sample and self._train_seconds):
            return None
        rate = per_sample * self._train_images / self._train_seconds
        return rate / (peak * self.world)

    def fit(self) -> dict:
        cfg = self.config
        if cfg.watchdog_timeout_s:
            self._watchdog = StepWatchdog(cfg.watchdog_timeout_s).start()
        try:
            return self._fit_inner()
        finally:
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None
            if self._pending_save is not None:
                # an exception mid-epoch must not leave a writer racing a
                # restarted run's restore; the original exception wins
                try:
                    self._pending_save.wait()
                except Exception:
                    log.exception("async checkpoint write failed")
                self._pending_save = None
            if self._metrics_fh is not None:
                self._metrics_fh.close()
                self._metrics_fh = None

    def _fit_inner(self) -> dict:
        cfg = self.config
        timer = Timer()
        accuracy: Optional[float] = None
        # after a restore, take up the epoch the restored step falls in:
        # lost work is one checkpoint interval, not the run
        steps_per_epoch = self.train_loader.steps_per_epoch
        if cfg.max_steps_per_epoch:
            steps_per_epoch = min(steps_per_epoch, cfg.max_steps_per_epoch)
        start_epoch = min(self.state.step // max(steps_per_epoch, 1),
                          cfg.epochs)
        if start_epoch:
            info0("resuming at epoch %d (step %d)", start_epoch,
                  self.state.step)
        for epoch in range(start_epoch, cfg.epochs):
            info0("=== epoch %d / %d ===", epoch + 1, cfg.epochs)
            self.train_epoch(epoch)
            if cfg.eval_every_epochs and (
                    (epoch + 1) % cfg.eval_every_epochs == 0):
                accuracy = self.evaluate()
                info0("Accuracy is %.2f%%", accuracy * 100.0)
                self._write_eval_record(epoch, accuracy)
            if cfg.checkpoint_every_epochs and (
                    (epoch + 1) % cfg.checkpoint_every_epochs == 0):
                self.save()
        if accuracy is None or not cfg.eval_every_epochs:
            accuracy = self.evaluate()
            self._write_eval_record(cfg.epochs - 1, accuracy)
        self.save()
        elapsed = timer.elapsed()
        ips = self._train_images / max(self._train_seconds, 1e-9)
        summary = {
            "accuracy": accuracy,
            "elapsed_seconds": elapsed,
            "train_seconds": self._train_seconds,
            "images_per_sec": ips,
            "images_per_sec_per_chip": ips / self.world,
            "steps": self.state.step,
            "global_batch": self.global_batch,
            "devices": self.world,
            "mfu": self._mfu(),
            **self._last_moe,
        }
        if self.eval_perplexity is not None:
            summary["perplexity"] = self.eval_perplexity
            summary["tokens_per_sec_per_chip"] = (
                ips * cfg.seq_len / self.world)
            info0("perplexity: %.3f", self.eval_perplexity)
        # the reference's three parity-visible lines
        info0("Accuracy is %.2f%%", accuracy * 100.0)
        info0("time elapsed: %.2fs", elapsed)
        info0("throughput: %.1f images/sec (%.1f /chip)", ips,
              ips / self.world)
        info0("MFU: %s", "not measured (no peak rate for this device)"
              if summary["mfu"] is None else f"{summary['mfu']:.4g}")
        self._write_metrics({"kind": "summary", **summary})
        return summary


def fit(config: TrainConfig) -> dict:
    """Train once, or with checkpoint-based restarts when `max_restarts`
    > 0 (train/elastic.py `run_with_restarts`: each later attempt
    resumes from the newest checkpoint, so a `checkpoint_dir` bounds the
    lost work to one checkpoint interval)."""
    if config.max_restarts > 0:
        return run_with_restarts(
            lambda resume: Trainer(
                config.replace(resume=config.resume or resume)),
            max_restarts=config.max_restarts)
    return Trainer(config).fit()
