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

Batches stream from the host: each is pinned and copied with
`non_blocking=True`, `prefetch` batches ahead of the step. The reference's
`data_placement="auto"` picks its device-resident path when the corpus
fits; the port's "auto" means host (the same batches; the resident path is
ROADMAP A3). The step's metrics stay on the device and are read back only
at log steps and at the end of an epoch, so the host runs ahead of the
card between them.

Data parallelism: run one process per card under torchrun (or pass
`coordinator_address`, `num_processes` and `process_id`); the global batch
is `batch_size x world size`, each rank takes `ShardSpec.local_slice` of
every global batch, the model runs wrapped in DistributedDataParallel, and
eval sums are all-reduced. `fused_encoder` ("auto" | "on" | "off") is the
reference's flag: "on" forces the fused encoder layer and raises for a
model that does not take it or a shape the kernels refuse. The image task
trains the ConvNet (the default: `convnet` on `mnist`, its BatchNorm
statistics averaged over the ranks, so DDP does not broadcast buffers
for it) and the image transformers (vit_tiny, vit_base, vit_tiny_moe);
resnet* raise (ROADMAP A2). `num_experts` and `moe_router` pass to the MoE
families as the reference's loop passes them (expert choice sets the
capacity factor to 1.0 unless given), and the summary gains the last
step's `moe_load_max`, `moe_load_min` and `moe_drop_rate`.

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
`python -m ddp_practice_tpu_torch.utils.xprof DIR STEPS`): every step runs
under a `train#<step>` annotation and eval under an "eval" one, the trace
stops after a `torch.cuda.synchronize()` at the window's end, and a short
or failing epoch closes it on the way out.
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

import ddp_practice_tpu_torch.checkpoint as ckpt
from ddp_practice_tpu_torch.config import TrainConfig, resolve_device
from ddp_practice_tpu_torch.data.datasets import load_dataset
from ddp_practice_tpu_torch.data.loader import DataLoader
from ddp_practice_tpu_torch.data.lm_corpus import (
    LMDataLoader,
    TokenCorpus,
    load_text_corpus,
    synthetic_token_corpus,
)
from ddp_practice_tpu_torch.data.sharding import ShardSpec
from ddp_practice_tpu_torch.models import accepts_fused, create_model
from ddp_practice_tpu_torch.models import _NOT_PORTED as _MODELS_NOT_PORTED
from ddp_practice_tpu_torch.parallel import dist
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
from ddp_practice_tpu_torch.train.steps import (
    make_eval_step,
    make_lm_eval_step,
    make_lm_train_step,
    make_train_step,
)
from ddp_practice_tpu_torch.ops.batchnorm import BatchNorm
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
        self.dp = config.mesh.resolve(self.world)
        self.global_batch = config.batch_size * self.dp
        self.task = "lm" if config.model.lower().startswith("lm") else "image"
        name = config.model.lower()
        if name in _MODELS_NOT_PORTED:
            raise NotImplementedError(
                f"--model {config.model}: not ported yet (ROADMAP "
                f"{_MODELS_NOT_PORTED[name]}); the port trains the "
                f"ConvNet, the decoder LMs (lm_tiny, lm_base, lm_moe) and "
                f"the image transformers (vit_tiny, vit_base, "
                f"vit_tiny_moe)")
        shard = ShardSpec(dist.process_index(), self.world)
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
        if name == "convnet":
            for flag, what in ((config.num_heads, "--num_heads"),
                               (config.dropout, "--dropout"),
                               (config.attn_impl != "xla", "--attn_impl"),
                               (config.num_experts, "--num_experts")):
                if flag:
                    raise ValueError(f"{what} applies to the transformer "
                                     "families, not 'convnet'")
        if config.num_heads:
            model_kwargs["num_heads"] = config.num_heads
        if config.dropout:
            if not 0.0 < config.dropout < 1.0:
                raise ValueError(
                    f"--dropout must be in [0, 1), got {config.dropout}")
            model_kwargs["dropout_rate"] = config.dropout
        if config.attn_impl != "xla":
            model_kwargs["attn_impl"] = config.attn_impl
        if config.num_experts:
            model_kwargs["num_experts"] = config.num_experts
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
        if config.remat:
            model_kwargs["remat"] = True
        if config.pos_emb != "learned":
            model_kwargs["pos_emb"] = config.pos_emb
        if config.tied_embeddings:
            model_kwargs["tied_embeddings"] = True
        self.model = create_model(config.model,
                                  policy=config.precision_policy(),
                                  device=self.device, seed=config.seed,
                                  **model_kwargs)
        self.forward = self.model
        if self.world > 1:
            from torch.nn.parallel import DistributedDataParallel

            # BatchNorm's statistics are all-reduced (SyncBN): every rank
            # holds the same running buffers, so DDP's per-forward
            # broadcast of rank 0's would move nothing
            synced = any(isinstance(m, BatchNorm)
                         for m in self.model.modules())
            self.forward = DistributedDataParallel(
                self.model,
                device_ids=([self.device.index]
                            if self.device.type == "cuda" else None),
                broadcast_buffers=not synced)
        optimizer = make_optimizer(config, self.model,
                                   self.train_loader.steps_per_epoch,
                                   self.world)
        self.state = TrainState(step=0, model=self.model,
                                optimizer=optimizer)
        if (config.resume and config.checkpoint_dir
                and ckpt.exists(config.checkpoint_dir)):
            self.state = ckpt.restore(config.checkpoint_dir, self.state)
            info0("resumed from %s at step %d", config.checkpoint_dir,
                  self.state.step)
        self._pending_save: Optional[ckpt.AsyncSave] = None
        if self.task == "lm":
            self.train_step = make_lm_train_step(
                self.model, label_smoothing=config.label_smoothing,
                seed=config.seed, forward=self.forward)
            self.eval_step = make_lm_eval_step(self.model)
        else:
            self.train_step = make_train_step(
                self.model, label_smoothing=config.label_smoothing,
                seed=config.seed, augment=config.augment,
                forward=self.forward)
            self.eval_step = make_eval_step(self.model)
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

    # ------------------------------------------------------------------ #

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

    def train_epoch(self, epoch: int) -> dict:
        cfg = self.config
        self.train_loader.set_epoch(epoch)
        timer = Timer()
        steps_done = 0
        final = None
        # host-side step base for the trace's step annotations
        step_base = self.state.step
        window = self._profile_window(epoch)
        tracing = False
        try:
            for batch in self._device_batches(self.train_loader):
                if (cfg.max_steps_per_epoch
                        and steps_done >= cfg.max_steps_per_epoch):
                    break
                if tracing and steps_done >= window[1]:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    tracing = False
                    info0("profile: wrote %s (steps %d-%d)",
                          profiling.stop_capture(), window[0], window[1] - 1)
                    window = None
                if window and not tracing and steps_done >= window[0]:
                    tracing = profiling.start_capture(cfg.profile_dir)
                with profiling.step_annotation(step_base + steps_done):
                    self.state, metrics = self.train_step(self.state, batch)
                prev = steps_done
                steps_done += 1
                final = metrics
                if cfg.log_every_steps and (
                        prev // cfg.log_every_steps
                        != steps_done // cfg.log_every_steps):
                    m = {k: float(v) for k, v in metrics.items()}  # readback
                    info0("epoch %d step %d loss %.4f acc %.3f", epoch,
                          steps_done, m["loss"], m["accuracy"])
                    self._write_metrics({"kind": "train", "epoch": epoch,
                                         "step": self.state.step, **m})
                every = cfg.checkpoint_every_steps
                if cfg.checkpoint_dir and every and (
                        prev // every != steps_done // every):
                    self.save(periodic=True)
        finally:
            if tracing:   # a short epoch or a failing step: close the trace
                failing = sys.exc_info()[0] is not None
                if not failing and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                info0("profile: wrote %s",
                      profiling.stop_capture(swallow=failing))
        if final is not None:
            float(final["loss"])     # fence: the epoch's steps are done
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
        NLL, on `eval_perplexity`)."""
        sums = torch.zeros(2 if self.task == "image" else 3,
                           device=self.device)
        # an annotation: eval apart from train on the device timeline
        with profiling.profile_region("eval"):
            for batch in self._device_batches(self.eval_loader):
                sums += torch.stack(self.eval_step(self.state, batch))
        if self.task == "image":
            correct, total = dist.all_reduce_sum(sums).tolist()
            return correct / max(total, 1.0)
        correct, total, nll = dist.all_reduce_sum(sums).tolist()
        t = max(total, 1.0)
        self.eval_perplexity = math.exp(min(nll / t, 30.0))
        return correct / t

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
        run write asynchronously unless `checkpoint_async` is off."""
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
                moe_every=m.moe_every,
                moe_top_k=m.moe_top_k) * self.config.seq_len
        else:
            dims = {} if name == "convnet" else dict(
                patch_size=m.patch_size, hidden_dim=m.hidden_dim,
                depth=m.depth, mlp_dim=m.mlp_dim)
            per_sample = flops.train_flops_per_image(
                name, self.train_ds.image_shape, self.train_ds.num_classes,
                **dims)
        if not (peak and per_sample and self._train_seconds):
            return None
        rate = per_sample * self._train_images / self._train_seconds
        return rate / (peak * self.world)

    def fit(self) -> dict:
        try:
            return self._fit_inner()
        finally:
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
    """Train once (`resume` takes up a checkpoint; automatic restarts,
    `max_restarts`, are ROADMAP A8)."""
    return Trainer(config).fit()
