"""Pipeline-parallel decoder LM (counterpart of
ddp_practice_tpu/models/pipeline_lm.py): a stage-sharded causal block
stack.

`PipelinedLM` is the embedding (`LMEmbed`: token table and learned
positions, or RoPE inside the blocks), the blocks and the head
(`LMHead`: final LN and the bias-free vocabulary projection, logits
fp32, as the reference's). The blocks are the port's causal
`EncoderBlock` with their leaves STACKED: one parameter a block leaf,
with a leading depth dim, as the reference's vmapped init (`StageStack`:
`blocks.attn.qkv.weight` is (depth, 3 h hd, d)); block k runs as the
one EncoderBlock module called on the leaves' k-th slices
(`torch.func.functional_call`). Laid out over a mesh with a `pipe` axis
(parallel/mesh.py `shard_state`), a rank keeps its stage's slice of each
stacked leaf (its chunks v P + i under the interleaved schedule) and
the model its `PipeGroup` (`pipe`).

`forward` runs GPipe (parallel/pipeline.py; under interleaving V passes
of it, one a chunk): the training forward of the GPipe schedule and the
eval path of every schedule. Without a pipe group every block runs in
order on the whole batch, the reference's `_sequential`. `loss_and_grad`
is the 1F1B and interleaved schedules' training entry point
(parallel/pipeline_1f1b.py), as the reference's: the embedding runs
outside the schedule on stage 0 and closes its backward with the
rescaled cotangents the schedule returns; the head and loss run inside
the last stage's backward ticks; accuracy comes back as scalar counts.

`remat` recomputes in the backward: each GPipe stage application
(`torch.utils.checkpoint` around the stage), each block of the 1F1B
backward ticks and of the sequential path. Microbatching splits the
batch, never the sequence, so causal masking is untouched by the
schedules. `seq_axis` (ring or Ulysses inside each stage's attention)
and the tensor axis compose as in the dense LM. Decode, tied embeddings
and dropout are the dense family's features (the reference's too).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ddp_practice_tpu_torch.models.lm import vocab_embed
from ddp_practice_tpu_torch.models.vit import EncoderBlock, LayerNorm, dense
from ddp_practice_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stages,
)
from ddp_practice_tpu_torch.parallel.tensor import (
    copy_to_tp,
    gather_from_tp,
)


class LMEmbed(nn.Module):
    """Token embedding in the compute dtype plus learned positions (none
    under RoPE). Under sequence parallelism the positions are the
    chunk's (`offset`); under tensor parallelism (`tp`) the table holds
    the rank's vocabulary rows."""

    def __init__(self, vocab_size: int, max_len: int, hidden_dim: int, *,
                 pos_emb: str = "learned", dtype=torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.tok_embed = nn.Embedding(vocab_size, hidden_dim)
        if pos_emb == "learned":
            self.pos_embed = nn.Parameter(torch.zeros(1, max_len, hidden_dim))
        self.tp = None

    def forward(self, tokens: torch.Tensor, offset: int = 0) -> torch.Tensor:
        x = vocab_embed(tokens, self.tok_embed.weight, self.tp, self.dtype)
        if hasattr(self, "pos_embed"):
            s = tokens.shape[1]
            x = x + self.pos_embed[:, offset:offset + s].to(self.dtype)
        return x


class LMHead(nn.Module):
    """Final LN and the bias-free vocabulary projection in the compute
    dtype; logits fp32, as the reference's (its pipeline's psums needed
    fp32; the port keeps the numerics). Under tensor parallelism the
    projection holds the rank's vocabulary outputs, gathered whole."""

    def __init__(self, hidden_dim: int, vocab_size: int, *,
                 dtype=torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.ln_f = LayerNorm(hidden_dim, dtype)
        self.lm_head = nn.Linear(hidden_dim, vocab_size, bias=False)
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_tp(self.ln_f(x), self.tp)
        return gather_from_tp(dense(x, self.lm_head, self.dtype),
                              self.tp).float()


def stack_leaves(block: nn.Module, depth: int) -> nn.Module:
    """`block` with each parameter replaced by a (depth, ...) stack of
    zeros (`models.init_weights` draws them per block)."""
    for mod in block.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, name, nn.Parameter(
                p.new_zeros((depth,) + tuple(p.shape)),
                requires_grad=p.requires_grad))
    return block


class StageStack(nn.Module):
    """What the pipelined families share: the stacked `blocks`, the stage
    layout `block_stack` = (V, P, L) (virtual chunks, stages, blocks a
    chunk) and the ways of running them. A subclass builds `blocks`
    (`stack_leaves`) and calls `_init_stack`."""

    def _init_stack(self, *, depth: int, num_stages: int, num_virtual: int,
                    num_microbatches: int, remat: bool) -> None:
        if depth % max(num_stages * num_virtual, 1):
            raise ValueError(f"depth {depth} % logical stages "
                             f"{num_stages * num_virtual} != 0")
        self.depth = depth
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.remat = remat
        self.block_stack = (num_virtual, num_stages,
                            depth // (num_stages * num_virtual))
        self._names = [n for n, _ in self.blocks.named_parameters()]
        # this rank's stage (parallel/mesh.py shard_state)
        self.pipe = None

    @property
    def num_virtual(self) -> int:
        return self.block_stack[0]

    def _block(self, x: torch.Tensor, *leaves) -> torch.Tensor:
        return torch.func.functional_call(
            self.blocks, dict(zip(self._names, leaves)), (x,))

    def _run(self, x: torch.Tensor, leaves: list,
             per_block_remat: bool) -> torch.Tensor:
        """The blocks of `leaves` (each block leaf stacked, in the
        `blocks` parameters' order) on x, in order, each checkpointed
        when `per_block_remat` (and grads are on)."""
        per_block = zip(*(leaf.unbind(0) for leaf in leaves))
        remat = per_block_remat and torch.is_grad_enabled()
        for args in per_block:
            x = (checkpoint(self._block, x, *args, use_reentrant=False)
                 if remat else self._block(x, *args))
        return x

    def stage(self, x: torch.Tensor, chunk: int = 0, *,
              per_block_remat: bool = False) -> torch.Tensor:
        """This rank's chunk `chunk` of blocks on x (its whole stage when
        V = 1), fp32 out (the pipeline's boundary dtype)."""
        chunks = stack_stages(dict(self.blocks.named_parameters()),
                              self.num_virtual)
        return self._run(x, [c[chunk] for c in chunks.values()],
                         per_block_remat).float()

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """The block stack on x: in order without a pipe group (the
        reference's `_sequential`), else GPipe, once per chunk."""
        if self.pipe is None:
            return self._run(x, list(self.blocks.parameters()), self.remat)
        for v in range(self.num_virtual):
            x = pipeline_apply(lambda xx, v=v: self.stage(xx, v), x,
                               pipe=self.pipe,
                               num_microbatches=self.num_microbatches,
                               remat=self.remat)
        return x


class PipelinedLM(StageStack):
    """The reference's PipelinedLM (its defaults, lm_tiny's dims), its
    errors kept: an unknown `pos_emb` or `schedule`, a depth the logical
    stages do not divide."""

    def __init__(self, *, vocab_size: int = 256, max_len: int = 2048,
                 hidden_dim: int = 256, depth: int = 4, num_heads: int = 8,
                 mlp_dim: int = 1024, dtype=torch.float32,
                 param_dtype=torch.float32, num_stages: int = 1,
                 num_microbatches: int = 4, remat: bool = True,
                 pos_emb: str = "learned", seq_axis: Optional[str] = None,
                 sp_impl: str = "ring", attn_impl: str = "xla",
                 schedule: str = "gpipe", num_virtual: int = 2) -> None:
        super().__init__()
        if pos_emb not in ("learned", "rope"):
            raise ValueError(f"unknown pos_emb {pos_emb!r}")
        if schedule not in ("gpipe", "1f1b", "interleaved"):
            raise ValueError(
                f"unknown schedule {schedule!r} (gpipe|1f1b|interleaved)")
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.dtype = dtype
        self.pos_emb = pos_emb
        self.schedule = schedule
        self.seq_axis = seq_axis
        self.sp = None
        self.embed = LMEmbed(vocab_size, max_len, hidden_dim,
                             pos_emb=pos_emb, dtype=dtype)
        self.blocks = stack_leaves(EncoderBlock(
            hidden_dim, num_heads, mlp_dim, dtype=dtype, seq_axis=seq_axis,
            sp_impl=sp_impl, attn_impl=attn_impl, causal=True,
            rope=pos_emb == "rope"), depth)
        self.head = LMHead(hidden_dim, vocab_size, dtype=dtype)
        self._init_stack(depth=depth, num_stages=num_stages,
                         num_virtual=num_virtual if schedule == "interleaved"
                         else 1, num_microbatches=num_microbatches,
                         remat=remat)
        self.to(param_dtype)

    def _offset(self, s: int) -> int:
        return 0 if self.sp is None else self.sp.offset(s)

    def _check_len(self, s: int) -> None:
        total = s if self.sp is None else s * self.sp.size
        if total > self.max_len:
            raise ValueError(
                f"sequence {total} exceeds max_len {self.max_len}")

    def forward(self, tokens: torch.Tensor, *, train: bool = False,
                dropout_key=None) -> torch.Tensor:
        """tokens (b, s) -> fp32 logits (b, s, vocab) on every rank (the
        rank's chunk of the sequence under `sp`). `train` and
        `dropout_key` are the step's interface; the pipelined blocks
        have no dropout."""
        self._check_len(tokens.shape[1])
        x = self.embed(tokens, self._offset(tokens.shape[1]))
        return self.head(self.run_blocks(x))

    def loss_and_grad(self, inputs: torch.Tensor, targets: torch.Tensor, *,
                      weight: Optional[torch.Tensor] = None,
                      label_smoothing: float = 0.0,
                      with_accuracy: bool = True):
        """(loss, counts) of the 1F1B or interleaved schedule, the grads
        of the mean loss left in every parameter's `.grad`; `counts` is
        {"correct", "total"} (None without `with_accuracy`). The schedule
        differentiates the loss SUM: it is divided by the weight sum (at
        least 1; under `sp` the chunk's share of the whole sequences'),
        the stage's and head's grads rescaled by the same and the
        embedding's backward closed with the rescaled cotangents. The
        embed grads (stage 0's) and the head grads (the last stage's)
        are then summed over the pipe group, so every stage ends with
        them, as the reference's psums leave them."""
        from ddp_practice_tpu_torch.ops.losses import (
            accuracy_counts,
            cross_entropy_sum,
        )
        from ddp_practice_tpu_torch.parallel.fsdp import sum_over
        from ddp_practice_tpu_torch.parallel.pipeline_1f1b import (
            pipeline_1f1b_loss_and_grad,
            pipeline_interleaved_loss_and_grad,
        )

        M = self.num_microbatches
        b, s = inputs.shape
        if b % M:
            raise ValueError(f"batch {b} not divisible by microbatches {M}")
        self._check_len(s)
        pipe, sp = self.pipe, self.sp
        first = pipe is None or pipe.first
        if weight is None:
            weight = torch.ones((b, s), device=inputs.device)
        x = xs = None
        if first:
            x = self.embed(inputs, self._offset(s))
            xs = x.detach().float().reshape(
                (M, b // M) + tuple(x.shape[1:])).unbind(0)
        keys = ("weight", "correct", "total") if with_accuracy else (
            "weight",)

        def head_loss(y, tgt, wgt):
            logits = self.head(y)
            loss_sum, wsum = cross_entropy_sum(
                logits, tgt, weight=wgt, label_smoothing=label_smoothing)
            aux = {"weight": wsum}
            if with_accuracy:
                correct, total = accuracy_counts(logits, tgt, weight=wgt)
                aux.update(correct=correct, total=total)
            return loss_sum, aux

        def stage_fn(xx, chunk):
            return self.stage(xx, chunk, per_block_remat=self.remat)

        common = dict(pipe=pipe, mb_shape=(b // M, s, self.hidden_dim),
                      device=inputs.device, aux_keys=keys)
        tg = targets.reshape(M, b // M, s).unbind(0)
        wg = weight.float().reshape(M, b // M, s).unbind(0)
        if self.schedule == "interleaved":
            loss_sum, aux, dxs = pipeline_interleaved_loss_and_grad(
                stage_fn, head_loss, xs, tg, wg,
                num_virtual=self.num_virtual, **common)
        else:
            loss_sum, aux, dxs = pipeline_1f1b_loss_and_grad(
                stage_fn, head_loss, xs, tg, wg, **common)
        wsum = aux["weight"]
        if sp is not None:
            wsum = sum_over([wsum.clone()], sp.group)[0] / sp.size
        scale = 1.0 / torch.clamp(wsum, min=1.0)
        if first:
            x.backward((torch.stack(dxs) * scale).reshape(x.shape).to(
                x.dtype))
        with torch.no_grad():
            for p in [*self.blocks.parameters(), *self.head.parameters()]:
                if p.grad is not None:
                    p.grad.mul_(scale)
            if pipe is not None:
                shared: List[nn.Parameter] = [*self.embed.parameters(),
                                              *self.head.parameters()]
                for p in shared:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                sum_over([p.grad for p in shared], pipe.group)
        counts = ({"correct": aux["correct"], "total": aux["total"]}
                  if with_accuracy else None)
        return loss_sum * scale, counts
