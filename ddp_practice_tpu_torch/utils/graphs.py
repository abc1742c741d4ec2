"""K steps a dispatch on the card: one step captured as a CUDA graph and
replayed (no reference counterpart; the port's analogue of the
reference's K steps compiled as one `lax.scan` program, train/steps.py).

`StepGraph` runs a step function over the rows of a group: rows of an
index grid (the device-resident steps) or of K stacked batches (the
chunked steps). Where `graphed` allows it, it captures one unit of the
step (one optimizer apply: `accum_steps` micro-steps; one batch for
eval) as a `torch.cuda.CUDAGraph` that reads its rows from a static
device buffer through a device-side row cursor, which the graph
advances; a group of G rows is then G / unit replays with no other host
work. Elsewhere it runs the same step eagerly, row by row, by the rule
`eager_reason` writes down; where the rule captures, nothing falls back:
a step that cannot be captured raises `CaptureError` naming the line of
the op.

The capture rule (`eager_reason`): a step is captured on the card when
the world is one process, or ranks of NCCL process groups, one process a
card, whatever the layout: NCCL's kernels are stream work a graph
records (DDP's bucketed all-reduces, the Megatron all-reduces of
parallel/tensor.py, the expert group's sum, Ulysses' all-to-alls, the
pipeline's and the ring's hops, FSDP2's all-gathers and reduce-scatters,
`DataShards`' gather and reduce-scatter, the metrics' all-reduce). On
four cards DDP (lm_base, the ConvNet, ResNet-50), tensor 4, FSDP2, seq 4
ring and Ulysses, expert 4, pipe 4 1F1B and pipe 2 x data 2 with FSDP
were captured and replayed bit for bit against their eager steps
(experiments/parallel_step.py `--pairs`). It runs eagerly
- on the CPU (a CPU tensor: nothing to capture);
- under gloo, whose collectives run on the host;
- for ranks as threads (parallel/threads.py), whose collectives are host
  copies that rank 0's thread makes between device-wide synchronisations.

Under several processes the first `WARMUP` units run eagerly before the
capture (PyTorch's notes on CUDA graphs ask 11 eager iterations of a
DDP whose backward is captured: its reducer rebuilds its buckets after
the first and times the first ten with CUDA events read on the host;
parallel/mesh.py builds the DDP on a side stream, the notes' other
ask). The host work of DDP's hooks runs once, in the capture, and never
in a replay.

Capture rules:
- a unit is captured right after a real, eager unit of the same group
  (it counts), so SGD's momentum buffers and Adam's moments exist, every
  kernel is built (ops/cuda_build.py) and cuDNN has chosen its
  algorithms;
- it is captured again whenever a tensor it reads has been rebound: the
  graph bakes addresses, so a signature of the data pointers of the
  parameters, buffers, optimizer state, device counters and the bound
  inputs (the resident corpus) is compared before every group (a
  restore rebinds the optimizer state; a larger group reallocates the
  row buffer);
- rows a group has before an apply boundary (the optimizer mid
  accumulation) and after the last whole unit run through the same step
  eagerly.

The Python side of a step (`TrainState.step`, `Optimizer.applies` and
`micro`, the device counters' mirrors, the kernels' `LAUNCHES` counts)
runs once during a capture, which executes nothing, and never during a
replay: the capture pass's increments are undone, and each replay adds
the unit's increments to them, except the launch counts, which go to
`REPLAYED` (a kernel's launches on a path are its `LAUNCHES` count plus
its `REPLAYED` count; `reset_replayed` zeroes it). The outputs a graph
writes (the unit's last metrics, an eval sum) are static: each call
returns a copy.
"""

from __future__ import annotations

import collections
import os
import traceback
from typing import Optional

import torch
import torch.distributed as tdist

from ddp_practice_tpu_torch.parallel import dist

# kernel name -> launches made by graph replays (not by the wrappers)
REPLAYED: collections.Counter = collections.Counter()

# the Python counters a step advances: (owner, attribute)
_COUNTERS = (("state", "step"), ("state", "_step_at"),
             ("optimizer", "applies"), ("optimizer", "micro"),
             ("optimizer", "_applies_at"))

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reset_replayed() -> None:
    REPLAYED.clear()


class CaptureError(RuntimeError):
    """A step that cannot run as a CUDA graph (a host read of a device
    value, a synchronising call, an allocation outside the caching
    allocator): the message names the line of the op."""


# eager units before the first capture when several processes run
WARMUP = 11


def eager_reason(model) -> Optional[str]:
    """Why steps of `model` run eagerly, row by row; None when they are
    captured and replayed (the module docstring's rule)."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        return "a CPU tensor: nothing to capture"
    if dist.process_count() == 1:
        return None
    backend = tdist.get_backend()
    if backend == "threaded":
        return ("ranks as threads: the threaded group's collectives are "
                "host copies made by rank 0's thread between device-wide "
                "synchronisations")
    if backend != "nccl":
        return f"the {backend} group runs its collectives on the host"
    return None


def graphed(model) -> bool:
    """Whether steps of `model` run as graph replays (`eager_reason`)."""
    return eager_reason(model) is None


def _launch_counters() -> list:
    from ddp_practice_tpu_torch.ops import (
        decode_attention,
        flash_attention,
        fused_encoder,
        grouped_matmul,
    )

    return [decode_attention.LAUNCHES, flash_attention.LAUNCHES,
            flash_attention.VARIANT_LAUNCHES, fused_encoder.LAUNCHES,
            grouped_matmul.LAUNCHES]


def _counters(state) -> dict:
    """The state's Python counters (none for an eval step's None)."""
    if state is None:
        return {}
    owners = {"state": state, "optimizer": state.optimizer}
    return {(o, a): getattr(owners[o], a) for o, a in _COUNTERS}


def _set_counters(state, values: dict) -> None:
    if state is None:
        return
    owners = {"state": state, "optimizer": state.optimizer}
    for (o, a), v in values.items():
        setattr(owners[o], a, v)


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(v) for v in out)
    return out


def _signature(model, state, bind) -> tuple:
    """Data pointers of every tensor a captured step reads in place."""
    tensors = [*model.parameters(), *model.buffers(), *bind]
    if state is not None:
        opt = state.optimizer
        tensors += [opt.lr, opt.lr_table, opt._applies_t, state._step_t,
                    *(opt.acc or ())]
        for p in opt.params:
            tensors += [v for v in opt.inner.state.get(p, {}).values()
                        if isinstance(v, torch.Tensor)]
    return tuple(0 if t is None else t.data_ptr() for t in tensors)


def _where(exc: BaseException) -> str:
    """The innermost line of the port's own code (this module aside) in
    the traceback of `exc` or of an exception it was raised over."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        frames = [f for f in traceback.extract_tb(exc.__traceback__)
                  if f.filename.startswith(_PACKAGE)
                  and os.path.abspath(f.filename) != os.path.abspath(
                      __file__)]
        if frames:
            f = frames[-1]
            rel = os.path.relpath(f.filename, os.path.dirname(_PACKAGE))
            return (f"{rel}:{f.lineno} in {f.name}: `{f.line}` "
                    f"({type(exc).__name__}: {exc})")
        exc = exc.__cause__ or exc.__context__
    return "no line of the port in the traceback"


class StepGraph:
    """One step's CUDA graph and its static row buffer (see the module
    docstring): the steps of `model`. `name` labels errors; `replays` and
    `captures` count what this instance did."""

    def __init__(self, name: str, model):
        self.name = name
        self.model = model
        self.graph = None
        self.stream = None
        self.rows = None          # static (capacity, ...) row buffers
        self.cursor = None        # the next row a replay reads
        self.out = None           # the unit's static outputs
        self.unit = None
        self.signature = None
        self.delta = {}           # the unit's Python counter increments
        self.unit_launches = {}   # kernel launches a replay makes
        self.replays = 0
        self.captures = 0
        self.warm = 0             # eager units run so far

    def __call__(self, state, rows: dict, step, *, unit: int = 1,
                 bind=()):
        """Run `step(state, row) -> (state, out)` over the leading rows of
        `rows` (a dict of tensors with one leading dim); returns the state
        and the last row's `out`. `unit` rows make one graph; `bind` are
        the other tensors the step reads (their addresses are baked). An
        eval step's state may be None: it advances no counter."""
        n = len(next(iter(rows.values())))
        out = None
        if not graphed(self.model):
            for i in range(n):
                state, out = step(state, {k: v[i] for k, v in rows.items()})
            return state, out
        if state is not None:
            state.sync_device()
        self._stage(rows, n)
        buf = self.rows

        def eager(i, count):
            nonlocal state, out
            for j in range(i, i + count):
                state, out = step(state, {k: v[j] for k, v in buf.items()})
            return i + count

        # finish an apply the optimizer is in the middle of
        micro = 0 if state is None else state.optimizer.micro
        i = eager(0, min(n, -micro % unit))
        if n - i >= unit:
            if (self.graph is None or unit != self.unit
                    or _signature(self.model, state, bind)
                    != self.signature):
                # eager units first (WARMUP of them under several
                # processes, else one), the capture right after the last
                self.graph = None
                need = max((WARMUP if dist.process_count() > 1 else 1)
                           - self.warm, 1)
                while need and n - i >= unit:
                    i = eager(i, unit)
                    self.warm += 1
                    need -= 1
                if need == 0:
                    self._capture(state, step, unit, bind)
            reps = (n - i) // unit if self.graph is not None else 0
            if reps:
                out = self._replay(state, i, reps)
                i += reps * unit
        eager(i, n - i)
        return state, out

    def _stage(self, rows: dict, n: int) -> None:
        """Copy the group's rows into the static buffer (a new, larger or
        reshaped buffer drops the graph that read the old one)."""
        device = next(self.model.parameters()).device
        buf = self.rows
        if (buf is None or set(buf) != set(rows) or any(
                buf[k].shape[0] < n or buf[k].shape[1:] != v.shape[1:]
                or buf[k].dtype != v.dtype for k, v in rows.items())):
            self.rows = {k: torch.empty((n,) + tuple(v.shape[1:]),
                                        dtype=v.dtype, device=device)
                         for k, v in rows.items()}
            self.graph = None
        for k, v in rows.items():
            self.rows[k][:n].copy_(v, non_blocking=True)

    def _capture(self, state, step, unit: int, bind) -> None:
        device = next(self.model.parameters()).device
        if self.cursor is None:
            self.cursor = torch.zeros((), dtype=torch.int64, device=device)
            self.stream = torch.cuda.Stream(device)
        before = _counters(state)
        counts = _launch_counters()
        launches = [dict(c) for c in counts]
        cursor, buf = self.cursor, self.rows

        def row():
            r = {k: v.index_select(0, cursor.view(1)).squeeze(0)
                 for k, v in buf.items()}
            cursor.add_(1)
            return r

        self.graph = None
        graph = torch.cuda.CUDAGraph()
        caller = torch.cuda.current_stream(device)
        try:
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                out = None
                for _ in range(unit):
                    state, out = step(state, row())
        except Exception as exc:
            # a failed capture_end skips torch's own stream restore
            torch.cuda.set_stream(caller)
            raise CaptureError(
                f"the {self.name} step cannot be captured as a CUDA graph: "
                f"{_where(exc)}") from exc
        finally:
            after = _counters(state)
            _set_counters(state, before)
            grown = [{k: c[k] - b.get(k, 0) for k in c}
                     for c, b in zip(counts, launches)]
            for c, b in zip(counts, launches):
                c.clear()
                c.update(b)
        self.delta = {k: after[k] - before[k] for k in before}
        self.unit_launches = {k: v for g in grown for k, v in g.items()
                              if v}
        self.graph, self.out, self.unit = graph, out, unit
        self.signature = _signature(self.model, state, bind)
        self.captures += 1

    def _replay(self, state, i: int, reps: int):
        before = _counters(state)
        self.cursor.fill_(i)
        for _ in range(reps):
            self.graph.replay()
        _set_counters(state, {k: v + reps * self.delta[k]
                              for k, v in before.items()})
        for name, n in self.unit_launches.items():
            REPLAYED[name] += n * reps
        self.replays += reps
        return _clone(self.out)
