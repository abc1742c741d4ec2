"""Interleaved-1F1B schedule tables (virtual pipeline stages); a copy of
ddp_practice_tpu/parallel/interleave.py, plain Python and numpy.

Megatron-LM's interleaved schedule (Narayanan et al. 2021, section 2.2)
cuts the pipeline bubble by a factor of V: each rank holds V CHUNKS of
layers (logical stage s = v*P + i on rank i), so the fill/drain ramp
costs P ticks per chunk instead of P*V ticks for the whole depth.

`build_tables` GENERATES the schedule: a greedy dependency-respecting
list scheduler over Megatron's op ORDER gives constant (T, P) int32
tables, op kind/chunk/microbatch per rank per tick. `simulate()` replays
them against the data dependencies (every F/B exactly once, every input
produced >= 1 tick before use). The executor
(parallel/pipeline_1f1b.py `pipeline_interleaved_loss_and_grad`) walks the
tables: schedule correctness and executor correctness are tested apart.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Tables:
    """Constant schedule tables, all (T, P) int32. kind: 0 = idle,
    1 = forward, 2 = backward; chunk/mb meaningful where kind != 0."""

    kind: np.ndarray
    chunk: np.ndarray
    mb: np.ndarray

    @property
    def ticks(self) -> int:
        return self.kind.shape[0]

    def bubble_fraction(self) -> float:
        """Idle device-ticks over total device-ticks."""
        return float((self.kind == 0).mean())


def _megatron_op_order(P: int, V: int, M: int, i: int) -> List[Tuple]:
    """Device i's op sequence: ('F'|'B', chunk v, microbatch m), in
    Megatron's interleaved order — microbatches in groups of P,
    chunk-major within a group for forwards; warmup of
    2*(P-1-i) + (V-1)*P forwards, then 1F1B, then backward cooldown."""
    n_ops = M * V

    def f_id(k):  # k-th forward: group-of-P, chunk-major
        g, r = divmod(k, P * V)
        v, p = divmod(r, P)
        return ("F", v, g * P + p)

    def b_id(k):  # k-th backward: same order, chunks reversed
        g, r = divmod(k, P * V)
        v, p = divmod(r, P)
        return ("B", V - 1 - v, g * P + p)

    warmup = min((P - 1 - i) * 2 + (V - 1) * P, n_ops)
    ops: List[Tuple] = [f_id(k) for k in range(warmup)]
    nf, nb = warmup, 0
    # steady state: one F then one B per iteration (Megatron's
    # forward_step-then-backward_step loop); cooldown drains the Bs
    while nb < n_ops:
        if nf < n_ops:
            ops.append(f_id(nf))
            nf += 1
        ops.append(b_id(nb))
        nb += 1
    return ops


def build_tables(P: int, V: int, M: int) -> Tables:
    """Greedy list-schedule of the Megatron op order into global ticks.

    An op executes at tick t when its data dependency was PRODUCED at a
    tick < t (activations/cotangents hop between devices at tick
    boundaries via ppermute): F(v, m) on device i needs F(v, m) on
    i-1 (same chunk), or F(v-1, m) on device P-1 when i == 0 (chunk
    boundary — the ring wrap carries it); chunk 0 on device 0 reads the
    host input, always ready. B(v, m) on i needs B(v, m) on i+1, or
    B(v+1, m) on device 0 when i == P-1; the last stage's head
    additionally needs its own F(V-1, m) done (the stash holds x).
    Every device also needs its own F(v, m) before B(v, m)."""
    if M % P:
        raise ValueError(
            f"interleaved schedule needs microbatches ({M}) divisible by "
            f"pipe ({P}) — Megatron's group-of-P round robin"
        )
    orders = [_megatron_op_order(P, V, M, i) for i in range(P)]
    pos = [0] * P
    done: dict = {}
    kind_rows, chunk_rows, mb_rows = [], [], []
    t = 0
    guard = 10 * (M * V * 2 + 4 * P * V)
    while any(pos[i] < len(orders[i]) for i in range(P)):
        krow, crow, mrow = [0] * P, [0] * P, [0] * P
        fired = []
        for i in range(P):
            if pos[i] >= len(orders[i]):
                continue
            op, v, m = orders[i][pos[i]]
            if op == "F":
                if v == 0 and i == 0:
                    ready = True
                elif i > 0:
                    ready = done.get(("F", v, m, i - 1), t) < t
                else:
                    ready = done.get(("F", v - 1, m, P - 1), t) < t
            else:
                own_f = done.get(("F", v, m, i), t) < t
                if i == P - 1 and v == V - 1:
                    ready = own_f
                elif i < P - 1:
                    ready = own_f and done.get(("B", v, m, i + 1), t) < t
                else:
                    ready = own_f and done.get(("B", v + 1, m, 0), t) < t
            if ready:
                krow[i] = 1 if op == "F" else 2
                crow[i], mrow[i] = v, m
                fired.append((op, v, m, i))
        for key in fired:
            done[key] = t
            i = key[3]
            pos[i] += 1
        kind_rows.append(krow)
        chunk_rows.append(crow)
        mb_rows.append(mrow)
        t += 1
        if t > guard:
            raise RuntimeError(
                f"interleaved schedule did not converge (P={P}, V={V}, "
                f"M={M}) — dependency deadlock in the op order"
            )
    return Tables(
        kind=np.asarray(kind_rows, np.int32),
        chunk=np.asarray(chunk_rows, np.int32),
        mb=np.asarray(mb_rows, np.int32),
    )


def simulate(tables: Tables, P: int, V: int, M: int) -> None:
    """Replay the tables against the data dependencies; raise on any
    violation. The unit tests run this over a (P, V, M) grid."""
    done = {}
    for t in range(tables.ticks):
        fired = []
        for i in range(P):
            k = int(tables.kind[t, i])
            if k == 0:
                continue
            v, m = int(tables.chunk[t, i]), int(tables.mb[t, i])
            if k == 1:
                if not (v == 0 and i == 0):
                    src = (
                        ("F", v, m, i - 1) if i > 0
                        else ("F", v - 1, m, P - 1)
                    )
                    assert done.get(src, t) < t, (t, i, "F", v, m, src)
                fired.append(("F", v, m, i))
            else:
                assert done.get(("F", v, m, i), t) < t, (t, i, "B-own", v, m)
                if not (i == P - 1 and v == V - 1):
                    src = (
                        ("B", v, m, i + 1) if i < P - 1
                        else ("B", v + 1, m, 0)
                    )
                    assert done.get(src, t) < t, (t, i, "B", v, m, src)
                fired.append(("B", v, m, i))
        for key in fired:
            assert key not in done, ("duplicate", key)
            done[key] = t
    want = 2 * P * V * M
    assert len(done) == want, (len(done), want)
