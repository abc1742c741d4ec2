"""Deterministic multi-tenant workload plans for the QoS lab.

(Host-pure Python: a copy of ddp_practice_tpu/serve/workload.py with its
imports pointed at the port; the port imports nothing of the
reference package.)

The single-tenant trace builders in serve/bench.py (Poisson arrivals,
uniform lengths) can show throughput but cannot show FAIRNESS: every
interesting QoS failure needs at least two tenants with different
shapes — a hostile tenant flooding at several times its share while a
compliant tenant trickles, bursts landing on a diurnal trough, long
heavy-tailed prompts starving short interactive ones. This module makes
that mix a first-class, REPLAYABLE input, the same way serve/faults.py
made failures one: a WorkloadPlan is a list of TenantSpecs serialized
as JSON, and ``build(vocab=..., seed=...)`` expands it into the same
arrival-sorted trace-dict list the bench harness already replays —
identical every time for a given (plan, vocab, seed), so the fair and
FIFO arms of a bench see byte-identical offered load.

Per-tenant knobs (each one a real traffic shape):

- ``arrivals`` — "poisson" (memoryless baseline), "bursty" (rate jumps
  ``burst_mult``x inside periodic windows: retry storms, cron fanout),
  or "diurnal" (sinusoidal rate: the day/night cycle compressed to
  ``diurnal_period_s``). Non-homogeneous processes are sampled by
  Lewis thinning against the peak rate, so the draw count — and hence
  determinism — does not depend on where the bursts land.
- heavy-tailed lengths — prompt and output budgets are lognormal
  (``*_mean``/``*_sigma``) capped at ``*_cap``: most requests short, a
  tail of monsters, which is what real prompt-length histograms look
  like and what uniform ranges hide.
- ``sessions``/``turns_per_session`` — multi-turn chat: each session's
  turn N re-feeds the whole conversation so far (prefix + every prior
  tail) plus a fresh tail, which is exactly the traffic the radix
  prefix cache (serve/kv_pages.py) exists for. Turns of one session
  arrive in order; sessions interleave.
- ``hostile`` — marks the tenant whose traffic is the attack in an
  isolation experiment. The flag changes NOTHING about generation
  (hostility is just a rate several times the fair share — set
  ``rate_rps`` accordingly); it tells consumers (the qos bench arm,
  tools/check_qos.py) which tenant's SLO alert SHOULD trip and whose
  must not.

Trace rows carry ``tenant`` and ``priority``, which Request already
threads through every seam (admission -> scheduler -> SLO attribution),
so a plan drives the whole QoS plane with no new plumbing.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List, Optional, Sequence

import numpy as np

_ARRIVALS = ("poisson", "bursty", "diurnal")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic shape. Defaults are a small, polite,
    single-turn Poisson tenant; every field is a JSON key."""

    name: str
    rate_rps: float = 1.0
    arrivals: str = "poisson"
    burst_every_s: float = 10.0   # bursty: window period
    burst_len_s: float = 1.0      # bursty: window length
    burst_mult: float = 8.0       # bursty: in-window rate multiplier
    diurnal_period_s: float = 60.0  # diurnal: sinusoid period
    diurnal_depth: float = 0.8      # diurnal: amplitude in [0, 1)
    prompt_len_mean: float = 12.0   # lognormal median, tokens
    prompt_len_sigma: float = 0.6
    prompt_len_cap: int = 96
    max_new_mean: float = 12.0
    max_new_sigma: float = 0.5
    max_new_cap: int = 48
    sessions: int = 0             # >0: multi-turn mode, this many chats
    turns_per_session: int = 1
    session_prefix_len: int = 24  # shared system-prompt length per chat
    priority: int = 0
    hostile: bool = False

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.rate_rps <= 0:
            raise ValueError(f"{self.name}: rate_rps must be > 0")
        if self.arrivals not in _ARRIVALS:
            raise ValueError(f"{self.name}: arrivals {self.arrivals!r}; "
                             f"one of {_ARRIVALS}")
        if self.arrivals == "bursty" and (
                self.burst_every_s <= 0 or self.burst_len_s <= 0
                or self.burst_len_s > self.burst_every_s
                or self.burst_mult < 1.0):
            raise ValueError(f"{self.name}: bursty needs 0 < burst_len_s"
                             " <= burst_every_s and burst_mult >= 1")
        if self.arrivals == "diurnal" and not (
                0.0 <= self.diurnal_depth < 1.0
                and self.diurnal_period_s > 0):
            raise ValueError(f"{self.name}: diurnal needs depth in "
                             "[0, 1) and period > 0")
        for fld in ("prompt_len_mean", "prompt_len_sigma",
                    "max_new_mean", "max_new_sigma"):
            if getattr(self, fld) < 0:
                raise ValueError(f"{self.name}: {fld} must be >= 0")
        if self.prompt_len_cap < 1 or self.max_new_cap < 1:
            raise ValueError(f"{self.name}: length caps must be >= 1")
        if self.sessions < 0 or self.turns_per_session < 1:
            raise ValueError(f"{self.name}: sessions >= 0, "
                             "turns_per_session >= 1")
        if self.sessions > 0 and self.session_prefix_len < 1:
            raise ValueError(f"{self.name}: session_prefix_len >= 1")

    # ------------------------------------------------------------ rates
    def peak_rate(self) -> float:
        if self.arrivals == "bursty":
            return self.rate_rps * self.burst_mult
        if self.arrivals == "diurnal":
            return self.rate_rps * (1.0 + self.diurnal_depth)
        return self.rate_rps

    def rate_at(self, t: float) -> float:
        """Instantaneous rate at clock second `t` (thinning target)."""
        if self.arrivals == "bursty":
            in_burst = (t % self.burst_every_s) < self.burst_len_s
            return self.rate_rps * (self.burst_mult if in_burst else 1.0)
        if self.arrivals == "diurnal":
            phase = 2.0 * math.pi * t / self.diurnal_period_s
            return self.rate_rps * (1.0 + self.diurnal_depth
                                    * math.sin(phase))
        return self.rate_rps


class WorkloadPlan:
    """An ordered, serializable set of TenantSpecs plus a duration."""

    def __init__(self, tenants: Sequence[TenantSpec],
                 duration_s: float = 10.0) -> None:
        if not tenants:
            raise ValueError("a workload plan needs at least one tenant")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        if duration_s <= 0:
            raise ValueError("duration_s must be > 0")
        self.tenants: List[TenantSpec] = list(tenants)
        self.duration_s = float(duration_s)

    # --------------------------------------------------------------- json
    @classmethod
    def from_json(cls, src: str) -> "WorkloadPlan":
        """Parse a plan from a JSON string or a path to a JSON file.

        Schema: {"duration_s": ..., "tenants": [{"name": ..., ...}]} —
        or a bare list of tenant objects (default duration).
        """
        text = src
        if not src.lstrip().startswith(("{", "[")):
            # same rule as serve/faults.py FaultPlan: a mistyped path
            # must fail as a missing file, not a JSON decode error
            if not os.path.exists(src):
                raise FileNotFoundError(
                    f"workload plan {src!r}: not inline JSON and "
                    "no such file")
            with open(src) as f:
                text = f.read()
        data = json.loads(text)
        if isinstance(data, list):
            return cls([TenantSpec(**item) for item in data])
        return cls(
            [TenantSpec(**item) for item in data.get("tenants", [])],
            duration_s=data.get("duration_s", 10.0),
        )

    def to_json(self) -> str:
        return json.dumps({
            "duration_s": self.duration_s,
            "tenants": [dataclasses.asdict(t) for t in self.tenants],
        })

    def hostile_tenants(self) -> List[str]:
        return [t.name for t in self.tenants if t.hostile]

    # -------------------------------------------------------------- build
    def build(self, *, vocab: int, seed: int = 0) -> list:
        """Expand the plan into an arrival-sorted bench trace.

        Each row: {rid, arrival, prompt, max_new_tokens, tenant,
        priority}. rids are assigned AFTER the cross-tenant sort, so
        rid order == arrival order (what replay harnesses assume).
        Each tenant draws from its own child generator (spawned off the
        plan seed by tenant INDEX), so adding a tenant to the end of a
        plan never perturbs the traffic of the ones before it.
        """
        if vocab < 2:
            raise ValueError("vocab must be >= 2")
        rows: list = []
        root = np.random.SeedSequence(seed)
        children = root.spawn(len(self.tenants))
        for spec, child in zip(self.tenants, children):
            rng = np.random.default_rng(child)
            arrivals = _thinned_arrivals(spec, self.duration_s, rng)
            rows.extend(_tenant_rows(spec, arrivals, vocab, rng))
        rows.sort(key=lambda r: (r["arrival"], r["tenant"]))
        for i, row in enumerate(rows):
            row["rid"] = i
        return rows


def _thinned_arrivals(spec: TenantSpec, duration_s: float,
                      rng) -> List[float]:
    """Lewis thinning: draw a homogeneous Poisson stream at the PEAK
    rate, keep each point with probability rate(t)/peak. The candidate
    draw count is independent of the rate shape, which keeps the
    stream deterministic under spec edits that only move bursts."""
    peak = spec.peak_rate()
    out: List[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= duration_s:
            return out
        if float(rng.random()) * peak <= spec.rate_at(t):
            out.append(t)


def _lognormal_len(rng, mean: float, sigma: float, cap: int) -> int:
    """Heavy-tailed length: lognormal with median `mean`, clamped to
    [1, cap]. sigma 0 degenerates to the constant `mean`."""
    draw = mean * float(np.exp(rng.normal(0.0, sigma))) if sigma > 0 \
        else mean
    return max(1, min(cap, int(round(draw))))


def _tenant_rows(spec: TenantSpec, arrivals: List[float], vocab: int,
                 rng) -> list:
    rows = []
    if spec.sessions > 0:
        # multi-turn: each arrival is the next turn of a round-robin
        # session; a turn's prompt is the WHOLE conversation so far
        # (prefix + all prior tails) plus its fresh tail — the re-fed
        # history is what exercises the prefix cache
        prefixes = [
            rng.integers(0, vocab, spec.session_prefix_len).tolist()
            for _ in range(spec.sessions)
        ]
        history = [list(p) for p in prefixes]
        turns = [0] * spec.sessions
        for k, at in enumerate(arrivals):
            s = k % spec.sessions
            if turns[s] >= spec.turns_per_session:
                history[s] = list(prefixes[s])  # chat over: new one
                turns[s] = 0
            tail = rng.integers(0, vocab, _lognormal_len(
                rng, spec.prompt_len_mean, spec.prompt_len_sigma,
                spec.prompt_len_cap)).tolist()
            prompt = history[s] + tail
            history[s] = prompt
            turns[s] += 1
            rows.append(_row(spec, at, prompt, rng))
    else:
        for at in arrivals:
            prompt = rng.integers(0, vocab, _lognormal_len(
                rng, spec.prompt_len_mean, spec.prompt_len_sigma,
                spec.prompt_len_cap)).tolist()
            rows.append(_row(spec, at, prompt, rng))
    return rows


def _row(spec: TenantSpec, at: float, prompt: list, rng) -> dict:
    return {
        "rid": -1,  # assigned after the cross-tenant sort
        "arrival": float(at),
        "prompt": prompt,
        "max_new_tokens": _lognormal_len(
            rng, spec.max_new_mean, spec.max_new_sigma,
            spec.max_new_cap),
        "tenant": spec.name,
        "priority": spec.priority,
    }
