"""Deterministic exponential backoff with jitter (counterpart of
ddp_practice_tpu/utils/backoff.py, copied: the port imports nothing of
the reference package).

Delays grow geometrically and cap, and the jitter is a pure function of
(seed, attempt): the same arguments give the same delay, so a seeded
fault-injection replay is bit-identical while distinct seeds still
de-synchronise a fleet. `train/elastic.py run_with_restarts` waits by it
between attempts.
"""

from __future__ import annotations

import random


def backoff_delay(
    attempt: int,
    *,
    base_s: float,
    factor: float = 2.0,
    max_s: float = 60.0,
    jitter: float = 0.5,
    seed: int = 0,
) -> float:
    """Delay before retry number `attempt` (0-based): min(max_s, base_s *
    factor**attempt) stretched by up to `jitter` fraction.

    The jitter draw comes from a Random seeded with an integer mix of
    (seed, attempt) — pure arithmetic, immune to PYTHONHASHSEED — so the
    schedule is reproducible across processes and runs. jitter=0 gives
    the bare geometric schedule.
    """
    if attempt < 0:
        raise ValueError("attempt must be >= 0")
    if base_s < 0 or factor < 1.0 or jitter < 0:
        raise ValueError("need base_s >= 0, factor >= 1, jitter >= 0")
    delay = min(max_s, base_s * factor ** attempt)
    if jitter and delay:
        # Knuth multiplicative mix keeps nearby (seed, attempt) pairs
        # from drawing correlated jitter
        mix = seed * 2_654_435_761 + attempt
        delay *= 1.0 + jitter * random.Random(mix).random()
    return min(delay, max_s * (1.0 + jitter))
