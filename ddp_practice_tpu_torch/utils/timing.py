"""Wall-clock timing (a copy of ddp_practice_tpu/utils/timing.py): the
reference's only performance instrument, kept for parity, plus per-phase
accounting for throughput metrics."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self._start = time.perf_counter()
        self._laps = {}

    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        last = self._laps.get(name, self._start)
        self._laps[name] = now
        return now - last
