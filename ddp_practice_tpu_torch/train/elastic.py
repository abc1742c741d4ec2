"""Failure detection and checkpoint-based restarts (counterpart of
ddp_practice_tpu/train/elastic.py).

- `StepWatchdog` detects a hung step (a stuck collective, a dead peer):
  the loop beats it on confirmed progress, and a thread fires
  `on_timeout` when no beat came within the timeout (by default: log
  and hard-exit, so a supervisor restarts the process).
- `run_with_restarts` re-enters training from the last checkpoint after
  a failed attempt, waiting by `utils/backoff.py` between attempts and
  counting `train_restarts_total` in the metrics registry.
- `assert_in_sync` all-gathers a host fingerprint over the world and
  raises when a rank's driver loop has drifted (different step counts,
  skewed data exhaustion).

Progress on the card is confirmed through a rung (`Rung`): a CUDA event
recorded after a dispatched group, whose `synchronize()` returns once
that group, and by stream order every group before it, has run. A
tensor's `.item()` would not do: its copy is queued behind every later
group on the stream, so it waits for the whole in-flight backlog, which
is what the loop's oldest-rung probe must avoid. On the CPU the work is
done when the call returns, and a rung is resolved from the start.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as tdist

log = logging.getLogger("ddp_practice_tpu_torch")


class Rung:
    """A point of the progress ladder: an event recorded on the device's
    current stream after a group (None on the CPU: nothing is in
    flight)."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def resolve(value) -> None:
    """Block until `value` is resolved on the host: a rung's work done,
    a tensor read back; anything else is already a host value."""
    if isinstance(value, Rung):
        value.wait()
    elif isinstance(value, torch.Tensor):
        value.cpu()


def future_ready(value) -> bool:
    """Best-effort completion check (False when it cannot say: the probe
    then confirms this older rung)."""
    return isinstance(value, Rung) and value.ready()


class StepWatchdog:
    """Detects a hung training step (stuck collective / dead peer).

    `beat()` after every confirmed step; if no beat arrives within
    `timeout_s`, `on_timeout` fires from the watchdog thread (default:
    log CRITICAL and hard-exit so a supervisor restarts the process).
    """

    def __init__(
        self,
        timeout_s: float,
        on_timeout: Optional[Callable[[float], None]] = None,
        first_beat_grace: float = 10.0,
    ):
        self.timeout_s = timeout_s
        # until the first beat the run builds its kernels and captures
        # its graphs, which can dwarf a step: the first window gets
        # `first_beat_grace` x the step timeout
        self.first_beat_grace = first_beat_grace
        self._on_timeout = on_timeout or self._default_timeout
        self._last = time.monotonic()
        self._beaten = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _default_timeout(stalled_s: float) -> None:
        import os

        log.critical(
            "watchdog: no step completed in %.0fs — assuming hung "
            "collective or dead peer; exiting for supervisor restart",
            stalled_s,
        )
        os._exit(42)

    def start(self) -> "StepWatchdog":
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="step-watchdog")
        self._thread.start()
        return self

    def beat(self) -> None:
        self._last = time.monotonic()
        self._beaten = True

    def seconds_since_beat(self) -> float:
        return time.monotonic() - self._last

    def probe_due(self) -> bool:
        """True past half the timeout without a beat: the next progress
        confirmation should not wait any longer, so a step-count probe
        interval cannot starve the watchdog into firing on a healthy but
        slow run."""
        return self.seconds_since_beat() > self.timeout_s / 2

    def probe(self, value, fetch=None) -> None:
        """Record progress only after `value` resolves on the host
        (`fetch`, by default `resolve`: a rung's event synchronised, a
        tensor read back). A call returns before the card runs it, so a
        beat after dispatch would let a hung collective go unseen while
        the host keeps queueing; if the card is hung this call blocks,
        beats stop, and the watchdog fires on schedule."""
        (fetch or resolve)(value)
        self.beat()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        poll = min(1.0, self.timeout_s / 4)
        while not self._stop.wait(poll):
            stalled = time.monotonic() - self._last
            limit = self.timeout_s if self._beaten else (
                self.timeout_s * self.first_beat_grace
            )
            if stalled > limit:
                self._on_timeout(stalled)
                return


def assert_in_sync(fingerprint: int, *, what: str = "step") -> None:
    """Raise if `fingerprint` differs across ranks (driver-loop drift).

    Every rank must call this at the same point: it is itself a
    collective, an all-gather of one int64 over the world group (gloo,
    NCCL or the threaded group of parallel/threads.py). No-op with one
    rank."""
    if not tdist.is_initialized() or tdist.get_world_size() == 1:
        return
    device = (torch.device("cuda", torch.cuda.current_device())
              if tdist.get_backend() == "nccl" else torch.device("cpu"))
    mine = torch.tensor([int(fingerprint)], dtype=torch.int64, device=device)
    parts = [torch.empty_like(mine) for _ in range(tdist.get_world_size())]
    tdist.all_gather(parts, mine)
    all_vals = torch.cat(parts).cpu()
    if not bool((all_vals == all_vals[0]).all()):
        raise RuntimeError(
            f"hosts out of sync on {what}: process {tdist.get_rank()} "
            f"sees {fingerprint}, fleet sees {all_vals.tolist()}"
        )


def run_with_restarts(
    make_trainer: Callable[[bool], "object"],
    *,
    max_restarts: int = 0,
    restart_delay_s: float = 0.0,
    backoff_factor: float = 2.0,
    max_delay_s: float = 300.0,
    jitter: float = 0.5,
    seed: int = 0,
    metrics=None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Run `trainer.fit()` with checkpoint-based recovery.

    make_trainer(resume) builds a fresh trainer; after a failed attempt
    the next one is built with resume=True, so it restores the last
    checkpoint (a checkpoint_dir is what bounds the rework). Returns
    fit()'s summary; re-raises after `max_restarts` failures.

    The wait before attempt k is `backoff_delay(k - 1, base_s=
    restart_delay_s, ...)` (utils/backoff.py): exponential with a
    deterministic jitter, so a fleet-wide failure does not restart every
    host in lockstep, yet a seeded test replays the exact schedule.
    restart_delay_s=0 restarts at once. Restarts are counted in the
    metrics registry (`train_restarts_total`).
    """
    from ddp_practice_tpu_torch.utils.backoff import backoff_delay
    from ddp_practice_tpu_torch.utils.metrics import default_registry

    restarts = (metrics or default_registry()).counter(
        "train_restarts_total"
    )
    attempt = 0
    while True:
        try:
            trainer = make_trainer(attempt > 0)
            return trainer.fit()
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — any failure is restartable
            attempt += 1
            if attempt > max_restarts:
                raise
            restarts.inc()
            delay = backoff_delay(
                attempt - 1, base_s=restart_delay_s,
                factor=backoff_factor, max_s=max_delay_s,
                jitter=jitter, seed=seed,
            ) if restart_delay_s else 0.0
            log.error(
                "training attempt %d failed (%s: %s); restarting from last "
                "checkpoint in %.2fs (%d/%d)",
                attempt, type(e).__name__, e, delay, attempt, max_restarts,
            )
            if delay:
                sleep(delay)
