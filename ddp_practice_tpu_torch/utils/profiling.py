"""Profiling hooks over torch.profiler (counterpart of
ddp_practice_tpu/utils/profiling.py).

A capture writes one Kineto Chrome trace, `<host>_<pid>.<ns>.pt.trace.json`,
under its `profile_dir` (Perfetto and chrome://tracing read it;
`utils/xprof.py` summarizes it). It records the CPU ops and, when a card
is present, the CUDA kernels and copies, so the device timeline lines up
with the annotations below.

- `profile_region(name, profile_dir=None)` annotates a region
  (`torch.profiler.record_function`); with a `profile_dir` it also
  captures a trace. torch's profiler is one per process in effect, so only
  the OUTERMOST region holding a `profile_dir` starts and stops a capture:
  nested regions, and regions inside a capture that `start_capture` opened
  (the training loop's step window), annotate only.
- When the body raised, a failing stop is logged and swallowed and the
  body's exception propagates; when the body succeeded, a failing stop
  raises. The active flag drops before the stop, so a failed stop cannot
  leave every later region annotate-only.
- `step_annotation(step)` names a training step's range `train#<step>`
  (the reference's `StepTraceAnnotation("train", step_num=step)`).
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import threading
import time
from typing import Optional

import torch

log = logging.getLogger(__name__)

_lock = threading.Lock()
_active: Optional[tuple] = None    # (torch.profiler.profile, profile_dir)


def start_capture(profile_dir: str) -> bool:
    """Start a capture into `profile_dir` unless one is active; True if
    this call now owns the stop (`stop_capture`). A profiler started
    elsewhere (a `torch.profiler.profile` block) refuses a second one:
    that too means annotate only."""
    global _active
    from torch.profiler import ProfilerActivity, profile

    with _lock:
        if _active is not None:
            return False
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        try:
            prof.start()
        except RuntimeError as e:     # a profiler is already running
            log.warning("profile_region: not starting a capture (%s)", e)
            return False
        _active = (prof, profile_dir)
        return True


def stop_capture(swallow: bool = False) -> Optional[str]:
    """Stop the active capture and write its trace; returns the trace's
    path (None when nothing was active). The active flag drops first. With
    `swallow`, a failure is logged instead of raised."""
    global _active
    with _lock:
        active, _active = _active, None
    if active is None:
        return None
    prof, profile_dir = active
    try:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"{socket.gethostname()}_"
                            f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        return path
    except Exception:
        if not swallow:
            raise
        log.exception("profile_region: stopping the capture failed "
                      "(suppressed: the body's exception is the one that "
                      "matters)")
        return None


@contextlib.contextmanager
def profile_region(name: str, profile_dir: Optional[str] = None):
    """Annotate a region; with `profile_dir`, capture a trace of it too.
    Nested capture requests annotate only (see the module doc)."""
    from torch.profiler import record_function

    owns = bool(profile_dir) and start_capture(profile_dir)
    try:
        with record_function(name):
            yield
    except BaseException:
        if owns:
            stop_capture(swallow=True)
        raise
    else:
        if owns:
            stop_capture()


@contextlib.contextmanager
def step_annotation(step: int):
    from torch.profiler import record_function

    with record_function(f"train#{step}"):
        yield
