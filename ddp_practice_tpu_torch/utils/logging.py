"""Process-0-gated logging (counterpart of ddp_practice_tpu/utils/logging.py,
copied: the port imports nothing of the reference package).

The reference gates prints and saves on rank 0 by hand at each site
(ddp_main.py:158-169); here the gate is one decorator / logger filter.
The rank is the `torch.distributed` rank, and 0 when no process group
is initialised (a single serving process).
"""

from __future__ import annotations

import functools
import logging
import sys


def get_logger(name: str = "ddp_practice_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def process_index() -> int:
    """This process's rank: torch.distributed's when a group is up, else
    0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def main_process_only(fn):
    """Run fn only on process 0 — the rank-0 side-effect gate."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if process_index() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapper


@main_process_only
def emit_metrics(snapshot: dict, logger: logging.Logger = None) -> str:
    """Log one `metrics {...}` JSON line — process 0 only.

    The serving observability sink (serve/metrics.py): every replica of a
    multi-host server runs the same scheduler loop and accumulates the
    same registry, so an ungated emit would print one duplicate line per
    host. Returns the rendered line (None on non-0 processes — the
    decorator's contract), which is what the unit test pins.
    """
    import json

    line = "metrics " + json.dumps(snapshot, sort_keys=True, default=float)
    (logger or get_logger("ddp_practice_tpu_torch.serve")).info(line)
    return line
