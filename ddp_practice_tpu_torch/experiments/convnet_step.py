"""Where a ConvNet train step's time goes, and whether a finished
torch.profiler trace earlier in the process moves it.

    python -m ddp_practice_tpu_torch.experiments.convnet_step \
        [--steps 400] [--precision fp32|bf16]

The CLI's default run (the ConvNet, batch 32, SGD lr 1e-4, synthetic
MNIST) built through `Trainer`, its steps fed one fixed device batch so
the loader is out of the reading. Windows of `--steps` steps, in turn:
fresh; fresh again (the drift of an untraced process); after one step
traced by torch.profiler (its device busy time, device ops and the
device's idle share against the fresh host wall are printed); after a
second trace (does the cost build up?). Each window reports the host
wall a step (a synchronize ends the window) and the median gap between
CUDA events recorded after each step.

chip_smoke.py traces profiled steps in many phases of one process; this
script says what a trace costs the steps after it. Device times come
from the card only: on the CPU the script reports the host wall alone.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from ddp_practice_tpu_torch.cli import build_parser, config_from_args
from ddp_practice_tpu_torch.train.loop import Trainer
from ddp_practice_tpu_torch.utils import xprof


def _window(trainer, batch, steps, cuda):
    """(host ms a step, median event gap ms or None) over `steps`."""
    ends = []
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.state, _ = trainer.train_step(trainer.state, batch)
        if cuda:
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
    if cuda:
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / steps
    gap = (statistics.median(a.elapsed_time(b)
                             for a, b in zip(ends, ends[1:]))
           if cuda else None)
    return host, gap


def _profiled(trainer, batch, cuda):
    """(device busy ms, device ops) of one traced step, or None."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        trainer.state, _ = trainer.train_step(trainer.state, batch)
        if cuda:
            torch.cuda.synchronize()
    events = xprof.device_events(prof) if cuda else []
    if not events:
        return None
    summary = xprof.op_summary_events(events)
    busy = sum(c["ps"] for c in summary["categories"].values()) / 1e9
    return busy, sum(c["count"] for c in summary["categories"].values())


def main(steps: int = 400, precision: str = "fp32", device: str = "cuda"):
    argv = ["--data_dir", "build/no_such_data", "--synthetic_size", "3200",
            "--precision", precision, "--device", device]
    trainer = Trainer(config_from_args(build_parser().parse_args(argv)))
    cuda = trainer.device.type == "cuda"
    if cuda:
        print(torch.cuda.get_device_name(0), flush=True)
    batch = trainer._to_device(next(iter(trainer.train_loader)))
    _window(trainer, batch, 20, cuda)                    # warm
    rows = [(label, *_window(trainer, batch, steps, cuda))
            for label in ("fresh", "fresh again")]
    traced = _profiled(trainer, batch, cuda)
    rows.append(("after a trace", *_window(trainer, batch, steps, cuda)))
    _profiled(trainer, batch, cuda)
    rows.append(("after a second trace",
                 *_window(trainer, batch, steps, cuda)))
    print(f"convnet {precision} batch {trainer.global_batch}, {steps} "
          f"steps a window, one fixed device batch:")
    for label, host, gap in rows:
        print(f"  {label:>22}: host {host:.3f} ms/step"
              + ("" if gap is None else f", event gap {gap:.3f} ms"))
    if traced is None:
        print("  traced step: device time not measured")
    else:
        busy, ops = traced
        print(f"  traced step: device busy {busy:.3f} ms, {ops} device ops, "
              f"idle share {max(0.0, 1 - busy / rows[0][1]):.3f} of the "
              f"fresh host wall")
    return rows, traced


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = p.parse_args()
    main(a.steps, a.precision, a.device)
    sys.exit(0)
