"""Trace analysis without a viewer: per-category device-time summaries
(counterpart of ddp_practice_tpu/utils/xprof.py).

`utils/profiling.py` captures Kineto Chrome traces (`--profile_dir`,
`*.pt.trace.json`); this module reads them back, or reads a live
`torch.profiler.profile`'s events, into the reference's summary:

    {"planes", "total_ps", "categories": {cat: {"ps", "count", "bytes"}},
     "ops": {(cat, name): ps}, "op_counts": {(cat, name): count}}

`ps` are device picoseconds summed over every captured execution (divide
by the step count for time per step); "planes" counts the device streams
(Kineto's (pid, tid) rows) that held a matched event. Device events are
Kineto's `kernel`, `gpu_memcpy` and `gpu_memset`; a `gpu_user_annotation`
(a `record_function` range such as the optimizer's `Optimizer.step#...`,
mirrored onto the device timeline) spans kernels already counted, so it
is left out. Kernels fall into categories by name: the repo's own flash
E/F/G and their forward variants, fused H/I, grouped-matmul J/K, decode
A-D, the library's attention kernels, cuBLAS/CUTLASS matmuls, copies and
memsets, and other. `device_substr="cpu"` reads the host's `cpu_op`
events instead (nested ops each count: a CPU summary double-counts; it
exists to test the path on a machine with no card).

CLI:  python -m ddp_practice_tpu_torch.utils.xprof <trace_dir_or_file> [steps]
"""

from __future__ import annotations

import collections
import json
import os
import sys

_DEVICE_CATS = {"cuda": ("kernel", "gpu_memcpy", "gpu_memset"),
                "cpu": ("cpu_op",)}
# (category, substrings of the lower-cased kernel name); the first match
# wins, so the library's attention kernels (PyTorch's flash namespace
# `pytorch_flash`, the memory-efficient `fmha_*`, cuDNN's `*sdpa*`) come
# before the repo's own flash kernels, and the variants before kernel E
_KINDS = (
    ("library attention", ("pytorch_flash", "fmha", "sdpa")),
    ("flash variants", ("flash_fwd_variant",)),
    ("flash E", ("flash_fwd",)),
    ("flash F", ("flash_bwd_dkdv",)),
    ("flash G", ("flash_bwd_dq",)),
    ("fused H", ("fused_encoder_fwd",)),
    ("fused I reduce", ("fused_encoder_reduce",)),
    ("fused I", ("fused_encoder_bwd",)),
    ("grouped K", ("tgmm",)),           # K and its second pass
    ("grouped J", ("gmm_kernel",)),
    ("decode A-D", ("decode_attention",)),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "gemv")),
)


def category(name: str, cat: str) -> str:
    """The summary category of one device event."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy/memset"
    if cat == "cpu_op":
        return cat
    low = name.lower()
    for kind, needles in _KINDS:
        if any(n in low for n in needles):
            return kind
    return "other"


def find_trace(path: str) -> str:
    """`path` itself if it is a file, else the newest `*.pt.trace.json`
    under it (the counterpart of the reference's `_find_xplane`)."""
    if os.path.isfile(path):
        return path
    hits = []
    for root, _, files in os.walk(path):
        hits += [os.path.join(root, f) for f in files
                 if f.endswith(".pt.trace.json")]
    if not hits:
        raise FileNotFoundError(f"no .pt.trace.json under {path!r}")
    return max(hits, key=os.path.getmtime)   # newest capture


def op_summary(path: str, *, device_substr: str = "cuda") -> dict:
    """Summarize the newest Kineto trace under `path` (see the module
    doc). Raises ValueError when it holds no event of that device."""
    with open(find_trace(path)) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return op_summary_events(events, device_substr=device_substr)


def op_summary_events(events, *, device_substr: str = "cuda") -> dict:
    """`op_summary` over already-parsed events: a trace's `traceEvents`,
    or `device_events(prof)` of a live profiler. Each event is a dict with
    "cat", "name", "dur" (microseconds), optionally "args" (memcpy and
    memset carry "bytes"), "pid" and "tid"."""
    cats_of = _DEVICE_CATS.get(device_substr)
    if cats_of is None:
        raise ValueError(f"unknown device {device_substr!r} (want one of "
                         f"{', '.join(_DEVICE_CATS)})")
    cats: dict = collections.defaultdict(
        lambda: {"ps": 0, "count": 0, "bytes": 0})
    ops = collections.Counter()
    counts = collections.Counter()
    planes = set()
    for ev in events:
        cat = ev.get("cat")
        if cat not in cats_of or ev.get("ph", "X") != "X":
            continue
        name = ev.get("name", "?")
        kind = category(name, cat)
        ps = round(float(ev.get("dur", 0.0)) * 1e6)
        nbytes = int((ev.get("args") or {}).get("bytes", 0) or 0)
        cats[kind]["ps"] += ps
        cats[kind]["count"] += 1
        cats[kind]["bytes"] += nbytes
        ops[(kind, name)] += ps
        counts[(kind, name)] += 1
        planes.add((ev.get("pid"), ev.get("tid")))
    if not planes:
        raise ValueError(f"no {device_substr!r} device event in the trace "
                         f"(categories {', '.join(cats_of)})")
    return {
        "planes": len(planes),
        "total_ps": sum(c["ps"] for c in cats.values()),
        "categories": dict(cats),
        "ops": dict(ops),
        "op_counts": dict(counts),
    }


def device_events(prof) -> list:
    """A live `torch.profiler.profile`'s CUDA events in the trace's event
    form, for `op_summary_events`. User annotations are left out (see the
    module doc); a copy or memset keeps no byte count here."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.events():
        if (getattr(e, "device_type", None) != cuda
                or getattr(e, "is_user_annotation", False)
                or e.name.startswith("Optimizer.")):
            continue
        cat = ("gpu_memcpy" if e.name.startswith("Memcpy")
               else "gpu_memset" if e.name.startswith("Memset")
               else "kernel")
        out.append({"ph": "X", "cat": cat, "name": e.name,
                    "dur": e.time_range.elapsed_us(),
                    "pid": getattr(e, "device_index", 0),
                    "tid": getattr(e, "thread", 0)})
    return out


def print_summary(path: str, *, steps: int = 1, top: int = 12, out=None,
                  device_substr: str = "cuda") -> None:
    """Per-category and top-op table (the reference's format); `steps`
    divides totals into per-step numbers."""
    out = out or sys.stdout
    s = op_summary(path, device_substr=device_substr)
    tot = s["total_ps"]
    print(f"device op time: {tot / steps / 1e12 * 1e3:.2f} ms/step "
          f"({steps} step(s))", file=out)
    for cat, c in sorted(s["categories"].items(), key=lambda kv: -kv[1]["ps"]):
        if not c["ps"]:
            continue
        gbps = c["bytes"] / (c["ps"] / 1e12) / 1e9
        print(f"  {c['ps'] / tot * 100:5.1f}%  "
              f"{c['ps'] / steps / 1e12 * 1e3:8.2f} ms/step  "
              f"x{c['count'] // steps:6d}  {cat:28s} {gbps:7.0f} GB/s",
              file=out)
    print(f"top {top} ops:", file=out)
    for (cat, nm), d in sorted(s["ops"].items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {d / steps / 1e12 * 1e3:7.3f} ms/step  [{cat[:18]}] "
              f"{nm[:58]}", file=out)


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if not args or args[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    steps = int(args[1]) if len(args) > 1 else 1
    print_summary(args[0], steps=steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
