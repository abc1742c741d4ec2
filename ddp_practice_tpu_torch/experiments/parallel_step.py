"""lm_base's train step under tensor parallelism, FSDP and sequence
parallelism, lm_moe's under expert and sequence parallelism, and lm_pipe's
under pipeline parallelism, on several cards (NCCL, one process a card
under torchrun).

    python -m ddp_practice_tpu_torch.experiments.parallel_step \
        [--nproc 4] [--steps 20] [--batch_size 8] [--layouts NAME ...]

`--collectives` first times NCCL's all-reduce, all-gather and
reduce-scatter alone (64 MiB of bf16 a rank, bus GB/s), the bytes the
layouts' collectives move over.

With `--profile` each layout then runs again, 20 steps with steps 10-19
traced on every rank (`--profile_dir`), and one rank's trace is summed
by kind (utils/xprof.py: device ms a step; NCCL's kernels fall under
"other", and their time includes waiting for the other ranks); then
every rank's device ms a step, all kernels and the flash kernels E, F
and G alone (the causal ring gives rank r r + 1 blocks a layer, so its
ranks' flash time differs and the step runs at its last rank's pace),
and the host's five longest ops.

For each layout (`LAYOUTS`; default all: tensor4 = "--tensor 4",
tensor2_fsdp = "--tensor 2 --fsdp", fsdp = "--fsdp", the sequence
layouts seq4_ring = "--seq 4 --sp_impl ring", seq4_ulysses = "--seq 4
--sp_impl ulysses" and tensor2_seq2_ulysses = "--tensor 2 --seq 2
--sp_impl ulysses", the MoE layouts expert4_moe = "--model lm_moe
--expert 4" and seq4_ring_moe = "--model lm_moe --seq 4 --sp_impl ring"
(the later --model wins), the pipeline layouts pipe4_gpipe = "--model
lm_pipe --pipe 4 --microbatches 4" and pipe4_1f1b (the same with
"--pipe_schedule 1f1b"), and the yardsticks ddp = no flag and ddp_moe =
"--model lm_moe", plain DDP) it runs

    torchrun --nproc_per_node N -m ddp_practice_tpu_torch.cli \
        --model lm_base --attn_impl flash --precision bf16 \
        --optimizer adamw --lr 3e-4 --seq_len 2048 -b B -e 1 \
        --max_steps S --log_every 1 --metrics_file F --json <layout>

The MoE layouts run the same command through `--moe_tc_worker`, which
builds lm_moe at lm_moe_tc's fields (benchmarks.py's suite entry: lm_base
widths, 6 of 12 blocks routed over 8 experts, top-2, strided routing
groups of 256, capacity factor 1.5) where the CLI's registry preset has
lm_tiny's test-sized widths; the pipeline layouts through
`--lm_base_worker`, which builds lm_pipe at lm_base's widths (d 768, 12
heads, mlp 3072, depth 12).

(rank 0 writes one record a step after reading the step's metrics back,
so consecutive records are one step apart; the first two steps are left
out as warm-up) and prints, per layout, the median step ms, the global
batch, tokens/s over all cards and per card, the eval perplexity and the
fit's own tokens/s per card, beside the card's name and power limit
(nvidia-smi). `-b` is per data replica, as the reference's: the global
batch is B x the data degree.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

LAYOUTS = {"tensor4": "--tensor 4", "tensor2_fsdp": "--tensor 2 --fsdp",
           "fsdp": "--fsdp", "seq4_ring": "--seq 4 --sp_impl ring",
           "seq4_ulysses": "--seq 4 --sp_impl ulysses",
           "tensor2_seq2_ulysses": "--tensor 2 --seq 2 --sp_impl ulysses",
           "expert4_moe": "--model lm_moe --expert 4",
           "seq4_ring_moe": "--model lm_moe --seq 4 --sp_impl ring",
           "ddp_moe": "--model lm_moe",
           "pipe4_gpipe": "--model lm_pipe --pipe 4 --microbatches 4",
           "pipe4_1f1b": "--model lm_pipe --pipe 4 --microbatches 4 "
                         "--pipe_schedule 1f1b", "ddp": ""}
# the layouts that train lm_moe at lm_moe_tc's fields (`moe_tc_worker`)
MOE_TC = ("expert4_moe", "seq4_ring_moe", "ddp_moe")
# the layouts that train lm_pipe at lm_base's widths (`lm_base_worker`)
PIPE = ("pipe4_gpipe", "pipe4_1f1b")
LM_BASE = dict(hidden_dim=768, depth=12, num_heads=12, mlp_dim=3072)
# 4 M tokens: an epoch of the synthetic corpus holds every layout's steps
BASE = ["--model", "lm_base", "--attn_impl", "flash", "--precision", "bf16",
        "--optimizer", "adamw", "--lr", "3e-4", "--seq_len", "2048", "-e",
        "1", "--log_every", "1", "--json", "--synthetic_size", "4000000"]


def _torchrun(nproc: int, args: list, worker: str = "") -> dict:
    """The CLI under torchrun (through `--<worker>` when given: its
    model fields); rank 0's JSON summary."""
    entry = (["ddp_practice_tpu_torch.experiments.parallel_step",
              f"--{worker}"] if worker else ["ddp_practice_tpu_torch.cli"])
    cmd = ["torchrun", "--standalone", f"--nproc_per_node={nproc}", "-m",
           *entry, *BASE, *args]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _worker(name: str) -> str:
    return ("moe_tc_worker" if name in MOE_TC else
            "lm_base_worker" if name in PIPE else "")


def run_layout(name: str, nproc: int, steps: int, batch: int,
               workdir: str) -> dict:
    layout = LAYOUTS[name]
    metrics = os.path.join(workdir, f"{name}.jsonl")
    summary = _torchrun(nproc, ["-b", str(batch), "--max_steps", str(steps),
                                "--metrics_file", metrics, *layout.split()],
                        worker=_worker(name))
    with open(metrics) as f:
        records = [json.loads(x) for x in f]
    times = [r["time"] for r in records if r["kind"] == "train"]
    gaps = [(b - a) * 1e3 for a, b in zip(times, times[1:])][2:]
    step_ms = statistics.median(gaps)
    seq = int(BASE[BASE.index("--seq_len") + 1])
    tokens = summary["global_batch"] * seq
    return {"layout": name, "flags": layout, "step_ms": step_ms,
            "global_batch": summary["global_batch"],
            "tokens_per_s": tokens / step_ms * 1e3,
            "tokens_per_s_per_card": tokens / step_ms * 1e3 / nproc,
            "fit_tokens_per_s_per_card": summary["tokens_per_sec_per_chip"],
            "perplexity": summary["perplexity"], "steps": summary["steps"]}


def rank_device_ms(profile_dir: str, steps: int) -> list:
    """Every rank's trace under `profile_dir` (one a process): (all
    device ms a step, the flash kernels' E, F and G ms a step, the host's
    five longest op names with their ms a step), slowest flash first.
    Host ops nest, so a parent's ms holds its children's."""
    from ddp_practice_tpu_torch.utils import xprof

    out = []
    for root, _, files in os.walk(profile_dir):
        for f in files:
            if f.endswith(".pt.trace.json"):
                path = os.path.join(root, f)
                s = xprof.op_summary(path)
                flash = sum(c["ps"] for k, c in s["categories"].items()
                            if k in ("flash E", "flash F", "flash G"))
                host = xprof.op_summary(path, device_substr="cpu")["ops"]
                top = sorted(((ps, name) for (_, name), ps in host.items()
                              if not name.startswith("ProfilerStep")),
                             reverse=True)[:5]
                out.append((s["total_ps"] / steps / 1e9,
                            flash / steps / 1e9,
                            [(name, ps / steps / 1e9) for ps, name in top]))
    return sorted(out, key=lambda x: -x[1])


def fields_worker(argv: list, fields: dict) -> int:
    """One rank of a layout (under torchrun): the CLI's `main` on `argv`,
    its Trainer building the model with `fields` over the registry
    preset's (`--moe_tc_worker`: lm_moe_tc's; `--lm_base_worker`: lm_base's
    widths for lm_pipe)."""
    from ddp_practice_tpu_torch import cli
    from ddp_practice_tpu_torch.train import loop

    make = loop.create_model
    loop.create_model = lambda name, **kw: make(name, **{**kw, **fields})
    return cli.main(argv)


def collectives_worker(mib: int = 64, runs: int = 20) -> None:
    """One rank of `--collectives` (under torchrun): the NCCL all-reduce,
    all-gather and reduce-scatter of `mib` MiB of bf16 a rank, median of
    `runs` timed with CUDA events; rank 0 prints each one's ms and bus
    bandwidth (nccl-tests' convention: all-reduce moves 2(n-1)/n of the
    buffer a rank, the others (n-1)/n), and whether the cards reach each
    other's memory directly (peer access)."""
    import torch
    import torch.distributed as tdist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    tdist.init_process_group("nccl")
    n = mib * 2 ** 20 // 2
    x = torch.ones(n, dtype=torch.bfloat16, device="cuda")
    big = torch.empty(n * world, dtype=torch.bfloat16, device="cuda")
    part = torch.empty(n // world, dtype=torch.bfloat16, device="cuda")
    ops = {"all_reduce": (lambda: tdist.all_reduce(x), 2),
           "all_gather": (lambda: tdist.all_gather_into_tensor(big, x), 1),
           "reduce_scatter": (lambda: tdist.reduce_scatter_tensor(part, x),
                              1)}
    for name, (op, factor) in ops.items():
        op()
        times = []
        for _ in range(runs):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            op()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = statistics.median(times)
        moved = factor * (world - 1) / world * (
            big.numel() if name == "all_gather" else n) * 2
        if rank == 0:
            print(f"{name}: {mib} MiB bf16 a rank, {ms:.3f} ms, bus "
                  f"{moved / ms / 1e6:.1f} GB/s", flush=True)
    if rank == 0:
        peers = [torch.cuda.can_device_access_peer(0, j)
                 for j in range(1, torch.cuda.device_count())]
        print(f"peer access from card 0: {peers}", flush=True)
    tdist.destroy_process_group()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--collectives_worker" in argv:
        collectives_worker()
        return 0
    if argv and argv[0] == "--moe_tc_worker":
        from ddp_practice_tpu_torch import benchmarks

        return fields_worker(
            argv[1:], benchmarks._SUITE["lm_moe_tc"]["model_kwargs"])
    if argv and argv[0] == "--lm_base_worker":
        return fields_worker(argv[1:], LM_BASE)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nproc", type=int, default=4)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--layouts", nargs="*", default=list(LAYOUTS),
                   choices=list(LAYOUTS))
    p.add_argument("--profile", action="store_true",
                   help="then run each layout again under --profile_dir "
                        "(steps 10-19 traced on every rank) and print one "
                        "rank's device time a step by kind")
    p.add_argument("--collectives", action="store_true",
                   help="first time NCCL's collectives alone "
                        "(`collectives_worker`)")
    args = p.parse_args(argv)
    if args.collectives:
        out = subprocess.run(
            ["torchrun", "--standalone", f"--nproc_per_node={args.nproc}",
             "-m", "ddp_practice_tpu_torch.experiments.parallel_step",
             "--collectives_worker"], capture_output=True, text=True)
        print(out.stdout, out.stderr[-2000:] if out.returncode else "",
              flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(f"cards: {card}", flush=True)
    with tempfile.TemporaryDirectory(dir="build") as workdir:
        for name in args.layouts:
            r = run_layout(name, args.nproc, args.steps, args.batch_size,
                           workdir)
            print(f"{r['layout']:>18}: median step {r['step_ms']:.2f} ms, "
                  f"global batch {r['global_batch']}, "
                  f"{r['tokens_per_s']:.0f} tokens/s "
                  f"({r['tokens_per_s_per_card']:.0f} per card; fit's own "
                  f"{r['fit_tokens_per_s_per_card']:.0f}), {r['steps']} "
                  f"steps, eval perplexity {r['perplexity']:.3f} "
                  f"[{card[0]}]", flush=True)
            print(json.dumps(r), flush=True)
            if args.profile:
                from ddp_practice_tpu_torch.utils import xprof

                prof = os.path.join(workdir, f"{name}_profile")
                _torchrun(args.nproc, [
                    "-b", str(args.batch_size), "--max_steps", "20",
                    "--profile_dir", prof, *LAYOUTS[name].split()],
                    worker=_worker(name))
                print(f"{name}, traced steps 10-19, one rank [{card[0]}]:",
                      flush=True)
                xprof.print_summary(prof, steps=10, top=8)
                for t, f, top in rank_device_ms(prof, 10):
                    print(f"{name}, a rank: device {t:.2f} ms a step, "
                          f"flash E+F+G {f:.2f}; host's longest ops, ms "
                          f"a step: " + ", ".join(
                              f"{n[:48]} {ms:.2f}" for n, ms in top),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
