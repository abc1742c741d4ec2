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

(rank 0 writes one record a call after reading the call's metrics back;
the first two records are left out as warm-up, and a record's ms are
divided by the steps since the one before) and prints, per layout, the
median step ms, the global batch, tokens/s over all cards and per card,
the eval perplexity and the fit's own tokens/s per card, beside the
card's name and power limit (nvidia-smi). `-b` is per data replica, as
the reference's: the global batch is B x the data degree.

Captured steps across ranks (ROADMAP A8e-2): a layout named `<name>_k4`
is `<name>` at `--steps_per_call 4`, whose chunked calls run as replays
of one step captured per rank (utils/graphs.py: NCCL's collectives are
captured; the first `graphs.WARMUP` steps run eagerly). `--pairs` runs
each such layout against its eager twin (the same flags at one step a
call) in alternating pairs (eager, captured, captured, eager), `--steps`
steps with a record every 4 steps, and prints each leg's ms a step
(records past step 16, when the capture is done) and whether the
captured leg's losses at every fourth step and its eval perplexity equal
the eager leg's bit for bit. Rank 0 reports its chunked step's graph
(captures, replays) on stderr. The image layouts train the reference's
configs 2 (`convnet_bf16`: the ConvNet on the synthetic MNIST set, bf16,
batch 32 a card) and 5 (`resnet50`: ResNet-50 on a synthetic ImageNet
corpus of 6144 images written first under build/, bf16, batch 32 a card
so that an epoch holds 48 steps, random resized crops, the native
gather) under DDP;
`pipe2_fsdp2` is lm_pipe at data 2 x pipe 2 with FSDP (parallel/fsdp.py
`DataShards`).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
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
                         "--pipe_schedule 1f1b", "ddp": "",
           "pipe2_fsdp2": "--model lm_pipe --pipe 2 --fsdp --microbatches 4",
           "convnet_bf16": "", "resnet50": ""}
# the captured twins: `<name>_k4` is `<name>` at 4 steps a call
CAPTURED = ("ddp", "tensor4", "expert4_moe", "seq4_ulysses", "pipe4_1f1b",
            "seq4_ring", "fsdp", "pipe2_fsdp2", "convnet_bf16", "resnet50")
LAYOUTS.update({f"{n}_k4": f"{LAYOUTS[n]} --steps_per_call 4".strip()
                for n in CAPTURED})
# the image layouts' commands (the reference's configs 2 and 5)
IMAGE = {
    "convnet_bf16": ["--model", "convnet", "--precision", "bf16", "-e", "1",
                     "--data_dir", "build/no_such_data", "--json",
                     "--log_every", "1"],
    "resnet50": ["--model", "resnet50", "--dataset", "imagenet",
                 "--precision", "bf16", "--augment", "--augment_kind", "rrc",
                 "--loader", "native", "--optimizer", "sgd", "--momentum",
                 "0.9", "--lr", "0.01", "-e", "1", "--json", "--log_every",
                 "1", "--synthetic_size", "6144"],
}
IMAGE_BATCH = {"convnet_bf16": 32, "resnet50": 32}
# a torchrun run's limit (a hung collective ends the run, not the call)
TIMEOUT_S = 240
# the layouts that train lm_moe at lm_moe_tc's fields (`moe_tc_worker`)
MOE_TC = ("expert4_moe", "seq4_ring_moe", "ddp_moe", "expert4_moe_k4")
# the layouts that train lm_pipe at lm_base's widths (`lm_base_worker`)
PIPE = ("pipe4_gpipe", "pipe4_1f1b", "pipe4_1f1b_k4", "pipe2_fsdp2",
        "pipe2_fsdp2_k4")
LM_BASE = dict(hidden_dim=768, depth=12, num_heads=12, mlp_dim=3072)
# 4 M tokens: an epoch of the synthetic corpus holds every layout's steps
BASE = ["--model", "lm_base", "--attn_impl", "flash", "--precision", "bf16",
        "--optimizer", "adamw", "--lr", "3e-4", "--seq_len", "2048", "-e",
        "1", "--log_every", "1", "--json", "--synthetic_size", "4000000"]


def _image(name: str):
    """The image layout a layout name trains, or None (the LM's)."""
    base = name[:-3] if name.endswith("_k4") else name
    return base if base in IMAGE else None


def _torchrun(nproc: int, args: list, worker: str = "cli_worker",
              base=None) -> tuple:
    """The CLI under torchrun through `--<worker>` (its model fields, and
    rank 0's graph report); rank 0's JSON summary and its graph report
    (None without a chunked step)."""
    entry = ["ddp_practice_tpu_torch.experiments.parallel_step",
             f"--{worker}"]
    cmd = ["torchrun", "--standalone", f"--nproc_per_node={nproc}", "-m",
           *entry, *(BASE if base is None else base), *args]
    # its own session, so that a run past TIMEOUT_S is killed with every
    # rank it started
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"{' '.join(cmd)} ran past {TIMEOUT_S} s")
    if proc.returncode != 0:
        ranks = [x for x in stderr.splitlines() if x.startswith("[rank")]
        raise RuntimeError(f"{' '.join(cmd)} failed:\n"
                           + "\n".join(ranks[-60:] or [stderr[-4000:]]))
    graph = [json.loads(x[len("graph: "):]) for x in stderr.splitlines()
             if x.startswith("graph: ")]
    return (json.loads(stdout.strip().splitlines()[-1]),
            graph[-1] if graph else None)


def _worker(name: str) -> str:
    return ("moe_tc_worker" if name in MOE_TC else
            "lm_base_worker" if name in PIPE else "cli_worker")


def run_layout(name: str, nproc: int, steps: int, batch: int,
               workdir: str, log_every: int = 1) -> dict:
    """One layout's run: ms a step past the warm-up and the capture,
    rank 0's losses by step and its summary."""
    layout = LAYOUTS[name]
    image = _image(name)
    metrics = os.path.join(workdir, f"{name}.jsonl")
    if os.path.exists(metrics):
        os.remove(metrics)
    args = ["-b", str(IMAGE_BATCH[image] if image else batch),
            "--max_steps", str(steps), "--metrics_file", metrics,
            "--log_every", str(log_every), *layout.split()]
    if image == "resnet50":
        args += ["--data_dir", workdir]
    summary, graph = _torchrun(nproc, args, worker=_worker(name),
                               base=IMAGE[image] if image else None)
    with open(metrics) as f:
        records = [json.loads(x) for x in f]
    train = [(r["step"], r["time"]) for r in records if r["kind"] == "train"]
    skip = 16 if log_every > 1 else 2
    gaps = [(b - a) * 1e3 / (sb - sa) for (sa, a), (sb, b)
            in zip(train, train[1:]) if sa >= skip]
    step_ms = statistics.median(gaps)
    out = {"layout": name, "flags": layout, "step_ms": step_ms,
           "global_batch": summary["global_batch"], "steps": summary["steps"],
           "losses": {r["step"]: r["loss"] for r in records
                      if r["kind"] == "train"},
           "graph": graph}
    if image:
        out.update(images_per_s=summary["global_batch"] / step_ms * 1e3,
                   accuracy=summary["accuracy"])
        return out
    seq = int(BASE[BASE.index("--seq_len") + 1])
    tokens = summary["global_batch"] * seq
    out.update(tokens_per_s=tokens / step_ms * 1e3,
               tokens_per_s_per_card=tokens / step_ms * 1e3 / nproc,
               fit_tokens_per_s_per_card=summary["tokens_per_sec_per_chip"],
               perplexity=summary["perplexity"])
    return out


def run_pair(name: str, nproc: int, steps: int, batch: int, workdir: str,
             card: str, repeats: int = 2) -> dict:
    """`<name>_k4` against `<name>` in alternating pairs (eager, captured,
    captured, eager; `repeats` 1: eager, captured), a record every 4
    steps; prints each leg and whether the captured losses and eval
    result equal the eager ones."""
    legs = {"eager": [], "captured": []}
    order = ("eager", "captured", "captured", "eager")
    for leg in order[:2] if repeats == 1 else order:
        legs[leg].append(run_layout(name + ("_k4" if leg == "captured"
                                            else ""), nproc, steps, batch,
                                    workdir, log_every=4))
    key = "accuracy" if _image(name) else "perplexity"
    e, c = legs["eager"][0], legs["captured"][0]
    same = (c["losses"] == e["losses"] and c[key] == e[key]
            and all(r["losses"] == e["losses"] and r[key] == e[key]
                    for r in legs["eager"][1:] + legs["captured"][1:]))
    out = {"layout": name, "eager_ms": [r["step_ms"] for r in legs["eager"]],
           "captured_ms": [r["step_ms"] for r in legs["captured"]],
           "bit_identical": same, "graph": c["graph"],
           "global_batch": c["global_batch"], key: c[key],
           "losses": sorted(c["losses"].items())}
    print(f"{name:>14} pairs: eager {out['eager_ms']} ms a step, captured "
          f"{out['captured_ms']} (graph on rank 0 {c['graph']}), global "
          f"batch {c['global_batch']}, {steps} steps; losses at every "
          f"fourth step and eval {key} "
          f"{'bit-identical' if same else 'DIFFERENT'} [{card}]",
          flush=True)
    return out


def _write_imagenet(workdir: str) -> None:
    """resnet50's synthetic corpus, written once before its ranks start
    (the loop's eval split is a sixth of --synthetic_size)."""
    from ddp_practice_tpu_torch.data.datasets import load_dataset

    n = int(IMAGE["resnet50"][IMAGE["resnet50"].index("--synthetic_size")
                              + 1])
    for split, size in (("train", n), ("test", n // 6)):
        load_dataset("imagenet", workdir, split, seed=3407,
                     synthetic_size=size)


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
    widths for lm_pipe; `--cli_worker`: none). Rank 0 prints its chunked
    step's graph (captures, replays, the rule's reason when eager) on
    stderr."""
    from ddp_practice_tpu_torch import cli
    from ddp_practice_tpu_torch.train import loop
    from ddp_practice_tpu_torch.utils.graphs import eager_reason

    make = loop.create_model
    loop.create_model = lambda name, **kw: make(name, **{**kw, **fields})
    fit = loop.Trainer.fit

    def reported(self):
        out = fit(self)
        step = self.chunk_step or self.resident_train_step
        if step is not None and int(os.environ.get("RANK", 0)) == 0:
            print("graph: " + json.dumps({
                "captures": step.graph.captures,
                "replays": step.graph.replays,
                "eager_reason": eager_reason(self.model)}),
                file=sys.stderr, flush=True)
        return out

    loop.Trainer.fit = reported
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
    if argv and argv[0] == "--cli_worker":
        return fields_worker(argv[1:], {})
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nproc", type=int, default=4)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--layouts", nargs="*", default=None,
                   choices=list(LAYOUTS))
    p.add_argument("--pairs", nargs="*", default=None, choices=CAPTURED,
                   help="time these layouts captured (`_k4`) against "
                        "eager in alternating pairs (`run_pair`)")
    p.add_argument("--repeats", type=int, default=2, choices=[1, 2],
                   help="--pairs: 2 alternating pairs, or 1 (eager, "
                        "captured)")
    p.add_argument("--seq_len", type=int, default=None,
                   help="the LM layouts' sequence length (default 2048)")
    p.add_argument("--profile", action="store_true",
                   help="then run each layout again under --profile_dir "
                        "(steps 10-19 traced on every rank) and print one "
                        "rank's device time a step by kind")
    p.add_argument("--collectives", action="store_true",
                   help="first time NCCL's collectives alone "
                        "(`collectives_worker`)")
    args = p.parse_args(argv)
    if args.seq_len:
        BASE[BASE.index("--seq_len") + 1] = str(args.seq_len)
    if args.layouts is None:
        args.layouts = [] if args.pairs else [
            n for n in LAYOUTS if not n.endswith("_k4") and not _image(n)]
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
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as workdir:
        if "resnet50" in (args.pairs or []) or any(
                _image(n) == "resnet50" for n in args.layouts):
            _write_imagenet(workdir)
        for name in args.pairs or ():
            try:
                print(json.dumps(run_pair(name, args.nproc, args.steps,
                                          args.batch_size, workdir,
                                          card[0], args.repeats)),
                      flush=True)
            except RuntimeError as e:
                # a layout that fails (a capture the rule should name)
                # is reported, and the call goes on to the next
                print(f"{name} pairs FAILED: {str(e)[-6000:]}", flush=True)
        for name in args.layouts:
            r = run_layout(name, args.nproc, args.steps, args.batch_size,
                           workdir)
            if _image(name):
                print(f"{r['layout']:>18}: median step {r['step_ms']:.2f} "
                      f"ms, global batch {r['global_batch']}, "
                      f"{r['images_per_s']:.0f} images/s, {r['steps']} "
                      f"steps, eval accuracy {r['accuracy']:.4f}, graph "
                      f"{r['graph']} [{card[0]}]", flush=True)
            else:
                print(f"{r['layout']:>18}: median step {r['step_ms']:.2f} "
                      f"ms, global batch {r['global_batch']}, "
                      f"{r['tokens_per_s']:.0f} tokens/s "
                      f"({r['tokens_per_s_per_card']:.0f} per card; fit's "
                      f"own {r['fit_tokens_per_s_per_card']:.0f}), "
                      f"{r['steps']} steps, eval perplexity "
                      f"{r['perplexity']:.3f}, graph {r['graph']} "
                      f"[{card[0]}]", flush=True)
            print(json.dumps(r), flush=True)
            if args.profile:
                from ddp_practice_tpu_torch.utils import xprof

                prof = os.path.join(workdir, f"{name}_profile")
                image = _image(name)
                _torchrun(args.nproc, [
                    "-b", str(IMAGE_BATCH[image] if image
                              else args.batch_size), "--max_steps", "20",
                    "--profile_dir", prof, *LAYOUTS[name].split()],
                    worker=_worker(name),
                    base=IMAGE[image] if image else None)
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
