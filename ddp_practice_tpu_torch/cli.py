"""Command line of the port (counterpart of ddp_practice_tpu/cli.py).

    python -m ddp_practice_tpu_torch.cli [training flags] [--device cpu]
    python -m ddp_practice_tpu_torch.cli serve [serve flags]

Training takes the reference's parser (the same flag names and defaults)
plus `--device` (the card unless `--device cpu`); flags this slice does
not port raise NotImplementedError naming their ROADMAP item (config.py).
The image transformers train on the card's fused encoder-layer kernels
with no flag:

    python -m ddp_practice_tpu_torch.cli --model vit_tiny --dataset cifar10 \\
        --precision bf16 -b 1024

Data parallelism is one process per card:

    torchrun --nproc_per_node 4 -m ddp_practice_tpu_torch.cli --model \\
        lm_base --attn_impl flash --precision bf16 ...

`serve` runs the serving benches on the card; serve/bench.py owns its
flags (the slot, static and, with `--paged`, paged rows; `--shared-prefix
[--kv-int8]`; `--spec-decode`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ddp_practice_tpu_torch.config import MeshConfig, TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ddp_practice_tpu_torch")
    p.add_argument("-e", "--epochs", type=int, default=3)
    p.add_argument("-b", "--batch_size", type=int, default=32,
                   help="per data-parallel replica, like the reference")
    p.add_argument("--model", default="convnet",
                   choices=["convnet", "resnet18", "resnet50", "vit_tiny",
                            "vit_base", "vit_tiny_moe", "vit_tiny_pipe",
                            "lm_tiny", "lm_base", "lm_moe", "lm_pipe"])
    p.add_argument("--num_heads", type=int, default=0,
                   help="override attention head count (0 = model default)")
    p.add_argument("--dataset", default="mnist",
                   help="image models: mnist | cifar10 | synthetic* (real "
                        "files under --data_dir, else a seeded synthetic "
                        "set of the same shape); lm models: text (bytes "
                        "from --data_dir) or anything else for the "
                        "synthetic Markov corpus")
    p.add_argument("--seq_len", type=int, default=256,
                   help="LM sequence length (lm_* models)")
    p.add_argument("--remat", action="store_true",
                   help="recompute LM block activations in backward")
    p.add_argument("--pos_emb", default="learned", choices=["learned", "rope"])
    p.add_argument("--tied", action="store_true",
                   help="tie the LM output projection to the token embedding")
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--synthetic_size", type=int, default=0,
                   help="synthetic-fallback corpus size (0 = default)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--optimizer", default="sgd",
                   choices=["sgd", "adam", "adamw"])
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--clip_norm", type=float, default=0.0)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--lr_schedule", default="constant",
                   choices=["constant", "cosine", "warmup_cosine"])
    p.add_argument("--accum_steps", type=int, default=1)
    p.add_argument("--scale_lr", action="store_true")
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--data_axis", type=int, default=-1)
    p.add_argument("--seq", type=int, default=1)
    p.add_argument("--tensor", type=int, default=1)
    p.add_argument("--pipe", type=int, default=1)
    p.add_argument("--expert", type=int, default=1)
    p.add_argument("--sp_impl", default="ring", choices=["ring", "ulysses"])
    p.add_argument("--attn_impl", default="xla", choices=["xla", "flash"],
                   help="local attention: xla (plain PyTorch) or flash "
                        "(the CUDA kernels E/F/G on the card)")
    p.add_argument("--microbatches", type=int, default=4)
    p.add_argument("--pipe_schedule", default="gpipe",
                   choices=["gpipe", "1f1b", "interleaved"])
    p.add_argument("--num_virtual", type=int, default=2)
    p.add_argument("--num_experts", type=int, default=0)
    p.add_argument("--moe_router", default="topk",
                   choices=["topk", "expert_choice"])
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--devices", type=int, default=0,
                   help="the reference's device limit; one process drives "
                        "one card here (more cards: torchrun)")
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="the reference's virtual CPU devices; here N=1 "
                        "means --device cpu")
    p.add_argument("--coordinator", default=None,
                   help="host:port of the tcp:// rendezvous (instead of "
                        "torchrun's environment)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--ckpt_every", type=int, default=0, metavar="STEPS")
    p.add_argument("--ckpt_sync", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max_restarts", type=int, default=0)
    p.add_argument("--watchdog", type=float, default=0.0, metavar="SECS")
    p.add_argument("--sync_check", type=int, default=0, metavar="STEPS")
    p.add_argument("--eval_every", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=0,
                   help="cap steps per epoch (0 = full epoch)")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--trace-out", "--trace_out", dest="trace_out",
                   default=None, metavar="PATH")
    p.add_argument("--metrics_file", default=None, metavar="PATH",
                   help="append one JSON record per logged step / eval / "
                        "summary (process 0 only)")
    p.add_argument("--metrics-port", "--metrics_port", dest="metrics_port",
                   type=int, default=None, metavar="PORT")
    p.add_argument("--telemetry-out", "--telemetry_out",
                   dest="telemetry_out", default=None, metavar="PATH")
    p.add_argument("--slo", default=None, metavar="JSON|PATH")
    p.add_argument("--alert-sink", "--alert_sink", dest="alert_sink",
                   action="append", default=None, metavar="KIND:TARGET")
    p.add_argument("--loader", default="auto",
                   choices=["auto", "native", "python"])
    p.add_argument("--steps_per_call", type=int, default=1)
    p.add_argument("--data_placement", default="auto",
                   choices=["auto", "host", "device"])
    p.add_argument("--compile_cache", default="auto")
    p.add_argument("--fused", nargs="?", const="on", default="auto",
                   choices=["auto", "on", "off"],
                   help="fused encoder layer (ops/fused_encoder.py): auto "
                        "(plain blocks of a supported shape on the card), "
                        "on (force; raises where it cannot run), off")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--augment_kind", default="crop_flip",
                   choices=["crop_flip", "rrc"])
    p.add_argument("--json", action="store_true", help="print summary as JSON")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default; raises without one) or the "
                        "CPU, where the kernels' plain versions run")
    return p


def config_from_args(args) -> TrainConfig:
    if args.augment_kind != "crop_flip" and not args.augment:
        raise SystemExit("--augment_kind has no effect without --augment")
    if args.alert_sink and not args.slo:
        raise SystemExit("--alert-sink needs --slo")
    if args.cpu > 1 or args.devices > 1:
        raise NotImplementedError(
            "several devices in one process are not ported (ROADMAP A8): "
            "run one process per device under torchrun")
    return TrainConfig(
        model=args.model, dataset=args.dataset, data_dir=args.data_dir,
        synthetic_size=args.synthetic_size, seq_len=args.seq_len,
        remat=args.remat, pos_emb=args.pos_emb, tied_embeddings=args.tied,
        epochs=args.epochs, batch_size=args.batch_size,
        learning_rate=args.lr, optimizer=args.optimizer,
        momentum=args.momentum, clip_norm=args.clip_norm,
        dropout=args.dropout, weight_decay=args.weight_decay,
        lr_schedule=args.lr_schedule, scale_lr_by_replicas=args.scale_lr,
        accum_steps=args.accum_steps, seed=args.seed,
        precision=args.precision,
        mesh=MeshConfig(data=args.data_axis, seq=args.seq,
                        tensor=args.tensor, pipe=args.pipe,
                        expert=args.expert),
        fsdp=args.fsdp, sp_impl=args.sp_impl, attn_impl=args.attn_impl,
        num_microbatches=args.microbatches,
        pipe_schedule=args.pipe_schedule, num_virtual=args.num_virtual,
        augment=args.augment, augment_kind=args.augment_kind,
        fused_encoder=args.fused, num_experts=args.num_experts,
        moe_router=args.moe_router, num_heads=args.num_heads,
        coordinator_address=args.coordinator,
        num_processes=args.num_processes, process_id=args.process_id,
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every_steps=args.ckpt_every,
        checkpoint_async=not args.ckpt_sync, resume=args.resume,
        max_restarts=args.max_restarts,
        watchdog_timeout_s=args.watchdog,
        sync_check_every_steps=args.sync_check,
        eval_every_epochs=args.eval_every,
        max_steps_per_epoch=args.max_steps,
        log_every_steps=args.log_every, profile_dir=args.profile_dir,
        trace_out=args.trace_out, metrics_file=args.metrics_file,
        metrics_port=args.metrics_port, telemetry_out=args.telemetry_out,
        slo=args.slo,
        alert_sinks=tuple(args.alert_sink) if args.alert_sink else None,
        loader_backend=args.loader, steps_per_call=args.steps_per_call,
        data_placement=args.data_placement,
        compilation_cache=args.compile_cache,
        device="cpu" if args.cpu else args.device,
    )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "serve":
        from ddp_practice_tpu_torch.serve.bench import main as serve_main

        return serve_main(argv[1:])
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    from ddp_practice_tpu_torch.parallel import dist
    from ddp_practice_tpu_torch.train.loop import fit

    t0 = time.time()
    try:
        summary = fit(config)
        main_process = dist.is_main_process()
    finally:
        dist.shutdown()
    summary["wall_seconds"] = time.time() - t0
    if args.json and main_process:
        print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
