"""Where a ResNet train step's time goes (ROADMAP A2's models; the
ResNet half of the root experiments/step_profile.py).

    python -m ddp_practice_tpu_torch.experiments.resnet_step \
        [--model resnet18|resnet50] [--steps 20]
    python -m ddp_practice_tpu_torch.experiments.resnet_step \
        --model resnet50 --losses sgd:0.05,sgd:0.01,adam:1e-4 \
        [--precision bf16|fp32]

The model built through `Trainer` from the CLI's parser at the reference
bench's shapes (bench.py:78-85: ResNet-18 on 32x32x3, batch 512,
crop_flip; ResNet-50 on 224x224x3, 1000 classes, batch 128, rrc), bf16,
SGD with momentum, fed one fixed device batch so the loader is out of the
reading (ResNet-50's synthetic ImageNet corpus is cut to 256 images
under build/). Prints, each a median of `--steps` CUDA-event intervals:
the augmentation alone, the train-mode forward, forward + backward and
the whole eager step; the host wall a step; then one step under
torch.profiler: device busy, the device's idle share, device ops, device
time by kind (cuDNN convs, BatchNorm's reductions, elementwise,
augmentation's gathers and contractions as matmul, copies) and the top
ops. Whether the activations stay channels-last is printed too (a conv
fed a tensor in another layout converts it). `--losses` instead runs the
smoke's leg (fit, host batches) under each optimizer setting and prints
its losses, in bf16 as the leg runs or in fp32 (TF32 off) to tell the
optimizer's behaviour from bf16's. Device times come from the card
only: on the CPU the script prints host walls.
"""

from __future__ import annotations

import argparse
import re
import statistics
import sys
import time

import torch

from ddp_practice_tpu_torch.cli import build_parser, config_from_args
from ddp_practice_tpu_torch.ops.augment import apply_augment, augment_rng
from ddp_practice_tpu_torch.ops.losses import cross_entropy
from ddp_practice_tpu_torch.train.loop import Trainer
from ddp_practice_tpu_torch.train.steps import prepare_image
from ddp_practice_tpu_torch.utils import xprof

# model -> (dataset, batch, augmentation, train images): the smoke's
# legs (0: the dataset's own size, 50000 for CIFAR-10)
SHAPES = {"resnet18": ("cifar10", 512, "crop_flip", 0),
          "resnet50": ("imagenet", 128, "rrc", 4096)}
KINDS = (("conv (cuDNN)", "conv|fprop|dgrad|wgrad|cudnn|implicit|winograd|"
                          "xmma|sm90_"),
         ("reduce", "reduce"),
         ("matmul", "gemm|gemv|nvjet|cutlass"),
         ("pool", "pool"),
         ("copy", "copy|memcpy|memset|cat|pad|index"),
         ("elementwise", "elementwise|vectorized|unrolled"))


def _timed(fn, steps, cuda):
    """(median ms between CUDA events around each call, or the host wall
    on the CPU)."""
    fn()
    out = []
    for _ in range(steps):
        if cuda:
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            out.append((s, e))
        else:
            t = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t)
    if cuda:
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in out)
    return statistics.median(out) * 1e3


def main(model: str = "resnet18", steps: int = 20, device: str = "cuda"):
    dataset, batch, augment, _ = SHAPES[model]
    argv = ["--model", model, "--dataset", dataset, "-b", str(batch),
            "--precision", "bf16", "--optimizer", "sgd", "--momentum",
            "0.9", "--lr", "0.05", "--device", device, "--data_dir",
            "build/resnet_step", "--synthetic_size", "256",
            "--data_placement", "host", "--augment", "--augment_kind",
            augment]
    trainer = Trainer(config_from_args(build_parser().parse_args(argv)))
    cuda = trainer.device.type == "cuda"
    card = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(f"{card}; {model} bf16 batch {batch} augment {augment}",
          flush=True)
    data = trainer._to_device(next(iter(trainer.train_loader)))
    net, state = trainer.model, trainer.state
    images = prepare_image(data["image"])
    key = augment_rng(0, state.device_step())
    labels = data["label"]

    def fwd():
        return net(images, train=True)

    def fwd_bwd():
        cross_entropy(net(images, train=True), labels).backward()

    def step():
        trainer.state, _ = trainer.train_step(trainer.state, data)

    rows = [("augment", lambda: apply_augment(images, key, augment)),
            ("forward (train mode)", fwd), ("forward + backward", fwd_bwd),
            ("whole step", step)]
    for name, fn in rows:
        print(f"  {name:22s} {_timed(fn, steps, cuda):9.3f} ms", flush=True)
    if cuda:
        torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        step()
    if cuda:
        torch.cuda.synchronize()
    host = (time.perf_counter() - t) * 1e3 / steps
    print(f"  host wall a step      {host:9.3f} ms", flush=True)
    y = net.stem_conv(images.to(net.dtype).permute(0, 3, 1, 2))
    print(f"  stem output channels-last: "
          f"{y.is_contiguous(memory_format=torch.channels_last)}; after "
          f"the first block: {_block_out(net, images)}")
    if not cuda:
        return None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    summary = xprof.op_summary_events(xprof.device_events(prof))
    kinds = dict.fromkeys([k for k, _ in KINDS] + ["other"], 0.0)
    for (_, name), ps in summary["ops"].items():
        kind = next((k for k, rx in KINDS if re.search(rx, name.lower())),
                    "other")
        kinds[kind] += ps / 1e9
    busy = sum(kinds.values())
    ops = sum(c["count"] for c in summary["categories"].values())
    print(f"  profiled step: device busy {busy:.3f} ms, idle share "
          f"{max(0.0, 1 - busy / host):.3f} (against the host wall), "
          f"{ops} device ops; by kind " + ", ".join(
              f"{k} {v:.3f}" for k, v in kinds.items()))
    for (_, name), ps in sorted(summary["ops"].items(),
                                key=lambda kv: -kv[1])[:15]:
        calls = summary["op_counts"][(_, name)]
        print(f"  {ps / 1e9:9.3f} ms {calls:5d} calls  {name[:100]}")
    return kinds


def losses(model: str, settings, steps: int = 20, device: str = "cuda",
           precision: str = "bf16"):
    """`fit` for `steps` steps (host batches, eager) under each optimizer
    setting ("sgd:LR" with momentum 0.9, or "adam:LR") at `precision`,
    the smoke's leg otherwise (its corpus, batch and augmentation); in
    fp32 cuDNN's and cuBLAS's TF32 are turned off. Prints the
    loss at steps 1, 5, 10, 15, 20 and the means of the first and last
    five. Which setting's loss falls within the leg's steps."""
    dataset, batch, augment, size = SHAPES[model]
    torch.backends.cudnn.allow_tf32 = precision != "fp32"
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{model} {precision} batch {batch} augment {augment}", flush=True)
    out = {}
    for setting in settings:
        opt, lr = setting.split(":")
        argv = ["--model", model, "--dataset", dataset, "-b", str(batch),
                "--precision", precision, "--optimizer", opt, "--lr", lr,
                "--device", device, "--data_dir", "build/resnet_step",
                "--synthetic_size", str(size), "--max_steps", str(steps),
                "-e", "1", "--log_every", "0", "--data_placement", "host",
                "--augment", "--augment_kind", augment]
        if opt == "sgd":
            argv += ["--momentum", "0.9"]
        trainer = Trainer(config_from_args(build_parser().parse_args(argv)))
        seen, step = [], trainer.train_step

        def recorded(*args):
            state, metrics = step(*args)
            seen.append(metrics["loss"])
            return state, metrics

        trainer.train_step = recorded
        trainer.train_epoch(0)
        loss = [float(x) for x in seen]
        out[setting] = loss
        head, tail = statistics.fmean(loss[:5]), statistics.fmean(loss[-5:])
        print(f"  {setting:12s} loss at steps " + ", ".join(
            f"{i} {loss[i - 1]:.4f}" for i in (1, 5, 10, 15, 20)
            if i <= len(loss)) + f"; first five {head:.4f}, last five "
            f"{tail:.4f}", flush=True)
    return out


def _block_out(net, images):
    x = images.to(net.dtype).permute(0, 3, 1, 2)
    x = torch.relu(net.stem_bn(net.stem_conv(x), train=True))
    x = getattr(net, net.block_names[0])(x, train=True)
    return x.is_contiguous(memory_format=torch.channels_last)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="resnet18", choices=sorted(SHAPES))
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--device", default="cuda")
    p.add_argument("--losses", default="", metavar="OPT:LR,...",
                   help="instead: the loss over `--steps` fit steps under "
                        "each optimizer setting, e.g. sgd:0.05,adam:1e-4")
    p.add_argument("--precision", default="bf16", choices=("bf16", "fp32"),
                   help="the `--losses` runs' precision")
    a = p.parse_args()
    if a.losses:
        losses(a.model, a.losses.split(","), a.steps, device=a.device,
               precision=a.precision)
    else:
        main(a.model, a.steps, a.device)
    sys.exit(0)
