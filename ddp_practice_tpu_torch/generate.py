"""Generate text from a trained LM checkpoint (counterpart of
ddp_practice_tpu/generate.py).

    python -m ddp_practice_tpu_torch.generate --ckpt_dir ckpts \\
        --prompt "def main" --max_new_tokens 256 --temperature 0.8 --top_k 40

The training run's state-shaping knobs (model, optimizer, seq_len,
vocabulary, positions, tied head, precision) are read back from the
checkpoint manifest (train/loop.py `save`), so only the checkpoint
directory is required; flags override. The checkpoint may be the port's
own or one the JAX package wrote (checkpoint/ reads both). Decoding runs
on the card unless `--device cpu`: its single-token steps go through
kernel A, or kernel B with `--kv_cache int8` (ops/decode_attention.py).

Sampling draws from a `torch.Generator` seeded with `--seed`; its numbers
are not JAX's, so sampled text matches the reference only in
distribution. Greedy decoding (`--temperature 0`) matches it token for
token.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

import ddp_practice_tpu_torch.checkpoint as ckpt
from ddp_practice_tpu_torch.config import PrecisionPolicy, TrainConfig
from ddp_practice_tpu_torch.inference import (
    cast_params_for_streaming,
    decode_bytes,
    encode_bytes,
    make_generate_fn,
)
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--prompt", default="\n")
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.8,
                   help="0 = greedy argmax")
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=0.0)
    p.add_argument("--eos_id", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model", default=None,
                   help="override the manifest's model name")
    p.add_argument("--seq_len", type=int, default=0,
                   help="override the manifest's max sequence length")
    p.add_argument("--kv_cache", default="policy",
                   choices=["policy", "int8"],
                   help="KV-cache storage: the policy dtype (default) or "
                        "int8 (quantized cache + scales, kernel B)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default; raises without one) or the CPU")
    return p


def load_lm(ckpt_dir, *, model=None, seq_len=0, kv_cache="policy",
            device="cuda", precision=None) -> tuple:
    """(model, step) rebuilt from the checkpoint manifest and leaves on
    `device`; shared by this CLI and the serving entry point
    (serve/bench.py). `precision` ("fp32" | "bf16") overrides the
    manifest's policy. The whole train state is restored (the optimizer
    rebuilt from the manifest, as the reference rebuilds its tree), so a
    checkpoint whose leaves do not fit the model raises naming one.
    Under the bf16 policy the parameters are then cast to bf16 for
    streaming (inference.cast_params_for_streaming)."""
    manifest = ckpt.latest_manifest(ckpt_dir)
    if manifest is None:
        raise SystemExit(f"no checkpoint under {ckpt_dir!r}")
    extra = manifest.get("extra", {})
    name = model or extra.get("model")
    if not name or not name.startswith("lm_"):
        raise SystemExit(
            f"checkpoint model {name!r} is not an LM (lm_*): generation "
            "needs a decoder; pass --model to override")
    if name == "lm_pipe":
        raise SystemExit("lm_pipe has no KV-cache decode path: generate "
                         "from an equivalent lm_tiny/lm_base checkpoint")
    seq_len = seq_len or int(extra.get("seq_len", 2048))
    vocab = int(extra.get("vocab_size", 256))
    policy = PrecisionPolicy.from_name(
        precision or extra.get("precision_policy", "fp32"))
    model_kw = {"kv_cache_dtype": "int8"} if kv_cache == "int8" else {}
    lm = create_model(
        name, policy=policy, device=device, vocab_size=vocab,
        max_len=seq_len, remat=bool(extra.get("remat", False)),
        pos_emb=extra.get("pos_emb", "learned"),
        tied_embeddings=bool(extra.get("tied_embeddings", False)),
        **model_kw)
    cfg = TrainConfig(
        model=name, optimizer=extra.get("optimizer", "sgd"),
        momentum=float(extra.get("momentum", 0.0)),
        clip_norm=float(extra.get("clip_norm", 0.0)),
        weight_decay=float(extra.get("weight_decay", 0.0)),
        accum_steps=int(extra.get("accum_steps", 1)), device=device)
    ckpt.restore(ckpt_dir, TrainState(step=0, model=lm,
                                      optimizer=make_optimizer(cfg, lm)))
    if policy.name == "bf16":
        cast_params_for_streaming(lm)
    return lm, int(extra.get("step", -1))


def cut_at_eos(tokens, eos_id):
    """The generated ids up to the first `eos_id` (the done-mask pads
    every later slot with pad id 0, which must not reach the text)."""
    tokens = list(tokens)
    if eos_id is not None and eos_id in tokens:
        tokens = tokens[:tokens.index(eos_id)]
    return tokens


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    model, step = load_lm(args.ckpt_dir, model=args.model,
                          seq_len=args.seq_len, kv_cache=args.kv_cache,
                          device=args.device)
    prompt = torch.from_numpy(encode_bytes(args.prompt)).long()
    gen = make_generate_fn(
        model, max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        eos_id=args.eos_id)
    generator = None
    if args.temperature != 0.0:
        generator = torch.Generator(device=args.device)
        generator.manual_seed(args.seed)
    t0 = time.perf_counter()
    tokens = gen(prompt, generator).cpu()
    dt = time.perf_counter() - t0
    generated = cut_at_eos(tokens[0, prompt.shape[1]:].tolist(), args.eos_id)
    print(decode_bytes(torch.tensor(generated, dtype=torch.int64)))
    print(f"[generate] ckpt step {step}, {args.max_new_tokens} tokens in "
          f"{dt:.2f}s ({args.max_new_tokens / dt:.1f} tok/s)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
