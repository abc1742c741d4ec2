"""Autoregressive inference: KV-cache prefill/decode + sampling
(counterpart of ddp_practice_tpu/inference.py).

`decode_apply` is the one primitive both inference paths are built from:
a prompt prefill is `decode_apply` over the prompt, a decode step is
`decode_apply` over one token per sequence. The cache is a plain dict
with the Flax "cache" collection's tree (models/lm.py `init_cache`); the
model writes it in place and advances its host-int cursors.

Sampling draws from explicit `torch.Generator`s. They give other numbers
than JAX's threefry keys from the same seed, so sampled tokens match the
reference only in distribution; greedy decoding matches token for token.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ddp_practice_tpu_torch.models.lm import TransformerLM

_NEG = -1e30


def make_cache(model: TransformerLM, batch: int, total_len: int,
               device=None) -> dict:
    """Zero-initialised KV cache for `batch` sequences of `total_len`."""
    return model.init_cache(batch, total_len, device)


@torch.no_grad()
def decode_apply(model: TransformerLM, cache: dict, tokens: torch.Tensor,
                 *, attn_start: Optional[torch.Tensor] = None) -> tuple:
    """One decode-mode model application: `(cache, logits)`. The cache is
    updated in place and returned for symmetry with the reference."""
    logits = model(tokens, cache=cache, attn_start=attn_start)
    return cache, logits


def _filter_logits(logits: torch.Tensor, top_k: int, top_p: float):
    """The reference's k-then-p filter over fp32 (b, vocab) logits:
    entries outside the kept set become -1e30."""
    neg = torch.tensor(_NEG, dtype=logits.dtype, device=logits.device)
    top_k = min(top_k, logits.shape[-1])
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p > 0.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        # exclusive cumulative mass: the argmax (mass 0 before it) stays
        cum = torch.cumsum(probs, dim=-1) - probs
        thresh = torch.where(cum < top_p, desc,
                             torch.full_like(desc, float("inf")))
        thresh = thresh.amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, neg, logits)
    return logits


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """Sample ids (b,) from logits (b, vocab); upcast to fp32 first.
    temperature=0 is greedy argmax (no generator needed); top_k then top_p
    filter as in the reference."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = _filter_logits(logits.float() / temperature, top_k, top_p)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_logits_batch(logits: torch.Tensor, generators: Sequence,
                        *, temperature, top_k, top_p) -> torch.Tensor:
    """Per-row sampling: row i uses its own (temperature, top_k, top_p)
    and its own generator. temperature <= 0 is greedy; top_k <= 0 and
    top_p <= 0 switch a filter off. Every row with a generator draws once
    whatever its params, so a row's stream never depends on its
    batchmates'."""
    rows = []
    for i in range(logits.shape[0]):
        row = logits[i:i + 1].float()
        t, k, p = float(temperature[i]), int(top_k[i]), float(top_p[i])
        g = generators[i]
        if g is None:
            rows.append(torch.argmax(row, dim=-1))
            continue
        scaled = _filter_logits(row / (t if t > 0 else 1.0), max(k, 0),
                                max(p, 0.0))
        drawn = torch.multinomial(torch.softmax(scaled, -1), 1,
                                  generator=g)[:, 0]
        rows.append(torch.argmax(row, dim=-1) if t <= 0 else drawn)
    return torch.cat(rows)


def make_generate_fn(model: TransformerLM, *, max_new_tokens: int,
                     temperature: float = 1.0, top_k: int = 0,
                     top_p: float = 0.0, eos_id: Optional[int] = None,
                     pad_id: int = 0) -> Callable:
    """Build `gen(prompt, generator=None, prompt_lens=None) -> tokens`.

    `prompt` is (b, prompt_len) int; the result is
    (b, prompt_len + max_new_tokens) with the prompt copied through.
    `prompt_lens` marks LEFT-padded prompts (pad_left_prompts): the
    padding is masked out of every attention. After EOS a sequence emits
    `pad_id`. Like the reference's scan, the loop runs all
    `max_new_tokens` steps."""

    @torch.no_grad()
    def gen(prompt, generator=None, prompt_lens=None):
        dev = model.tok_embed.weight.device
        prompt = torch.as_tensor(prompt, device=dev).long()
        b, prompt_len = prompt.shape
        if prompt_len == 0:
            raise ValueError("prompt must contain at least one token")
        total = prompt_len + max_new_tokens
        if total > model.max_len:
            raise ValueError(
                f"prompt {prompt_len} + max_new_tokens {max_new_tokens} "
                f"exceeds model max_len {model.max_len}"
            )
        if temperature != 0.0 and generator is None:
            raise ValueError("sampling (temperature != 0) needs a generator")
        attn_start = None
        if prompt_lens is not None:
            lens = torch.as_tensor(prompt_lens, device=dev)
            lens = lens.clamp(1, prompt_len).to(torch.int32)
            attn_start = (prompt_len - lens).to(torch.int32)
        cache, logits = decode_apply(
            model, make_cache(model, b, total), prompt,
            attn_start=attn_start,
        )
        last = logits[:, -1]
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        out = []
        for _ in range(max_new_tokens):
            tok = sample_logits(last, generator, temperature=temperature,
                                top_k=top_k, top_p=top_p).long()
            tok = torch.where(done, torch.full_like(tok, pad_id), tok)
            if eos_id is not None:
                done = done | (tok == eos_id)
            # a finished row keeps decoding garbage that is never shown;
            # clamp its pad id into the vocabulary for the lookup
            fed = tok.clamp(0, model.vocab_size - 1)
            cache, logits = decode_apply(model, cache, fed[:, None],
                                         attn_start=attn_start)
            last = logits[:, -1]
            out.append(tok)
        return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)

    return gen


def pad_left_prompts(prompts, pad_id: int = 0):
    """Variable-length token lists -> (tokens (b, w) int64, lengths (b,)
    int32), real tokens right-aligned."""
    lens = np.asarray([len(p) for p in prompts], np.int32)
    if (lens == 0).any():
        raise ValueError("every prompt must contain at least one token")
    width = int(lens.max())
    out = np.full((len(prompts), width), pad_id, np.int64)
    for i, p in enumerate(prompts):
        out[i, width - len(p):] = np.asarray(p, np.int64)
    return torch.from_numpy(out), torch.from_numpy(lens)


def encode_bytes(text: str) -> np.ndarray:
    """str -> (1, len) int32 byte tokens (the byte-level LM vocabulary)."""
    raw = np.frombuffer(text.encode("utf-8"), dtype=np.uint8)
    return raw.astype(np.int32)[None, :]


def decode_bytes(tokens) -> str:
    """(len,) byte tokens -> str (invalid UTF-8 replaced, not raised)."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    arr = np.asarray(tokens).astype(np.uint8)
    return arr.tobytes().decode("utf-8", errors="replace")
