"""The port's TransformerLM (ddp_practice_tpu_torch/models) against the
JAX package's, from one set of converted weights: the training forward
(learned and RoPE positions, tied and untied heads) at 1e-5, and KV-cache
decode (an 8-token left-padded prefill, then 4 single-token steps through
the decode-attention path) at 1e-4 for the fp32 cache.

int8 cache: both sides quantize K/V per (batch, token, head) on write,
but the projections they quantize differ by fp32 rounding (~1e-6), which
can move a value that sits on a rounding boundary by one int8 step
(1/127 of that row's max). The JAX single-tile kernel also applies the
key scale after q.k rather than before. The logits are therefore held at
an absolute 2e-3 (logits here are O(1)), against a difference the int8
cache itself makes of ~1e-2 relative (tests/test_decode_attention.py
pins that at 5%)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import build_pair
from ddp_practice_tpu.inference import decode_apply as jax_decode_apply
from ddp_practice_tpu.inference import make_cache as jax_make_cache
from ddp_practice_tpu_torch.convert import flax_to_state_dict
from ddp_practice_tpu_torch.inference import decode_apply, make_cache

VOCAB = 64


def test_converter_layouts():
    _, params, tm = build_pair(0, max_len=32, pos_emb="rope")
    sd = flax_to_state_dict(jax.device_get(params))
    assert set(sd) == set(tm.state_dict())
    qkv = np.asarray(params["block0"]["attn"]["qkv"]["kernel"])
    w = sd["blocks.0.attn.qkv.weight"].numpy()
    # row (j, head, i) of the torch weight is column [:, j, head, i]
    np.testing.assert_array_equal(w[1 * 128 + 64 + 3], qkv[:, 1, 1, 3])
    out = np.asarray(params["block1"]["attn"]["out"]["kernel"])
    np.testing.assert_array_equal(
        sd["blocks.1.attn.out.weight"].numpy()[5, 64 + 2], out[1, 2, 5])


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("pos_emb", ["learned", "rope"])
def test_training_forward_matches_jax(pos_emb, tied):
    jm, params, tm = build_pair(1, max_len=32, pos_emb=pos_emb,
                                tied_embeddings=tied)
    tokens = np.random.default_rng(2).integers(0, VOCAB, (2, 24))
    want = jm.apply({"params": params}, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _decode_both(kv_cache_dtype, seed):
    """8-token left-padded prefill + 4 token steps in both packages;
    returns the stacked logits (jax, torch) and the torch cache."""
    jm, params, tm = build_pair(seed, max_len=32, pos_emb="rope",
                                kv_cache_dtype=kv_cache_dtype)
    rng = np.random.default_rng(seed + 10)
    prompt = rng.integers(1, VOCAB, (2, 8))
    prompt[0, :3] = 0                       # row 0 is 5 tokens, padded
    starts = np.asarray([3, 0], np.int32)
    steps = rng.integers(0, VOCAB, (2, 4))

    # jitted: one compile per shape beats eager interpret-mode dispatch
    step = jax.jit(functools.partial(jax_decode_apply, jm))
    jcache = jax_make_cache(jm, 2, 12)
    jstart = jnp.asarray(starts)
    jcache, lg = step(params, jcache, jnp.asarray(prompt, jnp.int32),
                      attn_start=jstart)
    want = [np.asarray(lg)]
    tcache = make_cache(tm, 2, 12)
    tstart = torch.from_numpy(starts)
    tcache, lg = decode_apply(tm, tcache, torch.from_numpy(prompt),
                              attn_start=tstart)
    got = [lg.numpy()]
    for i in range(4):
        jcache, lg = step(params, jcache,
                          jnp.asarray(steps[:, i:i + 1], jnp.int32),
                          attn_start=jstart)
        want.append(np.asarray(lg))
        tcache, lg = decode_apply(tm, tcache,
                                  torch.from_numpy(steps[:, i:i + 1]),
                                  attn_start=tstart)
        got.append(lg.numpy())
    return np.concatenate(want, 1), np.concatenate(got, 1), tcache


def test_decode_fp32_cache_matches_jax():
    want, got, cache = _decode_both(None, 3)
    assert cache["block0"]["attn"]["cache_index"] == 12
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_decode_int8_cache_matches_jax():
    want, got, cache = _decode_both("int8", 4)
    attn = cache["block1"]["attn"]
    assert attn["cached_key"].dtype == torch.int8
    assert attn["cached_key_scale"].shape == (2, 2, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_decode_steps_match_full_forward():
    """Prefill + token steps reproduce the training forward's logits: the
    cache path is an optimisation, not an approximation."""
    _, _, tm = build_pair(5, max_len=32, pos_emb="rope")
    tokens = torch.from_numpy(
        np.random.default_rng(6).integers(0, VOCAB, (2, 10)))
    with torch.no_grad():
        full = tm(tokens)
    cache = make_cache(tm, 2, 10)
    cache, first = decode_apply(tm, cache, tokens[:, :6])
    outs = [first]
    for i in range(6, 10):
        cache, lg = decode_apply(tm, cache, tokens[:, i:i + 1])
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=1e-5,
                               atol=1e-5)
