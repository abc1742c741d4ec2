"""The port's decode attention (ddp_practice_tpu_torch/ops/decode_attention.py)
against the JAX package's `decode_attention_packed`, whose Pallas kernels
run in interpret mode here. On CPU tensors the port's wrapper runs the
plain PyTorch version of its CUDA kernels; the kernels themselves are
held against that version on the card by chip_smoke.py.

Tolerance: fp32 at 2e-5, the reference tests' own
(tests/test_decode_attention.py). The int8 single-tile kernel multiplies
the score row by the key scale after q.k, while the port dequantizes the
keys first; in fp32 the two differ by rounding only, inside the same
2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_practice_tpu.ops.decode_attention import (
    decode_attention_packed as jax_decode,
)
from ddp_practice_tpu_torch.ops.decode_attention import (
    LAUNCHES,
    decode_attention_packed,
    decode_attention_plain,
)

B, H, HD = 3, 4, 64
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(L, cur, seed, quant=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H * HD)).astype(np.float32)
    if quant:
        kc = rng.integers(-127, 128, size=(B, L, H * HD)).astype(np.int8)
        vc = rng.integers(-127, 128, size=(B, L, H * HD)).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, size=(B, H, L)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, size=(B, H, L)).astype(np.float32)
        return q, kc, vc, ks, vs
    kc = rng.normal(size=(B, L, H * HD)).astype(np.float32)
    vc = rng.normal(size=(B, L, H * HD)).astype(np.float32)
    return q, kc, vc, None, None


def _starts(cur):
    # every row keeps at least one valid key ([start, cur] non-empty)
    return np.asarray([0, min(5, cur), min(60, cur)], np.int32)


def _compare(L, cur, with_start, quant, seed, **jax_kw):
    q, kc, vc, ks, vs = _inputs(L, cur, seed, quant)
    start = _starts(cur) if with_start else None
    want = jax_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(cur),
        None if start is None else jnp.asarray(start), n_heads=H,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), **jax_kw,
    )
    t = torch.from_numpy
    got = decode_attention_packed(
        t(q), t(kc), t(vc), cur, None if start is None else t(start),
        n_heads=H, k_scale=None if ks is None else t(ks),
        v_scale=None if vs is None else t(vs),
    )
    assert got.shape == (B, 1, H * HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_start", [False, True])
@pytest.mark.parametrize("cur", [0, 100, 255])
def test_single_tile_matches_jax(cur, with_start):
    _compare(256, cur, with_start, quant=False, seed=cur)


@pytest.mark.parametrize("with_start", [False, True])
@pytest.mark.parametrize("cur", [3, 700, 1500])
def test_multi_block_matches_jax(cur, with_start):
    """L=2048 takes the reference's online-softmax kernel (block_l 512,
    blocks past `cur` skipped)."""
    _compare(2048, cur, with_start, quant=False, seed=cur + 1,
             block_l=512, single_block_max=1024)


@pytest.mark.parametrize("cur", [0, 100, 255])
def test_int8_single_tile_matches_jax(cur):
    """L=256: the reference's `_kernel_single_quant`."""
    _compare(256, cur, True, quant=True, seed=cur + 2)


@pytest.mark.parametrize("cur", [3, 1500])
def test_int8_long_cache_matches_jax_dequantize(cur):
    """L=2048: the reference dequantizes in XLA and runs the multi-block
    kernel; the port computes the same at every L."""
    _compare(2048, cur, True, quant=True, seed=cur + 3, block_l=512,
             single_block_max=1024)


def test_rejects_multi_row_queries():
    q, kc, vc, _, _ = _inputs(128, 4, 0)
    q2 = torch.from_numpy(np.concatenate([q, q], axis=1))
    with pytest.raises(ValueError, match="single-token"):
        decode_attention_packed(q2, torch.from_numpy(kc),
                                torch.from_numpy(vc), 4, n_heads=H)


def test_rejects_unpackable_heads():
    q = torch.zeros((1, 1, 3 * 64))
    kc = torch.zeros((1, 64, 3 * 64))
    with pytest.raises(ValueError, match="pack"):
        decode_attention_packed(q, kc, kc, 0, n_heads=3)
    q = torch.zeros((1, 1, 4 * 32))
    kc = torch.zeros((1, 64, 4 * 32))
    with pytest.raises(ValueError, match="pack"):
        decode_attention_plain(q, kc, kc, 0, n_heads=4)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q, kc, vc, _, _ = _inputs(64, 10, 4)
    before = dict(LAUNCHES)
    t = torch.from_numpy
    got = decode_attention_packed(t(q), t(kc), t(vc), 10, n_heads=H)
    want = decode_attention_plain(t(q), t(kc), t(vc), 10, n_heads=H)
    assert torch.equal(got, want)
    assert LAUNCHES == before


def test_kernel_without_a_card_raises():
    """Asking for the kernel never runs on the CPU: CPU tensors are
    refused, and the library loader raises when no card is present."""
    from ddp_practice_tpu_torch.ops.cuda_build import load_library

    q, kc, vc, _, _ = _inputs(64, 10, 5)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_attention_packed(t(q), t(kc), t(vc), 10, n_heads=H,
                                impl="kernel")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            load_library("decode_attention")
