"""The port's decode attention (ddp_practice_tpu_torch/ops/decode_attention.py)
against the JAX package's `decode_attention_packed`, whose Pallas kernels
run in interpret mode here. On CPU tensors the port's wrapper runs the
plain PyTorch version of its CUDA kernels; the kernels themselves are
held against that version on the card by chip_smoke.py. The kernels'
split over the cache (`_split_plan`, per-split max and rounding, the
in-launch combine) runs here as its torch emulation
(tests/_decode_split.py), held against the plain version and the JAX
kernels.

Tolerance: fp32 at 2e-5, the reference tests' own
(tests/test_decode_attention.py). The int8 single-tile kernel multiplies
the score row by the key scale after q.k, while the port dequantizes the
keys first; in fp32 the two differ by rounding only, inside the same
2e-5. bf16 at |err| <= 1.6e-2 + 2^-7 |ref| (chip_smoke.py's BF16_TOL):
the split schedule rounds each p to bf16 against its split's max, the
plain version against the global max, so a p can differ by a bf16 ulp
and the final rounding of an output by one more."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_practice_tpu.ops.decode_attention import (
    decode_attention_packed as jax_decode,
)
from _decode_split import flat_split_emulated
from ddp_practice_tpu_torch.ops.decode_attention import (
    _MAX_SMEM,
    _SPLIT_SMEM,
    LAUNCHES,
    _key_group,
    _smem_bytes,
    _split_plan,
    decode_attention_packed,
    decode_attention_plain,
)

B, H, HD = 3, 4, 64
TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1.6e-2)


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


# ------------------------------------------------------- the split schedule
# (L, cur, plan (splits, chunk) or None for `_split_plan`'s, attn_start)
SPLIT_CASES = [
    (256, 255, (4, 64), [0, 100, 200]),     # starts in later splits
    (256, 63, (1, 64), [0, 5, 63]),         # cur on a chunk's last key
    (256, 64, (2, 64), [0, 64, 10]),        # cur opens split 1, a start too
    (2048, 1500, (24, 64), [0, 700, 1400]),  # splits empty for later starts
    (2048, 2047, None, [3, 1024, 2000]),    # the plan's own chunks
]


def _plan(L, cur, plan, quant, bh=B * H):
    return plan or _split_plan(cur + 1, bh, d=HD, kv_bytes=1 if quant else 4,
                               quant=quant)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("L,cur,plan,starts", SPLIT_CASES)
def test_split_schedule_matches_plain_and_jax(L, cur, plan, starts, quant):
    q, kc, vc, ks, vs = _inputs(L, cur, seed=cur + quant, quant=quant)
    start = np.asarray(starts, np.int32)
    t = torch.from_numpy
    kw = dict(n_heads=H, k_scale=None if ks is None else t(ks),
              v_scale=None if vs is None else t(vs))
    got = flat_split_emulated(t(q), t(kc), t(vc), cur, t(start),
                              _plan(L, cur, plan, quant), **kw)
    want = decode_attention_plain(t(q), t(kc), t(vc), cur, t(start), **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    jax_kw = {} if L <= 256 else dict(block_l=512, single_block_max=1024)
    ref = jax_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(cur),
        jnp.asarray(start), n_heads=H,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), **jax_kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("plan", [(1, 2048), (8, 256), (32, 64)])
def test_split_schedule_bf16_matches_plain(plan, quant):
    """bf16 queries (and cache): p rounds to bf16 against each split's max;
    the plain version's exact max moves a rounding by at most an ulp."""
    q, kc, vc, ks, vs = _inputs(2048, 2047, seed=7, quant=quant)
    t = torch.from_numpy
    q16 = t(q).bfloat16()
    k16, v16 = (t(kc), t(vc)) if quant else (t(kc).bfloat16(),
                                             t(vc).bfloat16())
    start = torch.tensor([0, 333, 1900], dtype=torch.int32)
    kw = dict(n_heads=H, k_scale=None if ks is None else t(ks),
              v_scale=None if vs is None else t(vs))
    got = flat_split_emulated(q16, k16, v16, 2047, start, plan, **kw)
    want = decode_attention_plain(q16, k16, v16, 2047, start, **kw)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


def test_split_schedule_empty_range_gives_zeros():
    """A row whose attn_start passes cur has every split empty (m = -inf,
    l = 0): the combine writes zeros, as the plain version does."""
    q, kc, vc, _, _ = _inputs(256, 100, seed=3)
    t = torch.from_numpy
    start = torch.tensor([101, 0, 50], dtype=torch.int32)
    for plan in ((1, 128), (4, 32)):
        got = flat_split_emulated(t(q), t(kc), t(vc), 100, start, plan,
                                  n_heads=H)
        assert not got[0].any()
        want = decode_attention_plain(t(q), t(kc), t(vc), 100, start,
                                      n_heads=H)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# (head_dim, cache bytes per element, int8)
KV_KINDS = [(64, 4, False), (64, 2, False), (64, 1, True), (128, 2, False),
            (256, 4, False), (256, 1, True)]


@pytest.mark.parametrize("d,kv_bytes,quant", KV_KINDS)
def test_split_plan_covers_the_range_and_refuses_no_length(d, kv_bytes,
                                                           quant):
    """Flat: a range of at most `span` keys is one split; a longer one
    takes ceil(len / chunk) splits of `chunk` keys, and the plan's splits
    cover the longest (n) with the last holding at least one position; a
    chunk is a multiple of the block's key group, `span` fits a split's
    shared memory, and every n up to 2^20 is taken (the old kernel refused
    a span past its shared memory)."""
    group = _key_group(d, kv_bytes)
    for n in (1, 2, 31, 255, 321, 1000, 2048, 4097, 32768, 56000, 65536,
              999_983, 2 ** 20):
        for bh in (1, 12, 96, 768):
            splits, chunk, span = _split_plan(n, bh, d=d, kv_bytes=kv_bytes,
                                              quant=quant)
            assert chunk % group == 0 and span % group == 0
            assert chunk <= span
            if n <= span:
                assert splits == 1
                assert _smem_bytes(span, d, kv_bytes, quant) <= _MAX_SMEM
            else:
                assert (splits - 1) * chunk < n <= splits * chunk
                assert _smem_bytes(span, d, kv_bytes, quant) <= _SPLIT_SMEM


@pytest.mark.parametrize("d,kv_bytes,quant", KV_KINDS)
def test_split_plan_pages(d, kv_bytes, quant):
    """Paged: chunks of whole pages (or, for a page larger than a split's
    shared memory, equal parts of one page) over the capacity mb * bs, up
    to 2^20 positions a slot."""
    for bs in (8, 16, 48, 256, 1024):
        for mb in (1, 3, 128, 2 ** 20 // bs):
            n = mb * bs
            splits, chunk, span = _split_plan(n, 8 * H, d=d,
                                              kv_bytes=kv_bytes, quant=quant,
                                              bs=bs)
            assert n <= span or (splits - 1) * chunk < n <= splits * chunk
            assert chunk % 8 == 0 and span % 8 == 0
            if splits > 1:
                for size in (chunk, span):
                    assert size % bs == 0 or bs % size == 0
                assert _smem_bytes(span, d, kv_bytes, quant,
                                   bs) <= _SPLIT_SMEM


def test_split_plan_fills_the_card_and_keeps_serve_shapes_whole():
    """Batch 1 splits into enough blocks for the 132 SMs; the serve shape
    (8 slots of 12 heads, ~321 positions) keeps one split; a long range
    takes many chunks, each a split's shared memory at most."""
    s, c, span = _split_plan(2048, 12, d=64, kv_bytes=2, quant=False)
    assert 12 * s >= 132 and c * 2 * 64 * 2 >= 32 * 1024 and span >= c
    assert _split_plan(321, 96, d=64, kv_bytes=2, quant=False)[0] == 1
    assert _split_plan(320, 96, d=64, kv_bytes=2, quant=False, bs=16)[0] == 1
    # 8 x 12 pairs: one block each while a block's 227 KB holds the range
    assert _split_plan(1025, 96, d=64, kv_bytes=1, quant=True)[0] == 1
    assert _split_plan(1025, 12, d=64, kv_bytes=1, quant=True)[0] > 1
    assert _split_plan(2048, 96, d=64, kv_bytes=2, quant=False)[0] > 1
    s, c, _ = _split_plan(32768, 12, d=64, kv_bytes=2, quant=False)
    assert s * c >= 32768 and 12 * s >= 2 * 132


def test_split_plan_whole_keeps_one_split_while_a_block_holds_it():
    """`whole` (kernel C, fp32 queries over a bf16 pool): one split up to
    a block's 227 KB of shared memory, past it the usual plan."""
    kw = dict(d=256, kv_bytes=2, quant=False, bs=16)
    assert _split_plan(128, 4, whole=True, **kw) == (1, 128, 128)
    assert _split_plan(128, 4, **kw)[0] > 1
    assert _split_plan(65536, 4, whole=True, **kw) == _split_plan(65536, 4,
                                                                   **kw)


def test_split_schedule_short_ranges_take_one_split():
    """With span >= the valid length, a (batch, head) is one split and the
    schedule is the plain version's arithmetic (exact max): bf16 outputs
    are equal bit for bit, wherever the range starts."""
    q, kc, vc, _, _ = _inputs(2048, 2047, seed=9)
    t = torch.from_numpy
    q16, k16, v16 = t(q).bfloat16(), t(kc).bfloat16(), t(vc).bfloat16()
    start = torch.tensor([1800, 1700, 1900], dtype=torch.int32)
    got = flat_split_emulated(q16, k16, v16, 2047, start, (16, 128, 352),
                              n_heads=H)
    want = decode_attention_plain(q16, k16, v16, 2047, start, n_heads=H)
    assert torch.equal(got, want)


def test_hbm_bandwidth_is_known_for_the_h100_only():
    """The bytes bounds of A-D divide by the card's memory rate: 3.35 TB/s
    for the H100 SXM (data sheet); an unknown name (the CPU, a TPU kind
    the reference's own table holds) gives None, as the reference's
    `chip_hbm_bandwidth` does for a kind it does not know."""
    from ddp_practice_tpu.utils.flops import (
        chip_hbm_bandwidth as jax_hbm,
    )
    from ddp_practice_tpu_torch.utils.flops import chip_hbm_bandwidth

    assert chip_hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert chip_hbm_bandwidth(" NVIDIA H100 80GB HBM3\n") == 3.35e12
    for name in ("cpu", "TPU v4", "NVIDIA A100-SXM4-80GB"):
        assert chip_hbm_bandwidth(name) is None
    assert jax_hbm("cpu") is None
    assert jax_hbm("TPU v4") == 1228e9
