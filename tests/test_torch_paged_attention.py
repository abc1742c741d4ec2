"""The port's paged decode attention (ddp_practice_tpu_torch/ops/
decode_attention.py `paged_decode_attention`) against the JAX package's:
its Pallas `_paged_kernel` / `_paged_kernel_quant` in interpret mode and
its gather reference `paged_attention_reference`. On CPU tensors the
port runs the plain PyTorch version of kernels C and D; the kernels
themselves are held against that version on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Shapes: 3 slots, 2 heads of 64, a 12-block pool of 16 positions, 4
blocks per slot, page tables drawn from [1, 12) with one block shared by
two slots; lengths [0, 37, 63], with and without attn_start [2, 0, 17].

Tolerance: fp32 at 2e-5, the reference tests' own
(tests/test_decode_attention.py). The int8 pool: the port folds the
scales into the score and probability rows as `_paged_kernel_quant`
does, while the gather reference dequantizes first; in fp32 the two
differ by rounding only, inside the same 2e-5.

The kernels' split over each slot's capacity runs here as its torch
emulation (tests/_decode_split.py) at several plans: whole-page chunks,
splits past a slot's cursor, a garbage-block row, attn_start in a later
split, a cursor on a chunk edge. bf16 at |err| <= 1.6e-2 + 2^-7 |ref|
(chip_smoke.py's BF16_TOL): each split rounds p against its own max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_practice_tpu.ops.decode_attention import (
    gather_pages as jax_gather_pages,
    paged_attention_reference as jax_paged_reference,
    paged_decode_attention as jax_paged,
)
from _decode_split import paged_split_emulated
from ddp_practice_tpu_torch.ops.decode_attention import (
    LAUNCHES,
    _split_plan,
    gather_pages,
    paged_attention_reference,
    paged_decode_attention,
    paged_decode_attention_plain,
)

B, H, HD = 3, 2, 64
NB, BS, MB = 12, 16, 4
LENGTHS = np.asarray([0, 37, 63], np.int32)
STARTS = np.asarray([2, 0, 17], np.int32)
TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1.6e-2)


def _inputs(seed, quant=False, h=H, d=HD):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, h * d)).astype(np.float32)
    if quant:
        kp = rng.integers(-127, 128, size=(NB, BS, h * d)).astype(np.int8)
        vp = rng.integers(-127, 128, size=(NB, BS, h * d)).astype(np.int8)
        ks = (np.abs(rng.normal(size=(NB, h, BS))) * 0.01
              + 1e-3).astype(np.float32)
        vs = (np.abs(rng.normal(size=(NB, h, BS))) * 0.01
              + 1e-3).astype(np.float32)
    else:
        kp = rng.normal(size=(NB, BS, h * d)).astype(np.float32)
        vp = rng.normal(size=(NB, BS, h * d)).astype(np.float32)
        ks = vs = None
    pt = rng.integers(1, NB, size=(B, MB)).astype(np.int32)
    pt[2, 1] = pt[1, 0]            # one block shared by two slots
    return q, kp, vp, pt, ks, vs


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("with_start", [False, True])
def test_paged_attention_matches_jax_kernel_and_reference(quant,
                                                          with_start):
    q, kp, vp, pt, ks, vs = _inputs(7 + quant, quant)
    start = STARTS if with_start else None
    args = (q, kp, vp, pt, LENGTHS, start)
    jkw = dict(n_heads=H, k_scale=_j(ks), v_scale=_j(vs))
    kern = np.asarray(jax_paged(*map(_j, args), impl="kernel", **jkw))
    ref = np.asarray(jax_paged_reference(*map(_j, args), **jkw))
    tkw = dict(n_heads=H, k_scale=_t(ks), v_scale=_t(vs))
    before = dict(LAUNCHES)
    got = paged_decode_attention(*map(_t, args), **tkw)
    assert LAUNCHES == before          # CPU tensors launch nothing
    assert got.shape == (B, 1, H * HD) and got.dtype == torch.float32
    assert torch.equal(got, paged_decode_attention_plain(*map(_t, args),
                                                         **tkw))
    got = got.numpy()
    live = slice(1, None) if with_start else slice(None)
    np.testing.assert_allclose(got[live], kern[live], **TOL)
    np.testing.assert_allclose(got[live], ref[live], **TOL)
    port_ref = paged_attention_reference(*map(_t, args), **tkw).numpy()
    np.testing.assert_allclose(port_ref[live], ref[live], **TOL)
    # impl="reference" takes the gather reference on packable heads too
    by_impl = paged_decode_attention(*map(_t, args), impl="reference", **tkw)
    np.testing.assert_array_equal(by_impl.numpy(), port_ref)
    jax_by_impl = np.asarray(jax_paged(*map(_j, args), impl="reference",
                                       **jkw))
    np.testing.assert_allclose(by_impl.numpy()[live], jax_by_impl[live],
                               **TOL)
    if with_start:
        # slot 0: start 2 > length 0, an empty range. The port returns
        # zeros (as kernel A does); the JAX kernel and its own gather
        # reference disagree there (the -1e30 mask fill averages a tile's
        # values vs the whole span's), and no live slot of the engine
        # ever has an empty range
        assert not got[0].any()


def test_masked_positions_never_contribute():
    """Corrupting a key before attn_start changes nothing; corrupting one
    inside the window changes the output."""
    q, kp, vp, pt, _, _ = _inputs(3)
    lengths = np.asarray([5, 20, 47], np.int32)
    args = lambda k: (_t(q), _t(k), _t(vp), _t(pt), _t(lengths),
                      _t(STARTS))
    base = paged_decode_attention(*args(kp), n_heads=H)
    blk = int(pt[0, 0])
    bad = kp.copy()
    bad[blk, 0] += 100.0                       # position 0 < start 2
    same = paged_decode_attention(*args(bad), n_heads=H)
    torch.testing.assert_close(same[0], base[0], **TOL)
    bad = kp.copy()
    bad[blk, 3] += 100.0                       # position 3 in [2, 5]
    diff = paged_decode_attention(*args(bad), n_heads=H)
    assert float((diff[0] - base[0]).abs().max()) > 1e-3


@pytest.mark.parametrize("scaled", [False, True])
def test_gather_pages_matches_jax(scaled):
    q, kp, _, pt, ks, _ = _inputs(11, quant=scaled)
    want = np.asarray(jax_gather_pages(jnp.asarray(kp), jnp.asarray(pt), H,
                                       _j(ks)))
    got = gather_pages(_t(kp), _t(pt), H, _t(ks)).numpy()
    assert got.shape == want.shape == (B, MB * BS, H, HD)
    np.testing.assert_array_equal(got, want)


def test_refusals_match_jax():
    q, kp, vp, pt, ks, _ = _inputs(1)
    lens = np.zeros((B,), np.int32)
    q2 = np.concatenate([q, q], axis=1)
    for fn, conv in ((jax_paged, _j), (paged_decode_attention, _t)):
        with pytest.raises(ValueError, match="single-token"):
            fn(conv(q2), conv(kp), conv(vp), conv(pt), conv(lens),
               n_heads=H)
        with pytest.raises(ValueError, match="BOTH"):
            fn(conv(q), conv(kp), conv(vp), conv(pt), conv(lens),
               n_heads=H, k_scale=conv(np.ones((NB, H, BS), np.float32)))
    # h=4, d=16 does not pack into 128-lane tiles: the kernel refuses
    qs, kps, vps, _, _, _ = _inputs(2, h=4, d=16)
    for fn, conv in ((jax_paged, _j), (paged_decode_attention, _t)):
        with pytest.raises(ValueError, match="packable"):
            fn(conv(qs), conv(kps), conv(vps), conv(pt), conv(lens),
               n_heads=4, impl="kernel")


def test_unpackable_heads_take_the_ported_reference():
    """`auto` routes head_dim 16 through the gather reference, as the
    JAX package does, on every device."""
    q, kp, vp, pt, _, _ = _inputs(4, h=4, d=16)
    args = (q, kp, vp, pt, LENGTHS, None)
    want = np.asarray(jax_paged(*map(_j, args), n_heads=4))
    got = paged_decode_attention(*map(_t, args), n_heads=4)
    assert torch.equal(got, paged_attention_reference(*map(_t, args),
                                                      n_heads=4))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_kernel_needs_a_cuda_tensor_and_a_card():
    from ddp_practice_tpu_torch.ops.cuda_build import load_library

    q, kp, vp, pt, _, _ = _inputs(5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_decode_attention(_t(q), _t(kp), _t(vp), _t(pt), _t(LENGTHS),
                               n_heads=H, impl="kernel")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            load_library("decode_attention")


# (plan (splits, chunk) or None for `_split_plan`'s, lengths, attn_start):
# capacity MB * BS = 64 positions a slot
SPLIT_CASES = [
    ((4, 16), LENGTHS, STARTS),
    ((2, 32), [31, 32, 63], [0, 32, 40]),   # cursors on a chunk edge
    ((4, 16), [20, 63, 63], [17, 50, 0]),   # starts in later splits
    ((1, 64), [5, 37, 70], [0, 0, 3]),      # a cursor past the capacity
    (None, [0, 37, 63], [0, 0, 17]),
]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("plan,lengths,starts", SPLIT_CASES)
def test_split_schedule_matches_plain_and_jax_kernel(plan, lengths, starts,
                                                     quant):
    q, kp, vp, pt, ks, vs = _inputs(21 + quant, quant)
    pt[0] = 0          # slot 0: a garbage-block row (block 0)
    lengths = np.asarray(lengths, np.int32)
    start = np.asarray(starts, np.int32)
    args = (q, kp, vp, pt, lengths, start)
    plan = plan or _split_plan(MB * BS, B * H, d=HD, kv_bytes=1 if quant
                               else 4, quant=quant, bs=BS)
    tkw = dict(n_heads=H, k_scale=_t(ks), v_scale=_t(vs))
    got = paged_split_emulated(*map(_t, args), plan, **tkw).numpy()
    want = paged_decode_attention_plain(*map(_t, args), **tkw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    kern = np.asarray(jax_paged(*map(_j, args), impl="kernel", n_heads=H,
                                k_scale=_j(ks), v_scale=_j(vs)))
    live = start <= np.minimum(lengths, MB * BS - 1)
    np.testing.assert_allclose(got[live], kern[live], **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_split_schedule_bf16_matches_plain(quant):
    q, kp, vp, pt, ks, vs = _inputs(31, quant)
    t = torch.from_numpy
    q16 = t(q).bfloat16()
    kp16, vp16 = (t(kp), t(vp)) if quant else (t(kp).bfloat16(),
                                               t(vp).bfloat16())
    args = (q16, kp16, vp16, t(pt), t(np.asarray([9, 40, 63], np.int32)),
            t(np.asarray([0, 17, 30], np.int32)))
    kw = dict(n_heads=H, k_scale=_t(ks), v_scale=_t(vs))
    want = paged_decode_attention_plain(*args, **kw)
    for plan in ((1, 64), (2, 32), (4, 16)):
        got = paged_split_emulated(*args, plan, **kw)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


def test_split_schedule_empty_ranges_give_zeros():
    """Slots whose attn_start passes their cursor have every split empty:
    zeros, as the plain version gives."""
    q, kp, vp, pt, _, _ = _inputs(41)
    args = (q, kp, vp, pt, np.asarray([5, 37, 63], np.int32),
            np.asarray([6, 40, 0], np.int32))
    got = paged_split_emulated(*map(_t, args), (4, 16), n_heads=H).numpy()
    assert not got[:2].any()
    want = paged_decode_attention_plain(*map(_t, args), n_heads=H).numpy()
    np.testing.assert_allclose(got, want, **TOL)
