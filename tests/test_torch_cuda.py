"""The port's CUDA decode-attention kernels (A, B: flat cache; C, D:
paged pool) against their plain PyTorch versions, on the card. Every test
here is marked `cuda` and skips without a card; run them on a machine
with an H100:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX for the reference's
tests, and a GPU host of the port need not have JAX installed.)

chip_smoke.py holds the kernels at lm_base shapes; these cover what it
does not: every compiled head_dim (64, 128, 256), fp32 queries over a
bf16 cache or pool, empty valid ranges, shared blocks, garbage-block
rows, cursors past the per-slot capacity, and the wrappers' refusals.

Tolerance: fp32 2e-5 (the reference decode-attention tests). bf16
|err| <= 1.6e-2 + 2^-7 |ref|: kernel and plain version round at the same
points and differ only in fp32 summation order, which can flip one bf16
rounding by an ulp.
"""

import pytest
import torch

from ddp_practice_tpu_torch.ops import decode_attention as ops

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1.6e-2, 2.0 ** -7)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (run with -m cuda there)")
    return torch.device("cuda")


def _inputs(b, L, h, d, cur, q_dtype, kv_dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, L, h * d)
    q = torch.randn((b, 1, h * d), generator=g, device="cuda").to(q_dtype)
    starts = torch.randint(0, cur + 1, (b,), generator=g, device="cuda",
                           dtype=torch.int32)
    if kv_dtype == torch.int8:
        kc = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        vc = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        ks = torch.rand((b, h, L), generator=g, device="cuda") * 0.02 + 1e-3
        vs = torch.rand((b, h, L), generator=g, device="cuda") * 0.02 + 1e-3
        return q, kc, vc, starts, dict(k_scale=ks, v_scale=vs)
    kc = torch.randn(shape, generator=g, device="cuda").to(kv_dtype)
    vc = torch.randn(shape, generator=g, device="cuda").to(kv_dtype)
    return q, kc, vc, starts, {}


def _check(q, kc, vc, cur, starts, h, scales):
    got = ops.decode_attention_packed(q, kc, vc, cur, starts, n_heads=h,
                                      impl="kernel", **scales)
    want = ops.decode_attention_plain(q, kc, vc, cur, starts, n_heads=h,
                                      **scales)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    atol, rtol = TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("d,h", [(64, 4), (128, 2), (256, 1)])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.float32, torch.int8),
    (torch.bfloat16, torch.int8)])
@pytest.mark.parametrize("cur", [0, 37, 1999])
def test_kernel_matches_plain(card, d, h, q_dtype, kv_dtype, cur):
    q, kc, vc, starts, scales = _inputs(3, 2000, h, d, cur, q_dtype,
                                        kv_dtype, seed=cur + d)
    _check(q, kc, vc, cur, starts, h, scales)
    _check(q, kc, vc, cur, None, h, scales)


def test_empty_range_gives_zeros_and_launch_is_counted(card):
    q, kc, vc, _, _ = _inputs(2, 64, 2, 64, 10, torch.float32,
                              torch.float32, seed=1)
    starts = torch.tensor([11, 3], dtype=torch.int32, device="cuda")
    before = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention_packed(q, kc, vc, 10, starts, n_heads=2)
    assert ops.LAUNCHES["decode_attention"] == before + 1
    assert torch.count_nonzero(out[0]) == 0
    _check(q, kc, vc, 10, starts, 2, {})


def test_wrapper_refusals(card):
    q, kc, vc, _, _ = _inputs(1, 64, 2, 64, 5, torch.float32,
                              torch.float32, seed=2)
    with pytest.raises(ValueError, match="outside the cache"):
        ops.decode_attention_packed(q, kc, vc, 64, n_heads=2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attention_packed(q, kc[:, ::2], vc[:, ::2], 5, n_heads=2)
    with pytest.raises(ValueError, match="dtype"):
        ops.decode_attention_packed(q, kc.half(), vc.half(), 5, n_heads=2)
    # a span whose scores overflow shared memory is refused at launch
    L = 60_000
    big = torch.zeros((1, L, 256), device="cuda")
    with pytest.raises(RuntimeError, match="too long"):
        ops.decode_attention_packed(torch.zeros((1, 1, 256), device="cuda"),
                                    big, big, L - 1, n_heads=1,
                                    impl="kernel")


# ------------------------------------------------------------------- paged
def _paged_inputs(h, d, q_dtype, kv_dtype, seed, *, b=4, nb=40, bs=16,
                  mb=8):
    """A pool, a table where slots 0 and 1 share their first half of
    blocks, and slot b-1 a retired row (garbage block 0, length 0);
    lengths cover 0, a mid position and the last slot position, and one
    cursor past the per-slot capacity, which the kernel clamps."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, 1, h * d), generator=g, device="cuda").to(q_dtype)
    shape = (nb, bs, h * d)
    scales = {}
    if kv_dtype == torch.int8:
        kp = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        for name in ("k_scale", "v_scale"):
            scales[name] = (torch.rand((nb, h, bs), generator=g,
                                       device="cuda") * 0.02 + 1e-3)
    else:
        kp = torch.randn(shape, generator=g, device="cuda").to(kv_dtype)
        vp = torch.randn(shape, generator=g, device="cuda").to(kv_dtype)
    pt = torch.randint(1, nb, (b, mb), generator=g, device="cuda",
                       dtype=torch.int32)
    pt[1, :mb // 2] = pt[0, :mb // 2]
    pt[b - 1] = 0
    lengths = torch.tensor([37, mb * bs - 1, mb * bs + 5, 0][:b],
                           dtype=torch.int32, device="cuda")
    starts = torch.tensor([3, 0, 20, 0][:b], dtype=torch.int32,
                          device="cuda")
    return q, kp, vp, pt, lengths, starts, scales


def _check_paged(q, kp, vp, pt, lengths, starts, h, scales):
    got = ops.paged_decode_attention(q, kp, vp, pt, lengths, starts,
                                     n_heads=h, impl="kernel", **scales)
    want = ops.paged_decode_attention_plain(q, kp, vp, pt, lengths, starts,
                                            n_heads=h, **scales)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    atol, rtol = TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("d,h", [(64, 4), (128, 2), (256, 1)])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.float32, torch.int8),
    (torch.bfloat16, torch.int8)])
def test_paged_kernel_matches_plain(card, d, h, q_dtype, kv_dtype):
    q, kp, vp, pt, lengths, starts, scales = _paged_inputs(
        h, d, q_dtype, kv_dtype, seed=d)
    _check_paged(q, kp, vp, pt, lengths, starts, h, scales)
    _check_paged(q, kp, vp, pt, lengths, None, h, scales)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8])
def test_paged_empty_range_gives_zeros_and_launch_is_counted(card,
                                                             kv_dtype):
    q, kp, vp, pt, lengths, _, scales = _paged_inputs(
        2, 64, torch.float32, kv_dtype, seed=5)
    starts = torch.tensor([40, 0, 0, 0], dtype=torch.int32, device="cuda")
    name = ("paged_decode_attention_int8" if kv_dtype == torch.int8
            else "paged_decode_attention")
    before = ops.LAUNCHES[name]
    out = ops.paged_decode_attention(q, kp, vp, pt, lengths, starts,
                                     n_heads=2, **scales)
    assert ops.LAUNCHES[name] == before + 1
    assert torch.count_nonzero(out[0]) == 0      # start 40 > length 37
    _check_paged(q, kp, vp, pt, lengths, starts, 2, scales)


def test_paged_wrapper_refusals_and_routing(card):
    q, kp, vp, pt, lengths, starts, _ = _paged_inputs(
        2, 64, torch.float32, torch.float32, seed=6)
    with pytest.raises(ValueError, match="dtype"):
        ops.paged_decode_attention(q, kp, vp, pt.long(), lengths,
                                   n_heads=2, impl="kernel")
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_decode_attention(q, kp, vp, pt[:, ::2], lengths,
                                   n_heads=2, impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.paged_decode_attention(q, kp, vp, pt, lengths.cpu(),
                                   n_heads=2, impl="kernel")
    with pytest.raises(ValueError, match="BOTH"):
        ops.paged_decode_attention(q, kp, vp, pt, lengths, n_heads=2,
                                   k_scale=torch.ones((40, 2, 16),
                                                      device="cuda"))
    # a per-slot capacity whose scores overflow shared memory is refused
    wide = torch.zeros((4, 4000), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="too long"):
        ops.paged_decode_attention(q, kp, vp, wide, lengths, n_heads=2,
                                   impl="kernel")
    # unpackable heads (head_dim 16): "kernel" refuses, "auto" takes the
    # gather reference and launches nothing
    q16 = torch.randn((4, 1, 64), device="cuda")
    p16 = torch.randn((40, 16, 64), device="cuda")
    with pytest.raises(ValueError, match="packable"):
        ops.paged_decode_attention(q16, p16, p16, pt, lengths, n_heads=4,
                                   impl="kernel")
    before = dict(ops.LAUNCHES)
    out = ops.paged_decode_attention(q16, p16, p16, pt, lengths, starts,
                                     n_heads=4)
    want = ops.paged_attention_reference(q16, p16, p16, pt, lengths, starts,
                                         n_heads=4)
    assert ops.LAUNCHES == before
    torch.testing.assert_close(out, want)
