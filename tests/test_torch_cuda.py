"""The port's CUDA kernels against their plain PyTorch versions, on the
card: decode attention (A, B: flat cache; C, D: paged pool) and flash
attention (E forward, F and G backward). Every test
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
rounding by an ulp. Flash attention holds the output and each of dq, dk
and dv apart, element by element: fp32 at the reference flash tests' 2e-5
(forward) and 1e-4 (grads) absolute and relative; bf16 at the decode
kernels' 1.6e-2 + 2^-7 |ref| (the same rounding points, so only an
output's final bf16 rounding, or one p or ds inside a sum, can flip by an
ulp). Each tensor's error norm must also stay under a fraction of its
norm (1e-5 fp32, 2e-3 bf16): ulp flips are rare and scattered, while a
kernel wrong on one tile moves that tile's elements by their own size.
"""

import pytest
import torch

from ddp_practice_tpu_torch.ops import decode_attention as ops
from ddp_practice_tpu_torch.ops import flash_attention as fa

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


# ------------------------------------------------------------------- flash
# (forward, grads) per-element (atol, rtol), and the relative-norm limit
FLASH_TOL = {torch.float32: ((2e-5, 2e-5), (1e-4, 1e-4)),
             torch.bfloat16: (TOL[torch.bfloat16], TOL[torch.bfloat16])}
FLASH_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}


def _flash_run(entry, impl, inputs, weights, **kw):
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = entry(*xs, impl=impl, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
    grads = torch.autograd.grad(loss, xs)
    torch.cuda.synchronize()
    return [o.detach() for o in outs], grads


def _split_qkv(grads, fused):
    """A fused (b, s, 3hd) gradient as its dq, dk and dv windows."""
    return list(grads[0].chunk(3, dim=-1)) if fused else list(grads)


def _flash_check(entry, inputs, weights, fused=False, **kw):
    got_o, got_g = _flash_run(entry, "kernel", inputs, weights, **kw)
    want_o, want_g = _flash_run(entry, "plain", inputs, weights, **kw)
    dtype = inputs[0].dtype
    fwd, grad = FLASH_TOL[dtype]
    pairs = [(a, b, fwd) for a, b in zip(got_o, want_o)]
    pairs += [(a, b, grad) for a, b in zip(_split_qkv(got_g, fused),
                                           _split_qkv(want_g, fused))]
    for a, b, (atol, rtol) in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        a, b = a.float(), b.float()
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        assert rel <= FLASH_REL[dtype], rel


def _randn(*shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_match_plain(card, d, dtype, causal):
    """Fused QKV (d >= 64, 2 heads: packed windows) or the folded route
    (d=32) at s=96, which no tile size divides."""
    b, s, h = 2, 96, 2
    qkv = _randn(b, s, 3 * h * d, dtype=dtype, seed=d)
    w = _randn(b, s, h, d, dtype=torch.float32, seed=d + 1)
    row = "packed" if fa._heads_per_pack(h, d) else "folded"
    before = dict(fa.LAUNCHES)
    _flash_check(lambda x, **kw: fa.flash_attention_qkv(x, h, **kw), [qkv],
                 [w], fused=True, causal=causal)
    assert fa.LAUNCHES[f"flash_fwd_{row}"] == before[f"flash_fwd_{row}"] + 1
    assert fa.LAUNCHES[f"flash_bwd_{row}"] == before[f"flash_bwd_{row}"] + 1


@pytest.mark.parametrize("layout", ["packed", "folded", "heads"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_layouts_match_plain(card, layout, dtype):
    b, s, h, d = 2, 160, 4, 64
    if layout == "folded":
        shape, entry, wshape = (b * h, s, d), fa.flash_attention_with_lse, [
            (b * h, s, d), (b * h, s)]
    else:
        hh = 3 if layout == "heads" else h      # 3 heads of 64 don't pack
        shape, entry, wshape = (b, s, hh, d), fa.flash_attention, [
            (b, s, hh, d)]
    inputs = [_randn(*shape, dtype=dtype, seed=i) for i in range(3)]
    weights = [_randn(*ws, dtype=torch.float32, seed=9 + i)
               for i, ws in enumerate(wshape)]
    _flash_check(entry, inputs, weights, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_lse_grad_with_shorter_queries(card, dtype):
    """Causal s_q < s_k (bottom-right aligned) with a loss on lse too."""
    bh, sq, sk, d = 6, 70, 200, 64
    q = _randn(bh, sq, d, dtype=dtype, seed=1)
    k = _randn(bh, sk, d, dtype=dtype, seed=2)
    v = _randn(bh, sk, d, dtype=dtype, seed=3)
    weights = [_randn(bh, sq, d, dtype=torch.float32, seed=4),
               _randn(bh, sq, dtype=torch.float32, seed=5)]
    _flash_check(fa.flash_attention_with_lse, [q, k, v], weights,
                 causal=True)


def test_flash_wrapper_refusals(card):
    q = torch.zeros((1, 64, 2, 48), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, impl="kernel")
    k = torch.zeros((2, 32, 64), device="cuda")
    with pytest.raises(ValueError, match="seq_q <= seq_k"):
        fa.flash_attention_with_lse(torch.zeros((2, 64, 64), device="cuda"),
                                    k, k, causal=True)
    with pytest.raises(ValueError, match="dtype"):
        x = torch.zeros((2, 32, 64), device="cuda", dtype=torch.float16)
        fa.flash_attention_with_lse(x, x, x)
