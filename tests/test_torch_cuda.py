"""The port's CUDA kernels against their plain PyTorch versions, on the
card: decode attention (A, B: flat cache; C, D: paged pool) and flash
attention (E forward, F and G backward, and the forward variants of E the
reference's ablations time, with E on (b, s, h, d) strides), the fused
encoder layer (H
forward, I backward) and the grouped matmul (J gmm in both rhs layouts, K
tgmm; the sorted MoE path through them). Every test
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

The bf16 flash backward (G, then F) must also give the same bits on
every run: each dq, dk and dv row has one owner and a fixed summation
order. Operand windows whose base is not 16-byte aligned take the copy
ring's plain-load branch and must still match.

The fused encoder layer holds the output, dx and each of the 12 parameter
grads apart. fp32: 2e-5 forward, 2e-4 grads (3e-4 causal) per element,
scaled by the tensor's largest magnitude where that exceeds 1 (a weight
grad sums over every token: through kernel K's work units, in another
order than the plain version's one product, which the limit already
covers), and 1e-5 in relative error norm. bf16: kernel
and plain round at the same ~10 points (y1, qkv, p, o, y2, hg, g, dx2, do,
ds, dqkv) and differ in fp32 summation order, so a rounding flips by an ulp
(2^-8 relative) here and there and the flips pass through the later
products: per element 4e-2 of the tensor's largest magnitude, 5e-3 in
relative error norm (a tile wrong by its own size gives far more).

The grouped matmul: kernel and plain version both sum in fp32 and round
once, so fp32 holds 2e-5 relative and 2e-5 absolute times the tensor's
largest magnitude where that exceeds 1 (tgmm sums up to 65536 rows, and
fp32 rounding scales with the partial sums), bf16 the decode kernels'
1.6e-2 + 2^-7 |ref| (summation order can flip the final bf16 rounding by
an ulp); tgmm's fixed-order reduction (its work units' partials summed in
unit order) gives the same bits on every run. K's Hopper kernel runs at
the lm_moe shapes and at the fused ViT-Tiny layer's four one-group weight
grads (fp32 output), at work units smaller than the groups (rows of the
next unit, group or tail zeroed in both operands: an Inf there stays
out), at every compiled tile width; unaligned operands take the
ring-less kernel.

The fused layer's kernel I runs its weight grads through K and stages
its weights in shared memory; a width above 256 takes the row passes'
general path.
"""

import pytest
import torch

from ddp_practice_tpu_torch.ops import decode_attention as ops
from ddp_practice_tpu_torch.ops import flash_attention as fa
from ddp_practice_tpu_torch.ops import fused_encoder as fe
from ddp_practice_tpu_torch.ops import grouped_matmul as gm

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


@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_is_the_same_bits_every_run(card, d):
    """G owns each dq row and F each dk, dv row, and every sum runs in
    one order (no atomics): two backward runs give identical bits."""
    b, s, h = 2, 640, 2
    qkv = _randn(b, s, 3 * h * d, dtype=torch.bfloat16, seed=d)
    w = _randn(b, s, h, d, dtype=torch.float32, seed=d + 1)
    first = _flash_run(lambda x, **kw: fa.flash_attention_qkv(x, h, **kw),
                       "kernel", [qkv], [w], causal=True)[1]
    second = _flash_run(lambda x, **kw: fa.flash_attention_qkv(x, h, **kw),
                        "kernel", [qkv], [w], causal=True)[1]
    assert torch.equal(first[0], second[0])


@pytest.mark.parametrize("d", [64, 256])
def test_flash_unaligned_operands_match_plain(card, d):
    """Every operand window starts one element into its storage, so no
    head base is 16-byte aligned: the kernels stage and store those rows
    with plain loads (the copy ring's layout branch)."""
    b, s, h = 2, 96, 2
    flat = _randn(b * s * 3 * h * d + 1, dtype=torch.bfloat16, seed=d)
    w = _randn(b, s, h, d, dtype=torch.float32, seed=d + 2)

    def entry(x, **kw):
        qkv = x[1:].view(b, s, 3 * h * d)
        assert qkv.data_ptr() % 16 != 0
        return fa.flash_attention_qkv(qkv, h, **kw)

    _flash_check(entry, [flat], [w], causal=True)


@pytest.mark.parametrize("d", [64, 256])
def test_flash_backward_unaligned_everything(card, d):
    """The backward's two launches with q, k, v, o, do and the dq, dk, dv
    destinations all one element into their storage: plain-load staging,
    delta from an unaligned o, element stores."""
    b, h, s = 2, 2, 96

    def view(seed=None):
        n = b * h * s * d + 1
        flat = (torch.zeros(n, device="cuda", dtype=torch.bfloat16)
                if seed is None else
                _randn(n, dtype=torch.bfloat16, seed=seed))
        return flat[1:].view(b, h, s, d)

    q4, k4, v4, do4 = (view(seed=d + i) for i in range(4))
    o4 = view()
    o, lse = fa.flash_attention_plain(q4, k4, v4, causal=True)
    o4.copy_(o)
    dq4, dk4, dv4 = view(), view(), view()
    fa._launch_bwd(q4, k4, v4, o4, do4, lse, None, dq4, dk4, dv4, True)
    want = fa.flash_attention_plain_bwd(q4, k4, v4, o4, do4, lse,
                                        causal=True)
    torch.cuda.synchronize()
    for got, ref in zip((dq4, dk4, dv4), want):
        got, ref = got.float(), ref.float()
        torch.testing.assert_close(got, ref, atol=TOL[torch.bfloat16][0],
                                   rtol=TOL[torch.bfloat16][1])
        rel = float((got - ref).norm() / ref.norm())
        assert rel <= FLASH_REL[torch.bfloat16], rel


def test_flash_long_sequence_matches_plain(card):
    """b=1, s=8192, packed (12 heads of 64): 128 query and key tiles a
    head, the row behind chip_smoke's long-sequence timings."""
    b, s, h, d = 1, 8192, 12, 64
    inputs = [_randn(b, s, h, d, dtype=torch.bfloat16, seed=i)
              for i in range(3)]
    w = _randn(b, s, h, d, dtype=torch.float32, seed=3)
    before = fa.LAUNCHES["flash_bwd_packed"]
    _flash_check(fa.flash_attention, inputs, [w], causal=True)
    assert fa.LAUNCHES["flash_bwd_packed"] == before + 1


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_forward_is_the_same_bits_every_run(card, d):
    """Kernel E: every output row and lse entry has one owner warp and a
    fixed summation order, so two launches give identical bits."""
    b, h, s = 2, 3, 640
    q4, k4, v4 = (_randn(b, s, h, d, dtype=torch.bfloat16, seed=d + i)
                  .transpose(1, 2) for i in range(3))
    outs = [torch.empty_like(q4) for _ in range(2)]
    lses = [fa._launch_fwd(q4, k4, v4, o, True) for o in outs]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(lses[0], lses[1])


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_forward_unaligned_and_shorter_queries(card, d):
    """Kernel E alone with q, k, v and out one element into their storage
    (the ring's plain-load branch and element stores), causal s_q = 70 <
    s_k = 200 (ragged key and query tails, offset 130): out at the flash
    bf16 limits, lse within 1e-4 of the plain version's."""
    b, h, sq, sk = 2, 2, 70, 200

    def view(s, seed=None):
        n = b * h * s * d + 1
        flat = (torch.zeros(n, device="cuda", dtype=torch.bfloat16)
                if seed is None else
                _randn(n, dtype=torch.bfloat16, seed=seed))
        return flat[1:].view(b, h, s, d)

    q4, k4, v4 = view(sq, d), view(sk, d + 1), view(sk, d + 2)
    out4 = view(sq)
    lse = fa._launch_fwd(q4, k4, v4, out4, True)
    want, want_lse = fa.flash_attention_plain(q4, k4, v4, causal=True)
    torch.cuda.synchronize()
    got, ref = out4.float(), want.float()
    torch.testing.assert_close(got, ref, atol=TOL[torch.bfloat16][0],
                               rtol=TOL[torch.bfloat16][1])
    assert float((got - ref).norm() / ref.norm()) <= FLASH_REL[
        torch.bfloat16]
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


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


# ------------------------------------- kernel E's variants (row #12)
VARIANT_CASES = [(v, n, c) for v, n in (("v2", 1), ("v3", 1), ("v4", 2),
                                        ("v5", 2), ("v5", 4))
                 for c in (True, False)] + [("nomax", 1, True)]


@pytest.mark.parametrize("shape", [(8, 512, 512), (96, 2048, 2048),
                                   (8, 200, 328)])
@pytest.mark.parametrize("variant,n_heads,causal", VARIANT_CASES)
def test_flash_variant_kernels_match_plain(card, variant, n_heads, causal,
                                           shape):
    """Each variant against its plain version on the kernel's own 64 x 64
    tiles (so the same running max): out at the bf16 limits above; lse
    within 1e-4 where l sums fp32 p, within 2^-8 where it sums the rounded
    p (v3, v5: scores that differ in their last fp32 bits can round a p
    the other way, which moves l by at most 2^-8 of itself), and there
    the mean lse error stays under a tenth of the mean distance from plain
    v2 (which sums fp32 p): the kernel computes the sum-fold, not v2's
    sum; (8, 200, 328) has ragged tiles and, causal, a bottom-right
    offset."""
    bh, sq, sk = shape
    q = _randn(bh, sq, 64, dtype=torch.bfloat16, seed=sq)
    k = _randn(bh, sk, 64, dtype=torch.bfloat16, seed=sk + 1)
    v = _randn(bh, sk, 64, dtype=torch.bfloat16, seed=sk + 2)
    kw = dict(variant=variant, n_heads=n_heads, causal=causal)
    row = f"flash_fwd_{variant}" + (f"h{n_heads}" if variant == "v5" else "")
    before = fa.VARIANT_LAUNCHES[row]
    out, lse = fa.flash_forward_variant(q, k, v, impl="kernel", **kw)
    torch.cuda.synchronize()
    assert fa.VARIANT_LAUNCHES[row] == before + 1
    want, want_lse = fa.flash_forward_variant_plain(q, k, v, block_q=64,
                                                    block_k=64, **kw)
    a, b = out.float(), want.float()
    torch.testing.assert_close(a, b, atol=TOL[torch.bfloat16][0],
                               rtol=TOL[torch.bfloat16][1])
    assert float((a - b).norm() / b.norm()) <= FLASH_REL[torch.bfloat16]
    lse_tol = 2.0 ** -8 if variant in ("v3", "v5") else 1e-4
    torch.testing.assert_close(lse, want_lse, atol=lse_tol, rtol=0)
    if variant in ("v3", "v5"):
        _, v2_lse = fa.flash_forward_variant_plain(
            q, k, v, variant="v2", causal=causal, block_q=64, block_k=64)
        gap = float((want_lse - v2_lse).abs().mean())
        assert float((lse - want_lse).abs().mean()) <= 0.1 * gap


@pytest.mark.parametrize("b,s,h", [(2, 200, 4), (8, 2048, 12)])
def test_fwd4d_matches_fold(card, b, s, h):
    """fwd4d runs E's packed route on the (b, s, h, d) strides: against
    E's plain version on the same view at the bf16 limits above, and
    against E on a folded copy (the same kernel and tiles, so the same
    bits)."""
    from ddp_practice_tpu_torch.experiments import flash_4d

    qf, kf, vf = (_randn(b, s, h * 64, dtype=torch.bfloat16, seed=i)
                  for i in range(3))
    before = fa.LAUNCHES["flash_fwd_packed"]
    got = flash_4d.path_4d(qf, kf, vf, heads=h)
    want = flash_4d.path_fold(qf, kf, vf, heads=h)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd_packed"] == before + 1
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    q, k, v = (x.view(b, s, h, 64) for x in (qf, kf, vf))
    a = flash_4d.fwd4d(q, k, v, impl="kernel").float()
    p = flash_4d.fwd4d(q, k, v, impl="plain").float()
    torch.testing.assert_close(a, p, atol=TOL[torch.bfloat16][0],
                               rtol=TOL[torch.bfloat16][1])
    assert float((a - p).norm() / p.norm()) <= FLASH_REL[torch.bfloat16]


def test_flash_variant_refusals(card):
    x = torch.zeros((2, 64, 32), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 64"):
        fa.flash_forward_variant(x, x, x, variant="v2", impl="kernel")
    y = torch.zeros((2, 64, 64), device="cuda")
    with pytest.raises(ValueError, match="bf16 operands only"):
        fa.flash_forward_variant(y, y, y, variant="v3", impl="kernel")


# ------------------------------------------------- kernels H and I
FUSED_REL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


def _fused_inputs(imgs, s, d, mlp, dtype, seed):
    """(x, cotangent, the 12 leaves) on the card, from a seed."""
    from ddp_practice_tpu_torch.experiments.fused_profile import inputs

    return inputs(imgs, s, d, mlp, dtype, seed)


def _fused_held(got, want, dtype, tol, name):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.isfinite(got).all(), name
    got, want = got.float(), want.float()
    scale = max(1.0, float(want.abs().max()))
    if dtype == torch.bfloat16:
        assert float((got - want).abs().max()) <= 4e-2 * scale, name
    else:
        torch.testing.assert_close(got, want, atol=tol * scale, rtol=tol,
                                   msg=name)
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    assert rel <= FUSED_REL[dtype], (name, rel)


def _fused_check(imgs, s, d, heads, mlp, dtype, causal, seed=0):
    x, g, params = _fused_inputs(imgs, s, d, mlp, dtype, seed)
    kw = dict(num_heads=heads, compute_dtype=dtype, causal=causal)
    before = dict(fe.LAUNCHES)
    out = fe.fused_encoder_forward(x, params, impl="kernel", **kw)
    dx, grads = fe.fused_encoder_backward(x, g, params, impl="kernel", **kw)
    torch.cuda.synchronize()
    assert fe.LAUNCHES["fused_encoder_fwd"] == before["fused_encoder_fwd"] + 1
    assert fe.LAUNCHES["fused_encoder_bwd"] == before["fused_encoder_bwd"] + 1
    want_out = fe.fused_encoder_plain(x, params, **kw)
    want_dx, want = fe.fused_encoder_backward_plain(x, g, params, **kw)
    gtol = 3e-4 if causal else 2e-4
    _fused_held(out, want_out, dtype, 2e-5, "out")
    _fused_held(dx, want_dx, dtype, gtol, "dx")
    for name, a, b in zip(fe.PARAM_NAMES, grads, want):
        _fused_held(a, b, dtype, gtol, name)
    return x, g, params, kw, (dx, grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (33, 64, 192, 3, 768, False),     # ViT-Tiny's layer
    (7, 64, 192, 3, 768, False),      # an odd batch, fewer than the SMs
    (5, 49, 192, 3, 768, False),      # 28x28 images: 49 patches, padded
    (9, 128, 256, 4, 1024, True),     # lm_tiny with 4 heads, causal
    (4, 32, 128, 2, 128, True),       # the reference's causal test shape
    (3, 40, 128, 1, 208, False),      # head_dim 128, ragged mlp chunk
    (2, 64, 384, 6, 1536, False),     # d > 256: the general row passes
], ids=["vit_tiny", "odd_batch", "s49", "causal_lm", "causal_small",
        "hd128", "d384"])
def test_fused_kernels_match_plain(card, shape, dtype):
    _fused_check(*shape[:5], dtype, shape[5], seed=shape[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_backward_is_the_same_bits_every_run(card, dtype):
    x, g, params, kw, (dx, grads) = _fused_check(300, 64, 192, 3, 768, dtype,
                                                 False, seed=1)
    dx2, grads2 = fe.fused_encoder_backward(x, g, params, impl="kernel", **kw)
    assert torch.equal(dx, dx2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_fused_fp32_activations_with_bf16_compute(card):
    """x's dtype and the compute dtype are independent."""
    x, g, params = _fused_inputs(6, 64, 192, 768, torch.float32, 2)
    kw = dict(num_heads=3, compute_dtype=torch.bfloat16)
    out = fe.fused_encoder_forward(x, params, impl="kernel", **kw)
    dx, grads = fe.fused_encoder_backward(x, g, params, impl="kernel", **kw)
    _fused_held(out, fe.fused_encoder_plain(x, params, **kw),
                torch.bfloat16, 0, "out")
    want_dx, want = fe.fused_encoder_backward_plain(x, g, params, **kw)
    _fused_held(dx, want_dx, torch.bfloat16, 0, "dx")
    for name, a, b in zip(fe.PARAM_NAMES, grads, want):
        _fused_held(a, b, torch.bfloat16, 0, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layer_autograd_on_the_card(card, dtype):
    """The autograd.Function: kernel H forward, kernel I backward, against
    the plain version through the same Function."""
    x, g, params = _fused_inputs(10, 64, 192, 768, dtype, 3)

    def run(impl):
        xs = x.clone().requires_grad_(True)
        ps = [p.clone().requires_grad_(True) for p in params]
        out = fe.fused_encoder_layer(xs, ps, num_heads=3,
                                     compute_dtype=dtype, impl=impl)
        return out.detach(), torch.autograd.grad(out, [xs, *ps], g)

    before = dict(fe.LAUNCHES)
    out, grads = run("kernel")
    assert fe.LAUNCHES == {k: v + 1 for k, v in before.items()}
    want_out, want = run("plain")
    assert fe.LAUNCHES == {k: v + 1 for k, v in before.items()}
    _fused_held(out, want_out, dtype, 2e-5, "out")
    for name, a, b in zip(("x",) + fe.PARAM_NAMES, grads, want):
        _fused_held(a, b, dtype, 2e-4, name)


def test_vit_block_fuses_on_the_card_without_a_flag(card):
    """fused="auto": a plain block on a CUDA tensor launches H and I; a
    block that is not plain, or fused=False, keeps the per-op path."""
    from ddp_practice_tpu_torch.models.vit import EncoderBlock

    x = torch.randn(4, 64, 192, device="cuda")
    for kw, fused in ((dict(fused="auto"), True), (dict(fused=False), False),
                      (dict(fused="auto", dropout_rate=0.1), False)):
        blk = EncoderBlock(192, 3, 768, **kw).cuda()
        before = dict(fe.LAUNCHES)
        xs = x.clone().requires_grad_(True)
        blk(xs).sum().backward()
        torch.cuda.synchronize()
        assert fe.LAUNCHES == {k: v + int(fused) for k, v in before.items()}
        assert xs.grad is not None and torch.isfinite(xs.grad).all()


def test_fused_wrapper_refusals(card):
    x, g, params = _fused_inputs(2, 64, 192, 768, torch.float32, 4)
    with pytest.raises(ValueError, match="head_dim a multiple of 64"):
        fe.fused_encoder_forward(x, params, num_heads=6, impl="kernel")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fe.fused_encoder_forward(x, params, num_heads=3, impl="kernel",
                                 compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="shape"):
        fe.fused_encoder_forward(x, params[:11] + [params[11][:5]],
                                 num_heads=3, impl="kernel")
    with pytest.raises(ValueError, match="g must match x"):
        fe.fused_encoder_backward(x, g[:1], params, num_heads=3,
                                  impl="kernel")
    long = torch.zeros((1, 4096, 192), device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        fe.fused_encoder_forward(long, params, num_heads=3, impl="kernel")
    wide, _, wide_params = _fused_inputs(1, 64, 768, 3072, torch.float32, 5)
    with pytest.raises(ValueError, match="MiB"):
        fe.fused_encoder_forward(wide, wide_params, num_heads=12,
                                 impl="kernel")
    cpu_params = [p.cpu() for p in params]
    with pytest.raises(ValueError, match="is on cpu"):
        fe.fused_encoder_forward(x, cpu_params, num_heads=3, impl="kernel")


# ------------------------------------------------------ kernels J and K
GMM_PATTERNS = {
    "balanced": [125] * 8,
    "skewed": [900, 20, 20, 20, 10, 10, 10, 10],
    "empty_off_grid": [0, 17, 0, 399, 1, 0, 450, 133],
    "tail": [140, 0, 260, 0, 0, 300, 0, 0],
    "all_empty": [0] * 8,
}


def _gmm_operands(m, k, n, e, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((m, k), generator=g, device="cuda").to(dtype),
            torch.randn((e, k, n), generator=g, device="cuda").to(dtype),
            torch.randn((m, n), generator=g, device="cuda").to(dtype))


def _gmm_held(got, want, name):
    """fp32: 2e-5 relative plus 2e-5 of the tensor's largest magnitude
    where that exceeds 1 (a sum over hundreds of rows carries rounding of
    its partial sums' size); bf16: one ulp (2^-7) plus 1.6e-2."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape, name
    atol, rtol = TOL[want.dtype]
    if want.dtype == torch.float32:
        atol *= max(1.0, float(want.detach().abs().max()))
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    assert not bad.any(), f"{name}: max |err| {float(err.max()):.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pattern", sorted(GMM_PATTERNS))
def test_grouped_matmul_kernels_match_plain(card, pattern, dtype):
    sizes = torch.tensor(GMM_PATTERNS[pattern], dtype=torch.int32,
                         device="cuda")
    lhs, rhs, grad = _gmm_operands(1000, 96, 160, 8, dtype, 11)
    before = dict(gm.LAUNCHES)
    _gmm_held(gm.gmm(lhs, rhs, sizes, impl="kernel"),
              gm.gmm_plain(lhs, rhs, sizes), "gmm")
    _gmm_held(gm.gmm(grad, rhs, sizes, transpose_rhs=True, impl="kernel"),
              gm.gmm_plain(grad, rhs, sizes, transpose_rhs=True), "gmm_trhs")
    got = gm.tgmm(lhs, grad, sizes, impl="kernel")
    _gmm_held(got, gm.tgmm_plain(lhs, grad, sizes), "tgmm")
    for e, size in enumerate(GMM_PATTERNS[pattern]):
        if size == 0:
            assert not got[e].any()
    assert gm.LAUNCHES == {k: v + 1 for k, v in before.items()}


@pytest.mark.parametrize("shape", [(37, 29), (24, 40)])
def test_grouped_matmul_element_loads(card, shape):
    """fp32 rows that are not a multiple of 16 bytes, and an operand that
    does not start 16-byte aligned, take the element-load path."""
    k, n = shape
    sizes = torch.tensor(GMM_PATTERNS["empty_off_grid"], dtype=torch.int32,
                         device="cuda")
    lhs, rhs, grad = _gmm_operands(1001, k, n, 8, torch.float32, 12)
    lhs = torch.cat([torch.zeros(1, device="cuda"),
                     lhs.reshape(-1)])[1:].view(1001, k)   # offset 4 bytes
    _gmm_held(gm.gmm(lhs, rhs, sizes, impl="kernel"),
              gm.gmm_plain(lhs, rhs, sizes), "gmm")
    _gmm_held(gm.tgmm(lhs, grad, sizes, impl="kernel"),
              gm.tgmm_plain(lhs, grad, sizes), "tgmm")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_autograd_and_same_bits(card, dtype):
    sizes = torch.tensor(GMM_PATTERNS["skewed"], dtype=torch.int32,
                         device="cuda")
    lhs, rhs, w = _gmm_operands(1000, 64, 128, 8, dtype, 13)

    def run(impl):
        a = lhs.clone().requires_grad_()
        b = rhs.clone().requires_grad_()
        out = gm.grouped_matmul(a, b, sizes, impl=impl)
        (out.float() * w.float()).sum().backward()
        return out, a.grad, b.grad

    got, want = run("kernel"), run("plain")
    for name, x, y in zip(("out", "dlhs", "drhs"), got, want):
        _gmm_held(x, y, name)
    again = gm.tgmm(lhs, w, sizes, impl="kernel")
    assert torch.equal(again, gm.tgmm(lhs, w, sizes, impl="kernel"))


def test_sorted_moe_runs_the_kernels(card):
    """MoEMlp impl="sorted" on the card: kernels J (forward, transposed)
    and K run, and output and grads agree with the plain versions."""
    from ddp_practice_tpu_torch.ops.moe import MoEMlp

    torch.manual_seed(0)
    moe = MoEMlp(64, num_experts=8, top_k=2, mlp_dim=128,
                 impl="sorted").cuda()
    for p in moe.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.randn(4, 96, 64, device="cuda")

    def run(impl):
        moe.zero_grad()
        xs = x.clone().requires_grad_()
        gm.reset_launches()
        with gm.forced_impl(impl):
            y = moe(xs, train=True)
            (y * y).sum().backward()
        torch.cuda.synchronize()
        return dict(gm.LAUNCHES), [y, xs.grad] + [
            p.grad.clone() for p in moe.parameters()]

    launches, got = run("kernel")
    assert launches == {"gmm": 2, "gmm_trhs": 2, "tgmm": 2, "tgmm_reduce": 2}
    launches, want = run("plain")
    assert launches == {"gmm": 0, "gmm_trhs": 0, "tgmm": 0, "tgmm_reduce": 0}
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                   msg=f"tensor {i}")


@pytest.mark.parametrize("block_n", gm.GMM_BLOCK_N)
@pytest.mark.parametrize("pattern", ["skewed", "empty_off_grid", "tail"])
@pytest.mark.parametrize("shape", [(300, 72, 264), (129, 8, 8),
                                   (1000, 200, 520)])
def test_grouped_matmul_hopper_off_grid(card, shape, pattern, block_n):
    """The bf16 Hopper J at m, k and n off its 128 x BN x 64 grid (TMA's
    zero-filled boxes, a row tile split between groups, partial column
    tiles), both rhs layouts, both compiled tile widths."""
    m, k, n = shape
    sizes = [round(x * m / 1000) for x in GMM_PATTERNS[pattern]]
    sizes[-1] += m - sum(sizes) if pattern != "tail" else 0
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    lhs, rhs, grad = _gmm_operands(m, k, n, 8, torch.bfloat16, 21)
    _gmm_held(gm._launch_gmm(lhs, rhs, gs, False, block_n=block_n),
              gm.gmm_plain(lhs, rhs, gs), "gmm")
    _gmm_held(gm._launch_gmm(grad, rhs, gs, True, block_n=block_n),
              gm.gmm_plain(grad, rhs, gs, transpose_rhs=True), "gmm_trhs")


@pytest.mark.parametrize("transpose", [False, True])
def test_grouped_matmul_forward_is_the_same_bits_every_run(card, transpose):
    """J: each output element has one owner and one summation order."""
    sizes = torch.tensor(GMM_PATTERNS["empty_off_grid"], dtype=torch.int32,
                         device="cuda")
    lhs, rhs, grad = _gmm_operands(1000, 256, 512, 8, torch.bfloat16, 22)
    a = grad if transpose else lhs
    first = gm.gmm(a, rhs, sizes, transpose_rhs=transpose, impl="kernel")
    second = gm.gmm(a, rhs, sizes, transpose_rhs=transpose, impl="kernel")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_grouped_matmul_bf16_unaligned_operands(card):
    """bf16 operands one element into their storage: no tensor map can
    address them, so J takes the ring-less kernel (its vec = 0 branch)."""
    sizes = torch.tensor(GMM_PATTERNS["empty_off_grid"], dtype=torch.int32,
                         device="cuda")
    lhs, rhs, grad = _gmm_operands(1000, 96, 160, 8, torch.bfloat16, 23)
    shift = torch.cat([torch.zeros(1, device="cuda", dtype=torch.bfloat16),
                       lhs.reshape(-1)])[1:].view(1000, 96)
    assert shift.data_ptr() % 16 != 0
    _gmm_held(gm.gmm(shift, rhs, sizes, impl="kernel"),
              gm.gmm_plain(shift, rhs, sizes), "gmm")
    gshift = torch.cat([torch.zeros(1, device="cuda", dtype=torch.bfloat16),
                        grad.reshape(-1)])[1:].view(1000, 160)
    _gmm_held(gm.gmm(gshift, rhs, sizes, transpose_rhs=True, impl="kernel"),
              gm.gmm_plain(gshift, rhs, sizes, transpose_rhs=True),
              "gmm_trhs")


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("transpose", [False, True])
def test_grouped_matmul_fp32_output(card, transpose, aligned):
    """bf16 operands with out_dtype=float32 (the reference's
    preferred_element_type): the fp32 sums leave unrounded, held at the
    fp32 limits; aligned operands run the Hopper kernel's fp32 epilogue,
    a shifted lhs the ring-less kernel's."""
    sizes = torch.tensor(GMM_PATTERNS["skewed"], dtype=torch.int32,
                         device="cuda")
    lhs, rhs, grad = _gmm_operands(1000, 96, 160, 8, torch.bfloat16, 24)
    a = grad if transpose else lhs
    if not aligned:
        a = torch.cat([torch.zeros(1, device="cuda", dtype=a.dtype),
                       a.reshape(-1)])[1:].view(a.shape)
    got = gm.gmm(a, rhs, sizes, transpose_rhs=transpose,
                 out_dtype=torch.float32, impl="kernel")
    want = gm.gmm_plain(a, rhs, sizes, transpose_rhs=transpose,
                        out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _gmm_held(got, want, "gmm fp32 out")


def test_grouped_matmul_wrapper_refusals(card):
    sizes = torch.tensor([4, 4], dtype=torch.int32, device="cuda")
    lhs, rhs, grad = _gmm_operands(8, 16, 16, 2, torch.float32, 14)
    with pytest.raises(ValueError, match="one dtype"):
        gm.gmm(lhs, rhs.to(torch.bfloat16), sizes, impl="kernel")
    with pytest.raises(ValueError, match="contiguous"):
        gm.gmm(lhs.t().contiguous().t(), rhs, sizes, impl="kernel")
    with pytest.raises(ValueError, match="int32"):
        gm.gmm(lhs, rhs, sizes.long(), impl="kernel")
    with pytest.raises(ValueError, match="multiples of 8"):
        b16 = _gmm_operands(8, 12, 16, 2, torch.bfloat16, 15)
        gm.gmm(b16[0], b16[1], sizes, impl="kernel")
    with pytest.raises(ValueError, match="shapes"):
        gm.gmm(lhs, rhs[:, :8], sizes, impl="kernel")
    with pytest.raises(ValueError, match="writes the operands' dtype"):
        gm.tgmm(lhs, grad, sizes, out_dtype=torch.bfloat16, impl="kernel")


# ------------------------------------------------------- kernel K, Hopper
LM_MOE = {"balanced": [4096] * 8,
          "skewed": [16384, 8192, 4096, 2048, 1024, 512, 256, 256],
          "empty_off_grid": [0, 9001, 0, 7777, 1, 0, 15000, 989]}


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kn", [(768, 3072), (3072, 768)])
@pytest.mark.parametrize("pattern", sorted(LM_MOE))
def test_tgmm_lm_moe_shapes_match_plain(card, pattern, kn, out_dtype):
    """K at the sorted lm_moe leg's shapes (m = 32768, E = 8): its default
    unit size and width, bf16 and fp32 output; an empty group is zero."""
    k, n = kn
    sizes = torch.tensor(LM_MOE[pattern], dtype=torch.int32, device="cuda")
    lhs, _, grad = _gmm_operands(32768, k, n, 1, torch.bfloat16, 31)
    got = gm.tgmm(lhs, grad, sizes, out_dtype=out_dtype, impl="kernel")
    _gmm_held(got, gm.tgmm_plain(lhs, grad, sizes, out_dtype=out_dtype),
              f"tgmm {pattern} {kn}")
    for e, size in enumerate(LM_MOE[pattern]):
        if size == 0:
            assert not got[e].any()


@pytest.mark.parametrize("kn", [(576, 192), (192, 192), (768, 192),
                                (192, 768)],
                         ids=["dWqkv", "dWproj", "dW_in", "dW_out"])
def test_tgmm_one_group_at_the_vit_weight_grads(card, kn):
    """The fused ViT-Tiny layer's four weight grads: one group of 65536
    tokens, fp32 output, the rows split into units to fill the card."""
    k, n = kn
    one = torch.full((1,), 65536, dtype=torch.int32, device="cuda")
    lhs, _, grad = _gmm_operands(65536, k, n, 1, torch.bfloat16, 32)
    _gmm_held(gm.tgmm(lhs, grad, one, out_dtype=torch.float32,
                      impl="kernel"),
              gm.tgmm_plain(lhs, grad, one, out_dtype=torch.float32),
              f"tgmm one group {kn}")


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("block_n", gm.TGMM_BLOCK_N)
@pytest.mark.parametrize("chunk", [64, 100, 4096])
@pytest.mark.parametrize("pattern", ["skewed", "empty_off_grid", "tail"])
def test_tgmm_units_and_widths(card, pattern, chunk, block_n, out_dtype):
    """Units smaller than the groups (64 rows, and 100: off the 64-row
    slices), each compiled width, kd = 96 and n = 160 (partial tiles).
    With 4096-row units every group is one unit: no workspace slab, and
    no second pass."""
    sizes = torch.tensor(GMM_PATTERNS[pattern], dtype=torch.int32,
                         device="cuda")
    lhs, _, grad = _gmm_operands(1000, 96, 160, 1, torch.bfloat16, 33)
    before = gm.LAUNCHES["tgmm_reduce"]
    got = gm._launch_tgmm(lhs, grad, sizes, out_dtype, chunk=chunk,
                          block_n=block_n)
    assert gm.LAUNCHES["tgmm_reduce"] == before + (chunk < 1000)
    _gmm_held(got, gm.tgmm_plain(lhs, grad, sizes, out_dtype=out_dtype),
              f"tgmm {pattern} chunk {chunk} width {block_n}")


def test_tgmm_rows_past_a_unit_stay_out(card):
    """Inf in another group's rows, of either operand, reaches no other
    group's product: the rows past a unit are zeroed in both operands."""
    sizes = torch.tensor([37, 63, 100, 800], dtype=torch.int32,
                         device="cuda")
    lhs, _, grad = _gmm_operands(1000, 64, 128, 1, torch.bfloat16, 34)
    lhs[37:100, 5] = float("inf")
    grad[100:200, 7] = float("-inf")
    for chunk in (64, 4096):
        got = gm._launch_tgmm(lhs, grad, sizes, torch.float32, chunk=chunk)
        want = gm.tgmm_plain(lhs, grad, sizes, out_dtype=torch.float32)
        for e in (0, 3):
            assert torch.isfinite(got[e]).all(), (chunk, e)
            _gmm_held(got[e], want[e], f"tgmm group {e} chunk {chunk}")


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_tgmm_unaligned_operands_take_the_ringless_kernel(card, out_dtype):
    """bf16 operands one element into their storage: no tensor map, so K
    runs the ring-less kernel, every unit through the second pass."""
    sizes = torch.tensor(GMM_PATTERNS["empty_off_grid"], dtype=torch.int32,
                         device="cuda")
    lhs, _, grad = _gmm_operands(1000, 96, 160, 1, torch.bfloat16, 35)
    shift = torch.cat([torch.zeros(1, device="cuda", dtype=torch.bfloat16),
                       lhs.reshape(-1)])[1:].view(1000, 96)
    assert shift.data_ptr() % 16 != 0
    for chunk in (64, None):
        got = gm._launch_tgmm(shift, grad, sizes, out_dtype, chunk=chunk)
        _gmm_held(got, gm.tgmm_plain(shift, grad, sizes,
                                     out_dtype=out_dtype),
                  f"tgmm unaligned chunk {chunk}")


@pytest.mark.parametrize("chunk", [128, None])
def test_tgmm_is_the_same_bits_every_run(card, chunk):
    """Units summed in unit order, no atomics: two runs, the same bits."""
    sizes = torch.tensor(LM_MOE["skewed"], dtype=torch.int32, device="cuda")
    lhs, _, grad = _gmm_operands(32768, 768, 256, 1, torch.bfloat16, 36)
    first = gm._launch_tgmm(lhs, grad, sizes, torch.float32, chunk=chunk)
    second = gm._launch_tgmm(lhs, grad, sizes, torch.float32, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
