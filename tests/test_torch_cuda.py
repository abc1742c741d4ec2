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
rows, cursors past the per-slot capacity, and the wrappers' refusals;
ring and Ulysses attention on seq ranks as threads (E/F/G per block with
the merge's lse cotangent, the packed and "heads" routes after the head
scatter, lm_base steps at seq 2 against one rank: `-k sequence`); the
expert axis (J and K on a rank's local group sizes, an idle rank's
included, and a sorted MoE layer at expert 2 against one rank: `-k
expert`); the pipeline schedules (E/F/G on each stage's microbatches
under GPipe, 1F1B and interleaved against the same schedule on the plain
versions, with the launches each schedule implies, and lm_pipe steps at
pipe 2 x tensor 2 against one rank: `-k pipe`);
the split over the cache at forced plans and at ranges the old kernel
refused (L = 65536), its arrival counters across calls, and kernel C
with fp32 queries over a bf16 pool at S > 1 against the split schedule's
torch emulation (tests/_decode_split.py), which rounds p to bf16 at the
same points (the plain version's exact max moves that bf16 rounding, so
against it the bf16 limit holds).

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
Kernel H's Hopper kernel (bf16, the shapes `_wg_plan` takes) runs at every
shape of experiments/fused_profile.py, at odd image counts (a tail tile
with one sequence) and gives the same bits on a rerun; the general kernel
H it replaces at those shapes is held to the same limits. Kernel I's
outputs at a fixed input are pinned by their sha256 (the kernel I of the
commit before the Hopper H gave the same digest on an H100): I is not
changed by H's redesign.

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

import math

import numpy as np
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
    # a span the old kernel's shared-memory score buffer refused runs now,
    # in splits
    L = 60_000
    q, kc, vc, starts, _ = _inputs(1, L, 1, 256, L - 1, torch.float32,
                                   torch.float32, seed=3)
    _check(q, kc, vc, L - 1, starts, 1, {})


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
    # a per-slot capacity the old kernel's score buffer refused runs now
    wide = torch.randint(1, 40, (4, 4000), dtype=torch.int32, device="cuda")
    _check_paged(q, kp, vp, wide, lengths + 50_000, starts, 2, {})
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


# ------------------------------------------------------- the split plan
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16), (torch.float32, torch.int8),
          (torch.bfloat16, torch.int8)]


@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPES)
@pytest.mark.parametrize("b,L,h,d,cur,plan", [
    (1, 65536, 2, 64, 65535, None),      # refused by the old kernel
    (3, 2000, 4, 64, 1999, (8, 256)),
    (2, 3000, 2, 128, 2047, (33, 64)),   # splits past cur, empty
    (2, 700, 1, 256, 699, (15, 48)),
])
def test_kernel_splits_match_plain(card, b, L, h, d, cur, plan, q_dtype,
                                   kv_dtype):
    from _decode_split import flat_split_emulated

    q, kc, vc, starts, scales = _inputs(b, L, h, d, cur, q_dtype, kv_dtype,
                                        seed=L + d)
    for st in (starts, None):
        got = ops._launch(q, kc, vc, cur, st, h, d, scales.get("k_scale"),
                          scales.get("v_scale"), plan=plan)
        want = ops.decode_attention_plain(q, kc, vc, cur, st, n_heads=h,
                                          **scales)
        atol, rtol = TOL[q_dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        emu = flat_split_emulated(
            q, kc, vc, cur, st, plan or ops._split_plan(
                cur + 1, b * h, d=d, kv_bytes=kc.element_size(),
                quant=bool(scales)), n_heads=h, **scales)
        torch.testing.assert_close(got.float(), emu.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPES)
@pytest.mark.parametrize("mb,plan", [(4096, None), (8, (8, 16)),
                                     (8, (3, 48))])
def test_paged_kernel_splits_match_plain(card, mb, plan, q_dtype, kv_dtype):
    """mb = 4096 (65536 positions a slot) was refused by the old kernel.
    fp32 queries over a bf16 pool round p to bf16 against each split's
    max: held to the fp32 limit against the split emulation, to the bf16
    limit against the plain version."""
    from _decode_split import paged_split_emulated

    q, kp, vp, pt, lengths, starts, scales = _paged_inputs(
        2, 64, q_dtype, kv_dtype, seed=mb, mb=mb)
    if mb > 8:
        lengths = torch.tensor([37, 40_000, mb * 16 + 5, 0],
                               dtype=torch.int32, device="cuda")
        starts = torch.tensor([3, 30_000, 20, 0], dtype=torch.int32,
                              device="cuda")
    for st in (starts, None):
        got = ops._launch_paged(q, kp, vp, pt, lengths, st, 2, 64,
                                scales.get("k_scale"), scales.get("v_scale"),
                                plan=plan)
        full = ops._plan_args(plan or ops._split_plan(
            mb * 16, 4 * 2, d=64, kv_bytes=kp.element_size(),
            quant=bool(scales), bs=16,
            whole=kv_dtype == torch.bfloat16 != q_dtype), mb * 16)
        emu = paged_split_emulated(q, kp, vp, pt, lengths, st, full,
                                   n_heads=2, **scales)
        want = ops.paged_decode_attention_plain(q, kp, vp, pt, lengths, st,
                                                n_heads=2, **scales)
        atol, rtol = TOL[q_dtype]
        torch.testing.assert_close(got.float(), emu.float(), atol=atol,
                                   rtol=rtol)
        if kv_dtype == torch.bfloat16 != q_dtype and full[0] > 1:
            atol, rtol = TOL[torch.bfloat16]
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)


def test_split_counters_reset_and_grow(card):
    """The arrival counters: two calls in a row, a larger b*h (the buffer
    grows), a smaller one after it; every launch leaves them at zero."""
    for b, h in ((1, 2), (1, 2), (8, 4), (2, 2), (8, 4)):
        q, kc, vc, starts, _ = _inputs(b, 1500, h, 64, 1499, torch.float32,
                                       torch.float32, seed=b * h)
        got = ops._launch(q, kc, vc, 1499, starts, h, 64, None, None,
                          plan=(12, 128))
        want = ops.decode_attention_plain(q, kc, vc, 1499, starts,
                                          n_heads=h)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        count = ops._COUNTERS[q.device]
        assert count.numel() >= b * h
        assert not count.any()


@pytest.mark.parametrize("plan", [(1, 64), (4, 16)])
def test_split_empty_ranges_give_zeros_and_launch_is_counted(card, plan):
    q, kc, vc, _, _ = _inputs(2, 64, 2, 64, 40, torch.float32,
                              torch.float32, seed=9)
    starts = torch.tensor([41, 3], dtype=torch.int32, device="cuda")
    before = ops.LAUNCHES["decode_attention"]
    out = ops._launch(q, kc, vc, 40, starts, 2, 64, None, None, plan=plan)
    assert ops.LAUNCHES["decode_attention"] == before + 1
    assert torch.count_nonzero(out[0]) == 0
    want = ops.decode_attention_plain(q, kc, vc, 40, starts, n_heads=2)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    q, kp, vp, pt, lengths, _, _ = _paged_inputs(2, 64, torch.float32,
                                                 torch.float32, seed=10)
    starts = torch.tensor([40, 200, 0, 1], dtype=torch.int32, device="cuda")
    before = ops.LAUNCHES["paged_decode_attention"]
    out = ops._launch_paged(q, kp, vp, pt, lengths, starts, 2, 64, None,
                            None, plan=(2 * plan[0], 64 // plan[0]))
    assert ops.LAUNCHES["paged_decode_attention"] == before + 1
    assert torch.count_nonzero(out[:2]) == 0
    assert torch.count_nonzero(out[3]) == 0
    want = ops.paged_decode_attention_plain(q, kp, vp, pt, lengths, starts,
                                            n_heads=2)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)


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


def _variant_check(q, k, v, variant, n_heads, causal):
    """The kernel route of one variant, its launch counted under its row,
    against its plain version on 64-key tiles (so the same running max):
    out at the bf16 limits above; lse within 1e-4 where l sums fp32 p,
    within 2^-8 where it sums the rounded p (v3, v5: scores that differ in
    their last fp32 bits can round a p the other way, which moves l by at
    most 2^-8 of itself), and there the mean lse error stays under a tenth
    of the mean distance from plain v2 (which sums fp32 p): the kernel
    computes the sum-fold, not v2's sum."""
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


@pytest.mark.parametrize("shape", [(8, 512, 512), (96, 2048, 2048),
                                   (8, 200, 328), (8, 300, 300),
                                   (8, 130, 400)])
@pytest.mark.parametrize("variant,n_heads,causal", VARIANT_CASES)
def test_flash_variant_kernels_match_plain(card, variant, n_heads, causal,
                                           shape):
    """Each variant against its plain version (`_variant_check`); (8, 200,
    328), (8, 300, 300) and (8, 130, 400) have ragged query and key tiles
    (s_q not a multiple of the 128- or 64-query blocks) and, causal, a
    bottom-right offset."""
    bh, sq, sk = shape
    q = _randn(bh, sq, 64, dtype=torch.bfloat16, seed=sq)
    k = _randn(bh, sk, 64, dtype=torch.bfloat16, seed=sk + 1)
    v = _randn(bh, sk, 64, dtype=torch.bfloat16, seed=sk + 2)
    _variant_check(q, k, v, variant, n_heads, causal)


@pytest.mark.parametrize("variant,n_heads,causal", VARIANT_CASES)
def test_flash_variant_unaligned_operands_match_plain(card, variant, n_heads,
                                                      causal):
    """q, k and v as views of (b*h, s, 65) buffers: their rows are not 16
    bytes apart, so the kernel stages them with plain loads at the same
    points of the schedule (v5's padded copy of v is its own, aligned);
    held as `_variant_check` holds the aligned operands."""
    bh, sq, sk = 8, 300, 328
    q, k, v = (_randn(bh, s, 65, dtype=torch.bfloat16, seed=i)[..., :64]
               for i, s in enumerate((sq, sk, sk)))
    assert q.stride(1) == 65
    _variant_check(q, k, v, variant, n_heads, causal)


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


@pytest.mark.parametrize("shape", [
    (1024, 64, 192, 3, 768, False),    # fused_profile.SHAPES: ViT-Tiny
    (1, 64, 192, 3, 768, False),       # one sequence: half a tile
    (64, 128, 256, 4, 1024, True),     # the causal LM layer, s = 128
    (3, 64, 192, 3, 768, False),       # a tail tile
    (1023, 64, 192, 3, 768, False),
    (5, 49, 192, 3, 768, False),       # 49 positions padded to 64 rows
    (3, 40, 128, 1, 208, False),       # head_dim 128, a ragged MLP chunk
], ids=["vit_tiny", "one", "causal_lm", "three", "odd_1023", "s49",
        "hd128"])
def test_fused_forward_hopper_matches_plain(card, shape):
    """Kernel H's Hopper kernel (every bf16 shape here is in `_wg_plan`)
    and the general kernel against the plain version; the Hopper kernel
    gives the same bits on a rerun."""
    imgs, s, d, heads, mlp, causal = shape
    assert fe._wg_plan(s, d, heads) is not None
    x, _, params = _fused_inputs(imgs, s, d, mlp, torch.bfloat16, imgs)
    kw = dict(num_heads=heads, compute_dtype=torch.bfloat16, causal=causal)
    before = fe.LAUNCHES["fused_encoder_fwd"]
    out = fe.fused_encoder_forward(x, params, impl="kernel", **kw)
    again = fe.fused_encoder_forward(x, params, impl="kernel", **kw)
    general = fe._launch_fwd(x, params, heads, torch.bfloat16, causal,
                             general=True)
    torch.cuda.synchronize()
    assert fe.LAUNCHES["fused_encoder_fwd"] == before + 2
    assert torch.equal(out, again)
    want = fe.fused_encoder_plain(x, params, **kw)
    _fused_held(out, want, torch.bfloat16, 0, "out")
    _fused_held(general, want, torch.bfloat16, 0, "general out")


def test_fused_forward_hopper_fp32_activations(card):
    """fp32 x with bf16 compute on the Hopper kernel, one sequence a tile
    (its `seqs` override) and two ring stages: the same output as the
    plan's."""
    x, _, params = _fused_inputs(7, 64, 192, 768, torch.float32, 8)
    kw = dict(num_heads=3, compute_dtype=torch.bfloat16)
    out = fe.fused_encoder_forward(x, params, impl="kernel", **kw)
    _fused_held(out, fe.fused_encoder_plain(x, params, **kw),
                torch.bfloat16, 0, "out")
    for over in (dict(seqs=1), dict(stages=2)):
        other = fe._launch_fwd(x, params, 3, torch.bfloat16, False, **over)
        _fused_held(other, out, torch.bfloat16, 0, str(over))


def i_digest(dx, grads) -> str:
    """sha256 of kernel I's outputs' bytes (dx, then the 12 grads)."""
    import hashlib

    h = hashlib.sha256()
    for t in (dx, *grads):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def i_pinned_outputs():
    """Kernel I's dx and grads at a fixed input: 12 ViT-Tiny sequences in
    bf16, made with numpy from seed 9."""
    import numpy as np

    rng = np.random.default_rng(9)
    d, mlp = 192, 768

    def card_tensor(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((shift + scale * rng.standard_normal(shape))
                                .astype(np.float32)).cuda()

    shapes = ((d,), (d,), (3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,),
              (mlp, d), (mlp,), (d, mlp), (d,))
    params = [card_tensor(*sh, scale=sh[1] ** -0.5) if len(sh) == 2 else
              card_tensor(*sh, scale=0.1, shift=1.0 if i in (0, 6) else 0.0)
              for i, sh in enumerate(shapes)]
    x = card_tensor(12, 64, d).bfloat16()
    g = card_tensor(12, 64, d).bfloat16()
    return fe.fused_encoder_backward(x, g, params, num_heads=3,
                                     compute_dtype=torch.bfloat16,
                                     impl="kernel")


# i_digest(*i_pinned_outputs()) from csrc/fused_encoder.cu as it stood
# before the Hopper kernel H, on an NVIDIA H100 80GB HBM3
I_DIGEST = "74dc8279ca5c99b0d16f450ff138d724fbeaa3aaddeb1ab590a7ab7078898976"


def test_fused_backward_bits_are_pinned(card):
    assert i_digest(*i_pinned_outputs()) == I_DIGEST


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


# --------------------------------------------- graphed steps (ROADMAP A3)
# The resident and chunked steps run as replays of one captured CUDA graph
# (utils/graphs.py). Held against the eager host-fed steps of the same
# configuration: per-step loss 1e-6 relative, parameters and buffers 1e-5
# (the same kernels on the same batches; only an algorithm cuDNN or
# cuBLAS picks apart between the two could move a bit).
def _trainer(**kw):
    from ddp_practice_tpu_torch.config import TrainConfig
    from ddp_practice_tpu_torch.train.loop import Trainer

    base = dict(device="cuda", epochs=1, log_every_steps=0,
                data_dir="build/no_such_data")
    return Trainer(TrainConfig(**{**base, **kw}))


def _recorded(trainer, name):
    """The losses each call of `trainer.<name>` returns, in order, and
    the step's graph (None for the per-batch step)."""
    losses, step = [], getattr(trainer, name)

    def recorded(*args):
        state, metrics = step(*args)
        losses.append(metrics["loss"])
        return state, metrics

    setattr(trainer, name, recorded)
    return losses, getattr(step, "graph", None)


def _held(a, b, rel=1e-6, tol=1e-5):
    """Per-call losses (a: every step; b: the last of each group of
    len(a) / len(b)) and the two states."""
    (la, sa), (lb, sb) = a, b
    every = len(la) // len(lb)
    for i, got in enumerate(lb):
        want = float(la[(i + 1) * every - 1])
        assert abs(float(got) - want) <= rel * abs(want), (i, got, want)
    want = sa.model.state_dict()
    for name, value in sb.model.state_dict().items():
        torch.testing.assert_close(value, want[name], rtol=tol, atol=tol,
                                   msg=name)


def test_graphed_resident_convnet_equals_the_eager_host_steps(card):
    kw = dict(synthetic_size=3200, max_steps_per_epoch=50)
    host = _trainer(data_placement="host", **kw)
    res = _trainer(data_placement="device", **kw)
    h, _ = _recorded(host, "train_step")
    r, graph = _recorded(res, "resident_train_step")
    host.train_epoch(0)
    res.train_epoch(0)
    assert (graph.captures, graph.replays) == (1, 49)   # step 1 eager
    assert res.state.step == host.state.step == 50
    _held((h, host.state), (r, res.state))
    assert res.evaluate() == host.evaluate()
    assert res.resident_eval_step.graph.captures == 1


@pytest.mark.parametrize("kind", ["crop_flip", "rrc"])
def test_graphed_augmented_resnet18_equals_the_eager_host_steps(card, kind):
    """ResNet-18 (ROADMAP A2) with on-device augmentation: the resident
    steps' crops are drawn on the device from the step counter, so the
    captured step's replays crop as the eager host steps do (the
    random resized crop's weight matrices included)."""
    kw = dict(model="resnet18", dataset="cifar10", synthetic_size=1280,
              batch_size=64, max_steps_per_epoch=12, augment=True,
              augment_kind=kind, optimizer="sgd", momentum=0.9,
              learning_rate=0.05)
    host = _trainer(data_placement="host", **kw)
    res = _trainer(data_placement="device", **kw)
    h, _ = _recorded(host, "train_step")
    r, graph = _recorded(res, "resident_train_step")
    host.train_epoch(0)
    res.train_epoch(0)
    assert (graph.captures, graph.replays) == (1, 11)
    assert res.state.step == host.state.step == 12
    _held((h, host.state), (r, res.state))


@pytest.mark.parametrize("kw", [
    dict(optimizer="adamw", learning_rate=1e-3, lr_schedule="cosine"),
    dict(optimizer="adam", learning_rate=1e-3, dropout=0.1),
], ids=["cosine_adamw", "dropout"])
def test_graphed_lm_equals_the_eager_host_steps(card, kw):
    """lm_tiny, 4 steps a replay group, two epochs: the lr read from the
    device table and the dropout masks keyed on the device step counter
    under replay equal the eager steps'."""
    base = dict(model="lm_tiny", seq_len=64, batch_size=4, epochs=2,
                synthetic_size=60000, max_steps_per_epoch=12, **kw)
    host = _trainer(data_placement="host", **base)
    res = _trainer(data_placement="device", steps_per_call=4, **base)
    h, _ = _recorded(host, "train_step")
    r, graph = _recorded(res, "resident_train_step")
    for epoch in range(2):
        host.train_epoch(epoch)
        res.train_epoch(epoch)
    assert (graph.captures, graph.replays) == (1, 23)
    assert res.state.step == host.state.step == 24
    assert float(res.state.optimizer.lr) == float(host.state.optimizer.lr)
    _held((h, host.state), (r, res.state))


@pytest.mark.parametrize("placement,k,accum", [
    ("host", 4, 1), ("host", 4, 2), ("device", 3, 2),
], ids=["chunked", "chunked_accum2", "resident_k3_accum2"])
def test_graphed_chunks_and_accumulation_equal_the_eager_steps(
        card, placement, k, accum):
    """K host batches a call (one copy a chunk into the chunked step's
    buffer), and a unit of two micro-steps a replay: with K = 3 every
    group starts or ends mid-apply, so its edges run eagerly."""
    base = dict(model="lm_tiny", seq_len=64, batch_size=4,
                synthetic_size=60000, max_steps_per_epoch=12,
                optimizer="adamw", learning_rate=1e-3, accum_steps=accum)
    host = _trainer(data_placement="host", **base)
    graphed = _trainer(data_placement=placement, steps_per_call=k, **base)
    name = "chunk_step" if placement == "host" else "resident_train_step"
    h, _ = _recorded(host, "train_step")
    r, graph = _recorded(graphed, name)
    host.train_epoch(0)
    graphed.train_epoch(0)
    assert graph.captures == 1 and graph.replays > 0
    assert graphed.state.step == host.state.step == 12
    assert graphed.state.optimizer.applies == 12 // accum
    _held((h, host.state), (r, graphed.state))


def test_graphed_chunked_eval_equals_the_per_batch_eval(card):
    kw = dict(synthetic_size=3200, data_placement="host")
    chunked = _trainer(steps_per_call=4, **kw)
    assert chunked.evaluate() == _trainer(**kw).evaluate()
    assert chunked.chunk_eval_step.graph.captures == 1


def test_graph_replays_reach_the_flash_and_fused_kernels(card):
    """E/F/G (lm_tiny at 4 heads of 64, flash) and H/I with I's four K
    launches (vit_tiny, fused auto) run inside the replays: the launches a
    replay makes count in graphs.REPLAYED, depth x replays each, and the
    capture pass's own calls do not count."""
    from ddp_practice_tpu_torch.utils import graphs

    fa.reset_launches()
    graphs.reset_replayed()
    lm = _trainer(model="lm_tiny", attn_impl="flash", num_heads=4,
                  seq_len=128, batch_size=4, synthetic_size=60000,
                  max_steps_per_epoch=8, steps_per_call=4)
    lm.train_epoch(0)
    depth, replays = lm.model.depth, lm.resident_train_step.graph.replays
    assert replays == 7
    for kind in ("fwd", "bwd"):
        assert sum(n for k, n in graphs.REPLAYED.items()
                   if k.startswith(f"flash_{kind}_")) == depth * replays
        assert sum(n for k, n in fa.LAUNCHES.items()
                   if k.startswith(f"flash_{kind}_")) == depth   # step 1
    fe.reset_launches()
    gm.reset_launches()
    graphs.reset_replayed()
    vit = _trainer(model="vit_tiny", dataset="cifar10", batch_size=8,
                   synthetic_size=256, max_steps_per_epoch=4,
                   steps_per_call=2)
    vit.train_epoch(0)
    depth = len(vit.model.blocks)
    replays = vit.resident_train_step.graph.replays
    assert replays == 3
    assert graphs.REPLAYED["fused_encoder_fwd"] == depth * replays
    assert graphs.REPLAYED["fused_encoder_bwd"] == depth * replays
    assert graphs.REPLAYED["tgmm"] == 4 * depth * replays
    assert fe.LAUNCHES == {"fused_encoder_fwd": depth,
                           "fused_encoder_bwd": depth}


def test_a_step_that_cannot_be_captured_raises_naming_the_op(card,
                                                              monkeypatch):
    """A step with an op that reads a device value on the host (here the
    sorted MoE path's counts through torch.bincount, whose output size it
    reads, as the path counted before its index_add_): under capture the
    step raises, naming the port's line that reached the op, and runs no
    step eagerly in its place; the card and the caller's stream are fine
    afterwards."""
    from ddp_practice_tpu_torch.ops import moe as tmoe
    from ddp_practice_tpu_torch.utils.graphs import CaptureError

    def bincount_permutation(choices_flat, e, first=0):
        counts = torch.bincount(choices_flat, minlength=e)
        key = choices_flat if first == 0 else (choices_flat - first) % e
        _, inv = torch.sort(key, stable=True)
        dest = torch.empty_like(inv)
        dest[inv] = torch.arange(inv.numel(), device=inv.device)
        return counts.to(torch.int32), dest, inv

    monkeypatch.setattr(tmoe, "_assignment_permutation",
                        bincount_permutation)
    trainer = _trainer(model="lm_moe", seq_len=64, batch_size=2,
                       synthetic_size=60000, max_steps_per_epoch=4,
                       steps_per_call=2, num_experts=4)
    for m in tmoe.moe_layers(trainer.model):
        m.impl = "sorted"
    stream = torch.cuda.current_stream()
    with pytest.raises(CaptureError,
                       match=r"ops/moe\.py:\d+.*_assignment_permutation"):
        trainer.train_epoch(0)
    assert trainer.state.step == 1            # the eager step before it
    assert torch.cuda.current_stream() == stream
    x = torch.ones(1000, device="cuda")
    assert float((x * 2).sum()) == 2000.0


def test_the_sorted_moe_step_is_captured_with_j_and_k(card):
    """The sorted MoE path counts its experts with an index_add_ into E
    bins: a resident lm_moe step on it is captured, kernels J and K
    replay inside the graph, and the losses and parameters equal the
    eager host steps' bit for bit."""
    from ddp_practice_tpu_torch.ops.moe import moe_layers
    from ddp_practice_tpu_torch.utils import graphs

    base = dict(model="lm_moe", seq_len=64, batch_size=4, precision="bf16",
                synthetic_size=60000, max_steps_per_epoch=8,
                optimizer="adamw", learning_rate=1e-3, num_experts=4)
    host = _trainer(data_placement="host", **base)
    res = _trainer(data_placement="device", steps_per_call=4, **base)
    for t in (host, res):
        for m in moe_layers(t.model):
            m.impl = "sorted"
    h, _ = _recorded(host, "train_step")
    r, graph = _recorded(res, "resident_train_step")
    host.train_epoch(0)
    gm.reset_launches()
    graphs.reset_replayed()
    res.train_epoch(0)
    assert (graph.captures, graph.replays) == (1, 7)
    for k in ("gmm", "gmm_trhs", "tgmm"):
        assert graphs.REPLAYED[k] > 0 and gm.LAUNCHES[k] > 0, k
    assert [float(x) for x in r] == [float(h[3]), float(h[7])]
    want = host.model.state_dict()
    for name, value in res.model.state_dict().items():
        assert torch.equal(value, want[name]), name


def test_a_probe_behind_a_stalled_rung_fires_the_watchdog(card):
    """A rung recorded behind a spin kernel longer than the timeout: the
    probe waits for it (the event, not a readback queued behind later
    work), and `on_timeout` fires meanwhile, once."""
    import time

    from ddp_practice_tpu_torch.train.elastic import Rung, StepWatchdog

    fired = []
    wd = StepWatchdog(0.3, on_timeout=fired.append).start()
    wd.beat()
    torch.cuda._sleep(int(2e9))
    rung = Rung(torch.device("cuda", torch.cuda.current_device()))
    assert not rung.ready()
    t0 = time.monotonic()
    wd.probe(rung)
    waited = time.monotonic() - t0
    wd.stop()
    assert rung.ready() and waited > 0.3 and len(fired) == 1


def test_devices_flag_on_one_card(card):
    """--devices 1 is the plain run on the card; --devices N above the
    visible cards raises instead of taking fewer."""
    from ddp_practice_tpu_torch import cli

    argv = ["--model", "lm_tiny", "--seq_len", "64", "-b", "4", "-e", "1",
            "--max_steps", "2", "--synthetic_size", "60000", "--log_every",
            "0"]
    assert cli.main(["--devices", "1"] + argv) == 0
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"--devices {n}: "):
        cli.main(["--devices", str(n)] + argv)


def test_a_restore_after_the_capture_captures_again(card, tmp_path):
    """Adam's state is rebound by a restore: the next group captures a new
    graph. The steps after the restore repeat the steps after the save
    (the same grid rows from the same state), and a run resumed from the
    checkpoint before any capture takes them too."""
    import ddp_practice_tpu_torch.checkpoint as ckpt

    kw = dict(model="lm_tiny", seq_len=64, batch_size=4,
              synthetic_size=60000, optimizer="adam", learning_rate=1e-3,
              steps_per_call=5, checkpoint_dir=str(tmp_path))
    trainer = _trainer(**kw)
    step, data = trainer.resident_train_step, trainer._train_data
    starts, _ = trainer.train_loader.epoch_plan()
    grid = torch.from_numpy(starts[:10]).cuda()
    trainer.state, _ = step(trainer.state, data, grid[:5])
    trainer.save()
    trainer.state, _ = step(trainer.state, data, grid[5:])
    after = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    assert step.graph.captures == 1
    ckpt.restore(str(tmp_path), trainer.state)
    assert trainer.state.step == 5
    trainer.state, _ = step(trainer.state, data, grid[5:])
    assert step.graph.captures == 2
    resumed = _trainer(resume=True, **kw)
    assert resumed.state.step == 5
    resumed.state, _ = resumed.resident_train_step(
        resumed.state, resumed._train_data, grid[5:])
    for model in (trainer.model, resumed.model):
        for name, value in model.state_dict().items():
            torch.testing.assert_close(value, after[name], rtol=1e-5,
                                       atol=1e-5, msg=name)


# ------------------------------------------- ROADMAP A8a: sharded lm_base
SHARDED_LEGS = {"tensor2": (dict(mesh=dict(tensor=2)), 2),
                "fsdp": (dict(fsdp=True), 2),
                "tensor2_fsdp": (dict(fsdp=True, mesh=dict(tensor=2)), 4)}


def _sharded_trainer(world, optimizer, **kw):
    """lm_base (or `model`), fp32, flash, seq 512, global batch 4."""
    from ddp_practice_tpu_torch.config import MeshConfig

    mesh = kw.pop("mesh", None)
    if mesh is not None:
        kw["mesh"] = MeshConfig(**mesh)
    dp = max(world // math.prod((mesh or {}).values()), 1)
    kw.setdefault("model", "lm_base")
    return _trainer(attn_impl="flash", seq_len=512,
                    batch_size=4 // dp, optimizer=optimizer,
                    learning_rate=1e-2 if optimizer == "sgd" else 1e-4,
                    momentum=0.9 if optimizer == "sgd" else 0.0,
                    clip_norm=1.0, data_placement="host", **kw)


def _sharded_steps(trainer, n=2):
    trainer.train_loader.set_epoch(0)
    batches = trainer._device_batches(trainer.train_loader)
    losses = []
    for _ in range(n):
        trainer.state, m = trainer.train_step(trainer.state, next(batches))
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
@pytest.mark.parametrize("leg", sorted(SHARDED_LEGS))
def test_sharded_lm_base_steps_equal_one_rank(card, leg, optimizer):
    """Two steps under tensor 2, FSDP over data 2 and both (the ranks as
    threads on this card) against one rank: loss rtol 2e-4; under SGD
    every parameter rtol 1e-3 / atol 1e-5 (Adam turns rounding noise in
    near-zero grads into lr-sized updates: its loss only); E/F/G launch
    12 forward and 12 backward a step on each rank (6 heads: packed)."""
    from ddp_practice_tpu_torch.ops import flash_attention as fa
    from ddp_practice_tpu_torch.parallel.mesh import full_parameters
    from ddp_practice_tpu_torch.parallel.threads import run_ranks

    kw, world = SHARDED_LEGS[leg]
    ref = _sharded_trainer(1, optimizer)
    want_losses = _sharded_steps(ref)
    want = {n: p.detach().clone() for n, p in ref.model.named_parameters()}
    del ref
    fa.reset_launches()

    def rank(r):
        t = _sharded_trainer(world, optimizer, **dict(kw))
        return _sharded_steps(t), full_parameters(t.model)

    res = run_ranks(rank, world, timeout=300)
    for losses, _ in res:
        np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
    if optimizer == "sgd":
        got = res[0][1]
        for n, w in want.items():
            torch.testing.assert_close(got[n], w, rtol=1e-3, atol=1e-5)
    assert fa.LAUNCHES["flash_fwd_packed"] == world * 12 * 2
    assert fa.LAUNCHES["flash_bwd_packed"] == world * 12 * 2


def test_sharded_generate_on_the_card(card):
    """lm_base's widths at depth 2, greedy, tensor 2: the tokens of one
    rank, kernel A launching on each rank's 6 heads every token."""
    from ddp_practice_tpu_torch.config import MeshConfig
    from ddp_practice_tpu_torch.inference import make_generate_fn
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.ops import decode_attention as da
    from ddp_practice_tpu_torch.parallel.mesh import build_mesh, shard_state
    from ddp_practice_tpu_torch.parallel.sharding_rules import (
        param_sharding_rules,
    )
    from ddp_practice_tpu_torch.parallel.threads import run_ranks

    def model():
        return create_model("lm_base", device="cuda", seed=4, depth=2,
                            vocab_size=256, max_len=256, pos_emb="rope")

    prompt = torch.randint(0, 256, (3, 9),
                           generator=torch.Generator().manual_seed(0))
    want = make_generate_fn(model(), max_new_tokens=16,
                            temperature=0.0)(prompt).cpu()
    da.reset_launches()

    def rank(r):
        m = model()
        shard_state(m, build_mesh(MeshConfig(tensor=2), "cuda"),
                    param_sharding_rules("lm_base"), "lm_base")
        assert m.blocks[0].attn.num_heads == 6
        return make_generate_fn(m, max_new_tokens=16,
                                temperature=0.0)(prompt).cpu()

    for got in run_ranks(rank, 2, timeout=300):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert da.LAUNCHES["decode_attention"] == 2 * 2 * 16


# ------------------------------------- ROADMAP A8b: sequence parallelism
# bf16 without a causal mask, the relative error norm: the plain version
# tiles a row's keys 1024 at a time where E takes a few dozen, so its
# running maxima, and with them p's bf16 rounding, differ on most rows of
# a long unmasked sequence (one packed flash_attention call at s 1024,
# Ulysses' local attention here: 2.26e-3 on an H100); the per-element
# limits hold as everywhere
SEQ_FULL_BF16_REL = 3e-3


def _seq_run(sp_impl, world, inputs, weight, causal, impl):
    """ring or Ulysses attention (local impl "flash") with every flash
    entry forced to `impl`, on `world` seq ranks as threads of this
    process: the output and the grads of sum(out * weight), whole."""
    from ddp_practice_tpu_torch.config import MeshConfig
    from ddp_practice_tpu_torch.ops.attention import dot_product_attention
    from ddp_practice_tpu_torch.parallel.mesh import build_mesh, seq_group
    from ddp_practice_tpu_torch.parallel.threads import run_ranks

    def rank(r):
        sp = seq_group(build_mesh(MeshConfig(seq=world), "cuda"))
        xs = [sp.chunk(t).detach().clone().requires_grad_(True)
              for t in inputs]
        out = dot_product_attention(*xs, causal=causal, seq_axis=sp,
                                    sp_impl=sp_impl, impl="flash")
        loss = (out.float() * sp.chunk(weight)).sum()
        grads = torch.autograd.grad(loss, xs)
        torch.cuda.synchronize()
        return out.detach(), grads

    with fa.forced_impl(impl):
        res = run_ranks(rank, world, timeout=300)
    return ([torch.cat([r[0] for r in res], 1)]
            + [torch.cat([r[1][i] for r in res], 1) for i in range(3)])


def _seq_check(sp_impl, world, shape, dtype, causal):
    inputs = [_randn(*shape, dtype=dtype, seed=20 + i) for i in range(3)]
    weight = _randn(*shape, dtype=torch.float32, seed=23)
    fa.reset_launches()
    got = _seq_run(sp_impl, world, inputs, weight, causal, "kernel")
    launches = dict(fa.LAUNCHES)
    want = _seq_run(sp_impl, world, inputs, weight, causal, "plain")
    limit = (SEQ_FULL_BF16_REL if dtype == torch.bfloat16 and not causal
             else FLASH_REL[dtype])
    for i, (a, b) in enumerate(zip(got, want)):
        atol, rtol = FLASH_TOL[dtype][i > 0]
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol)
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        assert rel <= limit, (i, rel)
    return launches


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sequence_ring_kernels_match_plain(card, dtype, causal):
    """Ring attention on 4 seq ranks, (b, s, h, d) = (2, 768, 4, 64):
    E per held block (the diagonal causal, earlier blocks full, later
    ones skipped), the blocks' (out, lse) merged in logsumexp space, and
    G+F with the merge's lse cotangent in delta, against the same ring
    on the plain versions. Launches: a rank r runs r + 1 blocks under
    causal masking, 4 without."""
    launches = _seq_check("ring", 4, (2, 768, 4, 64), dtype, causal)
    blocks = sum(r + 1 for r in range(4)) if causal else 16
    assert launches["flash_fwd_folded"] == blocks
    assert launches["flash_bwd_folded"] == blocks


@pytest.mark.parametrize("heads", [8, 6], ids=["packed", "heads"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sequence_ulysses_kernels_match_plain(card, dtype, heads):
    """Ulysses on 2 seq ranks at s 1024, causal: 4 heads of 64 a rank
    take the packed route, 3 the "heads" route; one E and one G+F a
    rank."""
    launches = _seq_check("ulysses", 2, (2, 1024, heads, 64), dtype, True)
    row = "packed" if heads == 8 else "folded"
    assert launches[f"flash_fwd_{row}"] == 2
    assert launches[f"flash_bwd_{row}"] == 2


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_sequence_lm_base_steps_equal_one_rank(card, sp_impl):
    """lm_base, fp32, flash, seq_len 512 at seq 2 (ranks as threads on
    this card), two SGD steps against one rank: loss rtol 2e-4, every
    parameter rtol 1e-3 / atol 1e-5. Per step and rank r, ring launches
    12 (r + 1) folded E and G+F, Ulysses 12 packed (6 heads a rank)."""
    from ddp_practice_tpu_torch.parallel.mesh import full_parameters
    from ddp_practice_tpu_torch.parallel.threads import run_ranks

    ref = _sharded_trainer(1, "sgd")
    want_losses = _sharded_steps(ref)
    want = {n: p.detach().clone() for n, p in ref.model.named_parameters()}
    del ref
    fa.reset_launches()

    def rank(r):
        # world 1: the global batch stays 4 (one data replica)
        t = _sharded_trainer(1, "sgd", mesh=dict(seq=2), sp_impl=sp_impl)
        return _sharded_steps(t), full_parameters(t.model)

    res = run_ranks(rank, 2, timeout=300)
    for losses, _ in res:
        np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
    for n, w in want.items():
        torch.testing.assert_close(res[0][1][n], w, rtol=1e-3, atol=1e-5)
    row, per_step = (("folded", 12 * (1 + 2)) if sp_impl == "ring"
                     else ("packed", 12 * 2))
    assert fa.LAUNCHES[f"flash_fwd_{row}"] == 2 * per_step
    assert fa.LAUNCHES[f"flash_bwd_{row}"] == 2 * per_step


# ------------------------------------------- ROADMAP A8c: the expert axis
EXPERT_PATTERNS = {
    # a rank's local experts (4 of 8) of 1000 sorted rows: theirs lead,
    # the rows past their sum belong to the other rank's experts
    "leading": [300, 120, 0, 80],
    "idle": [0, 0, 0, 0],
    "all_local": [250, 250, 250, 250],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pattern", sorted(EXPERT_PATTERNS))
def test_expert_local_group_sizes_match_plain(card, pattern, dtype):
    """J (both rhs layouts) and K on a rank's local group sizes under
    the expert axis (ops/moe.py `_sorted`: the sort puts the local
    experts' rows first and the kernels take only their sizes): against
    the plain versions, J writing zero past the local rows (an idle
    rank's whole output), K reading none of them."""
    sizes = torch.tensor(EXPERT_PATTERNS[pattern], dtype=torch.int32,
                         device="cuda")
    lhs, rhs, grad = _gmm_operands(1000, 96, 160, 4, dtype, 31)
    used = int(sizes.sum())
    out = gm.gmm(lhs, rhs, sizes, impl="kernel")
    _gmm_held(out, gm.gmm_plain(lhs, rhs, sizes), "gmm")
    assert not out[used:].any()
    dlhs = gm.gmm(grad, rhs, sizes, transpose_rhs=True, impl="kernel")
    _gmm_held(dlhs, gm.gmm_plain(grad, rhs, sizes, transpose_rhs=True),
              "gmm_trhs")
    assert not dlhs[used:].any()
    # rows past the local ones hold garbage K must not read
    lhs[used:] = float("inf")
    got = gm.tgmm(lhs, grad, sizes, impl="kernel")
    _gmm_held(got, gm.tgmm_plain(lhs, grad, sizes), "tgmm")
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_sorted_layer_on_threads_equals_one_rank(card, dtype):
    """A sorted MoEMlp (d 256, 8 experts of 512, top-2, 512 tokens) at
    expert 2, the ranks as threads on this card, against one rank: the
    output, the input grad and every parameter grad (a rank's experts
    against their slice) within the grouped matmul's limits (TOL, the
    fp32 one times the tensor's largest magnitude where that exceeds 1;
    the ranks' partial outputs add in another order than one rank's
    combine); each rank launches J twice forward, J transposed twice and
    K twice backward."""
    import copy
    import threading

    from ddp_practice_tpu_torch.config import MeshConfig
    from ddp_practice_tpu_torch.ops.moe import MoEMlp
    from ddp_practice_tpu_torch.parallel.mesh import build_mesh, shard_state
    from ddp_practice_tpu_torch.parallel.sharding_rules import (
        param_sharding_rules,
    )
    from ddp_practice_tpu_torch.parallel.threads import run_ranks

    torch.manual_seed(0)
    layer = MoEMlp(256, num_experts=8, top_k=2, mlp_dim=512, dtype=dtype,
                   impl="sorted").cuda()
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn_like(p) * 0.05)
    x = _randn(2, 256, 256, dtype=torch.float32, seed=41)
    w = _randn(2, 256, 256, dtype=torch.float32, seed=42)

    def run(mod):
        xs = x.clone().requires_grad_(True)
        y = mod(xs.to(dtype), train=True)
        ((y.float() * w).sum() + mod.sown["moe_aux_loss"]).backward()
        torch.cuda.synchronize()
        return (mod._local(), y.detach(), xs.grad,
                {n: p.grad for n, p in mod.named_parameters()})

    _, want_y, want_gx, want = run(copy.deepcopy(layer))

    class Tally(dict):
        """Each count a wrapper writes, with the thread that wrote it
        (the ranks' `+= 1`s on one dict can race)."""
        writes: list = []

        def __setitem__(self, key, value):
            self.writes.append((threading.current_thread().name, key))
            super().__setitem__(key, value)

    def rank(r):
        mod = copy.deepcopy(layer)
        shard_state(mod, build_mesh(MeshConfig(expert=2), "cuda"),
                    param_sharding_rules("lm_moe"))
        return run(mod)

    counts, gm.LAUNCHES = gm.LAUNCHES, Tally(gm.LAUNCHES)
    try:
        res = run_ranks(rank, 2, timeout=300)
        writes = gm.LAUNCHES.writes
    finally:
        gm.LAUNCHES = counts
    for r, ((e0, e1), y, gx, grads) in enumerate(res):
        _gmm_held(y, want_y, "y")
        _gmm_held(gx, want_gx, "dx")
        for n, g in grads.items():
            ref = want[n][e0:e1] if n.startswith("expert_") else want[n]
            _gmm_held(g, ref, n)
        mine = [k for t, k in writes if t == f"rank{r}"]
        assert {k: mine.count(k) for k in ("gmm", "gmm_trhs", "tgmm")} == {
            "gmm": 2, "gmm_trhs": 2, "tgmm": 2}, mine


PIPE_KW = dict(vocab_size=256, max_len=512, hidden_dim=768, depth=4,
               num_heads=12, mlp_dim=3072, attn_impl="flash")
# (schedule, pipe, microbatches): each schedule at a small depth
PIPE_LEGS = [("gpipe", 2, 2), ("1f1b", 2, 2), ("interleaved", 2, 2)]


def _pipe_launches(schedule, P, M, rank, depth=4):
    """E and G+F launches of one lm_pipe step on pipe rank `rank` (remat
    on, packed at 12 heads): GPipe runs each stage's L = depth / P
    blocks a microbatch and recomputes them once in the backward; 1F1B
    runs them in its F tick (not the last stage), again in its B tick
    and once more in the block's remat; interleaved runs every chunk's F
    tick, B tick and remat."""
    L = depth // P
    if schedule == "gpipe":
        fwd = 2 * L * M
    elif schedule == "1f1b":
        fwd = (2 if rank == P - 1 else 3) * L * M
    else:
        fwd = 3 * L * M
    return fwd, L * M


@pytest.mark.parametrize("schedule,P,M", PIPE_LEGS,
                         ids=[leg[0] for leg in PIPE_LEGS])
def test_pipe_schedules_kernels_match_plain(card, schedule, P, M):
    """lm_pipe at lm_base's widths, depth 4, fp32, s 512, batch 4, pipe 2
    as threads on this card: the loss and every grad of one step with
    E/F/G (forced "kernel") against the same schedule on their plain
    versions (forced "plain"): loss rtol 1e-5, grads rtol 1e-3 / atol
    1e-5; the kernels launch as `_pipe_launches` counts, per rank."""
    from ddp_practice_tpu_torch.config import MeshConfig
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.ops.losses import cross_entropy
    from ddp_practice_tpu_torch.parallel.mesh import (
        build_mesh,
        full_parameters,
        shard_state,
    )
    from ddp_practice_tpu_torch.parallel.sharding_rules import (
        param_sharding_rules,
    )
    from ddp_practice_tpu_torch.parallel.threads import run_ranks

    g = torch.Generator().manual_seed(31)
    tokens = torch.randint(0, 256, (4, 513), generator=g).cuda()

    def rank(r):
        model = create_model("lm_pipe", device="cuda", seed=31,
                             num_stages=P, num_microbatches=M,
                             schedule=schedule, **PIPE_KW)
        shard_state(model, build_mesh(MeshConfig(pipe=P), "cuda"),
                    param_sharding_rules("lm_pipe"), "lm_pipe")
        x, y = tokens[:, :-1], tokens[:, 1:]
        if schedule == "gpipe":
            loss = cross_entropy(model(x, train=True), y)
            loss.backward()
        else:
            loss, _ = model.loss_and_grad(x, y)
        for p in model.parameters():
            p.data = p.grad
        torch.cuda.synchronize()
        return float(loss.detach()), full_parameters(model)

    fa.reset_launches()
    with fa.forced_impl("kernel"):
        got = run_ranks(rank, P, timeout=300)
    launches = dict(fa.LAUNCHES)
    with fa.forced_impl("plain"):
        want = run_ranks(rank, P, timeout=300)
    for (loss, grads), (wloss, wgrads) in zip(got, want):
        np.testing.assert_allclose(loss, wloss, rtol=1e-5)
        for n, w in wgrads.items():
            torch.testing.assert_close(grads[n], w, rtol=1e-3, atol=1e-5)
    fwd = sum(_pipe_launches(schedule, P, M, r)[0] for r in range(P))
    bwd = sum(_pipe_launches(schedule, P, M, r)[1] for r in range(P))
    assert launches["flash_fwd_packed"] == fwd
    assert launches["flash_bwd_packed"] == bwd


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipe_tensor_steps_equal_one_rank(card, schedule):
    """lm_pipe (d 256, 4 heads of 64, depth 4), fp32, flash, seq_len 512,
    pipe 2 x tensor 2 (the ranks as threads on this card), M 2: two SGD
    steps against one rank's: loss rtol 2e-4, every parameter rtol 1e-3
    / atol 1e-5."""
    from ddp_practice_tpu_torch.parallel.mesh import full_parameters
    from ddp_practice_tpu_torch.parallel.threads import run_ranks

    kw = dict(model="lm_pipe", num_heads=4)
    ref = _sharded_trainer(1, "sgd", **kw)
    want_losses = _sharded_steps(ref)
    want = {n: p.detach().clone() for n, p in ref.model.named_parameters()}
    del ref

    def rank(r):
        t = _sharded_trainer(4, "sgd", mesh=dict(pipe=2, tensor=2),
                             pipe_schedule=schedule, num_microbatches=2,
                             **kw)
        return _sharded_steps(t), full_parameters(t.model)

    res = run_ranks(rank, 4, timeout=300)
    for losses, _ in res:
        np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
    for n, w in want.items():
        torch.testing.assert_close(res[0][1][n], w, rtol=1e-3, atol=1e-5)
