"""Row #12 of the kernel table: the flash-forward variants of kernel E
(ops/flash_attention.py `flash_forward_variant`;
ddp_practice_tpu_torch/experiments/flash_*.py) on the CPU.

- Each variant's plain version against the reference's own Pallas kernel
  (experiments/flash_variants.py `fwd_call` / `fwd_v5_call`,
  experiments/flash_ablate.py `nomax_call`), run in interpret mode on the
  same seeded numpy inputs, (b*h 4, s 256, d 64) bf16, causal and not
  (nomax causal only, as the reference), plus s_q < s_k; both sides tile
  64 x 128. Tolerance: kernel E's bf16 limit, relative error norm 2e-3,
  and per element 1.6e-2 + 2^-7 |ref| (chip_smoke.py BF16_TOL): the same
  rounding points (fp32 scores times the scale, p rounded to bf16 before
  P.V, the output), sums in another order.
- v3 and v5 are not v2: their l is the sum of the ROUNDED p (column d of
  bf16(p).[v | 1]), v2's the fp32 sum of p; pinned on lse.
- An emulation of the CUDA kernel's block schedule against the plain
  version on 64-key tiles, fp32 before the output's rounding: 1e-5. It
  keeps the kernel's plan (`VARIANT_TILES`, pinned to the .cu's
  `FwdPlan`): blocks of 128 queries (64 at four heads a block), grid
  (query tiles, b*h / heads a block), a group of E's warps a head walking
  the same 64-key tiles of the ring, zero-filled staging, unscaled q, the
  scores times the scale, masked and past-the-end keys at p = 0, the
  block-level causal skip, l from one more n8 product (v3: ones made in
  registers; v5: the padded V's columns d..d+7 as they came) or from the
  fp32 sum of p. Its exponentials are the plain version's (the kernel's
  ex2.approx forms move p's bf16 rounding at a few elements, which the
  card tests hold at the bf16 limits). The emulation also stands in for
  the launch, so the wrapper's route (v5's padding, the launch counts)
  runs as on the card.
- `fwd4d` (`flash_attention`: kernel E's packed route on (b, s, h, d)
  strides) against the reference's 4D-grid kernel in interpret mode and
  against the fold-and-transpose path; its kernel route launches E on
  views of the caller's tensors (no copy), counted as E's packed row.
- `visible_fraction` equals the reference's.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from experiments import flash_4d as ref_4d
from experiments import flash_ablate as ref_ablate
from experiments import flash_variants as ref_variants
from ddp_practice_tpu_torch.experiments import flash_4d, flash_variants
from ddp_practice_tpu_torch.ops import flash_attention as fa

# one intra-op thread, as tests/_torch_port.py sets for the port's other
# files: the suite runs several workers on one machine
torch.set_num_threads(1)

BF16_TOL = (1.6e-2, 2.0 ** -7)
REL = 2e-3
BLOCKS = dict(block_q=64, block_k=128)
ROWS = 64


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _assert_bf16_close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= REL, rel
    assert (err <= BF16_TOL[0] + BF16_TOL[1] * np.abs(want)).all(), err.max()


def _reference(variant, n_heads, q, k, v, causal):
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        if variant == "nomax":
            out = ref_ablate.nomax_call(*args, **BLOCKS)
        elif variant == "v5":
            out = ref_variants.fwd_v5_call(*args, causal=causal,
                                           n_heads=n_heads, **BLOCKS)
        else:
            out = ref_variants.fwd_call(variant, *args, causal=causal,
                                        **BLOCKS)
    return np.asarray(out.astype(jnp.float32))


VARIANT_CASES = [("v2", 1), ("v3", 1), ("v4", 2), ("v5", 2), ("v5", 4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("variant,n_heads", VARIANT_CASES)
def test_plain_matches_reference_kernel(variant, n_heads, causal):
    q, k, v = _inputs([(4, 256, 64)] * 3, seed=len(variant) + n_heads)
    want = _reference(variant, n_heads, q, k, v, causal)
    got, _ = fa.flash_forward_variant_plain(
        _bf16(q), _bf16(k), _bf16(v), variant=variant, causal=causal,
        n_heads=n_heads, **BLOCKS)
    _assert_bf16_close(got.float(), want)


@pytest.mark.parametrize("variant,n_heads,sq", [("nomax", 1, 256),
                                                ("nomax", 1, 128),
                                                ("v2", 1, 128),
                                                ("v5", 4, 128)])
def test_plain_matches_reference_kernel_causal_offsets(variant, n_heads, sq):
    """nomax (causal only, as the reference) and s_q < s_k, where the
    causal mask is aligned bottom-right (offset s_k - s_q)."""
    q, k, v = _inputs([(4, sq, 64), (4, 256, 64), (4, 256, 64)], seed=sq)
    want = _reference(variant, n_heads, q, k, v, True)
    got, _ = fa.flash_forward_variant_plain(
        _bf16(q), _bf16(k), _bf16(v), variant=variant, causal=True,
        n_heads=n_heads, **BLOCKS)
    _assert_bf16_close(got.float(), want)


def test_sumfold_variants_sum_the_rounded_p():
    """One key block: v2's lse is m + log(sum p), v3's m + log(sum
    bf16(p)), v5's the same in base 2 converted back; the two sums differ
    on these inputs by far more than the tolerance."""
    q, k, v = (_bf16(a) for a in _inputs([(2, 64, 64)] * 3, seed=7))
    lse = {name: fa.flash_forward_variant_plain(
        q, k, v, variant=name, causal=False, block_q=64, block_k=64)[1]
        for name in ("v2", "v3", "v5")}
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    s_e = s * (1.0 / 8.0)
    m = s_e.amax(-1, keepdim=True)
    p = torch.exp(s_e - m)
    fp32_sum = m[..., 0] + torch.log(p.sum(-1))
    rounded_sum = m[..., 0] + torch.log(p.bfloat16().float().sum(-1))
    s_2 = s * fa._score_scale("v5", 64)
    m2 = s_2.amax(-1, keepdim=True)
    p2 = torch.exp2(s_2 - m2).bfloat16().float()
    base2 = (m2[..., 0] + torch.log2(p2.sum(-1))) * (1.0 / fa._LOG2E)
    torch.testing.assert_close(lse["v2"], fp32_sum, atol=2e-6, rtol=0)
    torch.testing.assert_close(lse["v3"], rounded_sum, atol=2e-6, rtol=0)
    torch.testing.assert_close(lse["v5"], base2, atol=2e-6, rtol=0)
    assert (fp32_sum - rounded_sum).abs().max() > 1e-4
    assert (lse["v5"] - lse["v2"]).abs().max() > 1e-4


# ------------------------------------------------ the kernel's schedule
def _stage(src, row0, n, rows, cols):
    """A (rows, cols) staging tile: columns [0, cols) of rows [row0, row0
    + n) of src, zeros past n."""
    tile = torch.zeros((rows, cols))
    tile[:n] = src[row0:row0 + n, :cols].float()
    return tile


def _row(variant, n_heads):
    return variant + (f"h{n_heads}" if variant == "v5" else "")


def _emulate_kernel(q, k, v, variant, n_heads, causal):
    """flash_fwd_variant_kernel's schedule in torch, block by block and
    head group by head group, on what the C entry receives (v5: v padded
    to d+64): returns (out before its bf16 rounding, lse), fp32."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    heads, bq, bk = fa.VARIANT_TILES[_row(variant, n_heads)]
    assert heads == n_heads
    sumfold, vpad = variant in ("v3", "v5"), variant == "v5"
    nomax = variant == "nomax"
    ex = torch.exp2 if vpad else torch.exp
    scale = fa._score_scale(variant, d)
    offset = sk - sq if causal else 0
    out = torch.zeros((bh, sq, d))
    lse = torch.zeros((bh, sq))
    ones = torch.zeros((bk, 8))           # v3's B fragment: column 0
    ones[:, 0] = 1.0
    qi = torch.arange(bq)[:, None]
    kj = torch.arange(bk)[None, :]
    for by in range(bh // n_heads):                    # blockIdx.y
        for bx in range(math.ceil(sq / bq)):           # blockIdx.x
            q0 = bx * bq
            nq = min(bq, sq - q0)
            k_end = min(sk, q0 + nq - 1 + offset + 1) if causal else sk
            for grp in range(n_heads):                 # a head's warps
                head = by * n_heads + grp
                q_t = _stage(q[head], q0, nq, bq, d)
                m = torch.full((bq,), -math.inf)
                l = torch.zeros(bq)
                acc = torch.zeros((bq, d))
                acc_l = torch.zeros((bq, 8))
                for k0 in range(0, k_end, bk):         # the ring's tiles
                    nk = min(bk, sk - k0)
                    k_t = _stage(k[head], k0, nk, bk, d)
                    v_t = _stage(v[head], k0, nk, bk, d)
                    o_t = (_stage(v[head], k0, nk, bk, d + 8)[:, d:] if vpad
                           else ones)
                    s = (q_t @ k_t.T) * scale
                    hidden = (k0 + kj >= sk) | (
                        causal & (k0 + kj > q0 + qi + offset))
                    s = s.masked_fill(hidden, -math.inf)
                    if nomax:
                        p, alpha = torch.exp(s), torch.ones(bq)
                    else:
                        m_new = torch.maximum(m, s.amax(-1))
                        alpha, m = ex(m - m_new), m_new
                        p = ex(s - m_new[:, None])
                    pb = p.bfloat16().float()
                    acc = acc * alpha[:, None] + pb @ v_t
                    if sumfold:
                        acc_l = acc_l * alpha[:, None] + pb @ o_t
                    else:
                        l = alpha * l + p.sum(-1)
                if sumfold:        # the quad's sum of the n8 fragment
                    l = acc_l.sum(-1)
                o = acc * torch.where(l > 0, 1.0 / l, 0.0)[:, None]
                out[head, q0:q0 + nq] = o[:nq]
                ls = l.clamp_min(1e-30)
                if nomax:
                    row_lse = torch.log(ls)
                elif vpad:
                    row_lse = (m + torch.log2(ls)) * (1.0 / fa._LOG2E)
                else:
                    row_lse = m + torch.log(ls)
                lse[head, q0:q0 + nq] = row_lse[:nq]
    return out, lse


def _padded(v):
    pad = torch.zeros((*v.shape[:2], 64), dtype=v.dtype)
    pad[..., 0] = 1.0
    return torch.cat([v, pad], dim=-1)


SCHEDULE_CASES = VARIANT_CASES + [("nomax", 1)]


@pytest.mark.parametrize("sq,sk,causal", [(192, 192, True),
                                          (192, 192, False),
                                          (128, 256, True),
                                          (130, 400, True),
                                          (300, 328, False)])
@pytest.mark.parametrize("variant,n_heads", SCHEDULE_CASES)
def test_block_schedule_matches_plain(variant, n_heads, sq, sk, causal):
    q, k, v = (_bf16(a) for a in _inputs(
        [(4, sq, 64), (4, sk, 64), (4, sk, 64)], seed=sq + sk))
    got, got_lse = _emulate_kernel(
        q, k, _padded(v) if variant == "v5" else v, variant, n_heads, causal)
    want, want_lse = fa._variant_forward(
        q, k, v, variant=variant, causal=causal, block_q=ROWS, block_k=ROWS)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_lse, want_lse, atol=1e-5, rtol=1e-5)


@pytest.fixture
def emulated_launches(monkeypatch):
    """The wrapper's kernel route, with the launch replaced by the block
    schedule's emulation (no card here)."""

    def launch(q, k, v, variant, n_heads, causal):
        out, lse = _emulate_kernel(q, k, v, variant, n_heads, causal)
        return out.to(q.dtype), lse

    monkeypatch.setattr(fa, "_use_kernel", lambda impl, x: True)
    monkeypatch.setattr(fa, "_launch_variant", launch)
    fa.reset_launches()
    yield
    fa.reset_launches()


@pytest.mark.parametrize("variant,n_heads", SCHEDULE_CASES)
def test_kernel_route_counts_and_matches_plain(emulated_launches, variant,
                                               n_heads):
    """Ragged tiles (s = 200) through the wrapper: v5's padding happens
    once there, the launch counts under its own row, and the result
    agrees with the plain version at the reference's blocks."""
    q, k, v = (_bf16(a) for a in _inputs([(4, 200, 64)] * 3, seed=11))
    out, lse = fa.flash_forward_variant(q, k, v, variant=variant,
                                        n_heads=n_heads)
    want, want_lse = fa.flash_forward_variant_plain(
        q, k, v, variant=variant, n_heads=n_heads)
    _assert_bf16_close(out.float(), want.float())
    # the tiles differ (64 against 200): so do m and the rounded p
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    row = f"flash_fwd_{_row(variant, n_heads)}"
    assert {n: c for n, c in fa.VARIANT_LAUNCHES.items() if c} == {row: 1}
    assert not any(fa.LAUNCHES.values())


def test_variant_tiles_match_the_source():
    """VARIANT_TILES is the .cu's FwdPlan<64, NH, KIND> over E's FwdTile<64>
    (four warps, two 16-row tiles a warp, 64-key tiles): a group of E's
    warps a head, one row tile a warp at four heads a block; each
    variant's heads a block is a case of the C entry's `with_variant`;
    E_KIND is E's kind in the kernel template's arguments."""
    from ddp_practice_tpu_torch.ops import cuda_build

    source = (cuda_build.CSRC / "flash_attention.cu").read_text()
    plan = source[source.index("template <int D, int NH, int KIND> struct "
                               "FwdPlan"):]
    plan = plan[:plan.index("};")]
    assert "RT = NH == 4 ? 1 : E::RT;" in plan
    assert "QUERIES = 16 * RT * E::WARPS;" in plan
    assert "THREADS = E::THREADS * NH;" in plan
    tile = source[source.index("template <int D> struct FwdTile"):]
    tile = tile[:tile.index("};")]
    assert "WARPS = 4;" in tile and "RT = D <= 64 ? 2 : 1;" in tile
    assert "KEYS = D == 256 ? 32 : 64;" in tile
    want = {}
    for variant, (code, allowed) in fa.VARIANTS.items():
        kind = ("kVarV2", "kVarV3", "kVarV4", "kVarV5", "kVarNoMax")[code]
        for nh in allowed:
            assert (f"case {kind} * 8 + {nh}:\n      return f(integral_"
                    f"constant<int, {nh}>()") in source, (variant, nh)
            want[_row(variant, nh)] = (nh, 16 * (1 if nh == 4 else 2) * 4,
                                       64)
    assert fa.VARIANT_TILES == want
    # E's own kind follows the variants' codes in the kernel's enum
    assert ("enum FwdKind { kVarV2 = 0, kVarV3, kVarV4, kVarV5, kVarNoMax, "
            "kFwdE };") in source and fa.E_KIND == 5
    assert fa.fwd_kernel_name(64, 4, 3) == "flash_fwd_tc_kernel<64, 4, 3>"


def test_variant_refusals():
    q = torch.zeros((3, 64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 operands only"):
        fa.flash_forward_variant(q.float(), q.float(), q.float(),
                                 variant="v2")
    with pytest.raises(ValueError, match="not a multiple"):
        fa.flash_forward_variant(q, q, q, variant="v4")
    with pytest.raises(ValueError, match="n_heads in"):
        fa.flash_forward_variant(q, q, q, variant="v5", n_heads=3)
    with pytest.raises(ValueError, match="unknown variant"):
        fa.flash_forward_variant(q, q, q, variant="v6")
    with pytest.raises(ValueError, match="seq_q <= seq_k"):
        fa.flash_forward_variant(q, q[:, :32], q[:, :32], variant="v2")
    with pytest.raises(ValueError, match="launches the CUDA kernels"):
        fa.flash_forward_variant(q, q, q, variant="v2", impl="kernel")
    with pytest.raises(ValueError, match="launches the CUDA kernels"):
        flash_4d.fwd4d(q[None], q[None], q[None], impl="kernel")


@pytest.mark.parametrize("name", ["shipped", "one block barrier",
                                  "v5h4 qs in registers"])
def test_variant_levers_apply_to_the_source(name):
    """experiments/flash_variant_levers.py undoes one choice of the
    variants' plan an entry, by text substitutions that must each find
    their text once; a stale entry would fail on the card only."""
    from ddp_practice_tpu_torch.experiments import flash_variant_levers as lv
    from ddp_practice_tpu_torch.ops import cuda_build

    assert list(lv.LEVERS) == ["shipped", "one block barrier",
                               "v5h4 qs in registers"]
    shipped = (cuda_build.CSRC / "flash_attention.cu").read_text()
    assert (lv.lever_source(name) == shipped) == (name == "shipped")


# --------------------------------------------------------------- fwd4d
def test_fwd4d_matches_reference_and_fold():
    q, k, v = _inputs([(2, 256, 2, 64)] * 3, seed=3)
    with pltpu.force_tpu_interpret_mode():
        want = ref_4d.fwd4d(*[jnp.asarray(x, jnp.bfloat16) for x in
                              (q, k, v)], causal=True, **BLOCKS)
    got = flash_4d.fwd4d(_bf16(q), _bf16(k), _bf16(v), causal=True,
                         **BLOCKS)
    assert got.shape == (2, 256, 2, 64)
    _assert_bf16_close(got.float(), np.asarray(want.astype(jnp.float32)))
    # the model boundary: (b, s, h*d) in and out, both paths on E's plain
    # version (default blocks), one function
    qf, kf, vf = (_bf16(x).reshape(2, 256, 128) for x in (q, k, v))
    torch.testing.assert_close(flash_4d.path_4d(qf, kf, vf, heads=2),
                               flash_4d.path_fold(qf, kf, vf, heads=2),
                               atol=0, rtol=0)


def test_fwd4d_launches_e_on_the_callers_strides(monkeypatch):
    """The kernel route of fwd4d, with E's launch replaced by its plain
    version: one launch of E's packed row on (b, h, s, d) views of the
    caller's (b, s, h, d) tensors, and no variant launch."""
    q, k, v = (_bf16(a) for a in _inputs([(2, 128, 2, 64)] * 3, seed=5))
    seen = []

    def launch(q4, k4, v4, out4, causal):
        seen.append((q4.data_ptr(), q4.stride()))
        o, lse = fa.flash_attention_plain(q4, k4, v4, causal=causal)
        out4.copy_(o)
        return lse

    monkeypatch.setattr(fa, "_use_kernel", lambda impl, x: True)
    monkeypatch.setattr(fa, "_launch_fwd", launch)
    fa.reset_launches()
    try:
        out = flash_4d.fwd4d(q, k, v, impl="kernel")
        launches = dict(fa.LAUNCHES), dict(fa.VARIANT_LAUNCHES)
    finally:
        fa.reset_launches()
    assert launches[0] == {"flash_fwd_folded": 0, "flash_bwd_folded": 0,
                           "flash_fwd_packed": 1, "flash_bwd_packed": 0}
    assert not any(launches[1].values())
    assert seen == [(q.data_ptr(), (q.stride(0), 64, q.stride(1), 1))]
    torch.testing.assert_close(out, flash_4d.fwd4d(q, k, v, impl="plain"),
                               atol=0, rtol=0)


@pytest.mark.parametrize("shape", [(256, 256, 64, 64, True),
                                   (128, 256, 64, 128, True),
                                   (512, 512, 128, 64, False),
                                   (2048, 2048, 512, 1024, True),
                                   (2048, 2048, 64, 64, True)])
def test_visible_fraction_matches_reference(shape):
    assert (flash_variants.visible_fraction(*shape)
            == ref_variants.visible_fraction(*shape))
