"""The bf16 forward kernel E of ddp_practice_tpu_torch/csrc/flash_attention.cu,
by its block schedule, on the CPU.

A torch emulation of E, block by block at its tile sizes (`FWD_TILES`, the
.cu's `FwdTile`), stands in for its launch (`_launch_fwd`), so the
wrapper's kernel route runs here: the (b, h, s, d) strides of every
layout, the lse it returns and the `LAUNCHES` rows. What the emulation
keeps of the kernel:
- a block per query tile (128 queries at d <= 64, 64 above), its qs =
  round(q * scale) rows zero-filled past s_q, walking the key tiles (64
  keys; 32 at d=256) from 0 up to the last one a row of the block sees
  (causal, bottom-right offset s_k - s_q), each staged zero-filled past
  s_k;
- the split between tiles wholly inside the visible triangle and both
  lengths, which skip the mask (the emulation checks that such a tile
  really masks nothing), and the others, where hidden and out-of-range
  keys get p = 0;
- the online softmax in base 2: p = 2^(s log2(e) - m log2(e)), the
  rescale 2^((m - m') log2(e)), l summing the unrounded p, p rounded to
  v's dtype before p.v, out = acc / l rounded once, lse = m + log(l).
Held in fp32 at 1e-5 against the plain version (`flash_attention_plain`)
and against the reference's Pallas kernels `_flash_fwd` /
`_flash_fwd_packed` in interpret mode: folded, (b, s, h, d) heads, packed
and fused-QKV windows, d in {32, 64}, s in {96, 160} (ragged tails at
64-row tiles), causal and not, and s_q = 70 < s_k = 200 at every head_dim.
On the card the kernel itself is held to the plain version
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_practice_tpu.ops import flash_attention as jfa
from ddp_practice_tpu_torch.ops import flash_attention as fa

# one intra-op thread, as tests/_torch_port.py sets for the port's other
# files: the suite runs several workers on one machine
torch.set_num_threads(1)

TOL = 1e-5
LOG2E = 1.4426950408889634
# the .cu's FwdTile<D>: (query rows a block, key rows a streamed tile):
# four warps of two 16-row tiles at d <= 64, of one above
FWD_TILES = {32: (128, 64), 64: (128, 64), 128: (64, 64), 256: (64, 32)}


def _stage(x, row0, rows):
    """A (b, h, rows, ...) tile of x's rows [row0, row0 + rows), zeros
    past the end (the kernel's zero-filled copies)."""
    tile = x.new_zeros((*x.shape[:2], rows, *x.shape[3:]))
    part = x[:, :, row0:row0 + rows]
    tile[:, :, :part.shape[2]] = part
    return tile


def emulate_e(q4, k4, v4, out4, causal, tiles_seen=None):
    """Kernel E block by block: out into out4, returns lse (b, h, s_q).
    `tiles_seen` collects (full, masked) tile counts."""
    b, h, sq, d = q4.shape
    sk = k4.shape[2]
    bq, bk = FWD_TILES[d]
    rnd = lambda x: x.to(q4.dtype).float()   # noqa: E731
    q_scale, _ = fa._scales(d, q4.dtype)
    offset = sk - sq if causal else 0
    qs = rnd(q4.float() * q_scale)
    lse = torch.empty((b, h, sq))
    for q0 in range(0, sq, bq):                        # one block each
        nq = min(bq, sq - q0)
        rows = torch.arange(q0, q0 + bq)[:, None]
        q_t = _stage(qs, q0, bq)
        k_end = min(sk, q0 + nq - 1 + offset + 1) if causal else sk
        m = torch.full((b, h, bq), float("-inf"))
        l = torch.zeros((b, h, bq))
        acc = torch.zeros((b, h, bq, d))
        for k0 in range(0, k_end, bk):                 # the ring's tiles
            k_t, v_t = _stage(k4.float(), k0, bk), _stage(v4.float(), k0, bk)
            s = q_t @ k_t.transpose(-1, -2)
            cols = torch.arange(k0, k0 + bk)[None, :]
            visible = cols < sk
            if causal:
                visible = visible & (cols <= rows + offset)
            full = (q0 + bq <= sq and k0 + bk <= sk
                    and (not causal or k0 + bk - 1 <= q0 + offset))
            if full:
                assert visible.all(), "an unmasked tile hides a key"
            else:
                s = s.masked_fill(~visible, float("-inf"))
            if tiles_seen is not None:
                tiles_seen[full] = tiles_seen.get(full, 0) + 1
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - m_new) * LOG2E)
            p = torch.exp2(s * LOG2E - (m_new * LOG2E)[..., None])
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + rnd(p) @ v_t.float()
            m = m_new
        out = acc * torch.where(l > 0, 1.0 / l, 0.0)[..., None]
        out4[:, :, q0:q0 + nq] = out[:, :, :nq].to(out4.dtype)
        lse[:, :, q0:q0 + nq] = (m + torch.log(l.clamp_min(1e-30)))[:, :, :nq]
    return lse


@pytest.fixture
def emulated_forward(monkeypatch):
    """The wrapper's kernel route with E emulated; returns the tile
    counts {True: unmasked tiles, False: masked tiles}."""
    seen = {}

    def fwd(q4, k4, v4, out4, causal):
        return emulate_e(q4, k4, v4, out4, causal, seen)

    monkeypatch.setattr(fa, "_use_kernel", lambda impl, x: impl != "plain")
    monkeypatch.setattr(fa, "_launch_fwd", fwd)
    fa.reset_launches()
    yield seen
    fa.reset_launches()


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _case(layout, b, s, d):
    """(operand shapes, heads, the route's launch row) of a layout."""
    if layout == "folded":
        return [(b * 2, s, d)] * 3, 1, "folded"
    if layout == "heads":                 # 3 heads never pack
        return [(b, s, 3, d)] * 3, 3, "folded"
    if layout == "packed":
        return [(b, s, 2 * d)] * 3, 2, "packed" if d >= 64 else "folded"
    return [(b, s, 6 * d)], 2, "packed" if d >= 64 else "folded"


def _port(layout, n_heads, arrays, causal, impl):
    """(out, lse) through the port's autograd route for `layout`; lse as
    (b, h, s_q)."""
    ts = [torch.from_numpy(a) for a in arrays]
    route = layout
    if layout in ("packed", "qkv") and fa._heads_per_pack(
            n_heads, ts[0].shape[-1] // n_heads // (3 if layout == "qkv"
                                                     else 1)) is None:
        # unpackable heads: the public entries' folded route
        if layout == "qkv":
            hd = ts[0].shape[-1] // 3
            ts = [ts[0][..., i * hd:(i + 1) * hd] for i in range(3)]
        ts = [t.unflatten(-1, (n_heads, -1)).contiguous() for t in ts]
        route = "heads"
    with torch.no_grad():
        out, lse = fa._FlashAttention.apply(route, n_heads, causal, 512,
                                            1024, impl, *ts)
    if route == "folded":
        lse = lse[:, None]
    out = out.reshape(*out.shape[:2], -1) if route != "folded" else out
    return out, lse


def _jax(layout, n_heads, arrays, causal):
    """The reference kernels in interpret mode, 32 x 32 blocks: (out as
    the port's route returns it, lse (b, h, s_q))."""
    blocks = dict(block_q=32, block_k=32, interpret=True)
    if layout == "folded":
        q, k, v = (jnp.asarray(a) for a in arrays)
        out, lse = jfa._flash_fwd(q, k, v, causal=causal, **blocks)
        return np.asarray(out), np.asarray(lse)[:, None]
    if layout in ("packed", "qkv"):
        flat = arrays * 3 if layout == "qkv" else arrays
        hd = flat[0].shape[-1] // (3 if layout == "qkv" else 1)
        d = hd // n_heads
        if jfa._heads_per_pack(n_heads, d) is not None:
            out, lse = jfa._flash_fwd_packed(
                *(jnp.asarray(a) for a in flat), n_heads=n_heads,
                causal=causal, fused_qkv=layout == "qkv", **blocks)
            b, n_packs, sq, hpc = lse.shape
            lse = np.asarray(lse).transpose(0, 1, 3, 2).reshape(
                b, n_packs * hpc, sq)
            return np.asarray(out), lse
        if layout == "qkv":
            arrays = [arrays[0][..., i * hd:(i + 1) * hd] for i in range(3)]
        arrays = [a.reshape(*a.shape[:2], n_heads, -1) for a in arrays]
    # (b, s, h, d) heads: folded as the reference's flash_attention does
    b, s, h, d = arrays[0].shape
    folded = [jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, -1, d))
              for a in arrays]
    out, lse = jfa._flash_fwd(*folded, causal=causal, **blocks)
    out = np.asarray(out).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    return out.reshape(b, s, h * d), np.asarray(lse).reshape(b, h, s)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [96, 160])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("layout", ["folded", "heads", "packed", "qkv"])
def test_schedule_matches_plain_and_reference(emulated_forward, layout, d,
                                              s, causal):
    shapes, n_heads, row = _case(layout, 2, s, d)
    arrays = _inputs(shapes, seed=d + s + causal)
    if layout == "heads":
        arrays = [a.reshape(2, s, 3 * d) for a in arrays]
        layout_port, arrays_port = "heads", [a.reshape(2, s, 3, d)
                                             for a in arrays]
    else:
        layout_port, arrays_port = layout, arrays
    got, got_lse = _port_or_heads(layout_port, n_heads, arrays_port, causal,
                                  "kernel")
    want, want_lse = _port_or_heads(layout_port, n_heads, arrays_port,
                                    causal, "plain")
    _close(got, want)
    _close(got_lse, want_lse)
    ref, ref_lse = _jax("packed" if layout == "heads" else layout, n_heads,
                        arrays, causal)
    _close(got.reshape(ref.shape), ref)
    _close(got_lse, ref_lse)
    other = "folded" if row == "packed" else "packed"
    assert fa.LAUNCHES[f"flash_fwd_{row}"] == 1
    assert fa.LAUNCHES[f"flash_fwd_{other}"] == 0
    # ragged tails and, causal, the diagonal tiles take the mask; tiles
    # inside both lengths and the visible triangle run without it (at
    # these lengths only the non-causal s=160 has one: the first 128-query
    # block below s_q, its first two key tiles)
    bq, bk = FWD_TILES[d]
    assert emulated_forward.get(False, 0) > 0
    assert emulated_forward.get(True, 0) == (
        (s // bq) * (s // bk) if not causal else 0)


def _port_or_heads(layout, n_heads, arrays, causal, impl):
    if layout == "heads":
        ts = [torch.from_numpy(a) for a in arrays]
        with torch.no_grad():
            out, lse = fa._FlashAttention.apply("heads", n_heads, causal, 512,
                                                1024, impl, *ts)
        return out.reshape(*out.shape[:2], -1), lse
    return _port(layout, n_heads, arrays, causal, impl)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_shorter_queries(emulated_forward, d):
    """Causal s_q = 70 < s_k = 200 (bottom-right offset 130): the last
    key tile a block walks ends at its last row's offset; at d=256 the key
    tiles are 32 rows."""
    bh, sq, sk = 2, 70, 200
    arrays = _inputs([(bh, sq, d), (bh, sk, d), (bh, sk, d)], seed=d)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = fa.flash_attention_with_lse(q, k, v, causal=True, impl="kernel")
    want = fa.flash_attention_with_lse(q, k, v, causal=True, impl="plain")
    for a, b in zip(got, want):
        _close(a.detach(), b.detach())
    ref, ref_lse = jfa._flash_fwd(*(jnp.asarray(a) for a in arrays),
                                  causal=True, block_q=sq, block_k=sk,
                                  interpret=True)
    _close(got[0].detach(), np.asarray(ref))
    _close(got[1].detach(), np.asarray(ref_lse))
    assert fa.LAUNCHES["flash_fwd_folded"] == 1


def test_e_tiles_match_the_source():
    """FWD_TILES is the .cu's FwdTile: blocks of four warps, two 16-row
    tiles a warp at d <= 64 (one above), key tiles of 64 rows (32 at
    d=256), a two-stage ring."""
    from ddp_practice_tpu_torch.ops import cuda_build

    source = (cuda_build.CSRC / "flash_attention.cu").read_text()
    tile = source[source.index("template <int D> struct FwdTile"):]
    tile = tile[:tile.index("};")]
    assert "WARPS = 4;" in tile and "QUERIES = 16 * RT * WARPS" in tile
    assert "RT = D <= 64 ? 2 : 1" in tile
    assert "KEYS = D == 256 ? 32 : 64" in tile and "STAGES = 2" in tile
    assert FWD_TILES == {d: (128 if d <= 64 else 64, 32 if d == 256 else 64)
                         for d in (32, 64, 128, 256)}


@pytest.mark.parametrize("name", ["shipped", "expf", "mask every tile",
                                  "1 row tile/warp", "2 blocks/SM",
                                  "3 blocks/SM", "8 warps"])
def test_ablation_variants_apply_to_the_source(name):
    """experiments/flash_fwd_ablate.py undoes one design choice of the
    shipped E a variant, by text substitutions that must each find their
    text once; a stale variant would fail on the card only."""
    from ddp_practice_tpu_torch.experiments import flash_fwd_ablate as ab
    from ddp_practice_tpu_torch.ops import cuda_build

    assert list(ab.VARIANTS) == ["shipped", "expf", "mask every tile",
                                 "1 row tile/warp", "2 blocks/SM",
                                 "3 blocks/SM", "8 warps"]
    shipped = (cuda_build.CSRC / "flash_attention.cu").read_text()
    assert (ab.variant_source(name) == shipped) == (name == "shipped")
