"""The port's grouped matmul (ddp_practice_tpu_torch/ops/grouped_matmul.py)
on the CPU:

- the plain versions of kernels J (gmm, both rhs layouts) and K (tgmm)
  against the reference's `_grouped_matmul` (megablox gmm/tgmm in
  interpret mode, as tests/test_moe.py runs it): the forward, and
  jax.grad's input and weight grads against the port's autograd, with an
  empty group and boundaries off every tile grid. fp32 at the reference's
  2e-5 (forward) and 5e-4 (grads); bf16, where both round once from an
  fp32 sum and differ only in summation order, within one bf16 ulp
  (2^-7 relative) plus 1e-2;
- the kernels' tile schedule, emulated in PyTorch as the blocks run it:
  the visit table (every row written by exactly one block, tiles split at
  group boundaries, the zero tail, early exits past m_tiles + E visits)
  and tgmm's work units (each group's rows cut into chunks, every row in
  exactly one unit, the units' slices zeroed past their end in both
  operands, partials summed in unit order by the second pass, fp32
  output), held against the plain versions;
- the wrapper: "auto" on a CPU tensor is the plain version and counts no
  launch; "kernel" on a CPU tensor raises; `forced_impl`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from ddp_practice_tpu.ops.moe import _grouped_matmul
from ddp_practice_tpu_torch.ops import grouped_matmul as gm

BF16 = dict(rtol=2.0 ** -7, atol=1e-2)
F32_OUT = dict(rtol=2e-5, atol=2e-5)
F32_GRAD = dict(rtol=5e-4, atol=5e-4)


def _operands(seed, m, k, n, e):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(e, k, n)).astype(np.float32),
            rng.normal(size=(m, n)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", [(20, 0, 30, 14), (0, 64, 0, 0)])
def test_plain_matches_megablox_forward_and_grads(dtype, sizes):
    m, k, n = 64, 32, 48
    lhs, rhs, w = _operands(sum(sizes) + len(dtype), m, k, n, len(sizes))
    jdt = jnp.dtype(dtype)
    gs = jnp.asarray(sizes, jnp.int32)

    def jloss(a, b):
        out = _grouped_matmul(a, b, gs, True)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, jout), (jda, jdb) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(lhs, jdt), jnp.asarray(rhs, jdt))
    tdt = getattr(torch, dtype)
    a = torch.from_numpy(lhs).to(tdt).requires_grad_()
    b = torch.from_numpy(rhs).to(tdt).requires_grad_()
    out = gm.grouped_matmul(a, b, torch.tensor(sizes, dtype=torch.int32))
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert out.dtype == a.grad.dtype == b.grad.dtype == tdt
    for name, got, want, tol in (
            ("out", out, jout, F32_OUT), ("dlhs", a.grad, jda, F32_GRAD),
            ("drhs", b.grad, jdb, F32_GRAD)):
        np.testing.assert_allclose(
            got.detach().float().numpy(), np.asarray(want, np.float32),
            err_msg=name, **(tol if dtype == "float32" else BF16))
    for e, size in enumerate(sizes):
        if size == 0:     # an empty group's weight grad is exactly zero
            assert not b.grad[e].any() and not np.asarray(jdb[e]).any()


# group-size patterns over m = 300 rows, E = 8: balanced, skewed, empty
# experts with boundaries off every tile grid, one expert taking all, a
# zero tail (sum < m), all empty
PATTERNS = {
    "balanced": [37, 38, 37, 38, 37, 38, 37, 38],
    "skewed": [250, 10, 10, 10, 5, 5, 5, 5],
    "empty_off_grid": [0, 17, 0, 99, 1, 0, 150, 33],
    "one_expert": [0, 0, 0, 300, 0, 0, 0, 0],
    "tail": [40, 0, 60, 0, 0, 70, 0, 0],
    "all_empty": [0] * 8,
}


@pytest.mark.parametrize("block_m", [16, 128])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_schedule_covers_every_row_once(pattern, block_m):
    sizes, m = PATTERNS[pattern], 300
    table = gm.gmm_schedule(sizes, m, block_m)
    grid = gm.gmm_grid_rows(m, len(sizes), block_m)
    assert len(table) <= grid
    written = np.zeros(m, np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    for group, tile, lo, hi in table:
        assert tile * block_m <= lo < hi <= tile * block_m + block_m
        if group < len(sizes):
            assert offsets[group] <= lo and hi <= offsets[group + 1]
        else:                      # the tail: rows past every group
            assert lo >= offsets[-1]
        written[lo:hi] += 1
    assert (written == 1).all()
    # one visit per tile a group touches: tiles split at boundaries only
    tiles = sum(len({t for g, t, _, _ in table if g == e})
                for e in range(len(sizes) + 1))
    assert tiles == len(table)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pattern", ["skewed", "empty_off_grid", "tail"])
def test_emulated_kernels_match_plain(pattern, dtype):
    sizes = torch.tensor(PATTERNS[pattern], dtype=torch.int32)
    lhs, rhs, grad = (torch.from_numpy(x).to(dtype)
                      for x in _operands(7, 300, 40, 24, 8))
    tol = F32_OUT if dtype == torch.float32 else BF16
    for tiles in ((16, 16, 8), None):
        got, table, exits = gm.gmm_emulated(lhs, rhs, sizes, tiles=tiles)
        bm = (tiles or gm.TILES[dtype])[0]
        assert exits == gm.gmm_grid_rows(300, 8, bm) - len(table)
        torch.testing.assert_close(got.float(),
                                   gm.gmm_plain(lhs, rhs, sizes).float(),
                                   **tol)
        # (m, n) x (E, k, n)^T -> (m, k): the input grad's product
        got, _, _ = gm.gmm_emulated(grad, rhs, sizes, transpose_rhs=True,
                                    tiles=tiles)
        want = gm.gmm_plain(grad, rhs, sizes, transpose_rhs=True)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        got = gm.tgmm_emulated(lhs, grad, sizes, tiles=tiles)
        want = gm.tgmm_plain(lhs, grad, sizes)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        for e, size in enumerate(PATTERNS[pattern]):
            if size == 0:
                assert not got[e].any()
    if pattern == "tail":
        out = gm.gmm_plain(lhs, rhs, sizes)
        assert not out[170:].any()


def test_wrapper_routes_by_device_and_counts_no_cpu_launch():
    sizes = torch.tensor([3, 0, 5], dtype=torch.int32)
    lhs, rhs, grad = (torch.from_numpy(x) for x in _operands(1, 8, 8, 8, 3))
    gm.reset_launches()
    out = gm.gmm(lhs, rhs, sizes)
    torch.testing.assert_close(out, gm.gmm_plain(lhs, rhs, sizes))
    assert gm.tgmm(lhs, grad, sizes).shape == (3, 8, 8)
    assert gm.LAUNCHES == {"gmm": 0, "gmm_trhs": 0, "tgmm": 0,
                           "tgmm_reduce": 0}
    with pytest.raises(ValueError, match="launches the CUDA kernels"):
        gm.gmm(lhs, rhs, sizes, impl="kernel")
    with pytest.raises(ValueError, match="launches the CUDA kernels"):
        with gm.forced_impl("kernel"):
            gm.tgmm(lhs, grad, sizes)
    with pytest.raises(ValueError, match="unknown impl"):
        gm.gmm(lhs, rhs, sizes, impl="fast")


def test_tiles_match_the_source():
    """TILES[bf16] is the Hopper J's WgTile<256> (128 rows, 256 columns,
    64 deep; 128 columns through block_n), TGMM_TILES[bf16] the Hopper K's
    TgTile<256> (192 wide through block_n), RINGLESS_BF16_TILES
    the ring-less kernel's Cfg<bf16>."""
    from ddp_practice_tpu_torch.ops import cuda_build

    source = (cuda_build.CSRC / "grouped_matmul.cu").read_text()
    tile = source[source.index("template <int BN_> struct WgTile"):]
    tile = tile[:tile.index("};")]
    assert "BM = 128, BN = BN_, BK = 64" in tile
    assert gm.TILES[torch.bfloat16] == (128, gm.GMM_BLOCK_N[0], 64)
    assert gm.GMM_BLOCK_N == (256, 128)
    assert "BM = 128, BN = 128, BK = 32" in source   # Cfg<bf16>
    assert gm.RINGLESS_BF16_TILES == (128, 128, 32)
    tile = source[source.index("template <int BN_> struct TgTile"):]
    tile = tile[:tile.index("};")]
    assert "BM = 128, BN = BN_, BK = 64" in tile
    assert gm.TGMM_TILES[torch.bfloat16] == (128, gm.TGMM_BLOCK_N[0], 64)
    assert gm.TGMM_BLOCK_N == (256, 192)
    for bn in gm.TGMM_BLOCK_N:
        assert f"launch_tgmm_wg<{bn}, F32OUT>" in source
    assert "launch_tgmm_wg<128" not in source
    assert "BM = 64, BN = 64, BK = 16" in source     # Cfg<float>
    assert gm.TGMM_TILES[torch.float32] == (64, 64, 16)


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
@pytest.mark.parametrize("block_n", [256, 128])
@pytest.mark.parametrize("pattern", ["skewed", "empty_off_grid", "tail",
                                     "one_expert"])
def test_hopper_schedule_writes_every_row_once(pattern, block_n, out_dtype):
    """The bf16 J's blocks at its own tiles, with m, k and n off the
    128 x BN x 64 grid (m = 300: three row tiles, every group boundary
    inside one; k = 72: a depth slice zero past k; n = 264: a partial
    column tile): no element is written by two blocks (gmm_emulated
    raises), none is left unwritten, and the result is the plain
    version's, in both rhs layouts and with fp32 output."""
    sizes = torch.tensor(PATTERNS[pattern], dtype=torch.int32)
    lhs, rhs, grad = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in _operands(9, 300, 72, 264, 8))
    tiles = (128, block_n, 64)
    for a, transpose in ((lhs, False), (grad, True)):
        got, table, exits = gm.gmm_emulated(a, rhs, sizes, tiles=tiles,
                                            transpose_rhs=transpose,
                                            out_dtype=out_dtype)
        assert not got.float().isnan().any()
        assert exits == gm.gmm_grid_rows(300, 8, 128) - len(table)
        want = gm.gmm_plain(a, rhs, sizes, transpose_rhs=transpose,
                            out_dtype=out_dtype)
        assert got.dtype == want.dtype == (out_dtype or torch.bfloat16)
        torch.testing.assert_close(
            got.float(), want.float(),
            **(F32_OUT if out_dtype == torch.float32 else BF16))
        if pattern == "tail":
            assert not got[170:].float().any()


def test_emulation_refuses_a_double_write(monkeypatch):
    """gmm_emulated's exactly-once check bites: a visit table that lists
    one visit twice makes two blocks write the same rows."""
    sizes = torch.tensor(PATTERNS["skewed"], dtype=torch.int32)
    lhs, rhs, _ = (torch.from_numpy(x) for x in _operands(5, 300, 8, 8, 8))
    real = gm.gmm_schedule

    def doubled(group_sizes, m, block_m):
        table = real(group_sizes, m, block_m)
        return table[:1] + table
    monkeypatch.setattr(gm, "gmm_schedule", doubled)
    with pytest.raises(AssertionError, match="two blocks"):
        gm.gmm_emulated(lhs, rhs, sizes, tiles=(128, 256, 64))


@pytest.mark.parametrize("sizes", [(20, 0, 30, 14), (0, 64, 0, 0)])
def test_plain_fp32_output_matches_megablox(sizes):
    """bf16 operands with an fp32 result: gmm_plain(out_dtype=float32)
    against megablox gmm with preferred_element_type=float32 (interpret
    mode), as experiments/gmm_tune.py's fp32 leg asks of kernel J."""
    from jax.experimental.pallas.ops.tpu.megablox.gmm import gmm as raw_gmm

    lhs, rhs, _ = _operands(len(sizes) + 3, 64, 32, 48, len(sizes))
    gs = np.asarray(sizes, np.int32)
    for transpose in (False, True):
        # transposed: rhs stored (E, n, k), out = lhs . rhs[e]^T
        w = rhs.transpose(0, 2, 1).copy() if transpose else rhs
        want = raw_gmm(jnp.asarray(lhs, jnp.bfloat16),
                       jnp.asarray(w, jnp.bfloat16), jnp.asarray(gs),
                       jnp.float32, (16, 32, 16), None, None, transpose,
                       True)
        got = gm.gmm_plain(torch.from_numpy(lhs).to(torch.bfloat16),
                           torch.from_numpy(w).to(torch.bfloat16),
                           torch.from_numpy(gs), transpose_rhs=transpose,
                           out_dtype=torch.float32)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **F32_OUT)


def test_ptxas_names_the_hopper_instantiations():
    """chip_smoke prints J's ptxas lines by kernel name with its integer
    and bool template arguments (`gmm_kernel<BN, TRANS, F32OUT>`), so the
    eight Hopper instantiations keep apart."""
    from ddp_practice_tpu_torch.ops import cuda_build

    mangled = ("_ZN12_GLOBAL__N_110gmm_kernelILi256ELb1ELb0EEEv14CUtensorMap"
               "_stS1_PKiPviiii")
    info = "\n".join([
        f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 16 barriers"])
    assert list(cuda_build.kernel_resources(info)) == [
        "gmm_kernel<256, 1, 0>"]


@pytest.mark.parametrize("chunk", [64, 100, 4096])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_tgmm_units_cover_every_row_once(pattern, chunk):
    """K's work units: every row of every group in exactly one unit, units
    no longer than `chunk`, one empty unit per empty group, a group's units
    consecutive and counted in each of them, within the grid's bound; the
    Hopper kernel's workspace slabs go to the units of groups of several
    units, one each, in unit order, within `tgmm_ws_slabs`."""
    sizes, m = PATTERNS[pattern], 300
    units = gm.tgmm_units(sizes, m, chunk)
    assert len(units) <= gm.tgmm_unit_rows(m, len(sizes), chunk)
    slabs = gm.tgmm_slabs_of(units, direct=True)
    split = [v for v, u in enumerate(units) if u[3] > 1]
    assert [slabs[v] for v in split] == list(range(len(split)))
    assert all(slabs[v] is None for v, u in enumerate(units) if u[3] == 1)
    assert len(split) <= gm.tgmm_ws_slabs(m, len(sizes), chunk, True)
    assert gm.tgmm_slabs_of(units, direct=False) == list(range(len(units)))
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    covered = np.zeros(m, np.int64)
    for e in range(len(sizes)):
        mine = [u for u in units if u[0] == e]
        assert mine and all(u[3] == len(mine) for u in mine)
        for _, lo, hi, _ in mine:
            assert offsets[e] <= lo <= hi <= offsets[e + 1]
            assert hi - lo <= chunk
            covered[lo:hi] += 1
        if sizes[e] == 0:
            assert [(lo, hi) for _, lo, hi, _ in mine] == [(mine[0][1],) * 2]
    assert [u[0] for u in units] == sorted(u[0] for u in units)
    assert (covered[:offsets[-1]] == 1).all()
    assert not covered[offsets[-1]:].any()


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("chunk", [64, 96, 512])
@pytest.mark.parametrize("pattern", ["balanced", "skewed", "empty_off_grid",
                                     "tail", "one_expert", "all_empty"])
def test_tgmm_split_schedule_matches_plain(pattern, chunk, dtype,
                                          out_dtype):
    """K's split at unit sizes that cut groups into several units, off the
    64-row slices too (96), and at units longer than m (512: every group
    one unit, no workspace slab and no second pass for bf16), at kd = 72
    and n = 264 (partial tiles): the Hopper schedule (bf16: groups of one
    unit written directly, the others summed by the second pass) and the
    ring-less one (fp32: every unit through the second pass) give the
    plain version's product, an empty group exactly zero, every element
    written."""
    sizes = torch.tensor(PATTERNS[pattern], dtype=torch.int32)
    lhs, _, grad = (torch.from_numpy(x).to(dtype)
                    for x in _operands(13, 300, 72, 264, 1))
    got = gm.tgmm_emulated(lhs, grad, sizes, out_dtype=out_dtype,
                           chunk=chunk)
    want = gm.tgmm_plain(lhs, grad, sizes, out_dtype=out_dtype)
    assert got.dtype == want.dtype
    assert not got.float().isnan().any()
    tol = BF16 if got.dtype == torch.bfloat16 else F32_GRAD
    torch.testing.assert_close(got.float(), want.float(), **tol)
    for e, size in enumerate(PATTERNS[pattern]):
        if size == 0:
            assert not got[e].any()


def test_tgmm_zeroes_rows_past_a_unit_in_both_operands():
    """A unit's last slice runs into its neighbours' rows; an Inf there, in
    either operand, must not reach another group's product (0 * Inf is
    NaN, so zeroing one operand alone would not do). The rows past m read
    as zeros."""
    sizes = torch.tensor([37, 63, 100, 70], dtype=torch.int32)
    lhs, _, grad = (torch.from_numpy(x).to(torch.bfloat16)
                    for x in _operands(17, 270, 64, 64, 1))
    lhs[37:100, 5] = float("inf")          # group 1's rows
    grad[100:200, 7] = float("-inf")       # group 2's rows
    got = gm.tgmm_emulated(lhs, grad, sizes, out_dtype=torch.float32,
                           chunk=64)
    want = gm.tgmm_plain(lhs, grad, sizes, out_dtype=torch.float32)
    for e in (0, 3):
        assert torch.isfinite(got[e]).all(), e
        torch.testing.assert_close(got[e], want[e], **F32_GRAD)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tgmm_one_group_many_units(dtype):
    """One group over every row (the fused layer's weight grads): rows cut
    into units of 32, the partials summed in unit order, fp32 output."""
    sizes = torch.tensor([300], dtype=torch.int32)
    lhs, _, grad = (torch.from_numpy(x).to(dtype)
                    for x in _operands(19, 300, 96, 40, 1))
    assert len(gm.tgmm_units(sizes.tolist(), 300, 32)) == 10
    got = gm.tgmm_emulated(lhs, grad, sizes, out_dtype=torch.float32,
                           chunk=32)
    want = gm.tgmm_plain(lhs, grad, sizes, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, **F32_GRAD)


def test_tgmm_chunk_and_width_rules():
    """16384 rows a unit at the lm_moe shapes (every group of the balanced
    and the skewed pattern one unit), 4096 for an fp32 output; halved
    while the units would fill less than half the SMs, down to 512, for
    one group with few tiles (the ViT-Tiny weight grads); the width that
    wastes the fewest columns, the widest on a tie."""
    assert gm.tgmm_chunk(32768, 6 * 12, 132) == 16384
    # an fp32 output keeps each fp32 accumulation chain to 4096 rows
    assert gm.tgmm_chunk(32768, 6 * 12, 132, out_f32=True) == 4096
    f32 = dict(out_f32=True)        # the fused layer's weight grads
    assert gm.tgmm_chunk(65536, 5, 132, **f32) == 4096   # dWqkv (576, 192)
    assert gm.tgmm_chunk(65536, 6, 132, **f32) == 4096   # dW_in, dW_out
    assert gm.tgmm_chunk(65536, 2, 132, **f32) == 1024   # dWproj (192, 192)
    assert gm.tgmm_chunk(65536, 5, 132) == 4096
    assert gm.tgmm_chunk(100, 1, 132) == gm.TGMM_MIN_CHUNK
    assert [gm.tgmm_block_n(n) for n in (192, 768, 3072, 576, 264)] == [
        192, 256, 256, 192, 192]
    assert gm.tgmm_unit_rows(32768, 8, 16384) == 10
    # the Hopper kernel's workspace: the units that can split only (3
    # slabs at the lm_moe shapes, none when every group fits one unit)
    assert gm.tgmm_ws_slabs(32768, 8, 16384, direct=True) == 3
    assert gm.tgmm_ws_slabs(32768, 8, 16384, direct=False) == 10
    assert gm.tgmm_ws_slabs(8192, 8, 16384, direct=True) == 0
    assert gm.tgmm_ws_slabs(16384, 8, 16384, direct=True) == 0
    assert gm.tgmm_ws_slabs(65536, 1, 4096, direct=True) == 17


@pytest.mark.parametrize("seed", range(6))
def test_tgmm_workspace_holds_every_split_unit(seed):
    """`tgmm_ws_slabs` bounds the units of groups of several units for any
    group sizes: random sizes (some empty, some past m, some just over a
    unit), m and unit sizes around them; the bound is met exactly when
    every group holds one unit more than a whole number of chunks."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        chunk = int(rng.integers(1, 40))
        e = int(rng.integers(1, 9))
        sizes = [int(x) for x in rng.integers(0, 4 * chunk, e)]
        sizes[int(rng.integers(e))] = chunk + 1
        m = int(rng.integers(0, sum(sizes) + chunk))
        units = gm.tgmm_units(sizes, m, chunk)
        split = sum(1 for u in units if u[3] > 1)
        assert split <= gm.tgmm_ws_slabs(m, e, chunk, True), (sizes, m)
    sizes = [21] * 5                 # 5 groups of 2 units of 20 rows
    units = gm.tgmm_units(sizes, 105, 20)
    assert sum(u[3] > 1 for u in units) == 10
    assert gm.tgmm_ws_slabs(105, 5, 20, True) == 10
