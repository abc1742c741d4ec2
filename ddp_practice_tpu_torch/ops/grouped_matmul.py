"""Ragged grouped matmul over expert-sorted rows (counterpart of
ddp_practice_tpu/ops/moe.py `_mb_gmm` and `_grouped_matmul`, the custom VJP
over megablox `gmm` and `tgmm`).

`group_sizes` (E,) int32 splits the m rows of `lhs` into E consecutive
groups; group e owns rows [off_e, off_e + gs_e) with off_e the exclusive
cumulative sum. Three products:

- `gmm(lhs (m, k), rhs (E, k, n))` -> (m, n) in lhs's dtype (or fp32 from
  bf16 operands with `out_dtype=torch.float32`, the reference's
  `preferred_element_type`): the rows of group e times `rhs[e]`. Rows past
  sum(group_sizes) come out zero (megablox leaves them undefined; the
  sorted MoE path has none);
- `gmm(lhs (m, n), rhs (E, k, n), transpose_rhs=True)` -> (m, k): the rows
  of group e times `rhs[e]ᵀ` (the input grad: dlhs = gmm(g, rhs,
  transpose_rhs=True));
- `tgmm(lhs (m, k), g (m, n))` -> (E, k, n) in `out_dtype`: drhs[e] =
  lhs_eᵀ · g_e; an empty group gives exactly zero.

Every product accumulates in fp32 and rounds once, to the output dtype.
`grouped_matmul(lhs, rhs, group_sizes)` is the differentiable entry (a
`torch.autograd.Function`): forward gmm, backward gmm transposed and tgmm,
as the reference's `_grouped_matmul`. The reference's v5e tilings
(`_gmm_tiling`) are TPU tuning and are not carried over.

On a CUDA tensor the products run two CUDA kernels written by hand for
sm_90a (`csrc/grouped_matmul.cu`, built by `ops/cuda_build.py`, launched
through ctypes): kernel J (`gmm`, both rhs layouts; launches counted as
"gmm" and "gmm_trhs") and kernel K (`tgmm`). The schedule is built on the
device from `group_sizes`: nothing is read back to the host. J's grid has
one row of blocks per (row tile, group) visit, m_tiles + E rows in all (a
tile that straddles a group boundary is visited once per group it touches,
multiplies all its rows and stores only the group's, as megablox's
`group_offsets`/`m_tile_ids` metadata; one more visit writes the zero
tail), and blocks past the last visit exit at once. bf16 J runs on
Hopper's wgmma, fed by a ring of TMA copies (128 x 256 output tiles; 128
x 128 through `_launch_gmm(..., block_n=128)`); fp32 operands, and bf16
ones that are not 16-byte aligned, take a ring-less WMMA/FMA kernel (a
layout branch). K cuts each group's rows into chunks of `tgmm_chunk` rows
(work units, `tgmm_units`); one block per (unit, kd tile, n tile) reduces
its unit's rows in row order. A group of one unit writes its tiles
directly; a group of several writes fp32 partial tiles into a workspace
(`tgmm_ws_slabs`), and a second launch ("tgmm_reduce") sums them in unit
order and rounds once: no atomics, the same bits every run. bf16 K runs on
wgmma from a TMA ring as J does, with lhsᵀ as the MN-major A operand (128
x 256 output tiles, or 192 wide, `tgmm_block_n`); its fp32 and unaligned
operands take the ring-less kernel, which writes every unit as a partial.
The second pass is skipped when the workspace has no slab (bf16 with m at
most one unit's rows).
`gmm_schedule` and `gmm_emulated`/`tgmm_emulated` are that schedule in
Python, pinned on the CPU against the plain versions.

On a CPU tensor the entries run the plain PyTorch version (`gmm_plain`,
`tgmm_plain`): a loop over the groups of `(lhs_e.float() @ rhs[e].float())`
rounded to the output dtype. `impl`: "auto" (the kernels for CUDA tensors,
the plain version for CPU tensors; never a fallback), "kernel" (the kernels
or raise) or "plain" (the plain version on any device; it reads the group
sizes back to the host). `forced_impl` overrides every entry's `impl`
inside a block.

Bound: 2*m*k*n flops per product over the card's peak for the dtype
(H100 SXM: 989.4e12 dense bf16, 67e12 fp32), against the operands read once
and the result written once over 3.35 TB/s: at the lm_moe shapes (m =
32768 sorted rows, (k, n) = (768, 3072) and (3072, 768)) operations bound
every direction.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch

# launches per row of the kernel table, counted where a wrapper launches
# its kernel and nowhere else
# (K's second pass counts as "tgmm_reduce": one per tgmm launch whose
# workspace has a slab, `tgmm_ws_slabs`)
LAUNCHES = {"gmm": 0, "gmm_trhs": 0, "tgmm": 0, "tgmm_reduce": 0}

# kernel J's tiles (rows, cols, depth): bf16 the Hopper kernel's
# (csrc/grouped_matmul.cu WgTile<256>), fp32 the ring-less kernel's (Cfg)
TILES = {torch.bfloat16: (128, 256, 64), torch.float32: (64, 64, 16)}
# kernel K's: bf16 the Hopper kernel's (TgTile<256>: kd rows, n columns,
# 64 reduction rows a slice), fp32 the ring-less kernel's (Cfg<float>)
TGMM_TILES = {torch.bfloat16: (128, 256, 64), torch.float32: (64, 64, 16)}
# the ring-less kernel's bf16 tile (Cfg<bf16>): J's and K's operands that
# TMA cannot address
RINGLESS_BF16_TILES = (128, 128, 32)
# the bf16 J's compiled tile widths (WgTile<BN>), and K's (TgTile<BN>)
GMM_BLOCK_N = (256, 128)
TGMM_BLOCK_N = (256, 192)
# K's rows a work unit: TGMM_CHUNK (TGMM_F32_CHUNK for an fp32 output),
# halved down to TGMM_MIN_CHUNK while the units would fill less than half
# the SMs (`tgmm_chunk`)
TGMM_CHUNK = 16384
TGMM_F32_CHUNK = 4096
TGMM_MIN_CHUNK = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {-2: "bad shape", -3: "unsupported dtype",
           -4: "tensor map refused (cuTensorMapEncodeTiled)"}
_IMPLS = ("auto", "kernel", "plain")
_forced: Optional[str] = None     # set by `forced_impl`


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def forced_impl(impl: str):
    """Inside the block every entry runs `impl`, whatever its own `impl`
    argument (a backward follows its forward's choice)."""
    global _forced
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want auto|kernel|plain)")
    previous, _forced = _forced, impl
    try:
        yield
    finally:
        _forced = previous


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    impl = _forced or impl
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want auto|kernel|plain)")
    if impl == "plain" or (impl == "auto" and x.device.type == "cpu"):
        return False
    if x.device.type != "cuda":
        raise ValueError(
            f"impl={impl!r} launches the CUDA kernels; got a tensor on "
            f"{x.device}")
    return True


# --------------------------------------------------------- plain versions
def _bounds(group_sizes: torch.Tensor, m: int):
    """[(group, row_lo, row_hi)] on the host, rows clipped to [0, m)."""
    out, off = [], 0
    for e, size in enumerate(group_sizes.tolist()):
        size = max(int(size), 0)
        out.append((e, min(off, m), min(off + size, m)))
        off += size
    return out


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor,
              group_sizes: torch.Tensor, *, transpose_rhs: bool = False,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Kernel J's arithmetic: per group, fp32 product rounded to
    `out_dtype` (lhs's by default); rows past the groups are zero."""
    m = lhs.shape[0]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.zeros((m, n), dtype=out_dtype or lhs.dtype,
                      device=lhs.device)
    for e, lo, hi in _bounds(group_sizes, m):
        if hi > lo:
            w = rhs[e].float()
            out[lo:hi] = (lhs[lo:hi].float() @ (w.T if transpose_rhs else w)
                          ).to(out.dtype)
    return out


def tgmm_plain(lhs: torch.Tensor, grad: torch.Tensor,
               group_sizes: torch.Tensor, *,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Kernel K's arithmetic: out[e] = lhs_eᵀ · g_e in fp32, rounded to
    `out_dtype` (lhs's by default); an empty group is zero."""
    e_count = group_sizes.shape[0]
    out = torch.zeros((e_count, lhs.shape[1], grad.shape[1]),
                      dtype=out_dtype or lhs.dtype, device=lhs.device)
    for e, lo, hi in _bounds(group_sizes, lhs.shape[0]):
        if hi > lo:
            out[e] = (lhs[lo:hi].float().T @ grad[lo:hi].float()).to(
                out.dtype)
    return out


# ---------------------------------------------------- the kernels' schedule
def gmm_schedule(group_sizes, m: int, block_m: int):
    """Kernel J's visit table, entry v for grid row v, exactly as each
    block derives it on the device: (group, tile, row_lo, row_hi) for the
    rows [row_lo, row_hi) of row tile `tile` that belong to `group`; group
    == E is the zero tail (rows past sum(group_sizes)). Blocks of grid rows
    past the table's end (the grid has m_tiles + E rows) exit at once."""
    visits, off, e_count = [], 0, len(group_sizes)
    for e, size in enumerate(list(group_sizes) + [None]):
        if size is None:                         # the tail, group E
            size, e = m - off, e_count
        size = max(int(size), 0)
        if size > 0 and off < m:
            hi = min(off + size, m)
            for t in range(off // block_m, (hi - 1) // block_m + 1):
                visits.append((e, t, max(t * block_m, off),
                               min(t * block_m + block_m, hi)))
        off += size
    return visits


def gmm_grid_rows(m: int, num_groups: int, block_m: int) -> int:
    """Kernel J's grid rows: every (tile, group) visit fits in m_tiles + E
    (E - 1 boundaries can split a tile, the tail adds one)."""
    return -(-m // block_m) + num_groups


def gmm_emulated(lhs, rhs, group_sizes, *, transpose_rhs=False,
                 tiles=None, out_dtype=None):
    """Kernel J's blocks in plain PyTorch, one grid cell at a time: the
    visit of its grid row (early exit past the table), the whole row tile
    multiplied (rows of other groups too, as the kernel's slices hold
    them) and only the group's rows stored, fp32 accumulation over depth
    slices that are zero past k, the tail written zero. Raises if a block
    writes an element that another block wrote. Returns (out, visits,
    exits); elements no block writes stay NaN."""
    bm, bn, bk = tiles or TILES[lhs.dtype]
    m, kd = lhs.shape
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    e_count = rhs.shape[0]
    out = torch.full((m, n), float("nan"), dtype=torch.float32)
    writes = torch.zeros((m, n), dtype=torch.int32)
    table = gmm_schedule(group_sizes.tolist(), m, bm)
    exits = 0
    for v in range(gmm_grid_rows(m, e_count, bm)):
        if v >= len(table):
            exits += 1
            continue
        e, t, lo, hi = table[v]
        for n0 in range(0, n, bn):
            cols = slice(n0, min(n0 + bn, n))
            writes[lo:hi, cols] += 1
            if e == e_count:
                out[lo:hi, cols] = 0.0
                continue
            w = rhs[e].float()
            w = (w.T if transpose_rhs else w)[:, cols]
            rows = lhs[t * bm:t * bm + bm].float()
            acc = torch.zeros((rows.shape[0], w.shape[1]))
            for k0 in range(0, kd, bk):
                acc += rows[:, k0:k0 + bk] @ w[k0:k0 + bk]
            out[lo:hi, cols] = acc[lo - t * bm:hi - t * bm]
    if (writes > 1).any():
        raise AssertionError("an output element is written by two blocks")
    return out.to(out_dtype or lhs.dtype), table, exits


def tgmm_units(group_sizes, m: int, chunk: int):
    """Kernel K's work units, unit v for grid row v, exactly as each block
    derives it on the device: (group, row_lo, row_hi, units of the group)
    for chunk c of a group, rows [lo + c * chunk, ...) clipped to the
    group's rows below m; an empty group (or one past m) is one unit of no
    rows. Blocks of grid rows past the list's end exit at once."""
    units, off = [], 0
    for e, size in enumerate(group_sizes):
        size = max(int(size), 0)
        lo, hi = min(off, m), min(off + size, m)
        count = -(-(hi - lo) // chunk) if hi > lo else 1
        for c in range(count):
            units.append((e, lo + c * chunk, min(lo + (c + 1) * chunk, hi),
                          count))
        off += size
    return units


def tgmm_unit_rows(m: int, num_groups: int, chunk: int) -> int:
    """K's grid rows: ceil(m / chunk) + E bounds the units, sum over groups
    of max(1, ceil(rows / chunk))."""
    return -(-m // chunk) + num_groups


def tgmm_ws_slabs(m: int, num_groups: int, chunk: int, direct: bool) -> int:
    """K's fp32 workspace slabs of (kd, n). The ring-less kernel writes
    every unit (`tgmm_unit_rows`). The Hopper kernel (`direct`) writes
    only the units of groups of several units, each such group having
    more than `chunk` rows: ceil(rows / chunk) <= rows // chunk + 1 sums
    to at most m // chunk + (number of such groups), and there are at most
    min(E, m // (chunk + 1)) of those. None when m <= chunk: every group
    is then one unit and the second pass does not run."""
    if not direct:
        return tgmm_unit_rows(m, num_groups, chunk)
    if m <= chunk:
        return 0
    return m // chunk + min(num_groups, m // (chunk + 1))


def tgmm_slabs_of(units, direct: bool) -> list:
    """Each unit's workspace slab, as the blocks derive it on the device:
    unit v's own index for the ring-less kernel; for the Hopper kernel the
    index among the units of groups of several units, in unit order, and
    None for a group of one unit (it writes the output directly)."""
    if not direct:
        return list(range(len(units)))
    slabs, split = [], 0
    for _, _, _, count in units:
        slabs.append(split if count > 1 else None)
        split += count > 1
    return slabs


def tgmm_chunk(m: int, tiles: int, sms: int, out_f32: bool = False) -> int:
    """K's rows a unit: TGMM_CHUNK, halved (down to TGMM_MIN_CHUNK) while
    ceil(m / chunk) units of `tiles` output tiles each would fill less
    than half the SMs. The lm_moe shapes keep 16384 (every group of the
    balanced and of the skewed pattern is one unit: no partials); the
    fused layer's one-group weight grads get 1024-4096 rows a unit. On an
    H100 (experiments/tgmm_tune.py) longer units won wherever they still
    half-filled the card: a unit of 4096 rows beat twice the units of 2048
    that would fill every SM, and the skewed pattern ran fastest unsplit.
    An fp32 output starts at TGMM_F32_CHUNK: one unit is one fp32
    accumulation chain, whose rounding grows with its rows (a 16384-row
    chain put the skewed pattern's fp32 result 1.4e-5 from the plain
    version in relative norm, 4096-row units 4.2e-6); a bf16 output rounds
    to 2^-8 and does not see it."""
    chunk = TGMM_F32_CHUNK if out_f32 else TGMM_CHUNK
    while chunk > TGMM_MIN_CHUNK and -(-m // chunk) * tiles < sms // 2:
        chunk //= 2
    return chunk


def tgmm_block_n(n: int) -> int:
    """K's tile width for n columns: the compiled width that wastes the
    fewest columns, the widest on a tie (n = 192 runs 192 wide)."""
    return min(TGMM_BLOCK_N, key=lambda bn: (-(-n // bn) * bn - n, -bn))


def tgmm_emulated(lhs, grad, group_sizes, *, out_dtype=None, tiles=None,
                  chunk=TGMM_CHUNK, direct=None):
    """Kernel K's blocks in plain PyTorch: per work unit (`tgmm_units`) and
    output tile, an fp32 sum over the unit's rows in slices of the tile
    depth, in row order. A slice holds whole rows of the operands as they
    lie (its last one runs past the unit into the next chunk, group or
    the zero-filled rows past m), and the rows past the unit are zeroed in
    both operands before the product. `direct` (the Hopper kernel, the
    default for bf16): a group of one unit writes its tiles rounded once,
    and only the other groups' units have workspace slabs
    (`tgmm_slabs_of`, `tgmm_ws_slabs`); otherwise every unit writes an
    fp32 partial slab. The second pass sums a group's slabs in unit order
    and rounds once (groups of one unit skipped when direct); it does not
    run when the workspace has no slab. Elements no block writes stay
    NaN."""
    bm, bn, bk = tiles or TGMM_TILES[lhs.dtype]
    if direct is None:
        direct = lhs.dtype == torch.bfloat16
    m, kd = lhs.shape
    n = grad.shape[1]
    e_count = group_sizes.shape[0]
    out_dtype = out_dtype or lhs.dtype
    units = tgmm_units(group_sizes.tolist(), m, chunk)
    assert len(units) <= tgmm_unit_rows(m, e_count, chunk)
    slab_of = tgmm_slabs_of(units, direct)
    slabs = tgmm_ws_slabs(m, e_count, chunk, direct)
    assert all(v is None or v < slabs for v in slab_of)
    ws = torch.full((slabs, kd, n), float("nan"))
    out = torch.full((e_count, kd, n), float("nan"))
    # rows past m read as zeros, as TMA fills them
    pad = lambda t: torch.cat([t.float(), t.new_zeros((bk, t.shape[1])
                                                      ).float()])
    a_all, g_all = pad(lhs), pad(grad)
    for v, (e, lo, hi, count) in enumerate(units):
        for i0 in range(0, kd, bm):
            for n0 in range(0, n, bn):
                acc = torch.zeros((min(bm, kd - i0), min(bn, n - n0)))
                for r0 in range(lo, hi, bk):
                    a = a_all[r0:r0 + bk, i0:i0 + bm].clone()
                    b = g_all[r0:r0 + bk, n0:n0 + bn].clone()
                    a[hi - r0:] = 0.0      # rows past the unit, both
                    b[hi - r0:] = 0.0      # operands (0 * Inf is NaN)
                    acc += a.T @ b
                if slab_of[v] is None:
                    out[e, i0:i0 + bm, n0:n0 + bn] = acc.to(out_dtype).float()
                else:
                    ws[slab_of[v], i0:i0 + bm, n0:n0 + bn] = acc
    u0 = 0
    for e in range(e_count if slabs else 0):      # the second pass
        count = sum(1 for unit in units if unit[0] == e)
        if count > 1 or not direct:
            acc = torch.zeros((kd, n))
            for c in range(count):
                acc += ws[u0 + c]
            out[e] = acc.to(out_dtype).float()
            u0 += count
    return out.to(out_dtype)


# -------------------------------------------------------------- public API
def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
        transpose_rhs: bool = False, out_dtype: Optional[torch.dtype] = None,
        impl: str = "auto") -> torch.Tensor:
    """(m, k) x (E, k, n) -> (m, n), or (m, n) x (E, k, n)ᵀ -> (m, k), in
    `out_dtype` (lhs's by default; fp32 from bf16 operands too)."""
    if not _use_kernel(impl, lhs):
        return gmm_plain(lhs, rhs, group_sizes, transpose_rhs=transpose_rhs,
                         out_dtype=out_dtype)
    return _launch_gmm(lhs, rhs, group_sizes, transpose_rhs,
                       out_dtype=out_dtype)


def tgmm(lhs: torch.Tensor, grad: torch.Tensor, group_sizes: torch.Tensor,
         *, out_dtype: Optional[torch.dtype] = None,
         impl: str = "auto") -> torch.Tensor:
    """(m, k), (m, n) -> (E, k, n): per group lhs_eᵀ · g_e."""
    if not _use_kernel(impl, lhs):
        return tgmm_plain(lhs, grad, group_sizes, out_dtype=out_dtype)
    return _launch_tgmm(lhs, grad, group_sizes, out_dtype)


class _GroupedMatmul(torch.autograd.Function):
    """The reference's `_grouped_matmul` VJP: residuals (lhs, rhs,
    group_sizes); dlhs = gmm(g, rhs, transpose_rhs=True) in lhs's dtype,
    drhs = tgmm(lhs, g) in rhs's dtype. The cotangent is cast to the
    output's dtype (lhs's) first."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, impl):
        use = _use_kernel(impl, lhs)
        ctx.impl = "kernel" if use else "plain"
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm(lhs, rhs, group_sizes, impl=ctx.impl)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, group_sizes = ctx.saved_tensors
        g = g.to(lhs.dtype).contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm(g, rhs, group_sizes, transpose_rhs=True,
                       impl=ctx.impl)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(lhs, g, group_sizes, out_dtype=rhs.dtype,
                        impl=ctx.impl)
        return dlhs, drhs, None, None


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor, *,
                   impl: str = "auto") -> torch.Tensor:
    """Differentiable gmm over expert-sorted rows (ops/moe.py's sorted
    path): lhs (m, k), rhs (E, k, n), group_sizes (E,) int32 -> (m, n)."""
    return _GroupedMatmul.apply(lhs, rhs, group_sizes, impl)


# -------------------------------------------------------------- launches
def _check(name, lhs, rhs, group_sizes, dims):
    for what, t in (("lhs", lhs), ("rhs", rhs)):
        if t.dtype not in _DTYPE_CODE or t.dtype != lhs.dtype:
            raise ValueError(
                f"{name}: {what} has dtype {t.dtype}; the kernel takes "
                f"operands of one dtype in (float32, bfloat16)")
        if t.device != lhs.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous on "
                             f"{lhs.device}")
    if (group_sizes.dtype != torch.int32 or group_sizes.dim() != 1
            or group_sizes.device != lhs.device):
        raise ValueError(f"{name}: group_sizes must be int32 (E,) on "
                         f"{lhs.device}")
    if lhs.dtype == torch.bfloat16 and any(d % 8 for d in dims):
        raise ValueError(f"{name}: the bf16 kernel takes k and n that are "
                         f"multiples of 8; got {dims}")


def _vec(*tensors) -> int:
    """16-byte loads when every operand starts 16-byte aligned and its
    rows are a multiple of 16 bytes long; else element loads."""
    ok = all(t.data_ptr() % 16 == 0 and (t.shape[-1] * t.element_size())
             % 16 == 0 for t in tensors)
    return int(ok)


def _launch_gmm(lhs, rhs, group_sizes, transpose_rhs, *, out_dtype=None,
                block_n=GMM_BLOCK_N[0]):
    """Kernel J; `block_n` picks the bf16 Hopper kernel's tile width
    (GMM_BLOCK_N; experiments/gmm_tune.py sweeps it)."""
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError(f"gmm takes lhs (m, k) and rhs (E, k, n); got "
                         f"{tuple(lhs.shape)} and {tuple(rhs.shape)}")
    m, kred = lhs.shape
    e_count = rhs.shape[0]
    nout, rk = ((rhs.shape[1], rhs.shape[2]) if transpose_rhs
                else (rhs.shape[2], rhs.shape[1]))
    if rk != kred or group_sizes.shape != (e_count,):
        raise ValueError(
            f"gmm shapes: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, "
            f"group_sizes {tuple(group_sizes.shape)}, transpose_rhs="
            f"{transpose_rhs}")
    _check("gmm", lhs, rhs, group_sizes, (kred, nout))
    out_dtype = out_dtype or lhs.dtype
    if out_dtype not in (lhs.dtype, torch.float32):
        raise ValueError(f"gmm: the kernel writes {lhs.dtype} or fp32; "
                         f"asked for {out_dtype}")
    if block_n not in GMM_BLOCK_N:
        raise ValueError(f"gmm: block_n {block_n} not compiled "
                         f"{GMM_BLOCK_N}")
    out = torch.empty((m, nout), dtype=out_dtype, device=lhs.device)
    if m and nout:
        lib = _library()
        with torch.cuda.device(lhs.device):
            rc = lib.grouped_matmul_gmm(
                lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
                out.data_ptr(), m, kred, nout, e_count, int(transpose_rhs),
                _vec(lhs, rhs, out), _DTYPE_CODE[lhs.dtype],
                int(out_dtype != lhs.dtype), block_n, _stream(lhs))
        _raise_on(rc, "grouped_matmul_gmm", lhs, rhs)
        LAUNCHES["gmm_trhs" if transpose_rhs else "gmm"] += 1
    return out


def _launch_tgmm(lhs, grad, group_sizes, out_dtype=None, *, chunk=None,
                 block_n=None):
    """Kernel K and its second pass (none when the workspace has no slab,
    `tgmm_ws_slabs`). bf16 operands that TMA can address (and m > 0) take
    the Hopper kernel at `block_n` (`tgmm_block_n` by default); the rest
    the ring-less kernel. `chunk`: rows a work unit (`tgmm_chunk` by
    default). out_dtype: the operands' dtype, or fp32 from bf16
    operands."""
    if lhs.dim() != 2 or grad.dim() != 2 or lhs.shape[0] != grad.shape[0]:
        raise ValueError(f"tgmm takes lhs (m, k) and g (m, n); got "
                         f"{tuple(lhs.shape)} and {tuple(grad.shape)}")
    out_dtype = out_dtype or lhs.dtype
    if out_dtype not in (lhs.dtype, torch.float32):
        raise ValueError(f"tgmm: the kernel writes the operands' dtype "
                         f"{lhs.dtype} or fp32; asked for {out_dtype}")
    m, kd = lhs.shape
    n = grad.shape[1]
    _check("tgmm", lhs, grad, group_sizes, (kd, n))
    e_count = group_sizes.shape[0]
    out = torch.empty((e_count, kd, n), dtype=out_dtype, device=lhs.device)
    if not out.numel():
        return out
    vec = _vec(lhs, grad, out)
    direct = lhs.dtype == torch.bfloat16 and bool(vec) and m > 0
    block_n = block_n or tgmm_block_n(n)
    if block_n not in TGMM_BLOCK_N:
        raise ValueError(f"tgmm: block_n {block_n} not compiled "
                         f"{TGMM_BLOCK_N}")
    if chunk is None:
        bm, bn, _ = ((128, block_n, 64) if direct else
                     TGMM_TILES[torch.float32] if lhs.dtype == torch.float32
                     else RINGLESS_BF16_TILES)
        sms = torch.cuda.get_device_properties(
            lhs.device).multi_processor_count
        chunk = tgmm_chunk(m, -(-kd // bm) * -(-n // bn), sms,
                           out_dtype == torch.float32)
    if chunk < 1:
        raise ValueError(f"tgmm: chunk {chunk} rows")
    slabs = tgmm_ws_slabs(m, e_count, chunk, direct)
    ws = torch.empty((slabs, kd, n), dtype=torch.float32, device=lhs.device)
    lib = _library()
    code, f32 = _DTYPE_CODE[lhs.dtype], int(out_dtype != lhs.dtype)
    with torch.cuda.device(lhs.device):
        rc = lib.grouped_matmul_tgmm(
            lhs.data_ptr(), grad.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), ws.data_ptr(), m, kd, n, e_count, chunk,
            int(direct), vec, code, f32, block_n, _stream(lhs))
        _raise_on(rc, "grouped_matmul_tgmm", lhs, grad)
        LAUNCHES["tgmm"] += 1
        if not slabs:
            return out
        rc = lib.grouped_matmul_tgmm_reduce(
            ws.data_ptr(), group_sizes.data_ptr(), out.data_ptr(), m, kd, n,
            e_count, chunk, int(direct), code, f32, _stream(lhs))
        _raise_on(rc, "grouped_matmul_tgmm_reduce", lhs, grad)
        LAUNCHES["tgmm_reduce"] += 1
    return out


def gmm_occupancy(block_n: int = GMM_BLOCK_N[0]) -> dict:
    """The bf16 Hopper J's footprint at tile width `block_n` on this card:
    {"smem_bytes", "threads", "blocks_per_sm"} (dynamic shared memory and
    threads a block, blocks an SM by the runtime's occupancy
    calculator)."""
    lib = _library()
    vals = [ctypes.c_int() for _ in range(3)]
    rc = lib.grouped_matmul_occupancy(block_n,
                                      *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"grouped_matmul_occupancy({block_n}): "
                           + _ERRORS.get(rc, f"cudaError_t {rc}"))
    return dict(zip(("smem_bytes", "threads", "blocks_per_sm"),
                    (v.value for v in vals)))


def tgmm_occupancy(block_n: int = TGMM_BLOCK_N[0]) -> dict:
    """The bf16 Hopper K's footprint at tile width `block_n`, as
    `gmm_occupancy` gives J's."""
    lib = _library()
    vals = [ctypes.c_int() for _ in range(3)]
    rc = lib.grouped_matmul_tgmm_occupancy(block_n,
                                           *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"grouped_matmul_tgmm_occupancy({block_n}): "
                           + _ERRORS.get(rc, f"cudaError_t {rc}"))
    return dict(zip(("smem_bytes", "threads", "blocks_per_sm"),
                    (v.value for v in vals)))


def _raise_on(rc, name, a, b):
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: " + _ERRORS.get(rc, f"cudaError_t {rc}")
            + f" ({tuple(a.shape)} x {tuple(b.shape)}, {a.dtype})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _library() -> ctypes.CDLL:
    """The grouped-matmul library with every pointer and the stream
    declared `c_void_p` (a bare Python int would pass as a 32-bit int)."""
    from ddp_practice_tpu_torch.ops.cuda_build import load_library

    lib = load_library("grouped_matmul")
    if not getattr(lib, "_signatures_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.grouped_matmul_gmm.argtypes = [P, P, P, P, I, I, I, I, I, I, I,
                                           I, I, P]
        lib.grouped_matmul_gmm.restype = I
        IP = ctypes.POINTER(ctypes.c_int)
        lib.grouped_matmul_occupancy.argtypes = [I, IP, IP, IP]
        lib.grouped_matmul_occupancy.restype = I
        lib.grouped_matmul_tgmm_occupancy.argtypes = [I, IP, IP, IP]
        lib.grouped_matmul_tgmm_occupancy.restype = I
        lib.grouped_matmul_tgmm.argtypes = [P] * 5 + [I] * 10 + [P]
        lib.grouped_matmul_tgmm.restype = I
        lib.grouped_matmul_tgmm_reduce.argtypes = [P, P, P] + [I] * 8 + [P]
        lib.grouped_matmul_tgmm_reduce.restype = I
        lib._signatures_set = True
    return lib
