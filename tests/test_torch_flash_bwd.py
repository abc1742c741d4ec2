"""The bf16 backward kernels G (dQ) and F (dK/dV) of
ddp_practice_tpu_torch/csrc/flash_attention.cu, by their block schedule,
on the CPU.

A torch emulation of the two kernels, block by block at their tile sizes
(`BWD_TILES`, the .cu's `BwdTile`), stands in for their launches
(`_launch_dq`, `_launch_dkdv`), so the wrapper's kernel route runs here:
the delta and qs scratches it allocates, the (b, h, s, d) strides of
every layout, the launch order (G writes the scratches, then F reads them)
and the `LAUNCHES` rows. What the emulation keeps of the kernels:
- G: a block per 64-query tile, staged zero-filled past s_q, delta =
  rowsum(do * o) - g_lse and qs = round(q * scale) for its rows written
  to the scratches, the key tiles from 0 up to the last one a row of the
  tile sees (causal, bottom-right offset s_k - s_q), dq summed tile by
  tile and scaled once;
- F: a block per key tile, the query tiles from the first one that sees
  its first key, qs, lse and delta read from their scratches and vectors,
  dv and dk summed tile by tile;
- the rounding points (qs, p before p^T.do, ds before ds^T.qs and ds.k,
  the outputs) in the operands' dtype.
Held against the plain version (`flash_attention_plain_bwd`) in fp32 at
1e-5, where only the summation order differs: folded, (b, s, h, d) heads,
packed and fused-QKV windows, d in {32, 64}, s in {96, 160} (ragged tails
at 64-row tiles), causal and not, and s_q = 70 < s_k = 200 with a loss on
lse (g_lse). On the card the kernels themselves are held to the plain
version (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from ddp_practice_tpu_torch.ops import flash_attention as fa

# one intra-op thread, as tests/_torch_port.py sets for the port's other
# files: the suite runs several workers on one machine
torch.set_num_threads(1)

TOL = 1e-5
# the .cu's BwdTile<D>: F's key rows a block and query rows a streamed
# tile, G's query rows a block and key rows a streamed tile
BWD_TILES = {32: (64, 64, 64, 64), 64: (64, 64, 64, 64),
             128: (64, 32, 64, 32), 256: (32, 32, 64, 32)}


def _stage(x, row0, rows):
    """A (b, h, rows, ...) tile of x's rows [row0, row0 + rows), zeros
    past the end (the kernels' zero-filled copies)."""
    tile = x.new_zeros((*x.shape[:2], rows, *x.shape[3:]))
    part = x[:, :, row0:row0 + rows]
    tile[:, :, :part.shape[2]] = part
    return tile


def _mask(rows, cols, sq, sk, causal, offset):
    """True where the (query, key) pair is visible and inside both
    lengths: rows and cols are the tile's absolute indices."""
    q, k = rows[:, None], cols[None, :]
    valid = (q < sq) & (k < sk)
    if causal:
        valid &= k <= q + offset
    return valid


def _rounding(dtype):
    return lambda x: x.to(dtype).float()


def emulate_g(q4, k4, v4, o4, do4, lse, glse, delta, qs_out, dq4, dk4,
              dv4, causal):
    """Kernel G block by block: dq into dq4, delta and the rounded scaled
    queries into their scratches."""
    b, h, sq, d = q4.shape
    sk = k4.shape[2]
    _, _, bq, bk = BWD_TILES[d]
    rnd = _rounding(q4.dtype)
    q_scale, dq_scale = fa._scales(d, q4.dtype)
    offset = sk - sq if causal else 0
    qs = rnd(q4.float() * q_scale)
    for q0 in range(0, sq, bq):                        # one block each
        nq = min(bq, sq - q0)
        rows = torch.arange(q0, q0 + bq)
        sq_t, do_t = _stage(qs, q0, bq), _stage(do4.float(), q0, bq)
        qs_out[:, :, q0:q0 + nq] = sq_t[:, :, :nq].to(qs_out.dtype)
        o_t = _stage(o4.float(), q0, bq)
        dl = (do_t * o_t).sum(-1)
        if glse is not None:
            dl = dl - _stage(glse[..., None], q0, bq)[..., 0]
        delta[:, :, q0:q0 + nq] = dl[:, :, :nq]
        ls = _stage(lse[..., None], q0, bq)[..., 0]
        k_end = min(sk, q0 + nq - 1 + offset + 1) if causal else sk
        acc = torch.zeros((b, h, bq, d))
        for k0 in range(0, k_end, bk):                 # the ring's tiles
            k_t, v_t = _stage(k4.float(), k0, bk), _stage(v4.float(), k0, bk)
            s = sq_t @ k_t.transpose(-1, -2)
            dp = do_t @ v_t.transpose(-1, -2)
            valid = _mask(rows, torch.arange(k0, k0 + bk), sq, sk, causal,
                          offset)
            p = torch.where(valid, torch.exp(s - ls[..., None]), 0.0)
            ds = rnd(p * (dp - dl[..., None]))
            acc = acc + ds @ k_t
        dq4[:, :, q0:q0 + nq] = (acc * dq_scale)[:, :, :nq].to(dq4.dtype)


def emulate_f(q4, k4, v4, o4, do4, lse, glse, delta, qs_in, dq4, dk4,
              dv4, causal):
    """Kernel F block by block: dk and dv, reading G's delta and scaled
    queries (never q itself)."""
    b, h, sq, d = q4.shape
    sk = k4.shape[2]
    bk, bq, _, _ = BWD_TILES[d]
    rnd = _rounding(q4.dtype)
    offset = sk - sq if causal else 0
    qs = qs_in.float()
    for k0 in range(0, sk, bk):                        # one block each
        nk = min(bk, sk - k0)
        keys = torch.arange(k0, k0 + bk)
        k_t, v_t = _stage(k4.float(), k0, bk), _stage(v4.float(), k0, bk)
        dk = torch.zeros((b, h, bk, d))
        dv = torch.zeros((b, h, bk, d))
        q_begin = max(0, k0 - offset) // bq * bq if causal else 0
        for q0 in range(q_begin, sq, bq):              # the ring's tiles
            sq_t, do_t = _stage(qs, q0, bq), _stage(do4.float(), q0, bq)
            ls = _stage(lse[..., None], q0, bq)[..., 0]
            dl = _stage(delta[..., None], q0, bq)[..., 0]
            s_t = k_t @ sq_t.transpose(-1, -2)         # s^T: keys x queries
            dp_t = v_t @ do_t.transpose(-1, -2)
            valid = _mask(torch.arange(q0, q0 + bq), keys, sq, sk, causal,
                          offset).T
            p_t = torch.where(valid, torch.exp(s_t - ls[..., None, :]), 0.0)
            ds_t = p_t * (dp_t - dl[..., None, :])
            dv = dv + rnd(p_t) @ do_t
            dk = dk + rnd(ds_t) @ sq_t
        dk4[:, :, k0:k0 + nk] = dk[:, :, :nk].to(dk4.dtype)
        dv4[:, :, k0:k0 + nk] = dv[:, :, :nk].to(dv4.dtype)


@pytest.fixture
def emulated_backward(monkeypatch):
    """The wrapper's kernel route with G and F emulated (and E's launch
    replaced by its plain version); returns the list of launches made,
    (name, delta scratch, qs scratch) in order."""
    calls = []

    def fwd(q4, k4, v4, out4, causal):
        o, lse = fa.flash_attention_plain(q4, k4, v4, causal=causal)
        out4.copy_(o)
        return lse

    def launch(name, emulate):
        def run(*args):
            calls.append((name, args[7], args[8]))
            emulate(*args)
        return run

    monkeypatch.setattr(fa, "_use_kernel", lambda impl, x: impl != "plain")
    monkeypatch.setattr(fa, "_launch_fwd", fwd)
    monkeypatch.setattr(fa, "_launch_dq", launch("G", emulate_g))
    monkeypatch.setattr(fa, "_launch_dkdv", launch("F", emulate_f))
    fa.reset_launches()
    yield calls
    fa.reset_launches()


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]


def _grads(entry, impl, inputs, weights):
    xs = [t.clone().requires_grad_(True) for t in inputs]
    out = entry(*xs, impl=impl)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o * w).sum() for o, w in zip(outs, weights))
    return torch.autograd.grad(loss, xs)


# (entry, route the wrapper takes at d=64; d=32 never packs)
def _case(layout, b, s, d):
    if layout == "folded":
        return (fa.flash_attention_with_lse, [(b * 2, s, d)] * 3,
                [(b * 2, s, d), (b * 2, s)], "folded")
    if layout == "heads":          # 3 heads never pack
        return fa.flash_attention, [(b, s, 3, d)] * 3, [(b, s, 3, d)], \
            "folded"
    if layout == "packed":
        return fa.flash_attention, [(b, s, 2, d)] * 3, [(b, s, 2, d)], \
            "packed" if d >= 64 else "folded"
    return (lambda x, **kw: fa.flash_attention_qkv(x, 2, **kw),
            [(b, s, 6 * d)], [(b, s, 2, d)],
            "packed" if d >= 64 else "folded")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [96, 160])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("layout", ["folded", "heads", "packed", "qkv"])
def test_schedule_matches_plain(emulated_backward, layout, d, s, causal):
    b = 2
    entry, shapes, wshapes, row = _case(layout, b, s, d)
    inputs = _inputs(shapes, seed=d + s + causal)
    weights = _inputs(wshapes, seed=7)

    def run(*xs, impl):
        return entry(*xs, causal=causal, impl=impl)

    got = _grads(run, "kernel", inputs, weights)
    want = _grads(run, "plain", inputs, weights)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=TOL, rtol=TOL)
    assert [name for name, *_ in emulated_backward] == ["G", "F"]
    other = "folded" if row == "packed" else "packed"
    assert fa.LAUNCHES[f"flash_bwd_{row}"] == 1
    assert fa.LAUNCHES[f"flash_bwd_{other}"] == 0


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_shorter_queries_with_lse_grad(emulated_backward, d):
    """Causal s_q = 70 < s_k = 200 (bottom-right offset 130) with a loss
    on lse: g_lse folds into G's delta; at d >= 128 the kernels' tiles
    are 32 rows."""
    bh, sq, sk = 2, 70, 200
    inputs = _inputs([(bh, sq, d), (bh, sk, d), (bh, sk, d)], seed=d)
    weights = _inputs([(bh, sq, d), (bh, sq)], seed=d + 1)

    def run(*xs, impl):
        return fa.flash_attention_with_lse(*xs, causal=True, impl=impl)

    got = _grads(run, "kernel", inputs, weights)
    want = _grads(run, "plain", inputs, weights)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=TOL, rtol=TOL)


def test_g_writes_delta_once_and_f_reads_it(emulated_backward):
    """Two scratches per backward: G is launched first and fills a
    (b, h, s_q) fp32 one with rowsum(do * o) - g_lse and a (b, h, s_q, d)
    one with round(q * scale); F is launched second on the same tensors."""
    bh, sq, sk, d = 3, 70, 200, 64
    q, k, v = (x.requires_grad_(True) for x in _inputs(
        [(bh, sq, d), (bh, sk, d), (bh, sk, d)], seed=3))
    w, w_lse = _inputs([(bh, sq, d), (bh, sq)], seed=4)
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=True,
                                           impl="kernel")
    ((out * w).sum() + (lse * w_lse).sum()).backward()
    (g, delta_g, qs_g), (f, delta_f, qs_f) = emulated_backward
    assert (g, f) == ("G", "F") and delta_f is delta_g and qs_f is qs_g
    assert delta_g.shape == (bh, 1, sq) and delta_g.dtype == torch.float32
    assert qs_g.shape == (bh, 1, sq, d) and qs_g.is_contiguous()
    want = (w * out.detach()).sum(-1) - w_lse
    torch.testing.assert_close(delta_g[:, 0], want, atol=TOL, rtol=TOL)
    q_scale, _ = fa._scales(d, q.dtype)
    torch.testing.assert_close(qs_g[:, 0], q.detach() * q_scale, atol=0,
                               rtol=0)


def test_backward_launches_refuse_what_the_kernels_do_not_take():
    """The checks before the two launches, reachable without a card."""
    q = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="unit head_dim stride"):
        fa._launch_bwd(q, q, q, q.transpose(-1, -2), q, lse, None, q, q, q,
                       True)
    with pytest.raises(ValueError, match="contiguous fp32"):
        fa._launch_bwd(q, q, q, q, q, lse.double(), None, q, q, q, True)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros((1, 2, 64, 48), dtype=torch.bfloat16)
        fa._launch_bwd(x, x, x, x, x, lse, None, x, x, x, True)


def test_ptxas_lines_are_named_by_kernel():
    """chip_smoke prints each backward kernel's registers and spills from
    nvcc's -Xptxas -v output, keyed by the kernel's demangled name."""
    from ddp_practice_tpu_torch.ops import cuda_build

    def mangled(parts, tail):
        return "_ZN" + "".join(f"{len(x)}{x}" for x in parts) + tail

    g = mangled(["_INTERNAL_0a1b_18_flash_attention_cu_9f", "flash_bwd_dq_tc_"
                 "kernel"], "ILi64EEEvNS_6ParamsE")
    f = mangled(["_GLOBAL__N_1", "flash_bwd_dkdv_kernel"],
                "IfLi128EEEvNS_6ParamsE")
    info = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{g}' for 'sm_90a'",
        f"ptxas info    : Function properties for {g}",
        "    16 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{f}' for 'sm_90a'",
        "ptxas info    : Used 90 registers, used 1 barriers"])
    found = cuda_build.kernel_resources(info)
    assert list(found) == ["flash_bwd_dq_tc_kernel<64>",
                           "flash_bwd_dkdv_kernel<128>"]
    assert "12 bytes spill stores" in found["flash_bwd_dq_tc_kernel<64>"][0]
    assert "Used 168 registers" in found["flash_bwd_dq_tc_kernel<64>"][1]
    assert found["flash_bwd_dkdv_kernel<128>"] == [
        "ptxas info    : Used 90 registers, used 1 barriers"]


@pytest.mark.parametrize("name", ["shipped", "exp2f", "mask every tile",
                                  "F 2 blocks/SM", "G 3 blocks/SM"])
def test_ablation_variants_apply_to_the_source(name):
    """experiments/flash_bwd_ablate.py undoes one design choice of the
    shipped kernels a variant, by text substitutions that must each find
    their text once; a stale variant would fail on the card only."""
    from ddp_practice_tpu_torch.experiments import flash_bwd_ablate as ab
    from ddp_practice_tpu_torch.ops import cuda_build

    assert list(ab.VARIANTS) == ["shipped", "exp2f", "mask every tile",
                                 "F 2 blocks/SM", "G 3 blocks/SM"]
    shipped = (cuda_build.CSRC / "flash_attention.cu").read_text()
    assert (ab.variant_source(name) == shipped) == (name == "shipped")
