"""The port's flash attention (ddp_practice_tpu_torch/ops/flash_attention.py,
plain path on the CPU) against the JAX package's Pallas kernels in
interpret mode, from the same numpy inputs: forward and every gradient,
fp32, at the reference tests' tolerances (tests/test_flash_attention.py):
forward 2e-5, grads 1e-4 on the folded route and 2e-4 on the packed one.

`block_q=block_k=32` makes the JAX side sweep several blocks (s=64 and
s=96, so the online softmax crosses tiles and s=96 fits 32 exactly); the
port's plain version runs the same tiles. Routing (packed vs folded) and
the launch counts are checked with the launches replaced by their plain
versions, since no card is here; the kernels themselves are held to the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_practice_tpu.ops import flash_attention as jfa
from ddp_practice_tpu_torch.ops import flash_attention as fa

FWD_TOL = 2e-5
GRAD_TOL = {"folded": 1e-4, "packed": 2e-4}
BLOCKS = dict(block_q=32, block_k=32)


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _both(jax_fn, torch_fn, arrays, weights):
    """Value and grads of sum(out * w) (+ sum(lse * w_lse)) on both
    sides; returns ((jax out, jax grads), (torch out, torch grads))."""

    def jloss(*xs):
        out = jax_fn(*xs)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights)), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(arrays))), has_aux=True)(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = torch_fn(*ts)
    touts = tout if isinstance(tout, tuple) else (tout,)
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(touts, weights)
        ).backward()
    return (jout, jgrads), (tout, [t.grad for t in ts])


@pytest.mark.parametrize("s", [64, 96])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("h,d", [(4, 32), (2, 64), (1, 128)])
def test_flash_attention_matches_jax(h, d, causal, s):
    b = 2
    route = "packed" if fa._heads_per_pack(h, d) else "folded"
    assert route == ("packed" if jfa._heads_per_pack(h, d) else "folded")
    arrays = _inputs([(b, s, h, d)] * 3, seed=h * 100 + s + causal)
    (w,) = _inputs([(b, s, h, d)], seed=7)
    (jout, jg), (tout, tg) = _both(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal, **BLOCKS),
        lambda q, k, v: fa.flash_attention(q, k, v, causal=causal, **BLOCKS),
        arrays, [w])
    _close(tout.detach(), jout, FWD_TOL)
    for a, b_ in zip(tg, jg):
        _close(a, b_, GRAD_TOL[route])


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_qkv_matches_jax(causal):
    b, s, h, d = 2, 96, 2, 64
    (qkv, w) = _inputs([(b, s, 3 * h * d), (b, s, h, d)], seed=11 + causal)
    (jout, jg), (tout, tg) = _both(
        lambda x: jfa.flash_attention_qkv(x, h, causal=causal, **BLOCKS),
        lambda x: fa.flash_attention_qkv(x, h, causal=causal, **BLOCKS),
        [qkv], [w])
    _close(tout.detach(), jout, FWD_TOL)
    _close(tg[0], jg[0], GRAD_TOL["packed"])


def test_flash_attention_qkv_unpackable_heads_match_jax():
    b, s, h, d = 2, 64, 3, 32
    (qkv, w) = _inputs([(b, s, 3 * h * d), (b, s, h, d)], seed=13)
    (jout, jg), (tout, tg) = _both(
        lambda x: jfa.flash_attention_qkv(x, h, causal=True, **BLOCKS),
        lambda x: fa.flash_attention_qkv(x, h, causal=True, **BLOCKS),
        [qkv], [w])
    _close(tout.detach(), jout, FWD_TOL)
    _close(tg[0], jg[0], GRAD_TOL["folded"])


@pytest.mark.parametrize("sq,sk,causal", [(32, 64, True), (64, 64, False)])
def test_flash_attention_with_lse_matches_jax(sq, sk, causal):
    """Folded (b*h, s, d) with a loss on lse as well as out: the lse
    cotangent folds into delta. s_q < s_k causal is bottom-right aligned."""
    bh, d = 4, 32
    q, k, v, w, w_lse = _inputs(
        [(bh, sq, d), (bh, sk, d), (bh, sk, d), (bh, sq, d), (bh, sq)],
        seed=17 + sq)
    (jout, jg), (tout, tg) = _both(
        lambda q, k, v: jfa.flash_attention_with_lse(
            q, k, v, causal=causal, **BLOCKS),
        lambda q, k, v: fa.flash_attention_with_lse(
            q, k, v, causal=causal, **BLOCKS),
        [q, k, v], [w, w_lse])
    _close(tout[0].detach(), jout[0], FWD_TOL)
    _close(tout[1].detach(), jout[1], FWD_TOL)
    for a, b_ in zip(tg, jg):
        _close(a, b_, GRAD_TOL["folded"])


def test_reference_value_errors():
    q = torch.zeros((1, 64, 2, 64))
    k = torch.zeros((1, 32, 2, 64))
    with pytest.raises(ValueError, match="seq_q <= seq_k"):
        fa.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="seq_q <= seq_k"):
        fa.flash_attention_with_lse(torch.zeros((2, 64, 32)),
                                    torch.zeros((2, 32, 32)),
                                    torch.zeros((2, 32, 32)), causal=True)
    with pytest.raises(ValueError, match="not 3\\*h\\*d"):
        fa.flash_attention_qkv(torch.zeros((1, 8, 100)), 2)


def test_fit_block_matches_reference():
    for seq, block in ((1536, 1024), (65, 512), (96, 64), (2048, 1024),
                       (96, 32)):
        assert fa._fit_block(seq, block) == jfa._fit_block(seq, block)


@pytest.fixture
def fake_launches(monkeypatch):
    """Route as on the card, with each launch doing the plain version's
    work into the kernel's output views (no card here)."""

    def fwd(q4, k4, v4, out4, causal):
        o, lse = fa.flash_attention_plain(q4, k4, v4, causal=causal)
        out4.copy_(o)
        return lse

    def bwd(q4, k4, v4, o4, do4, lse, glse, dq4, dk4, dv4, causal):
        for dst, src in zip((dq4, dk4, dv4), fa.flash_attention_plain_bwd(
                q4, k4, v4, o4, do4, lse, glse, causal=causal)):
            dst.copy_(src)

    monkeypatch.setattr(fa, "_use_kernel", lambda impl, x: True)
    monkeypatch.setattr(fa, "_launch_fwd", fwd)
    monkeypatch.setattr(fa, "_launch_bwd", bwd)
    fa.reset_launches()
    yield
    fa.reset_launches()


@pytest.mark.parametrize("h,d,row", [(2, 64, "packed"), (1, 128, "packed"),
                                     (4, 32, "folded"), (3, 64, "folded")])
def test_routes_count_their_rows(fake_launches, h, d, row):
    """Packable heads launch the packed row, others the folded row (the
    reference's predicates), once per forward and once per backward; the
    strided kernel route gives the plain route's values and grads."""
    b, s = 2, 32
    (qkv,) = _inputs([(b, s, 3 * h * d)], seed=h + d)
    x = torch.tensor(qkv, requires_grad=True)
    out = fa.flash_attention_qkv(x, h, causal=True)
    out.square().sum().backward()
    other = "folded" if row == "packed" else "packed"
    assert fa.LAUNCHES[f"flash_fwd_{row}"] == 1
    assert fa.LAUNCHES[f"flash_bwd_{row}"] == 1
    assert fa.LAUNCHES[f"flash_fwd_{other}"] == 0
    y = torch.tensor(qkv, requires_grad=True)
    want = fa.flash_attention_qkv(y, h, causal=True, impl="plain")
    want.square().sum().backward()
    _close(out.detach(), want.detach(), 1e-6)
    _close(x.grad, y.grad, 1e-6)


def test_kernels_need_a_card():
    q = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="launches the CUDA kernels"):
        fa.flash_attention(q, q, q, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        fa.flash_attention(q, q, q, impl="fast")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        fa._library()


def test_forced_impl_overrides_every_entry_inside_its_block():
    """A model built with the default impl runs what `forced_impl` says:
    "kernel" reaches the launch (and refuses a CPU tensor), "plain" runs
    the plain version; the override ends with the block."""
    from ddp_practice_tpu_torch.models import create_model

    model = create_model("lm_tiny", device="cpu", seed=0, vocab_size=16,
                         hidden_dim=64, depth=1, num_heads=1, mlp_dim=64,
                         max_len=8, attn_impl="flash")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with fa.forced_impl("kernel"):
        with pytest.raises(ValueError, match="launches the CUDA kernels"):
            model(tokens)
    with fa.forced_impl("plain"):
        plain = model(tokens)
    torch.testing.assert_close(model(tokens), plain, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown impl"):
        with fa.forced_impl("fast"):
            pass


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_scale_rounds_like_the_reference(d, dtype):
    """The reference multiplies a q tile by the Python float 1/sqrt(d),
    which JAX first rounds to the tile's dtype (at d=128 in bf16,
    0.08837890625); the flash and decode wrappers pass that value."""
    from ddp_practice_tpu_torch.ops import decode_attention

    want = float(jnp.ones((), getattr(jnp, dtype)) * (1.0 / (d ** 0.5)))
    assert fa._scales(d, getattr(torch, dtype))[0] == want
    assert decode_attention._scales is fa._scales
