"""The port's fused encoder layer (ddp_practice_tpu_torch/ops/fused_encoder.py)
on the CPU, where it runs its plain version:

- `fused_encoder_plain` and `fused_encoder_backward_plain` against the JAX
  package's `fused_encoder_layer` (its Pallas kernels in interpret mode, as
  tests/test_fused_encoder.py runs them) and against the unfused flax
  `EncoderBlock` under autodiff, from the same numpy inputs and the same
  weights through `convert.py`: fp32, bidirectional and causal, 2e-5 forward
  and 2e-4 grads (3e-4 causal), the reference tests' tolerances;
- a bf16 case against the JAX fused layer computing in bf16: both round at
  the same points, but sums run in another order, so a rounding can flip by
  one bf16 ulp (2^-8 relative) at each of ~10 stages; held to 2e-2 of each
  tensor's largest magnitude per element and 1e-2 in relative error norm;
- `fused_encoder_layer` as a torch.autograd.Function against autograd of the
  port's unfused `EncoderBlock`, for `bwd_impl` "kernel" and "reference";
- an emulation of kernel I's schedule: persistent blocks that each take
  sequences b, b + grid, ..., keep an fp32 partial of the vector grads
  (reduced in block order) and write the weight grads' operands, whose
  four products run through kernel K's emulation (one group, fp32 output,
  rows split into work units); it must give the whole batch's grads (the
  plain version's, and in fp32 the JAX fused layer's), the same bits on
  every run, whatever the grid and the unit size;
- the shared-memory plan and the port's own predicate: ViT-Tiny and the
  reference tests' shapes are admitted, wide models, long sequences and
  head_dim 32 are refused with the limit named, and `impl="kernel"` on a
  CPU tensor raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from ddp_practice_tpu.models.vit import EncoderBlock as JaxBlock
from ddp_practice_tpu.ops.fused_encoder import (
    fused_encoder_layer as jax_fused_layer,
)
from ddp_practice_tpu_torch.convert import flax_to_state_dict
from ddp_practice_tpu_torch.models.vit import EncoderBlock
from ddp_practice_tpu_torch.ops import fused_encoder as fe
from ddp_practice_tpu_torch.ops import grouped_matmul as gm

SHAPES = {
    # name: (imgs, s, d, heads, mlp, causal)
    "bidirectional": (3, 32, 128, 2, 256, False),
    "causal_lm": (2, 32, 128, 2, 128, True),
}


def _setup(imgs, s, d, heads, mlp, causal, seed=0):
    """(jax block, flax params with every leaf off its init value, torch
    leaves in PARAM_NAMES order, x, cotangent)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((imgs, s, d)).astype(np.float32)
    g = rng.standard_normal((imgs, s, d)).astype(np.float32)
    block = JaxBlock(heads, mlp, causal=causal)
    params = jax.device_get(jax.jit(block.init)(
        jax.random.PRNGKey(seed), jnp.asarray(x[:1]))["params"])
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), params)
    sd = flax_to_state_dict(params)
    leaves = [sd[name] for name in fe.PARAM_NAMES]
    return block, params, leaves, x, g


def _jax_grads(fn, params, x, g):
    """fn(params, x)'s output and the grads of sum(out * g), as numpy and
    a port-named dict."""
    def run(p, xx, gg):
        out, vjp = jax.vjp(fn, p, xx)
        return (out,) + vjp(gg.astype(out.dtype))

    out, dparams, dx = jax.jit(run)(params, jnp.asarray(x), jnp.asarray(g))
    return (np.asarray(out, np.float32), np.asarray(dx, np.float32),
            flax_to_state_dict(jax.device_get(dparams)))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("against", ["jax_fused", "flax_unfused"])
def test_plain_matches_jax_fp32(shape, against):
    imgs, s, d, heads, mlp, causal = SHAPES[shape]
    block, params, leaves, x, g = _setup(*SHAPES[shape])
    if against == "jax_fused":
        def fn(p, xx):
            return jax_fused_layer(xx, p, num_heads=heads,
                                   compute_dtype=jnp.float32, causal=causal)
    else:
        def fn(p, xx):
            return block.apply({"params": p}, xx)
    want_out, want_dx, want = _jax_grads(fn, params, x, g)
    kw = dict(num_heads=heads, compute_dtype=torch.float32, causal=causal)
    out = fe.fused_encoder_forward(torch.from_numpy(x), leaves, **kw)
    dx, grads = fe.fused_encoder_backward(
        torch.from_numpy(x), torch.from_numpy(g), leaves, **kw)
    assert fe.LAUNCHES == {"fused_encoder_fwd": 0, "fused_encoder_bwd": 0}
    np.testing.assert_allclose(out.numpy(), want_out, rtol=2e-5, atol=2e-5)
    tol = 3e-4 if causal else 2e-4
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=tol, atol=tol)
    for name, got in zip(fe.PARAM_NAMES, grads):
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=tol,
                                   atol=tol, err_msg=name)


def test_plain_matches_jax_at_vit_tiny_width():
    """The ViT-Tiny layer (d 192, 3 heads of 64, mlp 768, s 64) against the
    unfused flax block, forward and grads."""
    shape = (2, 64, 192, 3, 768, False)
    block, params, leaves, x, g = _setup(*shape, seed=1)
    want_out, want_dx, want = _jax_grads(
        lambda p, xx: block.apply({"params": p}, xx), params, x, g)
    kw = dict(num_heads=3, compute_dtype=torch.float32)
    out = fe.fused_encoder_plain(torch.from_numpy(x), leaves, **kw)
    dx, grads = fe.fused_encoder_backward_plain(
        torch.from_numpy(x), torch.from_numpy(g), leaves, **kw)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=2e-4, atol=2e-4)
    for name, got in zip(fe.PARAM_NAMES, grads):
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


def test_plain_matches_jax_bf16():
    imgs, s, d, heads, mlp, causal = SHAPES["bidirectional"]
    _, params, leaves, x, g = _setup(*SHAPES["bidirectional"], seed=2)
    xb = jnp.asarray(x, jnp.bfloat16)
    want_out, want_dx, want = _jax_grads(
        lambda p, xx: jax_fused_layer(xx, p, num_heads=heads,
                                      compute_dtype=jnp.bfloat16),
        params, np.asarray(xb), g)
    xt = torch.from_numpy(x).bfloat16()
    kw = dict(num_heads=heads, compute_dtype=torch.bfloat16)
    out = fe.fused_encoder_forward(xt, leaves, **kw)
    dx, grads = fe.fused_encoder_backward(
        xt, torch.from_numpy(g), leaves, **kw)
    assert out.dtype == dx.dtype == torch.bfloat16
    assert all(gr.dtype == torch.float32 for gr in grads)

    def held(got, ref, name):
        got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 2e-2 * scale, name
        assert (np.linalg.norm(got - ref)
                <= 1e-2 * np.linalg.norm(ref)), name

    held(out.float().numpy(), want_out, "out")
    held(dx.float().numpy(), want_dx, "dx")
    for name, got in zip(fe.PARAM_NAMES, grads):
        held(got.numpy(), want[name].numpy(), name)


def _torch_block(leaves, d, heads, mlp, causal, **kw):
    block = EncoderBlock(d, heads, mlp, causal=causal, **kw)
    with torch.no_grad():
        for name, value in zip(fe.PARAM_NAMES, leaves):
            block.get_parameter(name).copy_(value)
    return block


@pytest.mark.parametrize("bwd_impl", ["kernel", "reference"])
@pytest.mark.parametrize("causal", [False, True])
def test_layer_function_matches_unfused_block(bwd_impl, causal):
    imgs, s, d, heads, mlp = 2, 32, 128, 2, 256
    _, _, leaves, x, g = _setup(imgs, s, d, heads, mlp, causal, seed=3)
    block = _torch_block(leaves, d, heads, mlp, causal)
    xt = torch.from_numpy(x).requires_grad_(True)
    want_out = block(xt)
    want = torch.autograd.grad(want_out, [xt, *fe.block_params(block)],
                               torch.from_numpy(g))

    def reference_apply(ps, xx):
        return torch.func.functional_call(
            block, dict(zip(fe.PARAM_NAMES, ps)), (xx,))

    ps = [p.detach().clone().requires_grad_(True) for p in leaves]
    x2 = torch.from_numpy(x).requires_grad_(True)
    out = fe.fused_encoder_layer(
        x2, ps, num_heads=heads, compute_dtype=torch.float32, causal=causal,
        bwd_impl=bwd_impl, reference_apply=reference_apply)
    got = torch.autograd.grad(out, [x2, *ps], torch.from_numpy(g))
    torch.testing.assert_close(out, want_out, rtol=2e-5, atol=2e-5)
    tol = 3e-4 if causal else 2e-4
    for name, a, b in zip(("x",) + fe.PARAM_NAMES, got, want):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=name)


def test_layer_function_checks_its_arguments():
    _, _, leaves, x, _ = _setup(1, 16, 64, 1, 64, False)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="bwd_impl"):
        fe.fused_encoder_layer(xt, leaves, num_heads=1, bwd_impl="auto")
    with pytest.raises(ValueError, match="reference_apply"):
        fe.fused_encoder_layer(xt, leaves, num_heads=1,
                               bwd_impl="reference")
    with pytest.raises(ValueError, match="CUDA kernels"):
        fe.fused_encoder_forward(xt, leaves, num_heads=1, impl="kernel")
    with pytest.raises(ValueError, match="head_dim a multiple of 64"):
        fe.fused_encoder_plain(xt, leaves, num_heads=2)
    with fe.forced_impl("plain"):
        out = fe.fused_encoder_forward(xt, leaves, num_heads=1,
                                       compute_dtype=torch.float32,
                                       impl="kernel")
    assert out.shape == xt.shape


def _scheduled_backward(x, g, leaves, grid, chunk, **kw):
    """Kernel I's schedule in torch: block b takes sequences b, b + grid,
    ...; each sequence's pass (the plain version on its real rows: the
    kernel pads them to a multiple of 16 with zero cotangents and masked
    keys) gives its dx rows, adds its vector grads into the block's fp32
    partial and writes the weight grads' operands, rounded to the compute
    dtype, into per-layer (tokens, width) buffers; the partials are summed
    in block order, and each weight grad is one kernel K product with one
    group over all tokens (tgmm_emulated: fp32 output, `chunk` rows a work
    unit, the units' partials summed in order)."""
    imgs, s, d = x.shape
    cd = kw["compute_dtype"]
    vsz = 9 * d + leaves[9].shape[0]
    partial = torch.zeros((grid, vsz))
    dx = torch.empty_like(x)
    ops, gt = {}, torch.empty((imgs * s, d), dtype=cd)
    for b in range(grid):
        for img in range(b, imgs, grid):
            one_dx, vec, one_ops, one_g = fe.backward_parts(
                x[img:img + 1], g[img:img + 1], leaves, **kw)
            dx[img] = one_dx[0]
            partial[b] += torch.cat(vec)
            rows = slice(img * s, (img + 1) * s)
            for name, value in one_ops.items():
                ops.setdefault(name, torch.empty(
                    (imgs * s, value.shape[1]), dtype=cd))[rows] = value
            gt[rows] = one_g
    vec = torch.zeros(vsz)
    for b in range(grid):          # the reduce kernel's fixed order
        vec += partial[b]
    one = torch.tensor([imgs * s], dtype=torch.int32)
    mats = [gm.tgmm_emulated(lhs, rhs, one, out_dtype=torch.float32,
                             chunk=chunk)[0]
            for lhs, rhs in ((ops["dqkv"], ops["y1"]), (ops["dx2"], ops["o"]),
                             (ops["dh"], ops["y2"]), (gt, ops["hg"]))]
    return dx, fe.assemble_grads(vec, mats, leaves)


@pytest.mark.parametrize("grid,chunk,dtype", [
    (1, 4096, torch.float32), (3, 64, torch.float32),
    (7, 32, torch.float32), (3, 64, torch.bfloat16)])
def test_block_schedule_gives_the_batch_grads(grid, chunk, dtype):
    """The schedule against the plain version (fp32: dx 1e-5, grads 1e-4,
    sums in another order; bf16: the same rounding points, so one bf16
    rounding can flip by an ulp and pass through later products: 2e-2 of
    the tensor's largest magnitude) and, in fp32, against the JAX fused
    layer at the reference tests' 3e-4 (causal). Two runs give the same
    bits."""
    imgs, s, d, heads, mlp, causal = 7, 20, 64, 1, 48, True
    block, params, leaves, x, g = _setup(imgs, s, d, heads, mlp, causal,
                                         seed=4)
    kw = dict(num_heads=heads, compute_dtype=dtype, causal=causal)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    want_dx, want = fe.fused_encoder_backward_plain(xt, gt, leaves, **kw)
    dx, grads = _scheduled_backward(xt, gt, leaves, grid, chunk, **kw)
    again_dx, again = _scheduled_backward(xt, gt, leaves, grid, chunk, **kw)
    assert torch.equal(dx, again_dx)
    pairs = [("dx", dx, want_dx)] + list(zip(fe.PARAM_NAMES, grads, want))
    for name, a, b in pairs:
        if dtype == torch.float32:
            tol = 1e-5 if name == "dx" else 1e-4
            torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=name)
        else:
            scale = max(1.0, float(b.abs().max()))
            assert float((a - b).abs().max()) <= 2e-2 * scale, name
    for name, a, c in zip(fe.PARAM_NAMES, grads, again):
        assert torch.equal(a, c), name
    if dtype == torch.float32:
        jfn = (lambda p, xx: jax_fused_layer(
            xx, p, num_heads=heads, causal=causal,
            compute_dtype=jnp.float32))
        _, jdx, jgrads = _jax_grads(jfn, params, x, g)
        np.testing.assert_allclose(dx.numpy(), jdx, rtol=3e-4, atol=3e-4)
        for name, a in zip(fe.PARAM_NAMES, grads):
            np.testing.assert_allclose(a.numpy(), jgrads[name].numpy(),
                                       rtol=3e-4, atol=3e-4, err_msg=name)


def test_plan_places_vit_tiny_in_shared_memory():
    for backward in (False, True):
        plan = fe._plan(64, 192, 3, 768, 2, backward)
        assert plan.smem_bytes <= fe.SMEM_LIMIT
        spilled = {b for b in range(fe.N_BUFFERS) if plan.in_scratch[b]}
        # kernel I's two weight slots stay in shared memory at the cost of
        # the fp32 dy buffer; the fp32 residual streams, touched once per
        # element, spill too
        assert spilled <= {fe.B_DY, fe.B_XR, fe.B_DX2}, spilled
        assert all(off % 128 == 0 for off in plan.offset)
        assert plan.chunk % 16 == 0 and plan.ws >= 3 * 64
        assert 2 * plan.chunk <= plan.ws or not backward
    fwd = fe._plan(64, 192, 3, 768, 2, False)
    assert not any(fwd.in_scratch) and fwd.ld[fe.B_W] == 0
    bwd = fe._plan(64, 192, 3, 768, 2, True)
    # a slot holds an (hd, d) or a (d, hd) block at padded pitch
    assert bwd.ld[fe.B_W] == max(64 * 200, 192 * 72)
    assert bwd.chunk == 64
    # fp32 operands are twice as wide: more spills, same code path
    assert fe._plan(64, 192, 3, 768, 4, True).scratch_bytes > \
        fe._plan(64, 192, 3, 768, 2, True).scratch_bytes
    # a ragged length pads to the next multiple of 16
    assert fe._plan(49, 192, 3, 768, 2, True) == fe._plan(64, 192, 3, 768,
                                                          2, True)


@pytest.mark.parametrize("seq_len,d,mlp,heads,dtype,ok", [
    (64, 192, 768, 3, torch.bfloat16, True),      # ViT-Tiny
    (64, 192, 768, 3, torch.float32, True),
    (32, 128, 128, 2, torch.float32, True),       # the causal test shape
    (128, 256, 1024, 4, torch.bfloat16, True),    # lm_tiny with 4 heads
    (128, 256, 1024, 4, torch.float32, True),
    (49, 192, 768, 3, torch.bfloat16, True),      # 28x28 images, patch 4
    (64, 768, 3072, 12, torch.bfloat16, False),   # vit_base: weights
    (2048, 768, 3072, 12, torch.bfloat16, False),  # lm_base
    (2048, 256, 1024, 4, torch.bfloat16, False),  # long: staging tile
    (64, 192, 768, 6, torch.bfloat16, False),     # head_dim 32
    (64, 192, 776, 3, torch.bfloat16, False),     # mlp % 16
    (64, 192, 768, 3, torch.float16, False),
])
def test_shape_predicate(seq_len, d, mlp, heads, dtype, ok):
    kw = dict(seq_len=seq_len, d=d, mlp_dim=mlp, num_heads=heads,
              compute_dtype=dtype)
    assert fe.fused_shape_supported(**kw) is ok
    err = fe.shape_error(seq_len, d, mlp, heads, dtype)
    assert (err is None) is ok
    if not ok:
        assert any(word in err for word in (
            "MiB", "shared memory", "head_dim", "multiple of 16",
            "float32 or bfloat16"))
