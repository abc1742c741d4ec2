"""The port's pipeline schedules (parallel/pipeline.py,
parallel/pipeline_1f1b.py, parallel/interleave.py) and its pipelined ViT
(models/pipeline_vit.py) against the JAX package's, on the CPU, the
ranks as threads (tests/_torch_port.py `ranks`):

- the interleave tables, array for array against the reference's
  `build_tables` on its grid, replayed by `simulate`, with a bubble
  below flat 1F1B's;
- each rank's ticks: GPipe's F(i, m) at tick i + m, 1F1B's F at i + m
  (stages but the last) and B(i, m) at 2(P - 1) - i + m with the stash
  never above 2P - 1, the interleaved executor's ops where its tables
  put them; on a toy stage (x -> a x + b a stage) whose outputs and
  grads are known in closed form;
- vit_tiny_pipe against the sequential JAX model (its params through
  convert.py): forward (2e-5) and grads (5e-4) at pipe 4, M 2, and the
  forward under seq 2 (ring and Ulysses) x pipe 2 (2e-5);
- placements leaf by leaf against the reference's `_vit_pipe_rule`;
  `stack_stages`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import tree_flatten_with_path

from _torch_port import _perturb, ranks
from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu.parallel.interleave import (
    build_tables as jax_build_tables,
)
from ddp_practice_tpu.parallel.sharding_rules import (
    param_sharding_rules as jax_rules,
)
from ddp_practice_tpu_torch.config import MeshConfig
from ddp_practice_tpu_torch.convert import (
    _torch_name,
    flax_to_state_dict,
    load_flax_params,
)
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.parallel.interleave import build_tables, simulate
from ddp_practice_tpu_torch.parallel.mesh import (
    build_mesh,
    is_replica0,
    pipe_group,
    place,
    shard_state,
)
from ddp_practice_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stages,
)
from ddp_practice_tpu_torch.parallel.pipeline_1f1b import (
    pipeline_1f1b_loss_and_grad,
    pipeline_interleaved_loss_and_grad,
)
from ddp_practice_tpu_torch.parallel.sharding_rules import (
    layouts,
    param_sharding_rules,
)

GRID = [(2, 2, 4), (4, 2, 8), (2, 3, 4), (4, 3, 8)]


@pytest.mark.parametrize("P,V,M", GRID)
def test_interleave_tables_equal_the_references(P, V, M):
    got, want = build_tables(P, V, M), jax_build_tables(P, V, M)
    for field in ("kind", "chunk", "mb"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    simulate(got, P, V, M)
    flat = build_tables(P, 1, M)
    simulate(flat, P, 1, M)
    assert got.bubble_fraction() < flat.bubble_fraction()


# the toy stage: stage s maps x -> A[s] x + B[s] (scalars), so a chain
# of stages is affine and its grads are known
A = (1.5, -0.5, 2.0, 0.75, 1.25, -1.0, 0.5, 3.0)
B = (0.25, 1.0, -0.5, 0.125, -0.25, 0.5, 2.0, -1.0)


def _toy(P, i, V=1):
    """Rank i's stage `fn(x, v)` (logical stage v P + i) and its
    parameters (a, b per chunk)."""
    a = [torch.tensor(A[v * P + i], requires_grad=True) for v in range(V)]
    b = [torch.tensor(B[v * P + i], requires_grad=True) for v in range(V)]

    def fn(x, v=0):
        return a[v] * x + b[v]

    return fn, a, b


def _chain(S):
    """The composed affine map of S stages: (slope, intercept)."""
    slope, icpt = 1.0, 0.0
    for s in range(S):
        slope, icpt = A[s] * slope, A[s] * icpt + B[s]
    return slope, icpt


def _inputs(M, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(M * 2, 3)).astype(np.float32))


@pytest.mark.parametrize("P,M", [(2, 2), (4, 4), (4, 2)])
def test_gpipe_ticks_and_outputs(P, M):
    """GPipe: rank i runs F(i, m) at tick i + m and nothing else; every
    rank gets the last stage's outputs; the sum of the outputs'
    grads reaches every stage's parameters (a, b) and the input."""
    x = _inputs(M)
    slope, icpt = _chain(P)

    def rank(r):
        pp = pipe_group(build_mesh(MeshConfig(pipe=P), "cpu"))
        fn, a, b = _toy(P, pp.rank)
        xin = x.clone().requires_grad_(True)
        trace = []
        y = pipeline_apply(fn, xin, pipe=pp, num_microbatches=M,
                           remat=True, trace=trace)
        y.sum().backward()
        return trace, y.detach(), xin.grad, float(a[0].grad)

    for i, (trace, y, dx, da) in enumerate(ranks(rank, P)):
        assert trace == [(i + m, "F", m) for m in range(M)]
        torch.testing.assert_close(y, slope * x + icpt)
        torch.testing.assert_close(dx, torch.full_like(x, slope))
        # d/da_i of sum(y): the input of stage i times the later slopes
        pre_s, pre_i = _chain(i)
        post = slope / (pre_s * A[i])
        want = post * float((pre_s * x + pre_i).sum())
        np.testing.assert_allclose(da, want, rtol=1e-5)


def _head_loss(y, tgt, wgt):
    """Loss sum of the toy head: sum w (y - t)^2 / 2; aux its weight."""
    return (wgt * (y - tgt) ** 2).sum() / 2, {"weight": wgt.sum()}


@pytest.mark.parametrize("P,M", [(2, 2), (4, 4), (4, 8)])
def test_1f1b_ticks_stash_and_grads(P, M):
    """1F1B: F(i, m) at tick i + m on the stages but the last, B(i, m) at
    2(P - 1) - i + m; the stash never holds more than 2P - 1 inputs
    (at most 2(P - 1 - i) + 1 on rank i); the loss sum and the grads of
    the stage parameters and the inputs are the closed form's."""
    x = _inputs(M)
    tgt = _inputs(M, seed=1)
    w = torch.ones_like(x)
    slope, icpt = _chain(P)

    def rank(r):
        pp = pipe_group(build_mesh(MeshConfig(pipe=P), "cpu"))
        fn, a, b = _toy(P, pp.rank)
        trace = []
        xs = x.reshape(M, 2, 3).unbind(0) if pp.first else None
        loss, aux, dxs = pipeline_1f1b_loss_and_grad(
            lambda xx, v: fn(xx), _head_loss, xs,
            tgt.reshape(M, 2, 3).unbind(0), w.reshape(M, 2, 3).unbind(0),
            pipe=pp, mb_shape=(2, 3), device="cpu", trace=trace)
        return (trace, float(loss), float(aux["weight"]),
                None if dxs is None else torch.cat(dxs), float(b[0].grad))

    y = slope * x + icpt
    want_loss = float(((y - tgt) ** 2).sum() / 2)
    res = ranks(rank, P)
    for i, (trace, loss, wsum, dx, db) in enumerate(res):
        f = [(t, m) for t, k, _, m, _ in trace if k == "F"]
        bw = [(t, m) for t, k, _, m, _ in trace if k == "B"]
        assert f == ([] if i == P - 1 else [(i + m, m) for m in range(M)])
        assert bw == [(2 * (P - 1) - i + m, m) for m in range(M)]
        assert max(n for *_, n in trace) <= min(2 * (P - 1 - i) + 1,
                                                 2 * P - 1)
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        assert wsum == x.numel()
        # d loss / d b_i = sum of (y - t) times the slopes after stage i
        after = slope / _chain(i + 1)[0]
        np.testing.assert_allclose(db, after * float((y - tgt).sum()),
                                   rtol=1e-5)
        if i == 0:
            torch.testing.assert_close(dx, slope * (y - tgt))
        else:
            assert dx is None


@pytest.mark.parametrize("P,V,M", [(2, 2, 4), (4, 2, 8)])
def test_interleaved_executor_follows_its_tables(P, V, M):
    """The interleaved executor runs each rank's op (F or B, chunk,
    microbatch) at the tick its table row gives, and its loss and input
    cotangents are the closed form's over V P stages."""
    x = _inputs(M)
    tgt = _inputs(M, seed=2)
    w = torch.ones_like(x)
    slope, icpt = _chain(V * P)
    tables = build_tables(P, V, M)

    def rank(r):
        pp = pipe_group(build_mesh(MeshConfig(pipe=P), "cpu"))
        fn, _, _ = _toy(P, pp.rank, V)
        trace = []
        xs = x.reshape(M, 2, 3).unbind(0) if pp.first else None
        loss, _, dxs = pipeline_interleaved_loss_and_grad(
            fn, _head_loss, xs, tgt.reshape(M, 2, 3).unbind(0),
            w.reshape(M, 2, 3).unbind(0), pipe=pp, num_virtual=V,
            mb_shape=(2, 3), device="cpu", trace=trace)
        return trace, float(loss), None if dxs is None else torch.cat(dxs)

    y = slope * x + icpt
    for i, (trace, loss, dx) in enumerate(ranks(rank, P)):
        want = [(t, "F" if tables.kind[t, i] == 1 else "B",
                 int(tables.chunk[t, i]), int(tables.mb[t, i]))
                for t in range(tables.ticks) if tables.kind[t, i]]
        assert [e[:4] for e in trace] == want
        np.testing.assert_allclose(loss, float(((y - tgt) ** 2).sum() / 2),
                                   rtol=1e-5)
        if i == 0:
            torch.testing.assert_close(dx, slope * (y - tgt))


def test_stack_stages():
    leaves = {"w": torch.arange(24.0).reshape(6, 4)}
    out = stack_stages(leaves, 3)
    assert out["w"].shape == (3, 2, 4)
    torch.testing.assert_close(out["w"][1], leaves["w"][2:4])
    with pytest.raises(ValueError, match="not divisible by 4 stages"):
        stack_stages(leaves, 4)


VIT = dict(depth=4, hidden_dim=32, num_heads=4, mlp_dim=64, patch_size=4)


@pytest.fixture(scope="module")
def vit_ref():
    """The sequential JAX vit_tiny_pipe on 16x16 images: params, images,
    logits and the grads of sum(logits^2) (port names)."""
    jm = jax_create_model("vit_tiny_pipe", num_stages=1, **VIT)
    x = np.random.default_rng(0).uniform(size=(8, 16, 16, 3)).astype(
        np.float32)
    params = _perturb(jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"]),
        np.random.default_rng(3))

    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(logits ** 2), logits

    (_, logits), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return dict(params=params, x=x, logits=np.asarray(logits),
                grads=flax_to_state_dict(jax.device_get(g)))


def _vit_rank(vit_ref, mesh: dict, grads: bool, **kw):
    def rank(r):
        model = create_model("vit_tiny_pipe", device="cpu",
                             image_shape=(16, 16, 3), num_microbatches=2,
                             **VIT, **kw)
        load_flax_params(model, vit_ref["params"])
        shard_state(model, build_mesh(MeshConfig(**mesh), "cpu"),
                    param_sharding_rules("vit_tiny_pipe"), "vit_tiny_pipe")
        x = torch.from_numpy(vit_ref["x"])
        if not grads:
            with torch.no_grad():
                return model(x).numpy()
        logits = model(x)
        (logits ** 2).sum().backward()
        import torch.distributed as tdist

        sharding, out = model.sharding, {}
        for name, p in model.named_parameters():
            whole = torch.zeros(sharding.layouts[name].shape)
            if is_replica0(sharding, name):
                place(p.grad, sharding, name, whole)
            tdist.all_reduce(whole)
            out[name] = whole
        return logits.detach().numpy(), out

    return rank


def test_vit_pipe_forward_and_grads_match_sequential(vit_ref):
    res = ranks(_vit_rank(vit_ref, dict(pipe=4), True, num_stages=4), 4)
    for logits, grads in res:
        np.testing.assert_allclose(logits, vit_ref["logits"], rtol=2e-5,
                                   atol=2e-5)
        assert set(grads) == set(vit_ref["grads"])
        for name, want in vit_ref["grads"].items():
            np.testing.assert_allclose(grads[name].numpy(), want.numpy(),
                                       rtol=5e-4, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_vit_pipe_composes_sequence_parallelism(vit_ref, sp_impl):
    """seq 2 x pipe 2: ring or Ulysses attention inside each stage; every
    rank's logits are the sequential model's."""
    rank = _vit_rank(vit_ref, dict(seq=2, pipe=2), False, num_stages=2,
                     seq_axis="seq", sp_impl=sp_impl)
    for logits in ranks(rank, 4):
        np.testing.assert_allclose(logits, vit_ref["logits"], rtol=2e-5,
                                   atol=2e-5)


def test_placements_equal_the_references_vit_pipe_rule():
    tree = jax.eval_shape(
        jax_create_model("vit_tiny_pipe", num_stages=1, **VIT).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    model = create_model("vit_tiny_pipe", device="cpu", num_stages=4,
                         image_shape=(16, 16, 3), **VIT)
    lay = layouts(model)
    ref, port = jax_rules("vit_tiny_pipe"), param_sharding_rules(
        "vit_tiny_pipe")
    flat = tree_flatten_with_path(tree)[0]
    assert len(flat) == len(lay)
    cut = 0
    for path, leaf in flat:
        tname = _torch_name(tuple(k.key for k in path))
        layout = lay[tname]
        assert layout.ref_shape == tuple(leaf.shape), tname
        want = layout.from_ref(ref(path, leaf))
        got = port(tname, layout) or layout.unsharded()
        assert got == want, tname
        cut += got != layout.unsharded()
    assert cut == sum(1 for n in lay if n.startswith("blocks."))
