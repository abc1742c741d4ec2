"""The port's MoE slice (ddp_practice_tpu_torch/ops/moe.py, the routed
blocks of models/lm.py and models/vit_moe.py, the MoE parts of
train/steps.py) against the JAX package on the CPU, from seeded numpy
inputs and converted weights (router biases and expert biases moved off
their zero init so a layout slip cannot hide):

- every routing function's outputs, with ties (equal logits) broken the
  reference's way;
- `MoEMlp` einsum and gather, token choice and expert choice, whole-sequence,
  contiguous and strided routing groups: the output, the sown aux loss,
  load fractions and drop rate, the updated router bias, and the input and
  parameter grads, at the reference's tolerances (2e-5 forward, 5e-4
  grads, tests/test_moe.py:338-351);
- the sorted path (the grouped matmul's plain version) against the JAX
  einsum path at capacity factor E/k, where neither drops a token;
- lm_moe and vit_tiny_moe: forward and grads, and one training step
  (metrics including the moe_* ones, parameters, router biases) against
  the JAX step;
- the remat trap: a rematerialized lm_moe step (its routed blocks replayed
  in backward) gives the same loss, grads and router biases as one without
  remat, so the aux loss and the bias update happen once per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import _perturb, jit_quick
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu.ops import moe as jmoe
from ddp_practice_tpu.train.state import TrainState as JaxState
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu.train.steps import make_lm_train_step as jax_lm_step
from ddp_practice_tpu.train.steps import make_train_step as jax_image_step
from ddp_practice_tpu_torch.config import TrainConfig
from ddp_practice_tpu_torch.convert import flax_to_state_dict, load_flax_params
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.ops import moe as tmoe
from ddp_practice_tpu_torch.ops.losses import cross_entropy
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
from ddp_practice_tpu_torch.train.steps import (
    make_lm_train_step,
    make_train_step,
)

OUT = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=5e-4, atol=5e-4)
E, K, D, F = 4, 2, 16, 32


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _logits(seed, shape, ties=False):
    rng = np.random.default_rng(seed)
    if ties:          # few distinct values: many exact ties
        return rng.integers(0, 3, shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("ties", [False, True])
def test_topk_choices_and_permutation_match(ties):
    logits = _logits(0, (2, 16, E), ties)
    bias = np.array([0.1, -0.2, 0.0, 0.05], np.float32)
    want = jmoe.topk_choices(jnp.asarray(logits), k=K,
                             routing_bias=jnp.asarray(bias))
    got = tmoe.topk_choices(_t(logits), k=K, routing_bias=_t(bias))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), _np(b), **OUT)
    flat = np.asarray(want[0]).reshape(-1)
    jc, jd, ji = jmoe._assignment_permutation(jnp.asarray(flat), E)
    tc, td, ti = tmoe._assignment_permutation(_t(flat).long(), E)
    for a, b in ((tc, jc), (td, jd), (ti, ji)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert tc.dtype == torch.int32


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_top_k_routing_gating_and_slots_match(ties, bias):
    logits = _logits(1, (3, 12, E), ties)
    rb = np.array([0.3, -0.1, 0.2, 0.0], np.float32) if bias else None
    capacity = 5
    want = jmoe.top_k_routing(
        jnp.asarray(logits), k=K, capacity=capacity,
        routing_bias=None if rb is None else jnp.asarray(rb))
    got = tmoe.top_k_routing(_t(logits), k=K, capacity=capacity,
                             routing_bias=None if rb is None else _t(rb))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), _np(b), **OUT)
    choices, positions, keeps = (np.asarray(w) for w in want[:3])
    jt = jmoe._slot_tables(jnp.asarray(choices), jnp.asarray(positions),
                           jnp.asarray(keeps), E, capacity)
    tt = tmoe._slot_tables(_t(choices).long(), _t(positions).long(),
                           _t(keeps), E, capacity)
    for a, b in zip(tt, jt):
        assert np.array_equal(a.numpy(), np.asarray(b))
    jg = jmoe.top_k_gating(jnp.asarray(logits), k=K, capacity=capacity,
                           routing_bias=None if rb is None else
                           jnp.asarray(rb))
    tg = tmoe.top_k_gating(_t(logits), k=K, capacity=capacity,
                           routing_bias=None if rb is None else _t(rb))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), _np(b), **OUT)


@pytest.mark.parametrize("ties", [False, True])
def test_expert_choice_gating_matches(ties):
    logits = _logits(2, (2, 10, E), ties)
    want = jmoe.expert_choice_gating(jnp.asarray(logits), capacity=4)
    got = tmoe.expert_choice_gating(_t(logits), capacity=4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), **OUT)


# -------------------------------------------------------------- the layer
def _layer_pair(seed, x_shape, **kw):
    """(jax layer, jax variables, torch layer) with identical weights and
    a nonzero router bias."""
    jm = jmoe.MoEMlp(num_experts=E, top_k=K, mlp_dim=F, expert_axis=None,
                     **kw)
    args = (jax.random.PRNGKey(seed), jnp.zeros(x_shape, jnp.float32))
    # compiled, not run op by op: eagerly, init's forward took seconds
    variables = jax.device_get(jit_quick(jm.init, *args)(*args))
    rng = np.random.default_rng(seed)
    params = {k: (np.asarray(v, np.float32)
                  + rng.normal(0, 0.05, np.shape(v)).astype(np.float32)
                  if k.startswith("expert_b") else v)
              for k, v in variables["params"].items()}
    variables = {"params": params}
    tkw = {k: v for k, v in kw.items() if k not in ("impl", "router")}
    tm = tmoe.MoEMlp(D, num_experts=E, top_k=K, mlp_dim=F,
                     impl=kw.get("impl", "auto"),
                     router=kw.get("router", "topk"), **tkw)
    state = flax_to_state_dict(params)
    if kw.get("router", "topk") == "topk":
        rb = rng.normal(0, 0.1, (E,)).astype(np.float32)
        variables["batch_stats"] = {"router_bias": rb}
        state["router_bias"] = torch.from_numpy(rb)
    tm.load_state_dict(state, strict=True)
    return jm, jax.tree.map(jnp.asarray, variables), tm


def _jax_layer_run(jm, variables, x, w):
    mutable = ["intermediates"] + (
        ["batch_stats"] if "batch_stats" in variables else [])

    def loss(params, xx):
        v = dict(variables, params=params)
        y, mut = jm.apply(v, xx, mutable=mutable)
        aux = mut["intermediates"]["moe_aux_loss"][0]
        return jnp.sum(y * w) + aux, (y, mut)

    args = (variables["params"], x)
    (_, (y, mut)), (gp, gx) = jit_quick(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True), *args)(*args)
    return y, mut, gp, gx


def _torch_layer_run(tm, x, w):
    xs = _t(x).clone().requires_grad_()
    y = tm(xs, train=True)
    loss = (y * _t(w)).sum() + tm.sown["moe_aux_loss"]
    loss.backward()
    return y, xs.grad


LAYER_CASES = {
    "einsum_topk": dict(impl="einsum", capacity_factor=1.25),
    "einsum_topk_grouped": dict(impl="einsum", capacity_factor=1.0,
                                group_size=16, group_stride=False),
    "einsum_topk_strided": dict(impl="einsum", capacity_factor=1.5,
                                group_size=16),
    "einsum_expert_choice": dict(impl="einsum", router="expert_choice",
                                 capacity_factor=1.0),
    "einsum_expert_choice_strided": dict(impl="einsum",
                                         router="expert_choice",
                                         capacity_factor=2.0,
                                         group_size=16),
    "gather_topk": dict(impl="gather", capacity_factor=1.25),
    "gather_topk_strided": dict(impl="gather", capacity_factor=1.0,
                                group_size=16),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(case):
    kw = LAYER_CASES[case]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 64, D)).astype(np.float32)
    w = rng.normal(size=(2, 64, D)).astype(np.float32)
    jm, variables, tm = _layer_pair(3, x.shape, **kw)
    jy, mut, jgp, jgx = _jax_layer_run(jm, variables, jnp.asarray(x), w)
    y, gx = _torch_layer_run(tm, x, w)
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), **OUT)
    for name in ("moe_aux_loss", "moe_load_frac", "moe_drop_rate"):
        np.testing.assert_allclose(tm.sown[name].detach().numpy(),
                                   _np(mut["intermediates"][name][0]),
                                   err_msg=name, **OUT)
    if "batch_stats" in variables:
        np.testing.assert_allclose(
            tm.pending_bias.numpy(), _np(mut["batch_stats"]["router_bias"]),
            **OUT)
        before = tm.router_bias.clone()
        tm.commit_bias()
        assert not torch.equal(before, tm.router_bias)
        assert tm.sown is None and tm.pending_bias is None
    np.testing.assert_allclose(gx.numpy(), _np(jgx), **GRAD)
    want = flax_to_state_dict(jax.device_get(jgp))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD)


@pytest.mark.parametrize("group_size", [0, 16])
def test_sorted_matches_dropless_jax_einsum(group_size):
    """cf = E/k makes capacity = T: the einsum path drops nothing, and the
    sorted path (which ignores routing groups) computes the same function,
    router statistics and bias update included."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 64, D)).astype(np.float32)
    w = rng.normal(size=(2, 64, D)).astype(np.float32)
    jm, variables, tm = _layer_pair(
        4, x.shape, impl="einsum", capacity_factor=E / K,
        group_size=group_size)
    tm.impl = "sorted"
    jy, mut, jgp, jgx = _jax_layer_run(jm, variables, jnp.asarray(x), w)
    y, gx = _torch_layer_run(tm, x, w)
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), **OUT)
    for name in ("moe_aux_loss", "moe_load_frac", "moe_drop_rate"):
        np.testing.assert_allclose(tm.sown[name].detach().numpy(),
                                   _np(mut["intermediates"][name][0]),
                                   err_msg=name, **OUT)
    assert float(tm.sown["moe_drop_rate"]) == 0.0
    np.testing.assert_allclose(tm.pending_bias.numpy(),
                               _np(mut["batch_stats"]["router_bias"]), **OUT)
    np.testing.assert_allclose(gx.numpy(), _np(jgx), **GRAD)
    want = flax_to_state_dict(jax.device_get(jgp))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD)


def test_layer_contract_errors_capacity_and_eval():
    x = torch.zeros(1, 64, D)
    for kw, match in ((dict(impl="dense"), "moe impl"),
                      (dict(router="random"), "moe router"),
                      (dict(impl="sorted", router="expert_choice"),
                       "expert_choice routing runs on the einsum path")):
        with pytest.raises(ValueError, match=match):
            tmoe.MoEMlp(D, num_experts=E, mlp_dim=F, **kw)(x)
    with pytest.raises(ValueError, match="must divide"):
        tmoe.MoEMlp(D, num_experts=E, mlp_dim=F, group_size=48)(x)
    # capacity is the reference's max(1, int(cf * k * t / e)), Python int
    layer = tmoe.MoEMlp(D, num_experts=E, mlp_dim=F, capacity_factor=1.1)
    assert layer._capacity(30) == max(1, int(1.1 * K * 30 / E)) == 16
    assert tmoe.MoEMlp(D, num_experts=8, top_k=1,
                       capacity_factor=0.01)._capacity(8) == 1
    # eval routes with the current bias and records nothing
    layer(torch.randn(1, 8, D), train=False)
    assert layer.sown is None and layer.pending_bias is None
    with pytest.warns(UserWarning, match="exceeds the sequence"):
        tmoe.MoEMlp(D, num_experts=E, mlp_dim=F, group_size=128)(
            torch.randn(1, 8, D), train=True)


# ----------------------------------------------------------------- models
LM = dict(vocab_size=64, hidden_dim=64, depth=2, num_heads=1, mlp_dim=128,
          max_len=32, num_experts=E, moe_group_size=8)


def _lm_pair(seed, **kw):
    cfg = {**LM, **kw}
    jm = jax_create_model("lm_moe", **cfg)
    variables = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.default_rng(seed)
    params = _perturb(variables["params"], rng)
    for blk in params.values():
        if isinstance(blk, dict) and "moe" in blk:
            for name in ("expert_b_in", "expert_b_out"):
                blk["moe"][name] = blk["moe"][name] + rng.normal(
                    0, 0.05, blk["moe"][name].shape).astype(np.float32)
    stats = jax.tree.map(
        lambda v: rng.normal(0, 0.1, v.shape).astype(np.float32),
        variables["batch_stats"])
    tm = create_model("lm_moe", device="cpu", **cfg)
    load_flax_params(tm, params, stats)
    return (jm, jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, stats), tm)


def _tokens(seed, b=2, s=16):
    return np.random.default_rng(seed).integers(0, LM["vocab_size"],
                                                (b, s + 1))


def test_lm_moe_registry_and_decode_refusal():
    tm = create_model("lm_moe", device="cpu", vocab_size=64)
    routed = [b.use_moe for b in tm.blocks]
    assert routed == [False, True, False, True]       # lm_tiny depth 4
    assert tm.blocks[1].moe.capacity_factor == 2.0
    assert tm.blocks[1].fused is False and tm.blocks[0].fused == "auto"
    w_in = tm.blocks[1].moe.expert_w_in
    assert tuple(w_in.shape) == (8, 256, 1024)
    assert abs(float(w_in.detach().std()) - 256 ** -0.5) < 2e-3
    assert not tm.blocks[1].moe.expert_b_in.any()
    # decode runs through the routed blocks (ROADMAP A10): a one-token
    # step from an empty cache is the one-token forward
    token = torch.tensor([[5]])
    step = tm(token, cache=tm.init_cache(1, 8))
    assert tuple(step.shape) == (1, 1, 64) and torch.isfinite(step).all()
    torch.testing.assert_close(step, tm(token), rtol=2e-5, atol=2e-5)
    vit = create_model("vit_tiny_moe", device="cpu", depth=2)
    assert [b.use_moe for b in vit.blocks] == [False, True]
    assert vit.blocks[0].fused is False


def test_lm_moe_forward_and_grads_match_jax():
    jm, params, stats, tm = _lm_pair(3)
    tokens = _tokens(4)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def jloss(p):
        logits, mut = jm.apply({"params": p, "batch_stats": stats},
                               jnp.asarray(inputs, jnp.int32), train=True,
                               mutable=["intermediates", "batch_stats"])
        from ddp_practice_tpu.ops.losses import cross_entropy as jce
        from ddp_practice_tpu.train.steps import _sown_aux_loss

        loss = jce(logits, jnp.asarray(targets)) + _sown_aux_loss(
            mut["intermediates"])
        return loss, (logits, mut)

    (jl, (jlogits, mut)), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    logits = tm(torch.from_numpy(inputs), train=True)
    moes = tmoe.moe_layers(tm)
    loss = cross_entropy(logits, torch.from_numpy(targets)) + sum(
        m.sown["moe_aux_loss"] for m in moes)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), _np(jlogits), **OUT)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-5)
    want = flax_to_state_dict(jax.device_get(jgrads))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD)
    for m in moes:
        m.commit_bias()
    new_stats = flax_to_state_dict(jax.device_get(mut["batch_stats"]))
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), new_stats[name].numpy(),
                                   err_msg=name, **OUT)


def _check_step(metrics, jmetrics, tm, jstate, noise=None):
    assert set(metrics) == set(jmetrics)
    assert {"moe_load_max", "moe_load_min", "moe_drop_rate"} <= set(metrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    want = flax_to_state_dict(jax.device_get(jstate.params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    stats = flax_to_state_dict(jax.device_get(jstate.batch_stats))
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
def test_lm_moe_train_step_matches_jax(remat):
    kw = dict(optimizer="sgd", learning_rate=0.1, momentum=0.9)
    jm, params, stats, tm = _lm_pair(5, remat=remat)
    tx = jax_optimizer(JaxConfig(**kw), 5)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=stats, opt_state=tx.init(params))
    jstep = jit_quick(jax_lm_step(jm, tx, seed=1), jstate,
                      {"tokens": jnp.asarray(_tokens(10), jnp.int32)})
    state = TrainState(step=0, model=tm, optimizer=make_optimizer(
        TrainConfig(**kw), tm, 5))
    step = make_lm_train_step(tm, seed=1)
    for i in range(2):
        tokens = _tokens(10 + i)
        jstate, jmetrics = jstep(jstate, {"tokens": jnp.asarray(tokens,
                                                                jnp.int32)})
        state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
    _check_step(metrics, jmetrics, tm, jstate)


def test_remat_replays_routing_without_double_counting():
    """The same lm_moe step with and without torch.utils.checkpoint: one
    loss (the aux loss counted once), one set of grads, one bias update."""
    runs = []
    for remat in (False, True):
        _, _, _, tm = _lm_pair(6, remat=remat)
        tokens = torch.from_numpy(_tokens(12))
        state = TrainState(step=0, model=tm, optimizer=make_optimizer(
            TrainConfig(optimizer="sgd", learning_rate=0.1), tm, 5))
        state, metrics = make_lm_train_step(tm, seed=1)(
            state, {"tokens": tokens})
        runs.append((metrics, {n: p.grad for n, p in tm.named_parameters()},
                     {n: b.clone() for n, b in tm.named_buffers()}))
    (m0, g0, b0), (m1, g1, b1) = runs
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], rtol=1e-6, atol=1e-6)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-6)
    for n in b0:
        assert torch.equal(b1[n], b0[n]), n


def test_vit_tiny_moe_train_step_matches_jax():
    kw = dict(optimizer="sgd", learning_rate=0.05, momentum=0.9)
    cfg = dict(hidden_dim=32, num_heads=1, depth=2, mlp_dim=64,
               num_experts=E)
    image = (16, 16, 3)
    jm = jax_create_model("vit_tiny_moe", **cfg)
    init_args = (jax.random.PRNGKey(2), jnp.zeros((1, *image), jnp.float32))
    variables = jax.device_get(jit_quick(jm.init, *init_args)(*init_args))
    rng = np.random.default_rng(2)
    params = _perturb(variables["params"], rng)
    stats = jax.tree.map(
        lambda v: rng.normal(0, 0.1, v.shape).astype(np.float32),
        variables["batch_stats"])
    tm = create_model("vit_tiny_moe", device="cpu", image_shape=image,
                      **cfg)
    load_flax_params(tm, params, stats)
    params = jax.tree.map(jnp.asarray, params)
    tx = jax_optimizer(JaxConfig(**kw), 5)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=jax.tree.map(jnp.asarray, stats),
                      opt_state=tx.init(params))
    images = rng.integers(0, 256, (4, *image)).astype(np.uint8)
    labels = rng.integers(0, 10, 4).astype(np.int32)
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    jstate, jmetrics = jit_quick(jax_image_step(jm, tx, seed=1), jstate,
                                 batch)(jstate, batch)
    state = TrainState(step=0, model=tm, optimizer=make_optimizer(
        TrainConfig(**kw), tm, 5))
    state, metrics = make_train_step(tm, seed=1)(state, {
        "image": torch.from_numpy(images),
        "label": torch.from_numpy(labels).long()})
    _check_step(metrics, jmetrics, tm, jstate)
