"""The port's expert axis (ROADMAP A8c) and routed MoE under sequence
parallelism (A8f): parallel/mesh.py `ExpertGroup` and `shard_state`'s
expert cut, ops/moe.py `MoEMlp` with `ep` and `sp`, through the models,
the steps, the loop and the CLI, against the JAX package's, on the CPU,
the ranks as threads of this process (tests/_torch_port.py `ranks`: no
new process), inputs from numpy seeds:

- placements: the expert cut and the expert x FSDP placements of lm_moe
  and vit_tiny_moe at expert 2 and 4 equal the reference's rules leaf by
  leaf, and each rank stores its region of every leaf;
- one `MoEMlp` at expert 2 and 4 (einsum token choice, einsum expert
  choice, gather, sorted through the grouped matmul's plain version,
  against the JAX einsum path at capacity factor E/k where neither
  drops) against the JAX layer: output and sown aux loss, load
  fractions and drop rate at 2e-5, router-bias update at 2e-5, the
  input grad and every parameter grad (a rank's experts against their
  slice) at 5e-4 (the tolerances of tests/test_torch_moe.py); with a
  router bias that leaves one rank's experts without a token too. The
  sown statistics equal the reference's on every rank: `_batch_mean`
  and `_global_sum` stay right when the expert ranks repeat tokens;
- the reference's expert-mesh tests (tests/test_moe.py), the port's
  step against the JAX step on data 2 x expert 4 (8 ranks; the JAX step
  on the 8-device CPU mesh): vit_tiny_moe and lm_moe AdamW steps (loss
  and metrics rtol 1e-4, router biases 1e-6, parameters rtol 1e-3 /
  atol 1e-5 where the reference's grad (read from its AdamW moment) is
  at or above a 1e-6 noise floor: Adam turns a rounding-noise grad into an
  lr-sized update), and the aux loss in the total loss;
- greedy generation under expert 2 (einsum and sorted) equals the
  one-rank generate token for token;
- A8f: the seq-sharded lm_moe (8 ranks, ring and Ulysses, strided
  groups on and off, token and expert choice) against the reference's
  SP model: logits at 2e-4 (tests/test_torch_sequence_parallel.py's),
  and the routing (load fractions, drop rate, bias update) at 2e-5; an
  lm_moe SGD step at seq 2 (ring einsum, Ulysses sorted) against the
  JAX step: loss and aux loss rtol 1e-4, every grad at 5e-4 (a factor
  of the seq size on the aux loss's gradient shows here); vit_tiny_moe
  under a seq-2 ring, two steps against the dense JAX run (loss rtol
  2e-4, parameters rtol 1e-3 / atol 1e-5);
- composition: expert 2 x seq 2 (einsum, sorted) equals one rank's step;
- the CLI and the loop: `--expert 2` through the CLI, the reference's
  `num_experts` default and divisibility error, a dense lm_tiny under
  `--expert 2` equal to its one-rank run.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.tree_util import tree_flatten_with_path

from _torch_port import jit_quick, ranks
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu.ops import moe as jmoe
from ddp_practice_tpu.ops.losses import cross_entropy as jax_cross_entropy
from ddp_practice_tpu.parallel.fsdp import fsdp_rules as jax_fsdp_rules
from ddp_practice_tpu.parallel.mesh import batch_sharding as jax_batches
from ddp_practice_tpu.parallel.mesh import shard_state as jax_shard_state
from ddp_practice_tpu.parallel.sharding_rules import (
    param_sharding_rules as jax_rules,
)
from ddp_practice_tpu.train.state import TrainState as JaxState
from ddp_practice_tpu.train.state import create_state as jax_create_state
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu.train.steps import make_lm_train_step as jax_lm_step
from ddp_practice_tpu.train.steps import make_train_step as jax_image_step
from ddp_practice_tpu_torch import cli
from ddp_practice_tpu_torch.config import MeshConfig, TrainConfig
from ddp_practice_tpu_torch.convert import (
    _torch_name,
    flax_to_state_dict,
    load_flax_params,
)
from ddp_practice_tpu_torch.inference import make_generate_fn
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.ops import moe as tmoe
from ddp_practice_tpu_torch.ops.moe import moe_layers
from ddp_practice_tpu_torch.parallel.fsdp import fsdp_rules
from ddp_practice_tpu_torch.parallel.mesh import (
    batch_shard,
    build_mesh,
    full_parameters,
    local_tensor,
    parallelize,
    shard_state,
)
from ddp_practice_tpu_torch.parallel.sharding_rules import (
    layouts,
    param_sharding_rules,
)
from ddp_practice_tpu_torch.train.loop import Trainer
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
from ddp_practice_tpu_torch.train.steps import (
    make_lm_train_step,
    make_train_step,
)
# the reference's data 2 x expert 4 mesh (tests/test_moe.py) and the
# seq meshes of tests/test_torch_sequence_parallel.py, as fixtures
from test_moe import expert_mesh  # noqa: F401
from test_torch_moe import D, E, F, GRAD, K, OUT, _jax_layer_run
from test_torch_sequence_parallel import jax_mesh  # noqa: F401

# every tolerance of this file
SP_LOGITS = dict(rtol=2e-4, atol=2e-4)     # an SP model's logits
STEP_LOSS = dict(rtol=1e-4, atol=1e-6)     # a step's loss and metrics
PARAMS = dict(rtol=1e-3, atol=1e-5)        # parameters after steps
STATS = dict(rtol=1e-5, atol=1e-6)         # router metrics, biases
NOISE_FLOOR = 1e-6                         # Adam's held grads

LM = dict(vocab_size=32, max_len=32, hidden_dim=32, depth=2, num_heads=4,
          mlp_dim=64, num_experts=4, moe_every=2)
VIT = dict(depth=2, hidden_dim=32, num_heads=4, mlp_dim=64, num_experts=4,
           top_k=2, moe_every=2)
IMAGE = (16, 16, 3)
# name -> (fields, the flax init input, the port's extra fields)
MODELS = {
    "lm_moe": (LM, jnp.zeros((1, 8), jnp.int32), {}),
    "vit_tiny_moe": (VIT, jnp.zeros((1, *IMAGE)), dict(image_shape=IMAGE)),
}


def _random_variables(name, kw, sample, seed):
    """The reference's variables of model `name` (a flax module when
    `name` is one) in its init's tree and shapes (from eval_shape:
    nothing compiles), at values drawn from a numpy seed: kernels normal
    over sqrt(fan-in), biases and LayerNorm scales off their zeros and
    ones, router biases normal(0, 0.1)."""
    module = jax_create_model(name, **kw) if isinstance(name, str) else name
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), sample)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key, shape = path[-1].key, leaf.shape
        if key == "scale":
            return (1.0 + rng.normal(0, 0.2, shape)).astype(np.float32)
        if key in ("bias", "expert_b_in", "expert_b_out"):
            scale = 0.05
        elif key == "router_bias":
            scale = 0.1
        elif key == "pos_embed":
            scale = 0.02
        else:                       # kernels (.., in, out), expert stacks
            scale = 1.0 / np.sqrt(np.prod(shape[:-1]) if key == "kernel"
                                  else shape[-2] if len(shape) == 3
                                  else shape[-1])
        return rng.normal(0, scale, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _region(model, name, whole):
    """The rank's stored region of leaf `name`, cut from `whole`."""
    p = dict(model.named_parameters())[name]
    out = torch.empty(local_tensor(p).shape, dtype=whole.dtype)
    for gbox, lbox in model.sharding.region(name):
        out[tuple(slice(a, b) for a, b in lbox)] = whole[
            tuple(slice(a, b) for a, b in gbox)]
    return out


# ------------------------------------------------------------ placements
@pytest.mark.parametrize("fsdp", [False, True], ids=["expert", "fsdp"])
@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_expert_placements_equal_the_references(name, ep, fsdp):
    """The rules leaf by leaf (FSDP over data 2, min_leaf_size 128: the
    expert leaves' data cut goes on a free dim), then the layout on a
    mesh of data 1 or 2 x expert `ep`: every rank stores its region of
    each leaf, and `full_parameters` puts the whole model back."""
    kw, sample, extra = MODELS[name]
    params = jax.eval_shape(jax_create_model(name, **kw).init,
                            jax.random.PRNGKey(0), sample)["params"]
    ref, port = jax_rules(name), param_sharding_rules(name)
    if fsdp:
        ref = jax_fsdp_rules(2, ref, min_leaf_size=128)
        port = fsdp_rules(2, port, min_leaf_size=128)
    whole = create_model(name, device="cpu", **kw, **extra)
    lay = layouts(whole)
    flat = tree_flatten_with_path(params)[0]
    assert len(flat) == len(lay)
    for path, leaf in flat:
        tname = _torch_name(tuple(k.key for k in path))
        want = lay[tname].from_ref(ref(path, leaf))
        got = port(tname, lay[tname]) or lay[tname].unsharded()
        assert got == want, (tname, got, want)
        if tname.rsplit(".", 1)[-1].startswith("expert_"):
            assert got[0][0] == "expert" and (not fsdp or "data" in
                                              str(got)), tname
    want = {n: p.detach().clone() for n, p in whole.named_parameters()}

    def rank(r):
        model = create_model(name, device="cpu", **kw, **extra)
        mesh = build_mesh(MeshConfig(data=2 if fsdp else 1, expert=ep),
                          "cpu")
        parallelize(model, mesh, model_name=name, fsdp=fsdp,
                    min_leaf_size=128)
        moe = moe_layers(model)[0]
        assert moe.ep.size == ep and moe.num_experts == 4
        for n, p in model.named_parameters():
            torch.testing.assert_close(local_tensor(p.detach()),
                                       _region(model, n, want[n]),
                                       rtol=0, atol=0, msg=n)
        w = dict(model.named_parameters())[
            next(n for n in want if n.endswith("moe.expert_w_in"))]
        return tuple(local_tensor(w).shape), full_parameters(model)

    for shape, got in ranks(rank, ep * (2 if fsdp else 1)):
        assert shape[0] == 4 // ep
        for n, w in want.items():
            torch.testing.assert_close(got[n], w, rtol=0, atol=0, msg=n)


# ------------------------------------------------------------- the layer
LAYER_CASES = {
    "einsum_topk": dict(impl="einsum", capacity_factor=1.25),
    "einsum_expert_choice": dict(impl="einsum", router="expert_choice",
                                 capacity_factor=1.0),
    "gather_topk_strided": dict(impl="gather", capacity_factor=1.25,
                                group_size=16),
    # the JAX einsum path at capacity factor E/k drops nothing: the
    # sorted path computes its function
    "sorted": dict(impl="einsum", capacity_factor=E / K),
}
LAYER_PARAMS = [(c, ep, False) for c in sorted(LAYER_CASES) for ep in (2, 4)]
LAYER_PARAMS += [(c, ep, True) for c in ("einsum_topk", "gather_topk_strided",
                                         "sorted") for ep in (2, 4)]


@pytest.mark.parametrize("case,ep,idle", LAYER_PARAMS)
def test_layer_matches_jax_under_the_expert_axis(case, ep, idle):
    """`idle`: a router bias of -1000 on experts 2 and 3 routes every
    token to 0 and 1, so the last rank (expert 2) or the last two
    (expert 4) hold experts that get no token."""
    kw = LAYER_CASES[case]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 64, D)).astype(np.float32)
    w = rng.normal(size=(2, 64, D)).astype(np.float32)
    jm = jmoe.MoEMlp(num_experts=E, top_k=K, mlp_dim=F, expert_axis=None,
                     **kw)
    variables = _random_variables(jm, {}, jnp.zeros(x.shape), seed=3)
    if idle:
        variables["batch_stats"]["router_bias"] = np.asarray(
            [0.1, -0.1, -1e3, -1e3], np.float32)
    tm = tmoe.MoEMlp(D, num_experts=E, top_k=K, mlp_dim=F,
                     impl="sorted" if case == "sorted" else kw["impl"],
                     **{k: v for k, v in kw.items() if k != "impl"})
    tm.load_state_dict({**flax_to_state_dict(variables["params"]),
                        **flax_to_state_dict(variables.get("batch_stats",
                                                           {}))})
    jy, mut, jgp, jgx = _jax_layer_run(jm, variables, jnp.asarray(x), w)
    want = flax_to_state_dict(jax.device_get(jgp))

    def rank(r):
        layer = copy.deepcopy(tm)
        shard_state(layer, build_mesh(MeshConfig(expert=ep), "cpu"),
                    param_sharding_rules("lm_moe"))
        xs = torch.from_numpy(x).requires_grad_()
        y = layer(xs, train=True)
        ((y * torch.from_numpy(w)).sum() + layer.sown["moe_aux_loss"]
         ).backward()
        grads = {n: p.grad.clone() for n, p in layer.named_parameters()}
        return (layer._local(), y.detach(), xs.grad, grads,
                {k: v.detach() for k, v in layer.sown.items()},
                layer.pending_bias)

    used = []
    for (e0, e1), y, gx, grads, sown, bias in ranks(rank, ep):
        assert e1 - e0 == E // ep
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **OUT)
        np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **GRAD)
        for name, g in grads.items():
            ref = want[name]
            if name.startswith("expert_"):
                ref = ref[e0:e1]
            np.testing.assert_allclose(g.numpy(), ref.numpy(),
                                       err_msg=name, **GRAD)
        for name in ("moe_aux_loss", "moe_load_frac", "moe_drop_rate"):
            np.testing.assert_allclose(
                sown[name].numpy(),
                np.asarray(mut["intermediates"][name][0]), err_msg=name,
                **OUT)
        if "batch_stats" in mut:
            np.testing.assert_allclose(
                bias.numpy(), np.asarray(mut["batch_stats"]["router_bias"]),
                **OUT)
        used.append(float(sown["moe_load_frac"][e0:e1].sum()))
    if idle:
        assert used[-1] == 0.0 and used[0] > 0.0


# ------------------------------------------ the reference's expert mesh
def _jax_sharded_step(mesh, name, kw, sample, batch, lm):
    """The reference's test setup: AdamW 1e-3, the state laid out by its
    rules on `mesh` (its params drawn from a seed, `_random_variables`);
    one step. Returns (params before, batch_stats before, metrics, state
    after)."""
    model = jax_create_model(name, **kw)
    tx = jax_optimizer(JaxConfig(optimizer="adamw", learning_rate=1e-3))

    def init_fn(r):
        return jax_create_state(model, tx, rng=r, sample_input=sample)

    shardings = jax_shard_state(jax.eval_shape(init_fn, jax.random.PRNGKey(0)),
                                mesh, jax_rules(name))
    variables = _random_variables(name, kw, sample, seed=1)
    params, stats = variables["params"], variables["batch_stats"]
    jparams = jax.device_put(params, shardings.params)
    w = jparams["block1"]["moe"]["expert_w_in"]
    assert w.addressable_shards[0].data.shape[0] == w.shape[0] // 4
    state = JaxState(step=jnp.zeros((), jnp.int32), params=jparams,
                     batch_stats=jax.device_put(stats,
                                                shardings.batch_stats),
                     opt_state=jax.jit(tx.init, out_shardings=shardings
                                       .opt_state)(jparams))
    make = jax_lm_step if lm else jax_image_step
    step = make(model, tx, mesh=mesh, state_shardings=shardings,
                batch_shardings=jax_batches(mesh))
    state, metrics = jit_quick(step, state, batch)(state, batch)
    return params, stats, jax.device_get(metrics), jax.device_get(state)


def _jax_grads(jstate):
    """The reference step's gradient by leaf, read from its AdamW first
    moment after the first step: mu = (1 - b1) g, optax's b1 0.9."""
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state,
        is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return {n: m / 0.1 for n, m in flax_to_state_dict(adam.mu).items()}


def _port_mesh_step(name, kw, extra, params, stats, batch, lm):
    """Each of the 8 ranks: the model converted, laid out on data 2 x
    expert 4 as the train loop lays it out, one AdamW step on its rows.
    Returns per rank (metrics, {name: updated leaf}, buffers, model)."""

    def rank(r):
        model = create_model(name, device="cpu", **kw, **extra)
        load_flax_params(model, params, stats)
        mesh = build_mesh(MeshConfig(data=2, expert=4), "cpu")
        forward, after = parallelize(model, mesh, model_name=name,
                                     fsdp=False)
        state = TrainState(0, model, make_optimizer(
            TrainConfig(optimizer="adamw", learning_rate=1e-3,
                        device="cpu"), model))
        make = make_lm_train_step if lm else make_train_step
        step = make(model, forward=forward, after_backward=after)
        rows = batch_shard(mesh).local_slice(8)
        state, m = step(state, {k: torch.from_numpy(np.asarray(v)[rows])
                                for k, v in batch.items()})
        got = {n: local_tensor(p.detach()).clone()
               for n, p in model.named_parameters()}
        return ({k: float(v) for k, v in m.items()}, got,
                {n: b.clone() for n, b in model.named_buffers()}, model)

    return ranks(rank, 8)


def _check_mesh_step(res, jmetrics, jstate, jgrads):
    """Metrics, buffers, and each rank's updated leaves where the
    reference's gradient is at or above the noise floor."""
    want = flax_to_state_dict(jstate.params)
    want_stats = flax_to_state_dict(jstate.batch_stats)
    for metrics, got, buffers, model in res:
        assert {"moe_load_max", "moe_load_min", "moe_drop_rate"} <= set(
            metrics) & set(jmetrics)
        for k in set(metrics) & set(jmetrics):
            np.testing.assert_allclose(metrics[k], float(jmetrics[k]),
                                       err_msg=k, **STEP_LOSS)
        for n, p in got.items():
            ref = _region(model, n, want[n])
            held = _region(model, n, jgrads[n]).abs() >= NOISE_FLOOR
            assert held.any(), n
            np.testing.assert_allclose(p[held].numpy(), ref[held].numpy(),
                                       err_msg=n, **PARAMS)
        for n, b in buffers.items():
            np.testing.assert_allclose(b.numpy(), want_stats[n].numpy(),
                                       err_msg=n, **STATS)


def test_vit_moe_sharded_train_step(expert_mesh):
    """tests/test_moe.py `test_vit_moe_sharded_train_step`."""
    kw = dict(depth=2, hidden_dim=32, num_heads=4, mlp_dim=64,
              num_experts=4, top_k=2, moe_every=2)
    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(size=(8, *IMAGE)).astype(np.float32),
             "label": rng.integers(0, 10, 8).astype(np.int32)}
    jbatch = {**{k: jnp.asarray(v) for k, v in batch.items()},
              "weight": jnp.ones((8,), jnp.float32)}
    sample = jnp.zeros((8, *IMAGE))
    params, stats, jmetrics, jstate = _jax_sharded_step(
        expert_mesh, "vit_tiny_moe", kw, sample, jbatch, lm=False)
    jgrads = _jax_grads(jstate)
    batch["label"] = batch["label"].astype(np.int64)
    res = _port_mesh_step("vit_tiny_moe", kw, dict(image_shape=IMAGE),
                          params, stats, batch, lm=False)
    _check_mesh_step(res, jmetrics, jstate, jgrads)


def test_lm_moe_sharded_train_step_with_router_metrics(expert_mesh):
    """tests/test_moe.py `test_lm_moe_sharded_train_step_with_router_
    metrics`: the metrics are the reference's, in their ranges."""
    kw = dict(vocab_size=32, max_len=32, hidden_dim=32, depth=2,
              num_heads=4, mlp_dim=64, num_experts=4, moe_every=2)
    tokens = np.random.default_rng(5).integers(0, 32, (8, 17))
    sample = jnp.zeros((8, 16), jnp.int32)
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    params, stats, jmetrics, jstate = _jax_sharded_step(
        expert_mesh, "lm_moe", kw, sample, jbatch, lm=True)
    jgrads = _jax_grads(jstate)
    res = _port_mesh_step("lm_moe", kw, {}, params, stats,
                          {"tokens": tokens}, lm=True)
    _check_mesh_step(res, jmetrics, jstate, jgrads)
    metrics = res[0][0]
    assert 0.0 <= metrics["moe_drop_rate"] <= 1.0
    assert 0.0 <= metrics["moe_load_min"] <= metrics["moe_load_max"] <= 1.0


def test_aux_loss_increases_total_loss(expert_mesh):
    """tests/test_moe.py `test_aux_loss_increases_total_loss`: top-1
    vit_tiny_moe on data 2 x expert 4; each rank's logits and sown aux
    loss equal the reference's, and the step's loss is the reference's
    cross-entropy plus its aux loss, above the cross-entropy."""
    kw = dict(depth=2, hidden_dim=32, num_heads=4, mlp_dim=64,
              num_experts=4, top_k=1, moe_every=2)
    jm = jax_create_model("vit_tiny_moe", **kw)
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(8, *IMAGE)).astype(np.float32)
    labels = rng.integers(0, 10, 8).astype(np.int32)
    variables = _random_variables("vit_tiny_moe", kw, x, seed=0)
    logits, updated = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["intermediates"]))(variables, x)
    aux = float(updated["intermediates"]["block1"]["moe"]["moe_aux_loss"][0])
    assert aux > 0.0
    ce = float(jax_cross_entropy(logits, labels))

    def rank(r):
        model = create_model("vit_tiny_moe", device="cpu", **kw,
                             image_shape=IMAGE)
        load_flax_params(model, variables["params"],
                         variables["batch_stats"])
        mesh = build_mesh(MeshConfig(data=2, expert=4), "cpu")
        forward, after = parallelize(model, mesh, model_name="vit_tiny_moe",
                                     fsdp=False)
        rows = batch_shard(mesh).local_slice(8)
        with torch.no_grad():
            got = model(torch.from_numpy(x[rows]))
        state = TrainState(0, model, make_optimizer(
            TrainConfig(optimizer="sgd", learning_rate=0.1, device="cpu"),
            model))
        _, m = make_train_step(model, forward=forward,
                               after_backward=after)(state, {
            "image": torch.from_numpy(x[rows]),
            "label": torch.from_numpy(labels[rows]).long()})
        return rows, got.numpy(), float(m["loss"])

    for rows, got, loss in ranks(rank, 8):
        np.testing.assert_allclose(got, np.asarray(logits)[rows],
                                   **SP_LOGITS)
        np.testing.assert_allclose(loss, ce + aux, **STEP_LOSS)
        assert loss > ce


# -------------------------------------------------------------- generate
@pytest.mark.parametrize("impl", ["einsum", "sorted"])
def test_generate_under_expert_2_equals_one_rank(impl):
    """Greedy lm_moe generation, each rank computing its experts' part of
    every token (prefill and single-token steps), equals one rank's."""
    prompt = torch.from_numpy(np.asarray([[5, 2, 7], [1, 1, 1]]))

    def lm():
        model = create_model("lm_moe", device="cpu", seed=4, **LM)
        for m in moe_layers(model):
            m.impl = impl
        return model

    want = make_generate_fn(lm(), max_new_tokens=8,
                            temperature=0.0)(prompt)

    def rank(r):
        model = lm()
        shard_state(model, build_mesh(MeshConfig(expert=2), "cpu"),
                    param_sharding_rules("lm_moe"), "lm_moe")
        assert model.blocks[1].moe.expert_w_in.shape[0] == 2
        return make_generate_fn(model, max_new_tokens=8,
                                temperature=0.0)(prompt)

    for got in ranks(rank, 2):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# --------------------------------------------------------- A8f: the seq
SP_LM = dict(vocab_size=32, max_len=64, hidden_dim=64, depth=2, num_heads=8,
             mlp_dim=128, num_experts=4)
SP_CASES = {
    "topk": dict(moe_group_size=0),
    "topk-strided": dict(moe_group_size=8),
    "topk-contiguous": dict(moe_group_size=16, moe_group_stride=False),
    # groups of 2 inside a rank's chunk of 4: it dispatches its own groups
    "topk-contiguous-within": dict(moe_group_size=2, moe_group_stride=False),
    "expert_choice-strided": dict(moe_group_size=8,
                                  moe_router="expert_choice",
                                  capacity_factor=1.0),
    # the port's gather path against the reference's einsum
    "gather-strided": dict(moe_group_size=8, impl="gather"),
}


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
@pytest.mark.parametrize("case", sorted(SP_CASES))
def test_seq_sharded_lm_moe_matches_the_references_sp_model(
        jax_mesh, case, sp_impl):
    """lm_moe (8 heads) cut over 8 seq ranks, 4 tokens a rank, against
    the reference's seq-sharded model on its 8-device mesh, a training
    forward: the logits, and every routed layer's load fractions, drop
    rate and router-bias update (what its choices are)."""
    kw = {**SP_LM, **SP_CASES[case]}
    impl = kw.pop("impl", "einsum")
    tokens = np.random.default_rng(0).integers(0, 32, (2, 32))
    jm = jax_create_model("lm_moe", **kw, seq_axis="seq", sp_impl=sp_impl)
    variables = _random_variables("lm_moe", kw, jnp.zeros((1, 8), jnp.int32),
                                  seed=1)
    params, stats = variables["params"], variables.get("batch_stats")
    jax_mesh(data=1, seq=8)
    mutable = ["intermediates"] + (["batch_stats"] if stats else [])
    v = {"params": params, **({"batch_stats": stats} if stats else {})}
    want, mut = jax.jit(lambda v, t: jm.apply(v, t, train=True,
                                              mutable=mutable))(
        v, jnp.asarray(tokens, jnp.int32))
    inter = mut["intermediates"]["block1"]["moe"]

    def rank(r):
        model = create_model("lm_moe", device="cpu", **kw, seq_axis="seq",
                             sp_impl=sp_impl)
        load_flax_params(model, params, stats)
        for layer in moe_layers(model):
            layer.impl = impl
        shard_state(model, build_mesh(MeshConfig(seq=8), "cpu"), None,
                    "lm_moe")
        with torch.no_grad():
            got = model(torch.from_numpy(tokens[:, 4 * r:4 * r + 4]),
                        train=True).numpy()
        moe = model.blocks[1].moe
        return got, {k: t.numpy() for k, t in moe.sown.items()}, (
            None if moe.pending_bias is None else moe.pending_bias.numpy())

    res = ranks(rank, 8)
    got = np.concatenate([g for g, _, _ in res], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), **SP_LOGITS)
    for _, sown, bias in res:
        for k in ("moe_load_frac", "moe_drop_rate", "moe_aux_loss"):
            np.testing.assert_allclose(sown[k], np.asarray(inter[k][0]),
                                       err_msg=k, **OUT)
        if stats:
            np.testing.assert_allclose(
                bias, np.asarray(mut["batch_stats"]["block1"]["moe"][
                    "router_bias"]), **OUT)


SEQ_STEP = {
    "ring-einsum": ("ring", "einsum", dict(moe_group_size=8,
                                           capacity_factor=1.25)),
    # sorted against the JAX einsum path at cf E/k (nothing drops)
    "ulysses-sorted": ("ulysses", "sorted", dict(capacity_factor=2.0)),
}


@pytest.mark.parametrize("case", sorted(SEQ_STEP))
def test_seq_lm_moe_step_matches_the_jax_step(case):
    """One SGD step of lm_moe at seq 2 (laid out by `parallelize`: DDP
    over the seq ranks) against the dense JAX step on the same 4 rows:
    loss, each routed layer's aux loss, and every grad, on each rank."""
    sp_impl, impl, extra = SEQ_STEP[case]
    kw = {**SP_LM, **extra}
    jmodel = jax_create_model("lm_moe", **kw)
    variables = _random_variables("lm_moe", kw, jnp.zeros((1, 8), jnp.int32),
                                  seed=3)
    params, stats = variables["params"], variables["batch_stats"]
    tokens = np.random.default_rng(7).integers(0, 32, (4, 17))

    def jloss(p):
        logits, mut = jmodel.apply(
            {"params": p, "batch_stats": stats},
            jnp.asarray(tokens[:, :-1], jnp.int32), train=True,
            mutable=["intermediates", "batch_stats"])
        aux = mut["intermediates"]["block1"]["moe"]["moe_aux_loss"][0]
        return jax_cross_entropy(logits, jnp.asarray(tokens[:, 1:])) + aux, \
            aux

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    want = flax_to_state_dict(jax.device_get(jg))

    def rank(r):
        model = create_model("lm_moe", device="cpu", **kw, seq_axis="seq",
                             sp_impl=sp_impl)
        load_flax_params(model, params, stats)
        for m in moe_layers(model):
            m.impl = impl
        forward, after = parallelize(model, build_mesh(MeshConfig(seq=2),
                                                       "cpu"),
                                     model_name="lm_moe", fsdp=False)
        state = TrainState(0, model, make_optimizer(
            TrainConfig(optimizer="sgd", learning_rate=0.1, device="cpu"),
            model))
        step = make_lm_train_step(model, seed=1, forward=forward,
                                  after_backward=after)
        aux = []
        moe = model.blocks[1].moe
        moe.register_forward_hook(
            lambda *_: aux.append(float(moe.sown["moe_aux_loss"].detach())))
        _, m = step(state, {"tokens": torch.from_numpy(tokens)})
        return float(m["loss"]), aux[0], {n: p.grad.clone()
                                          for n, p in
                                          model.named_parameters()}

    for loss, aux, grads in ranks(rank, 2):
        np.testing.assert_allclose(loss, float(jl), **STEP_LOSS)
        np.testing.assert_allclose(aux, float(jaux), **STEP_LOSS)
        for n, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want[n].numpy(),
                                       err_msg=n, **GRAD)


def test_vit_tiny_moe_ring_matches_the_dense_reference():
    """vit_tiny_moe (16 patch tokens: 8 a rank) with ring attention at
    seq 2: two SGD steps against the reference's dense run."""
    kw = dict(depth=2, hidden_dim=32, num_heads=4, mlp_dim=64,
              num_experts=4, top_k=2, moe_every=2)
    jm = jax_create_model("vit_tiny_moe", **kw)
    variables = _random_variables("vit_tiny_moe", kw, jnp.zeros((1, *IMAGE)),
                                  seed=2)
    params, stats = variables["params"], variables["batch_stats"]
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (4, *IMAGE)).astype(np.uint8)
    labels = rng.integers(0, 10, 4).astype(np.int32)
    tx = jax_optimizer(JaxConfig(optimizer="sgd", learning_rate=0.05), 5)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=jparams,
                      batch_stats=jax.tree.map(jnp.asarray, stats),
                      opt_state=tx.init(jparams))
    jstep = jax_image_step(jm, tx, seed=1)
    want_losses = []
    for _ in range(2):
        jstate, jmetrics = jstep(jstate, {"image": jnp.asarray(images),
                                          "label": jnp.asarray(labels)})
        want_losses.append(float(jmetrics["loss"]))

    def rank(r):
        model = create_model("vit_tiny_moe", device="cpu", **kw,
                             image_shape=IMAGE, seq_axis="seq")
        load_flax_params(model, params, stats)
        forward, after = parallelize(model, build_mesh(MeshConfig(seq=2),
                                                       "cpu"),
                                     model_name="vit_tiny_moe", fsdp=False)
        assert model.sp.size == 2 and model.blocks[1].moe.sp is model.sp
        state = TrainState(0, model, make_optimizer(
            TrainConfig(optimizer="sgd", learning_rate=0.05, device="cpu"),
            model, 5))
        step = make_train_step(model, seed=1, forward=forward,
                               after_backward=after)
        losses = []
        for _ in range(2):
            state, m = step(state, {
                "image": torch.from_numpy(images),
                "label": torch.from_numpy(labels).long()})
            losses.append(float(m["loss"]))
        return losses, full_parameters(model), {
            n: b.clone() for n, b in model.named_buffers()}

    ref = flax_to_state_dict(jax.device_get(jstate.params))
    ref_stats = flax_to_state_dict(jax.device_get(jstate.batch_stats))
    for losses, got, buffers in ranks(rank, 2):
        np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
        for n, w in ref.items():
            np.testing.assert_allclose(got[n].numpy(), w.numpy(),
                                       err_msg=n, **PARAMS)
        for n, b in buffers.items():
            np.testing.assert_allclose(b.numpy(), ref_stats[n].numpy(),
                                       err_msg=n, **STATS)


# ----------------------------------------------------------- composition
def _composed_equals_one_rank(impl, mesh, **extra):
    """lm_moe (strided groups of 8) laid out on `mesh` (4 ranks; `extra`
    the model's arguments for it): two SGD steps, every rank's loss and
    metrics and the whole parameters and router biases equal one
    rank's."""
    kw = {**LM, "max_len": 64, "moe_group_size": 8}
    tokens = np.random.default_rng(9).integers(0, 32, (2, 33))
    cfg = TrainConfig(optimizer="sgd", learning_rate=0.1, device="cpu")

    def run(model, forward=None, after=None):
        for m in moe_layers(model):
            m.impl = impl
        state = TrainState(0, model, make_optimizer(cfg, model))
        step = make_lm_train_step(model, seed=1, forward=forward,
                                  after_backward=after)
        out = []
        for _ in range(2):
            state, m = step(state, {"tokens": torch.from_numpy(tokens)})
            out.append({k: float(v) for k, v in m.items()})
        return out

    one = create_model("lm_moe", device="cpu", seed=5, **kw)
    want = run(one)
    want_params = {n: p.detach() for n, p in one.named_parameters()}

    def rank(r):
        model = create_model("lm_moe", device="cpu", seed=5, **kw, **extra)
        forward, after = parallelize(model, build_mesh(mesh, "cpu"),
                                     model_name="lm_moe", fsdp=False)
        assert model.blocks[1].moe.ep.size == 2
        assert model.tp is None or model.tp.size == 2
        return (run(model, forward, after), full_parameters(model),
                {n: b.clone() for n, b in model.named_buffers()})

    for metrics, params, buffers in ranks(rank, 4):
        for got, ref in zip(metrics, want):
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], err_msg=k,
                                           **STATS)
        for n, w in want_params.items():
            torch.testing.assert_close(params[n], w, rtol=1e-4, atol=1e-6,
                                       msg=n)
        for n, b in one.named_buffers():
            torch.testing.assert_close(buffers[n], b, rtol=0, atol=1e-6,
                                       msg=n)


@pytest.mark.parametrize("impl", ["einsum", "sorted"])
def test_expert_2_x_seq_2_equals_one_rank(impl):
    """lm_moe at expert 2 x seq 2 (ring) equals one rank's two steps."""
    _composed_equals_one_rank(impl, MeshConfig(seq=2, expert=2),
                              seq_axis="seq")


@pytest.mark.parametrize("impl", ["einsum", "gather", "sorted"])
def test_expert_2_x_tensor_2_equals_one_rank(impl):
    """lm_moe at expert 2 x tensor 2 (attention and the dense MLPs cut
    over tensor, the experts over expert) equals one rank's two
    steps."""
    _composed_equals_one_rank(impl, MeshConfig(tensor=2, expert=2))


@pytest.mark.parametrize("case", [
    (2, 32, 0, True, 2), (2, 32, 8, True, 8), (1, 32, 16, False, 4),
    (1, 32, 4, False, 2), (1, 32, 4, True, 4)])
def test_chunk_places_cover_the_chunk_once(case):
    """`_chunk_places`: every token of a seq rank's chunk sits in one of
    its places, once, at the position its routing group gives it."""
    b, s, group, stride, size = case
    glob = torch.arange(b * s).reshape(b, s, 1)
    grouped = tmoe._group_tokens(glob, group, stride)[0][..., 0]
    for r in range(size):
        groups, slots, rows, inv = tmoe._chunk_places(b, s, group, stride,
                                                      r, size, "cpu")
        chunk = glob.reshape(b, s)[:, r * s // size:(r + 1) * s // size]
        got = tmoe._take(grouped, (groups, slots))
        torch.testing.assert_close(got, chunk.reshape(-1)[rows])
        assert torch.equal(rows.reshape(-1)[inv],
                           torch.arange(chunk.numel()))


def test_chunk_places_refuse_groups_split_unevenly():
    """Contiguous groups of 4 over chunks of 6: a rank would hold 4
    tokens of one group and 2 of the next."""
    with pytest.raises(ValueError, match="unequal parts"):
        tmoe._chunk_places(1, 12, 4, False, 0, 2, "cpu")


# ------------------------------------------------------- entry points
def _lm_config(**kw):
    base = dict(device="cpu", seq_len=16, batch_size=2, synthetic_size=20000,
                optimizer="sgd", learning_rate=0.1, data_placement="host",
                log_every_steps=0, max_steps_per_epoch=2, epochs=1)
    return TrainConfig(**{**base, **kw})


def test_expert_flag_runs_through_the_cli(capsys):
    """`--model lm_moe --expert 2` at data 2 x expert 2 through the CLI,
    the ranks as threads."""
    argv = ["--model", "lm_moe", "--device", "cpu", "-b", "2",
            "--max_steps", "2", "-e", "1", "--seq_len", "16",
            "--synthetic_size", "20000", "--log_every", "0", "--json",
            "--expert", "2"]
    assert ranks(lambda r: cli.main(argv), 4) == [0] * 4
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 2 and summary["devices"] == 4
    assert summary["global_batch"] == 4
    assert 0.0 <= summary["moe_load_min"] <= summary["moe_load_max"] <= 1.0


def test_num_experts_default_and_divisibility():
    """The reference's default (8 rounded up to a multiple of the expert
    axis: 9 at expert 3, 3 a rank) and its error."""

    def rank(r):
        t = Trainer(_lm_config(model="lm_moe", mesh=MeshConfig(expert=3)))
        moe = t.model.blocks[1].moe
        try:
            Trainer(_lm_config(model="lm_moe", num_experts=4,
                               mesh=MeshConfig(expert=3)))
        except ValueError as e:
            return moe.num_experts, moe.expert_w_in.shape[0], str(e)
        return None

    for experts, local, err in ranks(rank, 3):
        assert (experts, local) == (9, 3)
        assert err == "num_experts=4 not divisible by expert axis 3"


def test_dense_lm_under_expert_2_equals_one_rank():
    """lm_tiny takes `num_experts` and ignores it: at data 2 x expert 2
    the expert ranks are plain replicas, and two steps equal one rank's
    on the same global batch."""

    def steps(t):
        t.train_loader.set_epoch(0)
        batches = t._device_batches(t.train_loader)
        losses = []
        for _ in range(2):
            t.state, m = t.train_step(t.state, next(batches))
            losses.append(float(m["loss"]))
        return losses

    one = Trainer(_lm_config(model="lm_tiny", num_heads=4, batch_size=4))
    want = steps(one)
    want_params = {n: p.detach() for n, p in one.model.named_parameters()}

    def rank(r):
        t = Trainer(_lm_config(model="lm_tiny", num_heads=4,
                               mesh=MeshConfig(expert=2)))
        assert t.global_batch == 4
        return steps(t), full_parameters(t.model)

    for losses, params in ranks(rank, 4):
        np.testing.assert_allclose(losses, want, **STEP_LOSS)
        for n, w in want_params.items():
            torch.testing.assert_close(params[n], w, rtol=1e-4, atol=1e-6,
                                       msg=n)


def test_vit_takes_num_experts_and_conv_nets_refuse_expert(tmp_path):
    """The loop passes `num_experts` to every transformer, as the
    reference's does: a dense ViT takes it and ignores it (its expert
    ranks are replicas); the conv nets have no such field and refuse
    `--expert`."""
    image = dict(dataset="cifar10", synthetic_size=16, batch_size=2,
                 data_dir=str(tmp_path), device="cpu", log_every_steps=0,
                 mesh=MeshConfig(expert=2))

    def rank(r):
        t = Trainer(TrainConfig(model="vit_tiny", **image))
        with pytest.raises(ValueError, match="--expert applies to the "
                           "transformer families, not 'convnet'"):
            Trainer(TrainConfig(model="convnet", **image))
        return t.ep, len(moe_layers(t.model))

    assert ranks(rank, 2) == [(2, 0)] * 2
