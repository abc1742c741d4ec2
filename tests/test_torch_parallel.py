"""The port's mesh, tensor parallelism and FSDP (parallel/) against the JAX
package's, on the CPU, the ranks as threads of this process
(tests/_torch_port.py `ranks`: torch's threaded process group, a deadline
a case, no new process):

- placements: for vit_tiny, lm_tiny, lm_moe and the ConvNet the
  reference's `param_sharding_rules` and `fsdp_rules` evaluated on the
  flax tree (no mesh needed), mapped through the converter's layout
  (sharding_rules.Layout), equal each port leaf's Spec, leaf by leaf,
  for TP, FSDP and TP + FSDP, small leaves included;
- steps against the reference tests' setups (tests/test_tensor_parallel.py
  `_setup`, tests/test_fsdp.py `_make`, their batches): vit_tiny under
  tensor parallelism at data=2, tensor=4 (two SGD steps: loss rtol 2e-4,
  parameters rtol 1e-3 / atol 1e-5, the reference's TP tolerances); the
  ConvNet under FSDP at data=8 against replicated DP (loss rtol 1e-5,
  parameters atol 1e-5); FSDP composed with TP (vit_tiny, data=2 x
  tensor=4, min_leaf_size 128: the qkv bias is cut inside its torch dim,
  parallel/fsdp.py); the lm_tiny forward at tensor=8 (rtol/atol 2e-4);
  greedy generation at data=2, tensor=4 (tokens exact); the
  heads-divisibility error; an lm_base-shaped LM step at tensor=2 with
  clipping on, so the sharded global norm is held to JAX's;
- the mesh: MeshConfig's semantics and refusals, axis order (a tensor
  group is consecutive ranks), each rank's batch slice.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from _torch_port import jit_quick, ranks
from ddp_practice_tpu.config import MeshConfig as JaxMesh
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.inference import make_generate_fn as jax_generate_fn
from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu.parallel.fsdp import fsdp_rules as jax_fsdp_rules
from ddp_practice_tpu.parallel.sharding_rules import (
    param_sharding_rules as jax_rules,
)
from ddp_practice_tpu.train.state import TrainState as JaxState
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu.train.steps import make_lm_train_step as jax_lm_step
from ddp_practice_tpu_torch.config import MeshConfig, TrainConfig
from ddp_practice_tpu_torch.convert import (
    _torch_name,
    flax_to_state_dict,
    load_flax_params,
)
from ddp_practice_tpu_torch.inference import make_generate_fn
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.parallel.fsdp import fsdp_rules
from ddp_practice_tpu_torch.parallel.mesh import (
    batch_shard,
    build_mesh,
    coords,
    full_parameters,
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

LM = dict(vocab_size=32, max_len=64, hidden_dim=64, depth=2, num_heads=4,
          mlp_dim=128)
VIT = dict(depth=2, hidden_dim=32, num_heads=4, mlp_dim=64)
# name -> (model fields, the flax init input, the port's extra fields)
MODELS = {
    "vit_tiny": (VIT, jnp.zeros((1, 16, 16, 3)),
                 dict(image_shape=(16, 16, 3))),
    "lm_tiny": (LM, jnp.zeros((1, 8), jnp.int32), {}),
    "lm_moe": ({**LM, "num_experts": 4}, jnp.zeros((1, 8), jnp.int32), {}),
    "convnet": ({}, jnp.zeros((1, 28, 28, 1)), {}),
}


def _ref_shapes(name):
    """The flax params tree as shapes (the rules read only those)."""
    kw, sample, _ = MODELS[name]
    return jax.eval_shape(jax_create_model(name, **kw).init,
                          jax.random.PRNGKey(0), sample)["params"]


def _port_model(name, params=None):
    kw, _, extra = MODELS[name]
    model = create_model(name, device="cpu", **kw, **extra)
    if params is not None:
        load_flax_params(model, jax.device_get(params))
    return model


def _rule_cases():
    return [("tp", 1, 1024), ("fsdp", 2, 1024), ("fsdp", 8, 1024),
            ("fsdp", 2, 128), ("tp+fsdp", 2, 1024), ("tp+fsdp", 2, 128)]


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("kind,dp,min_leaf", _rule_cases())
def test_placements_equal_the_references_specs(name, kind, dp, min_leaf):
    params = _ref_shapes(name)
    model = _port_model(name)
    lay = layouts(model)
    ref, port = jax_rules(name), param_sharding_rules(name)
    if kind == "fsdp":
        ref, port = None, None
    if "fsdp" in kind:
        ref = jax_fsdp_rules(dp, ref, min_leaf_size=min_leaf)
        port = fsdp_rules(dp, port, min_leaf_size=min_leaf)
    flat = tree_flatten_with_path(params)[0]
    assert len(flat) == len(lay)
    cut = 0
    for path, leaf in flat:
        keys = tuple(k.key for k in path)
        tname = _torch_name(keys)
        layout = lay[tname]
        assert layout.ref_shape == tuple(leaf.shape), tname
        want = layout.from_ref(ref(path, leaf) if ref else None)
        got = (port(tname, layout) if port else None) or layout.unsharded()
        assert got == want, (keystr(path), got, want)
        cut += got != layout.unsharded()
    assert cut or name == "convnet" and kind == "tp"


def test_fsdp_small_leaves_stay_replicated():
    """The reference's case: the ConvNet's first conv bias (16,) stays
    whole under fsdp_rules(8); its head kernel is cut over data."""
    model = _port_model("convnet")
    lay = layouts(model)
    rules = fsdp_rules(8, None, min_leaf_size=1024)
    assert rules("conv0.bias", lay["conv0.bias"]) is None
    assert rules("head.weight", lay["head.weight"]) == ((None,), ("data",))


def _port_steps(rank, *, name, params, mesh_cfg, fsdp, batches, global_n,
                min_leaf=1024, lr=1e-2, batch_stats=None):
    """One rank's run of `batches` through the port's image step, laid
    out as the train loop lays it out; its losses and the whole
    parameters after."""
    model = _port_model(name)
    load_flax_params(model, jax.device_get(params), batch_stats)
    mesh = build_mesh(mesh_cfg, "cpu")
    forward, after = parallelize(model, mesh, model_name=name, fsdp=fsdp,
                                 min_leaf_size=min_leaf)
    dp = coords(mesh)["data"][1]
    state = TrainState(0, model, make_optimizer(
        TrainConfig(optimizer="sgd", learning_rate=lr, device="cpu"),
        model, 0, dp))
    step = make_train_step(model, forward=forward, after_backward=after)
    rows = batch_shard(mesh).local_slice(global_n)
    losses = []
    for b in batches:
        state, m = step(state, {
            "image": torch.from_numpy(np.array(b["image"])[rows]),
            "label": torch.from_numpy(np.array(b["label"])[rows]).long()})
        losses.append(float(m["loss"]))
    full = (full_parameters(model) if hasattr(model, "sharding") else
            {n: p.detach().clone() for n, p in model.named_parameters()})
    return losses, full


def _assert_params(got, want_tree, **tol):
    want = flax_to_state_dict(jax.device_get(want_tree))
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   err_msg=n, **tol)


@functools.lru_cache(maxsize=None)
def _vit_reference_setup():
    """The reference's replicated vit_tiny (host copy of its initial
    state) and its train step, built and compiled once per module."""
    from test_tensor_parallel import _batch, _setup

    _, state, step, bsh = _setup(JaxMesh(data=1), devices=jax.devices()[:1])
    b = {k: jax.device_put(v, bsh) for k, v in _batch(8).items()}
    return jax.device_get(state), jit_quick(step, state, b), bsh


def _vit_reference(steps, batch):
    host_state, step, bsh = _vit_reference_setup()
    state = jax.tree.map(jnp.asarray, host_state)
    b = {k: jax.device_put(v, bsh) for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return host_state.params, state.params, losses


def test_tp_matches_replicated():
    """vit_tiny at data=2, tensor=4 against the reference's replicated
    run (tests/test_tensor_parallel.py `test_tp_matches_replicated`)."""
    from test_tensor_parallel import _batch

    batch = _batch(8, seed=4)
    params0, want, want_losses = _vit_reference(2, batch)
    res = ranks(lambda r: _port_steps(
        r, name="vit_tiny", params=params0,
        mesh_cfg=MeshConfig(data=2, tensor=4), fsdp=False,
        batches=[batch, batch], global_n=8), 8)
    for losses, full in res:
        np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
    _assert_params(res[0][1], want, rtol=1e-3, atol=1e-5)


def test_fsdp_composes_with_tp():
    """TP claims `tensor`, FSDP a free dim over `data` (min_leaf_size 128:
    the qkv bias's data cut lies inside its torch dim); two steps equal
    the replicated run's."""
    from test_tensor_parallel import _batch

    batch = _batch(8, seed=1)
    params0, want, want_losses = _vit_reference(2, batch)
    res = ranks(lambda r: _port_steps(
        r, name="vit_tiny", params=params0,
        mesh_cfg=MeshConfig(data=2, tensor=4), fsdp=True, min_leaf=128,
        batches=[batch, batch], global_n=8), 8)
    np.testing.assert_allclose(res[0][0], want_losses, rtol=2e-4)
    _assert_params(res[0][1], want, rtol=1e-3, atol=1e-5)


def test_fsdp_matches_replicated_dp():
    """The ConvNet under FSDP over 8 data ranks (min_leaf_size 128, the
    reference's) against the reference's replicated DP, 3 steps."""
    from test_fsdp import _batch, _make

    batches = [_batch(8, seed=s) for s in range(3)]
    _, state, step, _ = _make(JaxMesh(data=8))
    params0, stats0 = jax.device_get((state.params, state.batch_stats))
    want_losses = []
    for b in batches:
        state, m = step(state, b)
        want_losses.append(float(m["loss"]))
    res = ranks(lambda r: _port_steps(
        r, name="convnet", params=params0, batch_stats=jax.device_get(
            stats0), mesh_cfg=MeshConfig(data=8), fsdp=True, min_leaf=128,
        batches=batches, global_n=8), 8)
    np.testing.assert_allclose(res[0][0], want_losses, rtol=1e-5)
    _assert_params(res[0][1], state.params, atol=1e-5)


def test_lm_tp_numerics_match_replicated():
    """lm_tiny's forward at tensor=8 (8 heads, 4 vocabulary rows a rank)
    against the reference's unsharded forward."""
    jm = jax_create_model("lm_tiny", **{**LM, "num_heads": 8})
    tokens = np.random.default_rng(1).integers(0, 32, (2, 16))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.asarray(tokens))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))

    def rank(r):
        model = create_model("lm_tiny", device="cpu",
                             **{**LM, "num_heads": 8})
        load_flax_params(model, jax.device_get(params))
        shard_state(model, build_mesh(MeshConfig(tensor=8), "cpu"),
                    param_sharding_rules("lm_tiny"), "lm_tiny")
        assert model.blocks[0].attn.num_heads == 1
        assert model.tok_embed.weight.shape == (4, 64)
        with torch.no_grad():
            return model(torch.from_numpy(tokens)).numpy()

    for got in ranks(rank, 8):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_generate_with_tensor_sharded_params():
    """Greedy generation at data=2, tensor=4 (one head a rank, each data
    rank its prompt row) gives exactly the unsharded tokens."""
    jm = jax_create_model("lm_tiny", **LM)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((2, 16), jnp.int32))["params"]
    prompt = np.asarray([[5, 2, 7], [1, 1, 1]])
    want = np.asarray(jax.jit(jax_generate_fn(
        jm, max_new_tokens=8, temperature=0.0))(params, jnp.asarray(
            prompt, jnp.int32)))

    def rank(r):
        model = create_model("lm_tiny", device="cpu", **LM)
        load_flax_params(model, jax.device_get(params))
        mesh = build_mesh(MeshConfig(data=2, tensor=4), "cpu")
        shard_state(model, mesh, param_sharding_rules("lm_tiny"), "lm_tiny")
        assert model.blocks[0].attn.qkv.weight.shape == (3 * 16, 64)
        rows = batch_shard(mesh).local_slice(2)
        gen = make_generate_fn(model, max_new_tokens=8, temperature=0.0)
        return rows, gen(torch.from_numpy(prompt[rows])).numpy()

    res = ranks(rank, 8)
    got = np.zeros_like(want)
    for rows, tokens in res:
        got[rows] = tokens
    np.testing.assert_array_equal(got, want)


def test_heads_must_divide_the_tensor_axis():
    cfg = TrainConfig(model="vit_tiny", dataset="cifar10", device="cpu",
                      synthetic_size=12, batch_size=2,
                      mesh=MeshConfig(tensor=2))
    with pytest.raises(RuntimeError) as err:
        ranks(lambda r: Trainer(cfg), 2)
    assert isinstance(err.value.__cause__, ValueError)
    assert ("tensor parallelism shards attention heads: vit_tiny has 3 "
            "heads, not divisible by --tensor 2 — pass --num_heads (e.g. "
            "4) or a different degree") in str(err.value.__cause__)


def test_lm_base_shaped_step_with_clipping_at_tensor_2():
    """lm_base's widths (12 heads of 64, d 768, mlp 3072), one block: an
    SGD step with clipping on at tensor=2 against the JAX step; the
    grad_norm metric is the sharded global norm, held to JAX's."""
    kw = dict(vocab_size=64, max_len=32, hidden_dim=768, depth=1,
              num_heads=12, mlp_dim=3072)
    cfg = dict(optimizer="sgd", learning_rate=0.1, clip_norm=0.05)
    jm = jax_create_model("lm_tiny", **kw)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"])
    tokens = np.random.default_rng(7).integers(0, 64, (2, 17))
    tx = jax_optimizer(JaxConfig(**cfg), 1)
    jparams = jax.tree.map(jnp.asarray, params)   # the step donates them
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=jparams,
                      batch_stats=None, opt_state=tx.init(jparams))
    jstate, jm_ = jax_lm_step(jm, tx, seed=1)(
        jstate, {"tokens": jnp.asarray(tokens, jnp.int32)})
    assert float(jm_["grad_norm"]) > 2 * cfg["clip_norm"]   # clipping on

    def rank(r):
        model = create_model("lm_tiny", device="cpu", **kw)
        load_flax_params(model, params)
        mesh = build_mesh(MeshConfig(tensor=2), "cpu")
        parallelize(model, mesh, model_name="lm_tiny", fsdp=False)
        state = TrainState(0, model, make_optimizer(
            TrainConfig(**cfg, device="cpu"), model))
        state, m = make_lm_train_step(model, seed=1)(
            state, {"tokens": torch.from_numpy(tokens)})
        return {k: float(v) for k, v in m.items()}, full_parameters(model)

    res = ranks(rank, 2)
    for metrics, _ in res:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(metrics[k], float(jm_[k]),
                                       rtol=1e-4, err_msg=k)
    _assert_params(res[0][1], jstate.params, rtol=1e-3, atol=1e-5)


def test_mesh_config_semantics():
    assert MeshConfig().resolve(8) == (8, 1, 1, 1, 1)
    assert MeshConfig(tensor=4).resolve(8) == (2, 1, 4, 1, 1)
    assert MeshConfig().axis_names == JaxMesh().axis_names
    with pytest.raises(ValueError, match="not divisible by"):
        MeshConfig(tensor=3).resolve(8)
    with pytest.raises(ValueError, match="!= 8 devices"):
        MeshConfig(data=4, tensor=4).resolve(8)
    assert MeshConfig(pipe=2).resolve(8) == (4, 1, 1, 2, 1)
    assert MeshConfig(tensor=2, pipe=2).resolve(8) == (2, 1, 2, 2, 1)
    assert MeshConfig(seq=2, tensor=2).resolve(8) == (2, 2, 2, 1, 1)
    assert MeshConfig(expert=4).resolve(8) == (2, 1, 1, 1, 4)
    assert MeshConfig(seq=2, expert=2).resolve(8) == (2, 2, 1, 1, 2)
    for axis in ("seq", "pipe", "expert"):
        with pytest.raises(ValueError, match=f"{axis}=0"):
            MeshConfig(**{axis: 0})


def test_mesh_order_and_batch_slices():
    """Data outermost, tensor inside: ranks 2k and 2k+1 form a tensor
    group and read the same rows of the global batch."""

    def rank(r):
        mesh = build_mesh(MeshConfig(tensor=2), "cpu")
        c = coords(mesh)
        return r, c["data"], c["tensor"], batch_shard(mesh).local_slice(8)

    for r, data, tensor, rows in ranks(rank, 4):
        assert data == (r // 2, 2) and tensor == (r % 2, 2)
        assert rows == slice(4 * (r // 2), 4 * (r // 2) + 4)
