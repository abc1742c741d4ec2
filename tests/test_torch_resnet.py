"""The port's ResNets (ddp_practice_tpu_torch/models/resnet.py,
convert.py, utils/flops.py) against the JAX package's on the CPU, from
the same numpy inputs and the same weights through `convert.py`:

- ResNet-18 (num_filters 8) at 16x16 and 15x15 and ResNet-50
  (num_filters 4) at 32x32 and 33x33: the even sizes pad asymmetrically
  at every stride-2 conv and at ResNet-50's max pool, the odd ones
  symmetrically, so a symmetric torch padding would move every logit;
- fp32 logits in eval and train mode and the updated batch statistics
  after one train-mode forward at 1e-5 relative error norm; one step's
  grads against `jax.grad`, per leaf at 1e-5 (ResNet-18 in fp32, every
  case in float64 on both sides: see the grads test); bf16 logits at
  2e-2 (the reference tests' bf16 limit);
- every leaf of the Flax tree converts to a named entry of the port's
  state and back (`state_dict_to_flax`); the last BatchNorm of each
  block starts at scale zero;
- the analytic FLOP counts are the reference's;
- a ResNet-18 checkpoint the JAX package wrote restores through
  checkpoint/ and its eval logits are the JAX model's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from ddp_practice_tpu import checkpoint as jax_ckpt
from ddp_practice_tpu.config import PrecisionPolicy as JaxPolicy
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu.models import resnet as jax_resnet
from ddp_practice_tpu.ops.losses import cross_entropy as jax_xent
from ddp_practice_tpu.train.state import TrainState as JaxState
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu.utils import flops as jax_flops
from ddp_practice_tpu_torch import checkpoint as ckpt
from ddp_practice_tpu_torch.config import PrecisionPolicy, TrainConfig
from ddp_practice_tpu_torch.convert import (
    flax_to_state_dict,
    load_flax_params,
    state_dict_to_flax,
)
from ddp_practice_tpu_torch.models import accepts_fused, create_model
from ddp_practice_tpu_torch.models.resnet import same_pads
from ddp_practice_tpu_torch.ops.losses import cross_entropy
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
from ddp_practice_tpu_torch.utils import flops

FP32_TOL = 1e-5
BF16_TOL = 2e-2     # tests/test_flash_attention.py's bf16 limit
NUM_CLASSES = 10
# (model, num_filters, image side): even and odd sizes
CASES = [("resnet18", 8, 16), ("resnet18", 8, 15), ("resnet50", 4, 32),
         ("resnet50", 4, 33)]
IDS = [f"{m}-{s}" for m, _, s in CASES]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@functools.lru_cache(maxsize=None)
def _flax(name, nf, side):
    """(jax model, params, batch_stats): every leaf moved off its init
    (scales off 0 and 1, running variances positive), numpy leaves."""
    jm = jax_create_model(name, num_classes=NUM_CLASSES, num_filters=nf)
    shapes = jax.eval_shape(lambda r: jm.init(
        r, jnp.zeros((1, side, side, 3)), train=False),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(side)
    last_bn = "BatchNorm_1" if name == "resnet18" else "BatchNorm_2"

    def draw(path, s):
        leaf = path[-1].key
        fan_in = int(np.prod(s.shape[:-1])) or 1
        if leaf == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        # scales about their init: one, zero on a block's last BatchNorm
        base = float(leaf == "scale" and path[-2].key != last_bn)
        return (base + rng.normal(0.0, 0.1, s.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jm, tree["params"], tree["batch_stats"]


def _pair(name, nf, side, bf16=False):
    jm, params, stats = _flax(name, nf, side)
    if bf16:
        jm = jax_create_model(name, num_classes=NUM_CLASSES, num_filters=nf,
                              policy=JaxPolicy.bf16())
    policy = PrecisionPolicy.bf16() if bf16 else PrecisionPolicy.fp32()
    tm = create_model(name, device="cpu", num_classes=NUM_CLASSES,
                      num_filters=nf, policy=policy)
    load_flax_params(tm, params, stats)
    return jm, params, stats, tm


def _images(side, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((b, side, side, 3), dtype=np.float32),
            rng.integers(0, NUM_CLASSES, b).astype(np.int32))


def test_same_pads_are_flax_padding():
    assert same_pads(32, 3, 2) == (0, 1)
    assert same_pads(224, 7, 2) == (2, 3)
    assert same_pads(112, 3, 2) == (0, 1)
    assert same_pads(33, 3, 2) == (1, 1)
    assert same_pads(15, 3, 1) == (1, 1)
    assert same_pads(16, 1, 2) == (0, 0)


@pytest.mark.parametrize("name,nf,side", CASES[::2], ids=IDS[::2])
def test_every_converted_leaf_is_named_and_maps_back(name, nf, side):
    _, params, stats = _flax(name, nf, side)
    tm = create_model(name, device="cpu", num_classes=NUM_CLASSES,
                      num_filters=nf)
    sd = flax_to_state_dict(params)
    sd.update(flax_to_state_dict(stats))
    assert set(sd) == set(tm.state_dict())
    n_leaves = len(jax.tree.leaves(params)) + len(jax.tree.leaves(stats))
    assert len(sd) == n_leaves
    # convs HWIO -> OIHW, keyed on the path (stem_conv, Conv_{j}, proj)
    blk = "BasicBlock_2" if name == "resnet18" else "BottleneckBlock_3"
    kernel = params[blk]["proj"]["kernel"]
    assert np.array_equal(sd[f"{blk}.proj.weight"].numpy(),
                          kernel.transpose(3, 2, 0, 1))
    assert np.array_equal(sd["stem_conv.weight"].numpy(),
                          params["stem_conv"]["kernel"].transpose(3, 2, 0, 1))
    assert np.array_equal(sd[f"{blk}.proj_bn.running_var"].numpy(),
                          stats[blk]["proj_bn"]["var"])
    assert np.array_equal(sd["head.weight"].numpy(),
                          params["Dense_0"]["kernel"].T)
    load_flax_params(tm, params, stats)
    sd_back = tm.state_dict()
    for tree in (params, stats):
        back = state_dict_to_flax(sd_back, tree)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert np.array_equal(a, b)
    assert not accepts_fused(name)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_last_batchnorm_of_each_block_starts_at_zero(name):
    tm = create_model(name, device="cpu", num_filters=4)
    zeros = {n for n, p in tm.named_parameters()
             if n.endswith("weight") and "bn" in n and not p.any()}
    last = "bn1" if name == "resnet18" else "bn2"
    assert zeros == {f"{b}.{last}.weight" for b in tm.block_names}
    n_blocks = 8 if name == "resnet18" else 16
    assert len(tm.block_names) == n_blocks
    assert tm.stem_bn.weight.eq(1).all()
    # against Flax's init, on two stages (a block without and one with
    # a projection) to keep the compile short
    tm = create_model(name, device="cpu", num_filters=4, stage_sizes=(1, 1))
    zeros = {n for n, p in tm.named_parameters()
             if n.endswith("weight") and "bn" in n and not p.any()}
    jm = jax_create_model(name, num_filters=4, stage_sizes=(1, 1))
    variables = jax.jit(lambda r: jm.init(
        r, jnp.zeros((1, 8, 8, 3)), train=False))(jax.random.PRNGKey(0))
    want = {k for k, v in flax_to_state_dict(
        jax.device_get(variables["params"])).items()
        if k.endswith("weight") and "bn" in k and not v.any()}
    assert zeros == want


@pytest.mark.parametrize("name,nf,side", CASES, ids=IDS)
def test_fp32_logits_and_batch_stats_match_jax(name, nf, side):
    jm, params, stats, tm = _pair(name, nf, side)
    x, _ = _images(side)
    variables = {"params": params, "batch_stats": stats}
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, NUM_CLASSES)
    assert _rel(got.detach(), want) <= FP32_TOL
    want, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    got = tm(torch.from_numpy(x), train=True)
    assert _rel(got.detach(), want) <= FP32_TOL
    back = state_dict_to_flax(tm.state_dict(), stats)
    for path, value in jax.tree_util.tree_leaves_with_path(
            upd["batch_stats"]):
        mine = back
        for k in path:
            mine = mine[k.key]
        assert _rel(mine, value) <= FP32_TOL, jax.tree_util.keystr(path)


def _jax_fp64_grads(name, nf, params, stats, x, labels):
    """jax.grad of the JAX package's ResNet computing in float64 (its
    logits fp32, as in fp32), with float64 copies of the weights."""
    cls = jax_resnet.ResNet18 if name == "resnet18" else jax_resnet.ResNet50
    with jax.enable_x64():
        jm = cls(num_classes=NUM_CLASSES, num_filters=nf, dtype=jnp.float64,
                 param_dtype=jnp.float64)
        p64, s64 = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
                    for t in (params, stats))

        def loss_fn(p):
            logits, _ = jm.apply({"params": p, "batch_stats": s64},
                                 jnp.asarray(x, jnp.float64), train=True,
                                 mutable=["batch_stats"])
            return jax_xent(logits, labels)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p64)
        return float(loss), jax.device_get(grads)


# fp32 on both sides for ResNet-18; float64 on both sides for every case
GRAD_CASES = [c + ("float32",) for c in CASES[:2]] + [
    c + ("float64",) for c in CASES]


@pytest.mark.parametrize("name,nf,side,dtype", GRAD_CASES,
                         ids=[f"{m}-{s}-{d}" for m, _, s, d in GRAD_CASES])
def test_one_step_grads_match_jax_grad(name, nf, side, dtype):
    """One train-mode step's loss and grads at 1e-5 per leaf. In fp32 the
    two sides' summation orders alone differ by more than that on
    ResNet-50's BatchNorm grads (its last stage normalises 4 values a
    channel at 32x32, batch 4): against float64 JAX, the port's fp32
    grads are off by up to 2.4e-5 and JAX's own fp32 by up to 2.7e-3
    (33x33, batch 8). So the fp32 case runs ResNet-18, and every model
    also runs with both sides computing in float64, where layout,
    padding and BatchNorm rules are held without fp32 rounding."""
    jm, params, stats, _ = _pair(name, nf, side)
    x, labels = _images(side, seed=1)
    if dtype == "float64":
        want_loss, want = _jax_fp64_grads(name, nf, params, stats, x,
                                          labels)
        tm = create_model(name, device="cpu", num_classes=NUM_CLASSES,
                          num_filters=nf, policy=PrecisionPolicy(
                              torch.float64, torch.float64))
        load_flax_params(tm, params, stats)
    else:
        def loss_fn(p):
            logits, _ = jm.apply({"params": p, "batch_stats": stats}, x,
                                 train=True, mutable=["batch_stats"])
            return jax_xent(logits, labels)

        want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
        tm = _pair(name, nf, side)[3]
    loss = cross_entropy(tm(torch.from_numpy(x).to(tm.dtype), train=True),
                         torch.from_numpy(labels).long())
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= FP32_TOL * abs(
        float(want_loss))
    got = state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()},
                             params)
    for path, value in jax.tree_util.tree_leaves_with_path(want):
        mine = got
        for k in path:
            mine = mine[k.key]
        assert _rel(mine, value) <= FP32_TOL, jax.tree_util.keystr(path)


@pytest.mark.parametrize("name,nf,side", CASES[:1] + CASES[3:], ids=[
    IDS[0], IDS[3]])
def test_bf16_logits_match_jax(name, nf, side):
    jm, params, stats, tm = _pair(name, nf, side, bf16=True)
    x, _ = _images(side, seed=2)
    variables = {"params": params, "batch_stats": stats}
    for train in (False, True):
        want = jax.jit(lambda v, x: jm.apply(
            v, x, train=train, mutable=["batch_stats"])[0])(variables, x)
        got = tm(torch.from_numpy(x), train=train)
        assert got.dtype == torch.float32
        assert _rel(got.detach(), want) <= BF16_TOL, train


@pytest.mark.parametrize("name,shape,classes", [
    ("resnet18", (32, 32, 3), 10), ("resnet50", (224, 224, 3), 1000)])
def test_resnet_flops_match_the_reference(name, shape, classes):
    want = jax_flops.train_flops_per_image(name, shape, classes)
    assert flops.train_flops_per_image(name, shape, classes) == want
    fwd = getattr(flops, f"{name}_forward_flops")
    assert fwd() == getattr(jax_flops, f"{name}_forward_flops")()
    assert flops.resnet_forward_flops((15, 15, 3), num_filters=8) == \
        jax_flops.resnet_forward_flops((15, 15, 3), num_filters=8)


def test_restore_a_jax_resnet18_checkpoint(tmp_path):
    """A ResNet-18 (num_filters 8) train state the JAX package wrote under
    SGD with momentum (its momentum trace filled from a seed): params,
    batch_stats, the trace and the step restore into the port, whose eval
    logits are then the JAX model's."""
    kw = dict(optimizer="sgd", learning_rate=0.01, momentum=0.9)
    jm, params, stats = _flax("resnet18", 8, 16)
    tx = jax_optimizer(JaxConfig(**kw), 4)
    rng = np.random.default_rng(4)
    opt_state = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32)
        if np.ndim(a) else a, jax.device_get(tx.init(params)))
    jstate = JaxState(step=jnp.asarray(3, jnp.int32), params=params,
                      batch_stats=stats, opt_state=opt_state)
    d = str(tmp_path / "jax")
    jax_ckpt.save(d, jstate, extra={"step": 3, "model": "resnet18"})
    model = create_model("resnet18", device="cpu", num_filters=8, seed=9)
    state = ckpt.restore(d, TrainState(step=0, model=model,
                                       optimizer=make_optimizer(
                                           TrainConfig(**kw), model, 4)))
    assert state.step == 3
    trace = flax_to_state_dict(opt_state[0].trace)
    for name, p in model.named_parameters():
        assert torch.equal(
            state.optimizer.inner.state[p]["momentum_buffer"], trace[name])
    x, _ = _images(16, b=8, seed=3)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, x)
    got = model(torch.from_numpy(x))
    assert _rel(got.detach(), want) <= FP32_TOL
