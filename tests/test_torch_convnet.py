"""The port's ConvNet path (ddp_practice_tpu_torch/models/convnet.py,
ops/batchnorm.py, convert.py, train/steps.py) against the JAX package's
on the CPU, from the same numpy inputs and the same weights through
`convert.py`:

- the converter's ConvNet tree: `Conv_{i}` kernels HWIO -> OIHW (keyed on
  the path, not reshaped as a 4-D qkv kernel), `BatchNorm_{i}` scale,
  bias and running statistics, `Dense_0` as a plain transpose;
- the forward (fp32 and bf16, train mode on batch statistics and eval
  mode on running ones) against the reference's `ConvNet`; the flatten
  is in NHWC order, so a wrong order would move every logit;
- three SGD steps (momentum, label smoothing) against the jitted JAX
  step: parameters and `batch_stats` at 1e-5 in fp32, where the running
  variance's biased-variance rule would show as a drift; one bf16 step
  at the reference tests' bf16 tolerance (2e-2);
- bf16 logits are held to 2e-2 relative plus 2e-2 of the largest
  magnitude where that exceeds 1 (logits reach ~5): XLA on the CPU keeps
  some bf16 intermediates in fp32 (the conv and Dense outputs come back
  off the bf16 grid), so the two sides round at different points;
- the eval step on running statistics and a wrap-padded batch;
- BatchNorm alone: Flax's running variance (the biased batch variance),
  not torch's stock layer's;
- the analytic FLOP count is the reference's;
- experiments/convnet_step.py runs on the CPU (host walls only: no
  device number comes from it there).
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from ddp_practice_tpu.config import PrecisionPolicy as JaxPolicy
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu.train.state import TrainState as JaxState
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu.train.steps import make_eval_step as jax_eval_step
from ddp_practice_tpu.train.steps import make_train_step as jax_train_step
from ddp_practice_tpu.utils import flops as jax_flops
from ddp_practice_tpu_torch.config import PrecisionPolicy, TrainConfig
from ddp_practice_tpu_torch.convert import (
    flax_to_state_dict,
    load_flax_params,
)
from ddp_practice_tpu_torch.models import accepts_fused, create_model
from ddp_practice_tpu_torch.ops.batchnorm import BatchNorm
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
from ddp_practice_tpu_torch.train.steps import make_eval_step, make_train_step
from ddp_practice_tpu_torch.utils import flops

IMAGE = (28, 28, 1)
BF16_TOL = 2e-2     # tests/test_flash_attention.py's bf16 limit


def _moved(tree, rng, scale):
    """Every leaf moved off its init value (running stats off 0 and 1,
    BN scale off 1, biases off 0), so a layout slip cannot hide."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _moved(value, rng, scale)
            continue
        arr = np.asarray(value, np.float32)
        arr = arr + rng.normal(0.0, scale, arr.shape).astype(np.float32)
        out[key] = np.abs(arr) + 0.5 if key == "var" else arr
    return out


def _pair(seed=0, bf16=False):
    """(jax model, params, batch_stats, torch model) with one set of
    weights and running statistics."""
    jpol = JaxPolicy.bf16() if bf16 else JaxPolicy.fp32()
    jm = jax_create_model("convnet", policy=jpol)
    variables = jax.jit(lambda r: jm.init(
        r, jnp.zeros((1, *IMAGE), jnp.float32), train=False))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.device_get(variables["params"])
    for name in ("BatchNorm_0", "BatchNorm_1", "Conv_0", "Dense_0"):
        params[name] = _moved(params[name], rng, 0.05)
    stats = _moved(jax.device_get(variables["batch_stats"]), rng, 0.1)
    tm = create_model("convnet", device="cpu", policy=(
        PrecisionPolicy.bf16() if bf16 else PrecisionPolicy.fp32()))
    load_flax_params(tm, params, stats)
    return (jm, jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, stats), tm)


def _batch(seed, b=8, uint8=False):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, b).astype(np.int32)
    if uint8:
        return rng.integers(0, 256, (b, *IMAGE)).astype(np.uint8), labels
    return rng.random((b, *IMAGE), dtype=np.float32), labels


def _bn_state(tm) -> dict:
    """The port's buffers under the reference's batch_stats names."""
    return {k: v for k, v in tm.state_dict().items() if "running_" in k}


def test_converter_maps_the_convnet_tree():
    rng = np.random.default_rng(0)
    conv = rng.standard_normal((5, 5, 3, 8)).astype(np.float32)   # HWIO
    dense = rng.standard_normal((12, 10)).astype(np.float32)
    sd = flax_to_state_dict({
        "Conv_0": {"kernel": conv, "bias": np.zeros(8)},
        "BatchNorm_0": {"scale": np.ones(8), "bias": np.zeros(8)},
        "Dense_0": {"kernel": dense, "bias": np.zeros(10)},
    })
    assert set(sd) == {"conv0.weight", "conv0.bias", "bn0.weight",
                       "bn0.bias", "head.weight", "head.bias"}
    got = sd["conv0.weight"]
    assert tuple(got.shape) == (8, 3, 5, 5)                        # OIHW
    for o, i, h, w in ((0, 0, 0, 0), (7, 2, 4, 1), (3, 1, 2, 3)):
        assert got[o, i, h, w] == conv[h, w, i, o]
    assert np.array_equal(sd["head.weight"].numpy(), dense.T)
    stats = flax_to_state_dict({"BatchNorm_1": {"mean": np.zeros(4),
                                                "var": np.ones(4)}})
    assert set(stats) == {"bn1.running_mean", "bn1.running_var"}
    tm = create_model("convnet", device="cpu")
    assert {k for k in tm.state_dict()} == {
        f"{m}{i}.{leaf}" for i in range(2) for m, leaf in (
            ("conv", "weight"), ("conv", "bias"), ("bn", "weight"),
            ("bn", "bias"), ("bn", "running_mean"), ("bn", "running_var"))
    } | {"head.weight", "head.bias"}
    assert tuple(tm.head.weight.shape) == (10, 7 * 7 * 32)
    assert not accepts_fused("convnet")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(train, bf16):
    jm, params, stats, tm = _pair(1, bf16=bf16)
    images, _ = _batch(2)
    variables = {"params": params, "batch_stats": stats}
    if train:
        want, upd = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(images))
        want_stats = flax_to_state_dict(jax.device_get(upd["batch_stats"]))
    else:
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            variables, jnp.asarray(images))
        want_stats = flax_to_state_dict(jax.device_get(stats))
    got = tm(torch.from_numpy(images), train=train)
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    want = np.asarray(want)
    tol = BF16_TOL if bf16 else 2e-5
    atol = tol * max(1.0, np.abs(want).max()) if bf16 else tol
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=atol)
    stat_tol = BF16_TOL if bf16 else 1e-5
    for name, value in _bn_state(tm).items():   # eval leaves them alone
        np.testing.assert_allclose(value.numpy(), want_stats[name].numpy(),
                                   rtol=stat_tol, atol=stat_tol * 0.1,
                                   err_msg=name)


@pytest.mark.parametrize("bf16,steps", [(False, 3), (True, 1)])
def test_sgd_steps_match_jax(bf16, steps):
    kw = dict(optimizer="sgd", learning_rate=0.01, momentum=0.9,
              label_smoothing=0.1)
    jm, params, stats, tm = _pair(3, bf16=bf16)
    init = flax_to_state_dict(jax.device_get(stats))   # the step donates
    tx = jax_optimizer(JaxConfig(**kw), 5)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=stats, opt_state=tx.init(params))
    jstep = jax_train_step(jm, tx, label_smoothing=0.1, seed=1)
    state = TrainState(step=0, model=tm, optimizer=make_optimizer(
        TrainConfig(**kw), tm, 5))
    step = make_train_step(tm, label_smoothing=0.1, seed=1)
    tol = BF16_TOL if bf16 else 1e-5
    for i in range(steps):
        images, labels = _batch(10 + i, b=4, uint8=True)
        jstate, jmetrics = jstep(jstate, {"image": jnp.asarray(images),
                                          "label": jnp.asarray(labels)})
        state, metrics = step(state, {
            "image": torch.from_numpy(images),
            "label": torch.from_numpy(labels).long()})
        assert set(metrics) == set(jmetrics) == {"loss", "accuracy",
                                                 "grad_norm"}
        for k in jmetrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                       rtol=tol, atol=tol, err_msg=k)
    assert state.step == int(jstate.step) == steps
    want = flax_to_state_dict(jax.device_get(jstate.params))
    want.update(flax_to_state_dict(jax.device_get(jstate.batch_stats)))
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=tol, atol=tol, err_msg=name)
    for name in init:        # the statistics did move
        assert not np.allclose(got[name].numpy(), init[name].numpy())


def test_eval_step_reads_running_stats_on_a_padded_batch():
    jm, params, stats, tm = _pair(5)
    images, labels = _batch(6, b=6, uint8=True)
    weight = np.array([1, 1, 1, 1, 0, 0], np.float32)
    before = {k: v.clone() for k, v in _bn_state(tm).items()}
    jout = jax_eval_step(jm)(
        JaxState(step=0, params=params, batch_stats=stats, opt_state=None),
        {"image": jnp.asarray(images), "label": jnp.asarray(labels),
         "weight": jnp.asarray(weight)})
    out = make_eval_step(tm)(None, {
        "image": torch.from_numpy(images),
        "label": torch.from_numpy(labels).long(),
        "weight": torch.from_numpy(weight)})
    assert float(out[1]) == float(jout[1]) == 4.0
    assert float(out[0]) == float(jout[0])
    for name, value in _bn_state(tm).items():
        assert torch.equal(value, before[name]), name


def test_batchnorm_keeps_flax_running_variance():
    """36 samples a channel: Flax's running var is 0.9 + 0.1 x the biased
    batch variance; torch's stock layer takes the unbiased one."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 3, 3, 2)).astype(np.float32) * 1.5 + 0.3
    fbn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5)
    variables = fbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    fy, upd = fbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(2)
    y = bn(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(fy), rtol=1e-5, atol=1e-5)
    want_var = np.asarray(upd["batch_stats"]["var"])
    np.testing.assert_allclose(bn.running_var.numpy(), want_var, rtol=1e-6)
    biased = x.reshape(-1, 2).var(axis=0)
    np.testing.assert_allclose(want_var, 0.9 + 0.1 * biased, rtol=1e-5)
    stock = torch.nn.BatchNorm2d(2, momentum=0.1, eps=1e-5)
    stock(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(stock.running_var.detach().numpy(), want_var,
                           rtol=1e-4)


def test_convnet_flops_match_the_reference():
    want = jax_flops.train_flops_per_image("convnet", IMAGE, 10)
    assert flops.train_flops_per_image("convnet", IMAGE, 10) == want
    assert flops.convnet_forward_flops(IMAGE, 10) == \
        jax_flops.convnet_forward_flops(IMAGE, 10)


def test_convnet_step_script_runs_on_the_cpu(tmp_path, monkeypatch):
    from ddp_practice_tpu_torch.experiments import convnet_step

    monkeypatch.chdir(tmp_path)           # its --data_dir is relative
    rows, traced = convnet_step.main(steps=2, device="cpu")
    assert [r[0] for r in rows] == ["fresh", "fresh again", "after a trace",
                                    "after a second trace"]
    assert all(host > 0 and gap is None for _, host, gap in rows)
    assert traced is None
