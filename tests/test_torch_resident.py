"""The port's device-resident steps and their counters (train/steps.py
`make_resident_*`, train/state.py, models/vit.py dropout keys,
train/loop.py placement) on the CPU, where the resident steps run their
per-batch body eagerly, row by row (on the card the same body is
replayed from a CUDA graph: tests/test_torch_cuda.py):

- port vs JAX, from the same numpy corpus, grid and weights (converted):
  the ConvNet with BatchNorm over a 3-row grid (SGD momentum, label
  smoothing): metrics, parameters and batch_stats at
  tests/test_torch_convnet.py's 1e-5; lm_tiny over a 3-row grid of window
  starts under a cosine schedule (so the device lr table is read at every
  apply): metrics and parameters at tests/test_torch_lm_train.py's 1e-5;
  both eval steps (the image one on a wrap-padded weight grid), counts
  exactly and the LM's NLL at 1e-5;
- resident vs per-batch in the port: bit for bit (`torch.equal`) over
  the parameters, buffers, optimizer state and metrics, for the ConvNet
  and for lm_tiny with dropout 0.1 and accumulation over 2 micro-steps
  on a 3-row grid (a remainder of one);
- the Trainer's placement: "auto" takes the resident path for a small
  corpus and streams above `resident_max_bytes`; steps_per_call=-1 needs
  resident data; invalid steps_per_call and data_placement are refused;
  `max_steps_per_epoch` caps a resident epoch; a resident epoch (K = 3
  and the whole epoch) and eval equal the host path's bit for bit;
- the counters: the lr table equals `schedule_lr` at every apply for the
  three schedules (with accumulation too); the dropout key is the same
  from the device counter and from an int, the same across calls, keeps
  1 - rate of the elements, gives two sites unrelated masks, and folds a
  step near 2^62 without overflow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from _torch_port import SMALL, build_pair
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.train.state import TrainState as JaxState
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu.train import steps as jax_steps
from ddp_practice_tpu_torch.config import TrainConfig
from ddp_practice_tpu_torch.convert import flax_to_state_dict
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.models.vit import (
    DropoutKey,
    dropout,
    fold32,
    subkey,
)
from ddp_practice_tpu_torch.train.loop import Trainer
from ddp_practice_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
    schedule_lr,
)
from ddp_practice_tpu_torch.train.steps import (
    make_lm_train_step,
    make_resident_eval_step,
    make_resident_lm_eval_step,
    make_resident_lm_train_step,
    make_resident_train_step,
    make_train_step,
    step_key,
)
from test_torch_convnet import IMAGE, _pair

WINDOW = 25   # lm_tiny at seq 24


def _corpus(seed, n=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, *IMAGE)).astype(np.uint8),
            rng.integers(0, 10, n).astype(np.int32))


def _grid(seed, rows, b, n):
    return np.random.default_rng(seed).integers(0, n, (rows, b)).astype(
        np.int32)


def _image_data(images, labels):
    return {"image": torch.from_numpy(images),
            "label": torch.from_numpy(labels)}


def _leaves(state) -> dict:
    """Every tensor of the port's train state, by name."""
    out = dict(state.model.state_dict())
    for i, p in enumerate(state.optimizer.params):
        for key, value in state.optimizer.inner.state.get(p, {}).items():
            out[f"opt.{i}.{key}"] = value
    for i, acc in enumerate(state.optimizer.acc or ()):
        out[f"acc.{i}"] = acc
    return out


def _assert_identical(a: dict, b: dict):
    assert set(a) == set(b)
    for name, value in a.items():
        assert torch.equal(value, b[name]), name


def test_resident_image_steps_match_jax():
    kw = dict(optimizer="sgd", learning_rate=0.01, momentum=0.9,
              label_smoothing=0.1)
    jm, params, stats, tm = _pair(3)
    images, labels = _corpus(4)
    idx = _grid(5, 3, 4, len(images))
    tx = jax_optimizer(JaxConfig(**kw), 5)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=stats, opt_state=tx.init(params))
    jstep = jax_steps.make_resident_train_step(jm, tx, label_smoothing=0.1,
                                               seed=1)
    jstate, jmetrics = jstep(jstate, {"image": jnp.asarray(images),
                                      "label": jnp.asarray(labels)},
                             jnp.asarray(idx))
    state = TrainState(step=0, model=tm, optimizer=make_optimizer(
        TrainConfig(**kw), tm, 5))
    step = make_resident_train_step(tm, label_smoothing=0.1, seed=1)
    state, metrics = step(state, _image_data(images, labels),
                          torch.from_numpy(idx))
    assert state.step == int(jstate.step) == 3
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    want = flax_to_state_dict(jax.device_get(jstate.params))
    want.update(flax_to_state_dict(jax.device_get(jstate.batch_stats)))
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_resident_image_eval_matches_jax_on_a_padded_grid():
    jm, params, stats, tm = _pair(5)
    images, labels = _corpus(6, n=12)
    idx = _grid(7, 3, 4, len(images))
    weight = np.ones((3, 4), np.float32)
    weight[-1, 2:] = 0.0                           # the wrap-padded tail
    jout = jax_steps.make_resident_eval_step(jm)(
        JaxState(step=0, params=params, batch_stats=stats, opt_state=None),
        {"image": jnp.asarray(images), "label": jnp.asarray(labels)},
        jnp.asarray(idx), jnp.asarray(weight))
    out = make_resident_eval_step(tm)(
        None, _image_data(images, labels), torch.from_numpy(idx),
        torch.from_numpy(weight))
    assert float(out[1]) == float(jout[1]) == 10.0
    assert float(out[0]) == float(jout[0])


def _stream(seed, n=400):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"],
                                                n).astype(np.int32)


def _starts(seed, rows, b, n):
    return np.random.default_rng(seed).integers(
        0, n - WINDOW, (rows, b)).astype(np.int32)


def test_resident_lm_steps_match_jax():
    kw = dict(optimizer="sgd", learning_rate=0.1, momentum=0.9,
              lr_schedule="cosine", epochs=1)
    jm, params, tm = build_pair(5, max_len=32)
    tokens = _stream(8)
    starts = _starts(9, 3, 2, len(tokens))
    tx = jax_optimizer(JaxConfig(**kw), 4)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=None, opt_state=tx.init(params))
    jstep = jax_steps.make_resident_lm_train_step(jm, tx, window=WINDOW,
                                                  seed=1)
    jstate, jmetrics = jstep(jstate, {"tokens": jnp.asarray(tokens)},
                             jnp.asarray(starts))
    state = TrainState(step=0, model=tm, optimizer=make_optimizer(
        TrainConfig(**kw), tm, 4))
    step = make_resident_lm_train_step(tm, window=WINDOW, seed=1)
    state, metrics = step(state, {"tokens": torch.from_numpy(tokens)},
                          torch.from_numpy(starts))
    assert state.step == int(jstate.step) == 3
    assert state.optimizer.applies == 3
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    want = flax_to_state_dict(jax.device_get(jstate.params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_resident_lm_eval_matches_jax():
    jm, params, tm = build_pair(6, max_len=32)
    tokens = _stream(10)
    starts = _starts(11, 3, 2, len(tokens))
    jout = jax_steps.make_resident_lm_eval_step(jm, window=WINDOW)(
        JaxState(step=0, params=params, batch_stats=None, opt_state=None),
        {"tokens": jnp.asarray(tokens)}, jnp.asarray(starts))
    out = make_resident_lm_eval_step(tm, window=WINDOW)(
        None, {"tokens": torch.from_numpy(tokens)},
        torch.from_numpy(starts))
    assert float(out[1]) == float(jout[1]) == 3 * 2 * (WINDOW - 1)
    assert float(out[0]) == float(jout[0])
    np.testing.assert_allclose(float(out[2]), float(jout[2]), rtol=1e-5)


def test_resident_equals_per_batch_convnet():
    kw = dict(optimizer="sgd", learning_rate=0.01, momentum=0.9)
    images, labels = _corpus(12)
    idx = _grid(13, 3, 4, len(images))
    runs = []
    for resident in (True, False):
        tm = _pair(3)[3]
        state = TrainState(step=0, model=tm, optimizer=make_optimizer(
            TrainConfig(**kw), tm, 5))
        if resident:
            step = make_resident_train_step(tm, label_smoothing=0.1, seed=1)
            state, metrics = step(state, _image_data(images, labels),
                                  torch.from_numpy(idx))
        else:
            step = make_train_step(tm, label_smoothing=0.1, seed=1)
            for row in idx:
                state, metrics = step(state, {
                    "image": torch.from_numpy(images[row]),
                    "label": torch.from_numpy(labels[row]).long()})
        runs.append((state, metrics))
    (a, ma), (b, mb) = runs
    assert a.step == b.step == 3
    _assert_identical(_leaves(a), _leaves(b))
    _assert_identical(ma, mb)


def test_resident_equals_per_batch_lm_with_dropout_and_accumulation():
    kw = dict(optimizer="adamw", learning_rate=1e-3, accum_steps=2,
              lr_schedule="warmup_cosine", warmup_steps=2, epochs=1)
    tokens = _stream(14)
    starts = _starts(15, 3, 2, len(tokens))
    runs = []
    for resident in (True, False):
        tm = create_model("lm_tiny", device="cpu", seed=2, max_len=32,
                          dropout_rate=0.1, **SMALL)
        state = TrainState(step=0, model=tm, optimizer=make_optimizer(
            TrainConfig(**kw), tm, 6))
        if resident:
            step = make_resident_lm_train_step(tm, window=WINDOW, seed=1)
            state, metrics = step(state, {"tokens": torch.from_numpy(tokens)},
                                  torch.from_numpy(starts))
        else:
            step = make_lm_train_step(tm, seed=1)
            for row in starts:
                batch = np.stack([tokens[s:s + WINDOW] for s in row])
                state, metrics = step(state, {
                    "tokens": torch.from_numpy(batch).long()})
        runs.append((state, metrics))
    (a, ma), (b, mb) = runs
    assert (a.step, a.optimizer.applies, a.optimizer.micro) == (3, 1, 1)
    assert (b.step, b.optimizer.applies, b.optimizer.micro) == (3, 1, 1)
    _assert_identical(_leaves(a), _leaves(b))
    _assert_identical(ma, mb)
    # the device counters advanced with the Python ones
    assert int(a.device_step()) == 3 and int(a._step_t) == 3


# ------------------------------------------------------------ placement
def _image_config(**kw):
    base = dict(device="cpu", dataset="synthetic", synthetic_size=64,
                epochs=1, batch_size=4, optimizer="sgd", learning_rate=1e-2,
                momentum=0.9, log_every_steps=0)
    return TrainConfig(**{**base, **kw})


def test_auto_placement_takes_the_resident_path_for_a_small_corpus():
    assert Trainer(_image_config()).resident_train_step is not None
    assert Trainer(_image_config(
        data_placement="host")).resident_train_step is None
    over = Trainer(_image_config(resident_max_bytes=1 << 10))
    assert over.resident_train_step is None
    assert Trainer(_image_config(data_placement="device",
                                 resident_max_bytes=1 << 10)
                   ).resident_train_step is not None


def test_whole_epoch_requires_resident():
    with pytest.raises(ValueError, match="steps_per_call=-1"):
        Trainer(_image_config(data_placement="host", steps_per_call=-1))


@pytest.mark.parametrize("kw,match", [
    (dict(steps_per_call=-2), "steps_per_call"),
    (dict(steps_per_call=0), "steps_per_call"),
    (dict(steps_per_call=-32), "steps_per_call"),
    (dict(data_placement="hbm"), "data_placement"),
])
def test_invalid_step_variants_are_refused(kw, match):
    with pytest.raises(ValueError, match=match):
        TrainConfig(**kw)


def test_max_steps_caps_a_resident_epoch():
    trainer = Trainer(_image_config(max_steps_per_epoch=5, steps_per_call=2))
    trainer.train_epoch(0)
    assert trainer.state.step == 5


@pytest.mark.parametrize("steps_per_call", [3, -1])
def test_resident_epoch_and_eval_equal_the_host_path(steps_per_call):
    host = Trainer(_image_config(data_placement="host",
                                 max_steps_per_epoch=7))
    res = Trainer(_image_config(data_placement="device",
                                steps_per_call=steps_per_call,
                                max_steps_per_epoch=7))
    assert res.evaluate() == host.evaluate()
    host.train_epoch(0)
    res.train_epoch(0)
    assert res.state.step == host.state.step == 7
    _assert_identical(_leaves(res.state), _leaves(host.state))
    assert res.evaluate() == host.evaluate()


# ------------------------------------------------------------- counters
@pytest.mark.parametrize("schedule", ["constant", "cosine", "warmup_cosine"])
@pytest.mark.parametrize("accum", [1, 2])
def test_lr_table_equals_the_schedule_at_every_apply(schedule, accum):
    config = TrainConfig(device="cpu", lr_schedule=schedule, warmup_steps=4,
                         epochs=2, learning_rate=0.1, accum_steps=accum)
    layer = torch.nn.Linear(3, 2)
    opt = make_optimizer(config, layer, 5)
    want = schedule_lr(config, 5, 0.1)
    for micro in range(2 * 5 * 2 + 3):   # past the schedule's horizon
        applies = opt.applies
        for p in layer.parameters():
            p.grad = torch.ones_like(p)
        if opt.step():
            assert float(opt.lr) == float(np.float32(want(applies))), \
                (micro, applies)
    assert opt.applies == (2 * 5 * 2 + 3) // accum


def test_dropout_key_from_the_device_counter():
    x = torch.ones(100_000)
    step = torch.tensor(7)
    key = step_key(3407, step)
    assert isinstance(key.step, torch.Tensor)
    assert int(key.step) == step_key(3407, 7).step
    a = dropout(x, 0.1, key)
    assert torch.equal(a, dropout(x, 0.1, key))
    assert torch.equal(a, dropout(x, 0.1, step_key(3407, 7)))
    kept = float((a != 0).float().mean())
    assert abs(kept - 0.9) < 0.01
    np.testing.assert_allclose(float(a.sum()) / len(a), 1.0, atol=0.02)
    # another site or another step: an unrelated mask
    for other in (subkey(key, 0), step_key(3407, 8)):
        b = dropout(x, 0.1, other) != 0
        both = float(((a != 0) & b).float().mean())
        assert abs(both - 0.81) < 0.01


def test_dropout_keys_fold_large_steps_without_overflow():
    for big in (2 ** 62 - 3, 2 ** 62 + 12345, 2 ** 63 - 1):
        t = torch.tensor(big, dtype=torch.int64)
        got = step_key(3407, t).step
        assert int(got) == step_key(3407, big).step   # Python's exact ints
        assert 0 <= int(got) < 2 ** 32
        assert 0 <= int(fold32(t)) < 2 ** 32
    # the key is 32 bits whatever the seed's size
    assert 0 <= step_key(2 ** 70 + 5, 1).step < 2 ** 32
    mask = dropout(torch.ones(1000), 0.5,
                   DropoutKey(torch.tensor(2 ** 32 - 1), 2 ** 32 - 1))
    assert 300 < int((mask != 0).sum()) < 700
