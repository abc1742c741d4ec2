"""The port's chunked steps (train/steps.py `make_chunked_*`: K steps a
call over K stacked batches) and `data/loader.py prefetch_chunked` on the
CPU, where a chunk runs its per-batch body eagerly K times (on the card
it is replays of one captured CUDA graph: tests/test_torch_cuda.py).
These mirror tests/test_chunked.py:

- chunked equals sequential in the port, bit for bit (`torch.equal`),
  for the ConvNet with BatchNorm (SGD momentum) and, with accumulation
  over 2 micro-steps (so one chunk of 4 holds two applies), lm_tiny;
- the port's chunked steps against the JAX package's on the same numpy
  batches and converted weights: the ConvNet (parameters and
  batch_stats at 1e-5) and lm_tiny under a cosine schedule (1e-5);
- chunked eval sums the per-batch step's weighted counts over a padded
  tail exactly, and equals the JAX package's chunked eval;
- `prefetch_chunked` keeps the order, stacks K batches a chunk and
  yields the tail as single batches;
- the Trainer on host data with steps_per_call K: chunked eval equals the
  per-batch eval, an epoch trains the capped number of steps, also when
  the cap does not divide by K, and equals the per-batch epoch bit for
  bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from _torch_port import SMALL, build_pair
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.train import steps as jax_steps
from ddp_practice_tpu.train.state import TrainState as JaxState
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu_torch.config import TrainConfig
from ddp_practice_tpu_torch.convert import flax_to_state_dict
from ddp_practice_tpu_torch.data.loader import prefetch_chunked
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.train.loop import Trainer
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
from ddp_practice_tpu_torch.train.steps import (
    make_chunked_eval_step,
    make_chunked_lm_train_step,
    make_chunked_train_step,
    make_eval_step,
    make_lm_train_step,
    make_train_step,
)
from test_torch_convnet import _batch, _pair
from test_torch_resident import _assert_identical, _leaves

SGD = dict(optimizer="sgd", learning_rate=0.01, momentum=0.9)


def _image_batches(seed, k=4, b=4):
    out = []
    for i in range(k):
        images, labels = _batch(seed + i, b=b, uint8=True)
        out.append({"image": images, "label": labels,
                    "weight": np.ones(b, np.float32)})
    return out


def _torch(batch):
    return {k: (torch.from_numpy(v).long() if k == "label"
                else torch.from_numpy(v)) for k, v in batch.items()}


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def test_chunked_equals_sequential_convnet():
    batches = _image_batches(20)
    runs = []
    for chunked in (True, False):
        tm = _pair(3)[3]
        state = TrainState(step=0, model=tm, optimizer=make_optimizer(
            TrainConfig(**SGD), tm, 5))
        if chunked:
            step = make_chunked_train_step(tm, num_steps=4, seed=1)
            state, metrics = step(state, _torch(_stack(batches)))
        else:
            step = make_train_step(tm, seed=1)
            for b in batches:
                state, metrics = step(state, _torch(b))
        runs.append((state, metrics))
    (a, ma), (b, mb) = runs
    assert a.step == b.step == 4
    _assert_identical(_leaves(a), _leaves(b))
    _assert_identical(ma, mb)


def _tokens(seed, k=4, b=2, s=24):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], (k, b, s + 1)).astype(np.int32)


def test_chunked_equals_sequential_lm_with_accumulation():
    kw = dict(optimizer="adam", learning_rate=1e-3, accum_steps=2)
    tokens = _tokens(21)
    runs = []
    for chunked in (True, False):
        tm = create_model("lm_tiny", device="cpu", seed=2, max_len=32,
                          **SMALL)
        state = TrainState(step=0, model=tm, optimizer=make_optimizer(
            TrainConfig(**kw), tm, 6))
        if chunked:
            step = make_chunked_lm_train_step(tm, num_steps=4, seed=1)
            state, metrics = step(state, {"tokens": torch.from_numpy(
                tokens).long()})
        else:
            step = make_lm_train_step(tm, seed=1)
            for t in tokens:
                state, metrics = step(state, {"tokens": torch.from_numpy(
                    t).long()})
        runs.append((state, metrics))
    (a, ma), (b, mb) = runs
    assert (a.step, a.optimizer.applies) == (b.step, b.optimizer.applies) \
        == (4, 2)
    _assert_identical(_leaves(a), _leaves(b))
    _assert_identical(ma, mb)


def test_chunked_steps_refuse_another_chunk_size():
    tm = _pair(3)[3]
    state = TrainState(step=0, model=tm, optimizer=make_optimizer(
        TrainConfig(**SGD), tm, 5))
    step = make_chunked_train_step(tm, num_steps=4)
    with pytest.raises(ValueError, match="built for 4"):
        step(state, _torch(_stack(_image_batches(22, k=3))))


def test_chunked_convnet_matches_jax():
    jm, params, stats, tm = _pair(4)
    batches = _image_batches(23)
    tx = jax_optimizer(JaxConfig(**SGD), 5)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=stats, opt_state=tx.init(params))
    jchunk = jax_steps.make_chunked_train_step(jm, tx, num_steps=4, seed=1)
    stacked = _stack(batches)
    jstate, jmetrics = jchunk(jstate, {k: jnp.asarray(v) for k, v in
                                       stacked.items() if k != "weight"})
    state = TrainState(step=0, model=tm, optimizer=make_optimizer(
        TrainConfig(**SGD), tm, 5))
    state, metrics = make_chunked_train_step(tm, num_steps=4, seed=1)(
        state, _torch(stacked))
    assert state.step == int(jstate.step) == 4
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    want = flax_to_state_dict(jax.device_get(jstate.params))
    want.update(flax_to_state_dict(jax.device_get(jstate.batch_stats)))
    got = tm.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_chunked_lm_matches_jax():
    kw = dict(optimizer="sgd", learning_rate=0.1, momentum=0.9,
              lr_schedule="cosine", epochs=1)
    jm, params, tm = build_pair(7, max_len=32)
    tokens = _tokens(24)
    tx = jax_optimizer(JaxConfig(**kw), 5)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=None, opt_state=tx.init(params))
    jchunk = jax_steps.make_chunked_lm_train_step(jm, tx, num_steps=4,
                                                  seed=1)
    jstate, jmetrics = jchunk(jstate, {"tokens": jnp.asarray(tokens)})
    state = TrainState(step=0, model=tm, optimizer=make_optimizer(
        TrainConfig(**kw), tm, 5))
    state, metrics = make_chunked_lm_train_step(tm, num_steps=4, seed=1)(
        state, {"tokens": torch.from_numpy(tokens).long()})
    assert state.step == int(jstate.step) == 4
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    want = flax_to_state_dict(jax.device_get(jstate.params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_chunked_eval_matches_per_batch_and_jax():
    jm, params, stats, tm = _pair(5)
    batches = _image_batches(25)
    batches[-1]["weight"][1:] = 0.0                     # a padded tail
    c_ref = t_ref = 0.0
    step = make_eval_step(tm)
    for b in batches:
        c, t = step(None, _torch(b))
        c_ref += float(c)
        t_ref += float(t)
    stacked = _stack(batches)
    c, t = make_chunked_eval_step(tm, num_steps=4)(None, _torch(stacked))
    assert float(t) == t_ref == 4 * 3 + 1
    assert float(c) == c_ref
    jc, jt = jax_steps.make_chunked_eval_step(jm, num_steps=4)(
        JaxState(step=0, params=params, batch_stats=stats, opt_state=None),
        {k: jnp.asarray(v) for k, v in stacked.items()})
    assert (float(jc), float(jt)) == (float(c), float(t))


def test_prefetch_chunked_order_and_tail():
    host = [{"image": np.full((8, 2, 2, 1), i, np.float32),
             "label": np.full((8,), i, np.int32)} for i in range(10)]
    seen = []

    def to_device(batch):
        seen.append(batch["label"].shape)
        return {k: torch.from_numpy(v) for k, v in batch.items()}

    got = list(prefetch_chunked(iter(host), 4, to_device, size=2))
    assert [t for t, _ in got] == ["chunk", "chunk", "single", "single"]
    assert seen == [(4, 8), (4, 8), (8,), (8,)]      # one copy a chunk
    first = got[0][1]["label"]
    assert tuple(first.shape) == (4, 8)
    assert first[:, 0].tolist() == [0, 1, 2, 3]
    assert got[1][1]["image"][:, 0, 0, 0, 0].tolist() == [4, 5, 6, 7]
    assert torch.equal(got[2][1]["label"], torch.full((8,), 8,
                                                      dtype=torch.int32))


def _host_config(**kw):
    base = dict(device="cpu", dataset="synthetic", synthetic_size=64,
                epochs=1, batch_size=4, optimizer="adam",
                learning_rate=1e-3, log_every_steps=0,
                data_placement="host")
    return TrainConfig(**{**base, **kw})


def test_trainer_chunked_eval_equals_per_batch():
    chunked = Trainer(_host_config(steps_per_call=4))
    assert chunked.chunk_eval_step is not None
    assert chunked.evaluate() == Trainer(_host_config()).evaluate()


@pytest.mark.parametrize("cap", [12, 10])
def test_trainer_chunked_epoch_takes_the_capped_steps(cap):
    chunked = Trainer(_host_config(steps_per_call=4, max_steps_per_epoch=cap))
    chunked.train_epoch(0)
    assert chunked.state.step == cap
    plain = Trainer(_host_config(max_steps_per_epoch=cap))
    plain.train_epoch(0)
    _assert_identical(_leaves(chunked.state), _leaves(plain.state))
