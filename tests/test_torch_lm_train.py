"""The port's LM training path against the JAX package's, from one set of
converted weights (tests/_torch_port.py `build_pair`, the SMALL decoder:
2 heads of 64, so the JAX flash path really runs its packed Pallas
kernels in interpret mode):

- the training forward's logits (2e-5) and every parameter's gradient of
  the mean next-token loss (2e-4) against jax.value_and_grad, for learned
  and RoPE positions, tied and untied heads, attn_impl xla and flash
  (the port's plain flash path) and remat. JAX grads map onto the port's
  names with the same converter as the weights (a grad tree has the
  params' structure);
- two `make_lm_train_step` steps against the jitted JAX step for each
  optimizer, weight decay, clipping, accumulation and schedule case: the
  parameters after (1e-5) and each step's metrics (1e-5). Adam divides
  each gradient element by its own magnitude (+1e-8), so where a
  gradient is rounding noise its update is noise of size lr: the key
  bias gets an exactly zero gradient (softmax ignores a shift shared by
  every key) and a barely active GELU unit a ~1e-8 one. Under Adam the
  elements whose gradient fell below 1e-6 at some step are held to
  Adam's bound instead, |update| <= lr (1 + weight_decay |p|) per step;
- `make_lm_eval_step`'s (correct, total, nll).

Dropout is 0: masks cannot match across frameworks (threefry vs Philox).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import build_pair
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.ops.losses import cross_entropy as jax_cross_entropy
from ddp_practice_tpu.train.state import TrainState as JaxState
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu.train.steps import make_lm_eval_step as jax_eval_step
from ddp_practice_tpu.train.steps import make_lm_train_step as jax_train_step
from ddp_practice_tpu_torch.config import TrainConfig
from ddp_practice_tpu_torch.convert import flax_to_state_dict
from ddp_practice_tpu_torch.ops.losses import cross_entropy
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
from ddp_practice_tpu_torch.train.steps import (
    make_lm_eval_step,
    make_lm_train_step,
)

VOCAB = 64


def _tokens(seed, b=2, s=24):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s + 1))


@pytest.mark.parametrize("pos_emb,tied,attn_impl,remat", [
    ("learned", False, "xla", False),
    ("rope", True, "xla", False),
    ("learned", False, "flash", False),
    ("rope", False, "flash", False),
    ("learned", True, "flash", True),
    ("rope", False, "xla", True),
])
def test_forward_and_grads_match_jax(pos_emb, tied, attn_impl, remat):
    kw = dict(max_len=32, pos_emb=pos_emb, tied_embeddings=tied,
              attn_impl=attn_impl, remat=remat)
    jm, params, tm = build_pair(3, **kw)
    tokens = _tokens(4)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(inputs, jnp.int32),
                          train=True)
        return jax_cross_entropy(logits, jnp.asarray(targets)), logits

    (jl, jlogits), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    logits = tm(torch.from_numpy(inputs), train=True)
    loss = cross_entropy(logits, torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-5)
    want = flax_to_state_dict(jax.device_get(jgrads))
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


CASES = {
    "sgd": dict(optimizer="sgd", learning_rate=0.1),
    "sgd_momentum_wd": dict(optimizer="sgd", learning_rate=0.1,
                            momentum=0.9, weight_decay=0.01),
    "adam": dict(optimizer="adam", learning_rate=1e-4),
    "adamw_wd": dict(optimizer="adamw", learning_rate=1e-4,
                     weight_decay=0.1),
    "clip": dict(optimizer="sgd", learning_rate=0.1, clip_norm=0.5),
    "accum2": dict(optimizer="sgd", learning_rate=0.1, momentum=0.9,
                   accum_steps=2),
    "warmup_cosine": dict(optimizer="adamw", learning_rate=1e-4,
                          lr_schedule="warmup_cosine", warmup_steps=1,
                          epochs=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax(case):
    kw = CASES[case]
    steps_per_epoch = 5
    jm, params, tm = build_pair(5, max_len=32, attn_impl="flash")
    tx = jax_optimizer(JaxConfig(**kw), steps_per_epoch)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=None, opt_state=tx.init(params))
    jstep = jax_train_step(jm, tx, seed=1)
    state = TrainState(step=0, model=tm, optimizer=make_optimizer(
        TrainConfig(**kw), tm, steps_per_epoch))
    step = make_lm_train_step(tm, seed=1)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    noise = {n: torch.zeros_like(p, dtype=torch.bool)
             for n, p in tm.named_parameters()}
    for i in range(2):
        tokens = _tokens(10 + i)
        jstate, jmetrics = jstep(jstate, {"tokens": jnp.asarray(tokens,
                                                                jnp.int32)})
        state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
        for n, p in tm.named_parameters():
            noise[n] |= p.grad.abs() < 1e-6
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    assert state.step == int(jstate.step) == 2
    want = flax_to_state_dict(jax.device_get(jstate.params))
    adam = kw["optimizer"] in ("adam", "adamw")
    for name, p in tm.named_parameters():
        got, ref = p.detach(), want[name]
        held = ~noise[name] if adam else torch.ones_like(noise[name])
        np.testing.assert_allclose(got[held].numpy(), ref[held].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
        if adam:   # Adam (+ decay) moves an element at most lr per step
            wd = kw.get("weight_decay", 0.0)
            bound = 2 * kw["learning_rate"] * (
                1 + wd * float(before[name].abs().max()) + 1e-3)
            assert (got - before[name]).abs().max() <= bound, name
            assert (ref - before[name]).abs().max() <= bound, name


def test_eval_step_matches_jax():
    jm, params, tm = build_pair(6, max_len=32, attn_impl="flash")
    tokens = _tokens(20, b=3)
    jout = jax_eval_step(jm)(
        JaxState(step=0, params=params, batch_stats=None, opt_state=None),
        {"tokens": jnp.asarray(tokens, jnp.int32)})
    out = make_lm_eval_step(tm)(None, {"tokens": torch.from_numpy(tokens)})
    for got, want in zip(out, jout):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
