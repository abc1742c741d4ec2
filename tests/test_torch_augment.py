"""The port's on-device augmentation (ddp_practice_tpu_torch/ops/augment.py
and its wiring in train/steps.py) against the JAX package's on the CPU:

- `random_crop_flip` fed the draws JAX made for a key (its randint
  offsets and bernoulli mirror mask) equals the reference's output bit
  for bit; `random_resized_crop` fed JAX's uniforms agrees with
  `jax.image.scale_and_translate`'s resample to 1e-5 absolute (even,
  odd and non-square sizes, flip on and off);
- the port's own draws (the device hash, keyed on (seed, step)) are
  deterministic per (seed, step), differ across steps and seeds, stay in
  range, are the same from an int step and from the device step counter,
  and are not the dropout key;
- an augmented training step (ResNet-18 at num_filters 8, 12x12 uint8
  images) gives the same losses and parameters bit for bit eagerly,
  chunked (K = 3) and resident over the same global steps, for both
  kinds; it trains on other pixels than the unaugmented step; a step
  restored to a later step counter draws that step's crops;
- unknown kinds raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from ddp_practice_tpu.ops import augment as jax_augment
from ddp_practice_tpu_torch.config import TrainConfig
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.ops import augment
from ddp_practice_tpu_torch.train import steps
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
from ddp_practice_tpu_torch.train.steps import (
    make_chunked_train_step,
    make_resident_train_step,
    make_train_step,
    step_key,
)

SHAPES = [(8, 16, 16, 3), (5, 15, 12, 1), (4, 32, 32, 3)]


def _images(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("pad,flip", [(4, True), (2, False), (0, True)])
def test_crop_flip_with_jax_draws_is_bit_equal(shape, pad, flip):
    x = _images(shape)
    key = jax.random.PRNGKey(sum(shape) + pad)
    want = np.asarray(jax_augment.random_crop_flip(
        jnp.asarray(x), key, pad=pad, flip=flip))
    kc, kf = jax.random.split(key)
    offsets = np.array(jax.random.randint(kc, (shape[0], 2), 0,
                                          2 * pad + 1))
    mirror = np.array(jax.random.bernoulli(kf, 0.5, (shape[0],)))
    got = augment.random_crop_flip(
        torch.from_numpy(x), pad=pad, flip=flip,
        offsets=torch.from_numpy(offsets), mirror=torch.from_numpy(mirror))
    assert np.array_equal(got.numpy(), want)
    # both branches in one batch, against numpy: pad, crop, mirror
    alt = np.arange(shape[0]) % 2 == 0
    got = augment.random_crop_flip(
        torch.from_numpy(x), pad=pad, flip=flip,
        offsets=torch.from_numpy(offsets), mirror=torch.from_numpy(alt))
    padded = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    h, w = shape[1:3]
    for i, (dy, dx) in enumerate(offsets):
        crop = padded[i, dy:dy + h, dx:dx + w]
        want = crop[:, ::-1] if flip and alt[i] else crop
        assert np.array_equal(got[i].numpy(), want), i


@pytest.mark.parametrize("shape", SHAPES + [(3, 24, 40, 3)])
@pytest.mark.parametrize("flip", [True, False])
def test_resized_crop_with_jax_draws_matches(shape, flip):
    x = _images(shape, seed=1)
    b = shape[0]
    key = jax.random.PRNGKey(b)
    want = np.asarray(jax_augment.random_resized_crop(
        jnp.asarray(x), key, flip=flip))
    ka, kr, kp, kf = jax.random.split(key, 4)
    draws = augment.RRCDraws(*(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(ka, (b,)), jax.random.uniform(kr, (b,)),
        jax.random.uniform(kp, (b, 2)),
        jax.random.bernoulli(kf, 0.5, (b,)))))
    got = augment.random_resized_crop(torch.from_numpy(x), flip=flip,
                                      draws=draws)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert not np.allclose(got.numpy(), x, atol=1e-3)   # it resampled


@pytest.mark.parametrize("key", [
    augment.augment_rng,
    lambda seed, step: step_key(seed, step).step,
], ids=["augment", "dropout"])
def test_keys_chain_seed_then_step(key):
    """Seed a at step b draws apart from seed b at step a (the
    reference's fold_in chain), on ints and on the device counter."""
    for a, b in ((0, 1), (3, 7), (3407, 12), (2 ** 40 + 1, 5)):
        assert key(a, b) != key(b, a)
        assert int(key(a, torch.tensor(b))) == key(a, b)
        assert int(key(b, torch.tensor(a))) == key(b, a)


def test_device_draws_are_deterministic_in_range_and_per_step():
    step_t = torch.tensor(7, dtype=torch.int64)
    k = augment.augment_rng(3, step_t)
    assert int(k) == augment.augment_rng(3, 7)
    assert augment.augment_rng(3, 8) != augment.augment_rng(3, 7)
    assert augment.augment_rng(4, 7) != augment.augment_rng(3, 7)
    assert augment.augment_rng(3, 7) != int(step_key(3, 7).step)
    off, mirror = augment.crop_flip_draws(k, 64, 4, "cpu")
    off2, mirror2 = augment.crop_flip_draws(augment.augment_rng(3, 7), 64,
                                            4, "cpu")
    assert torch.equal(off, off2) and torch.equal(mirror, mirror2)
    assert off.shape == (64, 2) and off.min() >= 0 and off.max() <= 8
    assert len(off.unique()) == 9 and 8 < int(mirror.sum()) < 56
    off3, mirror3 = augment.crop_flip_draws(augment.augment_rng(3, 8), 64,
                                            4, "cpu")
    assert not torch.equal(off, off3) and not torch.equal(mirror, mirror3)
    d = augment.rrc_draws(k, 256, "cpu")
    for u in (d.area, d.ratio, d.position):
        assert u.dtype == torch.float32 and 0.0 <= u.min() and u.max() < 1.0
        assert 0.4 < float(u.mean()) < 0.6
    assert not torch.equal(d.area, d.ratio)
    assert torch.equal(d.area, augment.rrc_draws(int(k), 256, "cpu").area)


def test_kinds_dispatch_and_unknown_kinds_raise():
    x = torch.from_numpy(_images((4, 8, 8, 3)))
    key = augment.augment_rng(0, 1)
    assert augment.apply_augment(x, key, False) is x
    assert torch.equal(augment.apply_augment(x, key, True),
                       augment.apply_augment(x, key, "crop_flip"))
    assert torch.equal(augment.apply_augment(x, key, "rrc"),
                       augment.random_resized_crop(x, key))
    with pytest.raises(ValueError, match="unknown augment kind"):
        augment.apply_augment(x, key, "mixup")
    with pytest.raises(ValueError, match="unknown augment kind"):
        make_train_step(torch.nn.Linear(1, 1), augment="mixup")
    with pytest.raises(ValueError, match="augment_kind"):
        TrainConfig(augment=True, augment_kind="mixup")


IMG = (12, 12, 3)


def _state(seed=0):
    model = create_model("resnet18", device="cpu", num_filters=8,
                         image_shape=IMG, seed=seed)
    cfg = TrainConfig(optimizer="sgd", learning_rate=0.05, momentum=0.9)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model, 3))


def _corpus(n=12):
    rng = np.random.default_rng(5)
    return (torch.from_numpy(rng.integers(0, 256, (n, *IMG)).astype(
        np.uint8)), torch.from_numpy(rng.integers(0, 10, n).astype(np.int32)))


def _leaves(state):
    out = dict(state.model.state_dict())
    for i, p in enumerate(state.optimizer.params):
        out[f"opt.{i}"] = state.optimizer.inner.state[p]["momentum_buffer"]
    return out


@pytest.mark.parametrize("kind", ["crop_flip", "rrc"])
def test_eager_chunked_and_resident_steps_augment_alike(kind):
    images, labels = _corpus()
    idx = torch.tensor([[0, 3, 5, 7], [1, 2, 9, 11], [4, 6, 8, 10]])
    batches = [{"image": images[r], "label": labels[r].long()} for r in idx]

    eager = _state()
    step = make_train_step(eager.model, seed=2, augment=kind)
    losses = []
    for batch in batches:
        eager, m = step(eager, batch)
        losses.append(m["loss"])

    chunked = _state()
    chunk = make_chunked_train_step(chunked.model, num_steps=3, seed=2,
                                    augment=kind)
    chunked, mc = chunk(chunked, {
        "image": torch.stack([b["image"] for b in batches]),
        "label": torch.stack([b["label"] for b in batches])})

    resident = _state()
    run = make_resident_train_step(resident.model, seed=2, augment=kind)
    resident, mr = run(resident, {"image": images, "label": labels}, idx)

    assert eager.step == chunked.step == resident.step == 3
    assert torch.equal(mc["loss"], losses[-1])
    assert torch.equal(mr["loss"], losses[-1])
    want = _leaves(eager)
    for got in (_leaves(chunked), _leaves(resident)):
        for name, value in want.items():
            assert torch.equal(got[name], value), name

    plain = _state()
    _, m0 = make_train_step(plain.model, seed=2)(plain, batches[0])
    other = _state()
    _, m1 = make_train_step(other.model, seed=2, augment=kind)(
        other, batches[0])
    assert not torch.equal(m0["loss"], m1["loss"])  # other pixels


def test_a_restored_step_counter_draws_that_steps_crops(monkeypatch):
    """The key is read from the device step counter, so a state restored
    at step 5 crops as the uninterrupted run did at its step 5."""
    seen = []
    real = augment.apply_augment

    def spy(images, key, kind):
        seen.append(int(key))
        return real(images, key, kind)

    monkeypatch.setattr(steps, "apply_augment", spy)
    images, labels = _corpus()
    batch = {"image": images[:4], "label": labels[:4].long()}
    state = _state()
    step = make_train_step(state.model, seed=2, augment=True)
    state, _ = step(state, batch)
    state.step = 5
    state, _ = step(state, batch)
    assert seen == [augment.augment_rng(2, 0), augment.augment_rng(2, 5)]
