"""The port's ViT path (ddp_practice_tpu_torch/models/vit.py, convert.py,
train/steps.py) against the JAX package's on the CPU, from the same numpy
inputs and the same weights through `convert.py`:

- the converter's ViT tree: the patch conv's HWIO kernel becomes OIHW (told
  apart from the 4-D qkv kernel by path), and `ViTEmbed` on a non-square
  image matches flax (NHWC input, row-major patches);
- `ViT` at depth 2 (d 128, 2 heads of 64, mlp 256, 16 patches): logits
  (2e-5) and every parameter's gradient of the mean cross-entropy (2e-4),
  with the fused layer (`fused=True`: its plain version on the CPU) and
  without, against the reference's per-op model;
- one `make_train_step` step (SGD with momentum and label smoothing) and one
  `make_eval_step` on a wrap-padded batch against the jitted JAX steps (one
  layer of d 64, a single head of 64);
- the tri-state gate: `fused=True` raises on rope, dropout, flash attention,
  decode and head_dim 32; `"auto"` on the CPU takes the per-op path; `False`
  never fuses; the registry's `accepts_fused`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from _torch_port import _perturb
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu.models.vit import ViTEmbed as JaxViTEmbed
from ddp_practice_tpu.ops.losses import cross_entropy as jax_cross_entropy
from ddp_practice_tpu.train.state import TrainState as JaxState
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu.train.steps import make_eval_step as jax_eval_step
from ddp_practice_tpu.train.steps import make_train_step as jax_train_step
from ddp_practice_tpu_torch.config import TrainConfig
from ddp_practice_tpu_torch.convert import (
    flax_to_state_dict,
    load_flax_params,
)
from ddp_practice_tpu_torch.models import accepts_fused, create_model
from ddp_practice_tpu_torch.models import vit as vit_module
from ddp_practice_tpu_torch.models.vit import EncoderBlock, ViTEmbed
from ddp_practice_tpu_torch.ops import fused_encoder as fe
from ddp_practice_tpu_torch.ops.losses import cross_entropy
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
from ddp_practice_tpu_torch.train.steps import (
    make_eval_step,
    make_train_step,
    prepare_image,
)

SMALL_VIT = dict(hidden_dim=128, num_heads=2, depth=2, mlp_dim=256)
TINY = dict(hidden_dim=64, num_heads=1, depth=1, mlp_dim=128)  # the steps
IMAGE = (16, 16, 3)


def _pair(seed=0, fused=False, **kw):
    """(jax model, jax params, torch model) with identical weights; the JAX
    side runs its per-op path."""
    cfg = {**SMALL_VIT, **kw}
    jm = jax_create_model("vit_tiny", fused=False, **cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, *IMAGE), jnp.float32))["params"]
    params = _perturb(jax.device_get(params), np.random.default_rng(seed))
    tm = create_model("vit_tiny", device="cpu", fused=fused,
                      image_shape=IMAGE, **cfg)
    load_flax_params(tm, params)
    return jm, jax.tree.map(jnp.asarray, params), tm


def _batch(seed, b=4, uint8=False):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, b).astype(np.int32)
    if uint8:
        return rng.integers(0, 256, (b, *IMAGE)).astype(np.uint8), labels
    return rng.random((b, *IMAGE), dtype=np.float32), labels


def test_converter_tells_the_patch_conv_from_qkv():
    rng = np.random.default_rng(0)
    conv = rng.standard_normal((4, 2, 3, 8)).astype(np.float32)   # HWIO
    qkv = rng.standard_normal((8, 3, 2, 4)).astype(np.float32)
    sd = flax_to_state_dict({
        "embed": {"patch_embed": {"kernel": conv, "bias": np.zeros(8)},
                  "pos_embed": np.zeros((1, 6, 8))},
        "block0": {"attn": {"qkv": {"kernel": qkv}}},
    })
    got = sd["embed.patch_embed.weight"]
    assert tuple(got.shape) == (8, 3, 4, 2)                       # OIHW
    for o, i, h, w in ((0, 0, 0, 0), (7, 2, 3, 1), (3, 1, 2, 0)):
        assert got[o, i, h, w] == conv[h, w, i, o]
    assert tuple(sd["blocks.0.attn.qkv.weight"].shape) == (24, 8)
    assert tuple(sd["embed.pos_embed"].shape) == (1, 6, 8)


def test_embed_matches_flax_on_a_non_square_image():
    rng = np.random.default_rng(1)
    x = rng.random((2, 8, 12, 3), dtype=np.float32)
    jm = JaxViTEmbed(patch_size=4, hidden_dim=16)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.asarray(x))["params"])
    params = _perturb(params, rng)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = ViTEmbed(4, 16, in_channels=3, num_patches=6)
    tm.load_state_dict(flax_to_state_dict(params))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 6, 16)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_vit_forward_and_grads_match_jax(fused, monkeypatch):
    jm, params, tm = _pair(1, fused=fused)
    images, labels = _batch(2)
    calls = []
    real = vit_module.fused_encoder_layer
    monkeypatch.setattr(vit_module, "fused_encoder_layer",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(images), train=True)
        return jax_cross_entropy(logits, jnp.asarray(labels)), logits

    (jl, jlogits), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    logits = tm(torch.from_numpy(images), train=True)
    loss = cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    assert len(calls) == (2 if fused else 0)       # one per layer
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-5)
    want = flax_to_state_dict(jax.device_get(jgrads))
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("fused", [True, False])
def test_image_train_step_matches_jax(fused):
    kw = dict(optimizer="sgd", learning_rate=0.05, momentum=0.9,
              label_smoothing=0.1)
    jm, params, tm = _pair(3, fused=fused, **TINY)
    tx = jax_optimizer(JaxConfig(**kw), 5)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=None, opt_state=tx.init(params))
    jstep = jax_train_step(jm, tx, label_smoothing=0.1, seed=1)
    state = TrainState(step=0, model=tm, optimizer=make_optimizer(
        TrainConfig(**kw), tm, 5))
    step = make_train_step(tm, label_smoothing=0.1, seed=1)
    images, labels = _batch(4, uint8=True)
    jstate, jmetrics = jstep(jstate, {"image": jnp.asarray(images),
                                      "label": jnp.asarray(labels)})
    state, metrics = step(state, {
        "image": torch.from_numpy(images),
        "label": torch.from_numpy(labels).long()})
    assert set(metrics) == set(jmetrics) == {"loss", "accuracy", "grad_norm"}
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert state.step == int(jstate.step) == 1
    want = flax_to_state_dict(jax.device_get(jstate.params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_image_eval_step_matches_jax_on_a_padded_batch():
    jm, params, tm = _pair(5, **TINY)
    images, labels = _batch(6, b=6, uint8=True)
    weight = np.array([1, 1, 1, 1, 0, 0], np.float32)   # two wrapped samples
    jout = jax_eval_step(jm)(
        JaxState(step=0, params=params, batch_stats=None, opt_state=None),
        {"image": jnp.asarray(images), "label": jnp.asarray(labels),
         "weight": jnp.asarray(weight)})
    out = make_eval_step(tm)(None, {
        "image": torch.from_numpy(images),
        "label": torch.from_numpy(labels).long(),
        "weight": torch.from_numpy(weight)})
    assert float(out[1]) == float(jout[1]) == 4.0
    assert float(out[0]) == float(jout[0])


def test_prepare_image_is_a_true_division():
    u8 = torch.arange(256, dtype=torch.uint8)
    want = np.arange(256, dtype=np.uint8).astype(np.float32) / 255.0
    assert np.array_equal(prepare_image(u8).numpy(), want)
    f = torch.rand(3)
    assert prepare_image(f) is f
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        make_train_step(torch.nn.Linear(1, 1), augment=True)


def _block(**kw):
    return EncoderBlock(128, kw.pop("heads", 2), 128, fused=True, **kw)


@pytest.mark.parametrize("kw", [
    dict(rope=True, causal=True), dict(dropout_rate=0.1),
    dict(attn_impl="flash"),
], ids=["rope", "dropout", "flash"])
def test_fused_true_raises_on_a_block_that_is_not_plain(kw):
    with pytest.raises(ValueError, match="plain blocks only"):
        _block(**kw)(torch.zeros(1, 16, 128))


def test_fused_true_raises_on_decode_and_on_refused_shapes():
    blk = _block(causal=True)
    cache = blk.attn.init_cache(1, 32, "cpu")
    with pytest.raises(ValueError, match="plain blocks only"):
        blk(torch.zeros(1, 1, 128), cache=cache)
    with pytest.raises(ValueError, match="head_dim a multiple of 64"):
        _block(heads=4)(torch.zeros(1, 16, 128))
    with pytest.raises(ValueError, match="shared memory"):
        _block()(torch.zeros(1, 4096, 128))
    with pytest.raises(ValueError, match="fused="):
        EncoderBlock(128, 2, 128, fused="on")


def test_auto_takes_the_per_op_path_on_the_cpu(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the fused layer ran")

    monkeypatch.setattr(vit_module, "fused_encoder_layer", refuse)
    x = torch.randn(2, 16, 128)
    for fused in ("auto", False):
        blk = EncoderBlock(128, 2, 128, fused=fused)
        assert blk(x).shape == x.shape
        assert not blk._auto_fuse(x, decode=False)
    assert fe.LAUNCHES == {"fused_encoder_fwd": 0, "fused_encoder_bwd": 0}
    with pytest.raises(AssertionError, match="the fused layer ran"):
        EncoderBlock(128, 2, 128, fused=True)(x)


@pytest.mark.parametrize("world,fuses", [(1, True), (2, False)])
def test_auto_fuses_on_one_process_only(monkeypatch, world, fuses):
    """fused="auto" on a (stubbed) CUDA tensor fuses at world size 1 and
    takes the per-op path at 2, as the reference's `single_chip_tpu()`
    gate keeps a multi-device run off the kernel; fused=True still
    forces it."""
    monkeypatch.setattr(vit_module, "_on_card", lambda x: True)
    monkeypatch.setattr(vit_module, "process_count", lambda: world)
    x = torch.randn(2, 16, 128)
    assert EncoderBlock(128, 2, 128)._auto_fuse(x, decode=False) is fuses
    assert not EncoderBlock(128, 2, 128)._auto_fuse(x, decode=True)
    forced = EncoderBlock(128, 2, 128, fused=True)
    monkeypatch.setattr(vit_module, "fused_encoder_layer",
                        lambda *a, **k: torch.zeros_like(x))
    assert not forced(x).any()


def test_registry_names_the_fused_capable_models():
    assert all(accepts_fused(n) for n in ("vit_tiny", "vit_base", "lm_tiny",
                                          "LM_BASE"))
    assert not accepts_fused("convnet")
    vit = create_model("vit_tiny", device="cpu", depth=1)
    assert (vit.hidden_dim, vit.num_heads, vit.mlp_dim) == (192, 3, 768)
    assert vit.blocks[0].fused == "auto"
    assert tuple(vit.embed.patch_embed.weight.shape) == (192, 3, 4, 4)
    assert tuple(vit.embed.pos_embed.shape) == (1, 64, 192)
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        create_model("resnet18", device="cpu")
