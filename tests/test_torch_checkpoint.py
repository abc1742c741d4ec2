"""The port's checkpoints (ddp_practice_tpu_torch/checkpoint/) on the CPU:
the cases of tests/test_checkpoint.py, one for one (round trip, shape
mismatch, crash mid-write, retention, fallback past a truncated
manifest, a torn directory and to a complete `.old.` directory,
save_async round trip and serialised sequence, the Trainer's periodic
saves and resume; not restore-onto-a-mesh: the port has no mesh before
ROADMAP A8), and:

- optimizer state round trips (Adam moments and count, SGD momentum,
  the accumulation mean and micro-step), and a second async save to a
  directory with one in flight is refused;
- the legacy single-checkpoint layout restores;
- a checkpoint the JAX package wrote restores into the port: a ConvNet
  under SGD with momentum after two JAX steps (params, batch_stats,
  momentum trace, step), the ConvNet under clipped Adam with gradient
  accumulation one micro-step into a window (mu, nu, the counts,
  acc_grads, mini_step) and lm_tiny under AdamW (mu, nu, count); one
  more step on each side agrees at fp32 tolerance. The reference's
  multi-host layout (shards.<p>.npz) reassembles. A JAX leaf with no
  counterpart in the target raises naming it;
- save -> corrupt the newest manifest -> resume through `Trainer` equals
  an uninterrupted run, parameters, buffers and optimizer state.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from _torch_port import jit_quick
from ddp_practice_tpu import checkpoint as jax_ckpt
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu.train.state import create_state as jax_create_state
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu.train.steps import make_lm_train_step as jax_lm_step
from ddp_practice_tpu.train.steps import make_train_step as jax_train_step
from ddp_practice_tpu_torch import checkpoint as ckpt
from ddp_practice_tpu_torch.config import TrainConfig
from ddp_practice_tpu_torch.convert import flax_to_state_dict
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.train.loop import Trainer
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
from ddp_practice_tpu_torch.train.steps import (
    make_lm_train_step,
    make_train_step,
)


def _state(seed=7, **kw):
    """A ConvNet train state on the CPU (the reference's default model),
    with its optimizer from TrainConfig(**kw)."""
    model = create_model("convnet", device="cpu", seed=seed)
    cfg = TrainConfig(**kw)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model, 4))


def _images(seed, b=4):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(
                rng.integers(0, 256, (b, 28, 28, 1)).astype(np.uint8)),
            "label": torch.from_numpy(rng.integers(0, 10, b)).long()}


def _trained(steps=2, **kw):
    """A state moved by `steps` steps, so every leaf is off its init."""
    state = _state(**kw)
    step = make_train_step(state.model)
    for i in range(steps):
        state, _ = step(state, _images(i))
    return state


def _assert_same(a, b):
    la, lb = ckpt.state_leaves(a), ckpt.state_leaves(b)
    assert list(la) == list(lb)
    for name in la:
        assert torch.equal(la[name].cpu(), lb[name].cpu()), name
    assert a.step == b.step


def test_roundtrip(tmp_path):
    state = _trained(optimizer="sgd", momentum=0.9, learning_rate=0.01)
    d = str(tmp_path / "ck")
    ckpt.save(d, state, extra={"precision_policy": "bf16", "step": 2})
    assert ckpt.exists(d)
    names = ckpt.latest_manifest(d)["paths"]
    assert "model.bn1.running_var" in names
    assert "optimizer.state.conv0.weight.momentum_buffer" in names
    fresh = _state(seed=8, optimizer="sgd", momentum=0.9,
                   learning_rate=0.01)
    _assert_same(ckpt.restore(d, fresh), state)
    man = ckpt.latest_manifest(d)
    assert man["schema_version"] == 2
    assert man["extra"]["precision_policy"] == "bf16"


@pytest.mark.parametrize("optimizer,accum", [("adam", 1), ("adamw", 3),
                                             ("sgd", 2)])
def test_optimizer_state_roundtrip(optimizer, accum, tmp_path):
    kw = dict(optimizer=optimizer, accum_steps=accum, learning_rate=1e-3,
              momentum=0.9 if optimizer == "sgd" else 0.0)
    state = _trained(steps=4, **kw)     # accum 3: one apply, micro 1
    d = str(tmp_path / "ck")
    ckpt.save(d, state, step=4)
    restored = ckpt.restore(d, _state(seed=9, **kw))
    _assert_same(restored, state)
    assert restored.optimizer.applies == state.optimizer.applies > 0
    assert restored.optimizer.micro == state.optimizer.micro
    step = make_train_step(state.model)
    other = make_train_step(restored.model)
    for i in range(2):   # the next steps agree bit for bit
        state, _ = step(state, _images(10 + i))
        restored, _ = other(restored, _images(10 + i))
    _assert_same(restored, state)


def test_restore_rejects_shape_mismatch(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, _state(), extra={"step": 0})
    model = create_model("convnet", device="cpu", image_shape=(32, 32, 1))
    bad = TrainState(step=0, model=model, optimizer=make_optimizer(
        TrainConfig(), model))
    with pytest.raises(ValueError, match=r"model\.head\.weight.*different "
                                         "model configuration"):
        ckpt.restore(d, bad)


def test_restore_names_leaves_the_target_cannot_take(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, _trained(optimizer="adam", learning_rate=1e-3), step=2)
    with pytest.raises(ValueError, match=r"optimizer\.state\.conv0\.weight"
                                         r"\.(step|exp_avg).*SGD"):
        ckpt.restore(d, _state())
    model = create_model("lm_tiny", device="cpu", vocab_size=16,
                         max_len=8, depth=1)
    lm = TrainState(step=0, model=model,
                    optimizer=make_optimizer(TrainConfig(), model))
    with pytest.raises(ValueError, match="no counterpart in the target"):
        ckpt.restore(d, lm)


def test_save_is_crash_safe_mid_write(tmp_path, monkeypatch):
    state = _state()
    d = str(tmp_path / "ck")
    ckpt.save(d, state, step=1)

    def torn_dump(*a, **k):
        raise RuntimeError("simulated crash mid-save")

    monkeypatch.setattr(json, "dump", torn_dump)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ckpt.save(d, state, step=2)
    monkeypatch.undo()
    # the torn step-2 attempt is invisible; step 1 still restores
    assert ckpt.all_steps(d) == [1]
    _assert_same(ckpt.restore(d, _state(seed=3)), state)
    # and a later save sweeps the debris and becomes the newest
    ckpt.save(d, state, step=2)
    assert ckpt.all_steps(d) == [1, 2]
    assert not [p for p in (tmp_path / "ck").iterdir()
                if p.name.startswith("tmp.")]


def test_retention_keeps_last_k(tmp_path):
    state = _state()
    d = str(tmp_path / "ck")
    for s in range(1, 6):
        ckpt.save(d, state, step=s, keep_last=3)
    assert ckpt.all_steps(d) == [3, 4, 5]
    assert ckpt.latest_manifest(d)["extra"]["step"] == 5


def test_restore_falls_back_past_truncated_manifest(tmp_path):
    state = _state()
    d = str(tmp_path / "ck")
    state.step = 1
    ckpt.save(d, state, step=1)
    state.step = 2
    ckpt.save(d, state, step=2)
    man2 = tmp_path / "ck" / "step_2" / "manifest.json"
    man2.write_bytes(man2.read_bytes()[: len(man2.read_bytes()) // 2])
    assert ckpt.exists(d)
    assert ckpt.latest_manifest(d)["extra"]["step"] == 1
    assert ckpt.restore(d, _state()).step == 1
    man2.write_bytes(b"")           # 0 bytes flushed: the same failure
    assert ckpt.latest_manifest(d)["extra"]["step"] == 1
    man1 = tmp_path / "ck" / "step_1" / "manifest.json"
    man1.write_bytes(b'{"schema_version": 2, "paths": [')
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, _state())


def test_restore_ignores_torn_dir(tmp_path):
    d = tmp_path / "ck"
    state = _state()
    state.step = 3
    ckpt.save(str(d), state, step=3)
    torn = d / "step_9"
    torn.mkdir()
    (torn / "leaves.npz").write_bytes(b"garbage")
    assert ckpt.all_steps(str(d)) == [3]
    assert ckpt.restore(str(d), _state()).step == 3


def test_restore_falls_back_to_complete_aside_dir(tmp_path):
    d = tmp_path / "ck"
    ckpt.save(str(d), _state(), step=5)
    os.rename(d / "step_5", d / "step_5.old.999")  # the re-save window
    assert ckpt.exists(str(d))
    restored = ckpt.restore(str(d), _state(seed=1))
    _assert_same(restored, _state())
    os.rename(d / "step_5.old.999", d / "tmp.step_5.123")
    assert ckpt.exists(str(d))


def test_legacy_single_file_layout_restores(tmp_path):
    d = tmp_path / "ck"
    ckpt.save(str(d), _state(), step=4)
    for name in ("leaves.npz", "manifest.json"):
        os.rename(d / "step_4" / name, d / name)
    os.rmdir(d / "step_4")
    assert ckpt.all_steps(str(d)) == []
    assert ckpt.latest_manifest(str(d))["extra"]["step"] == 4
    _assert_same(ckpt.restore(str(d), _state(seed=2)), _state())


def test_save_async_roundtrip(tmp_path):
    state = _trained(optimizer="sgd", momentum=0.9, learning_rate=0.01)
    d = str(tmp_path / "ck")
    saved = {k: v.clone() for k, v in ckpt.state_leaves(state).items()}
    handle = ckpt.save_async(d, state, extra={"step": 3}, step=3)
    with torch.no_grad():   # host copies were taken before the return
        state.model.head.weight.add_(1.0)
    path = handle.wait()
    assert path.endswith("step_3") and handle.done()
    restored = ckpt.restore(d, _state(seed=4, optimizer="sgd", momentum=0.9,
                                      learning_rate=0.01))
    got = ckpt.state_leaves(restored)
    assert list(got) == list(saved)
    for name, value in saved.items():
        assert torch.equal(got[name], value), name


def test_save_async_serialized_sequence(tmp_path):
    state = _state()
    d = str(tmp_path / "ck")
    for s in (1, 2, 3):
        ckpt.save_async(d, state, step=s).wait()
    assert ckpt.all_steps(d) == [1, 2, 3]
    assert ckpt.latest_manifest(d)["extra"]["step"] == 3


def test_overlapping_saves_to_one_directory_are_refused(tmp_path,
                                                        monkeypatch):
    import threading

    gate = threading.Event()
    real = ckpt._write

    def held(*a, **k):
        gate.wait(10)
        return real(*a, **k)

    monkeypatch.setattr(ckpt, "_write", held)
    d = str(tmp_path / "ck")
    handle = ckpt.save_async(d, _state(), step=1)
    with pytest.raises(RuntimeError, match="still in flight"):
        ckpt.save_async(d, _state(), step=2)
    with pytest.raises(RuntimeError, match="still in flight"):
        ckpt.save(d, _state(), step=2)
    ckpt.save_async(str(tmp_path / "other"), _state(), step=1)
    gate.set()
    handle.wait()
    ckpt.save(d, _state(), step=2)        # after wait(): allowed
    assert ckpt.all_steps(d) == [1, 2]


TRAIN = dict(device="cpu", synthetic_size=192, batch_size=32,
             log_every_steps=0, optimizer="sgd", learning_rate=0.01,
             momentum=0.9)


def test_trainer_periodic_step_checkpoints(tmp_path):
    d = str(tmp_path / "ck")
    cfg = TrainConfig(epochs=1, checkpoint_dir=d, checkpoint_every_steps=4,
                      **TRAIN)
    t = Trainer(cfg)
    t.fit()
    total = t.state.step                  # 6 steps of 32 over 192 images
    steps = ckpt.all_steps(d)
    assert steps == [4, total]
    extra = ckpt.latest_manifest(d)["extra"]
    assert extra == {"step": total, "precision_policy": "fp32",
                     "model": "convnet", "optimizer": "sgd",
                     "momentum": 0.9, "clip_norm": 0.0,
                     "weight_decay": 0.0, "accum_steps": 1}
    t2 = Trainer(cfg.replace(resume=True))
    assert t2.state.step == total
    _assert_same(t2.state, t.state)


def test_corrupt_newest_then_resume_equals_an_uninterrupted_run(tmp_path):
    whole = Trainer(TrainConfig(epochs=3, **TRAIN))
    whole.fit()
    d = str(tmp_path / "ck")
    first = Trainer(TrainConfig(epochs=2, checkpoint_dir=d,
                                checkpoint_every_epochs=1, **TRAIN))
    first.fit()
    assert ckpt.all_steps(d) == [6, 12]
    man = tmp_path / "ck" / "step_12" / "manifest.json"
    man.write_bytes(man.read_bytes()[:40])           # torn newest
    resumed = Trainer(TrainConfig(epochs=3, checkpoint_dir=d, resume=True,
                                  checkpoint_every_epochs=1, **TRAIN))
    assert resumed.state.step == 6                   # fell back
    resumed.fit()
    _assert_same(resumed.state, whole.state)
    assert ckpt.all_steps(d) == [6, 12, 18]


# ---------------------------------------------------- JAX-written state


def _jax_convnet_checkpoint(d, kw, steps=2):
    jm = jax_create_model("convnet")
    tx = jax_optimizer(JaxConfig(**kw), 4)
    jstate = jax.jit(lambda r: jax_create_state(
        jm, tx, rng=r, sample_input=jnp.zeros((1, 28, 28, 1))))(
        jax.random.PRNGKey(3))
    jstep = jax_train_step(jm, tx, seed=1)
    for i in range(steps):
        b = _images(i)
        jstate, _ = jstep(jstate, {"image": jnp.asarray(b["image"].numpy()),
                                   "label": jnp.asarray(b["label"].numpy())})
    jax_ckpt.save(d, jstate, extra={"step": steps, "model": "convnet"})
    return jstep, jstate


@pytest.mark.parametrize("kw,steps", [
    (dict(optimizer="sgd", learning_rate=0.01, momentum=0.9), 2),
    # clip, Adam's mu/nu/count and MultiSteps' acc_grads and mini_step,
    # one micro-step into the second accumulation window
    (dict(optimizer="adam", learning_rate=1e-3, accum_steps=2,
          clip_norm=1.0), 3),
])
def test_restore_a_jax_convnet_checkpoint_and_step_on(kw, steps, tmp_path):
    d = str(tmp_path / "jax")
    jstep, jstate = _jax_convnet_checkpoint(d, kw, steps=steps)
    state = ckpt.restore(d, _state(**kw))
    assert state.step == steps
    assert state.optimizer.applies == steps // kw.get("accum_steps", 1)
    assert state.optimizer.micro == steps % kw.get("accum_steps", 1)
    host = jax.device_get(jstate)
    want = flax_to_state_dict(host.params)
    want.update(flax_to_state_dict(host.batch_stats))
    got = state.model.state_dict()
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    if kw["optimizer"] == "sgd":
        trace = flax_to_state_dict(host.opt_state[0].trace)
    else:
        trace = flax_to_state_dict(host.opt_state.acc_grads)
    for i, (name, p) in enumerate(state.model.named_parameters()):
        buf = (state.optimizer.inner.state[p]["momentum_buffer"]
               if kw["optimizer"] == "sgd" else state.optimizer.acc[i])
        assert torch.equal(buf, trace[name]), name
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    b = _images(5)
    jstate, jm = jstep(jstate, {"image": jnp.asarray(b["image"].numpy()),
                                "label": jnp.asarray(b["label"].numpy())})
    state, m = make_train_step(state.model, seed=1)(state, b)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert state.step == int(jstate.step) == steps + 1
    want = flax_to_state_dict(jax.device_get(jstate.params))
    want.update(flax_to_state_dict(jax.device_get(jstate.batch_stats)))
    got = state.model.state_dict()
    for name, value in want.items():
        if kw["optimizer"] == "adam" and name.startswith("conv") \
                and name.endswith("bias"):
            # BatchNorm follows each conv: its bias gets a rounding-noise
            # gradient, which Adam scales to lr-sized updates
            assert (got[name] - before[name]).abs().max() <= 2e-3
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_restore_reassembles_the_multi_host_layout(tmp_path):
    """The reference's cross-host leaves: one leaf split over two
    writers' shards.<p>.npz files, reassembled on read."""
    kw = dict(optimizer="sgd", learning_rate=0.01, momentum=0.9)
    d = tmp_path / "jax"
    _jax_convnet_checkpoint(str(d), kw, steps=1)
    src = d / "step_1"
    man = json.loads((src / "manifest.json").read_text())
    i = man["paths"].index(".params['Dense_0']['kernel']")
    with np.load(src / "leaves.npz") as data:
        leaves = {k: data[k] for k in data.files}
    whole = leaves.pop(f"leaf_{i}")
    for p, (a, b) in enumerate(((0, 800), (800, whole.shape[0]))):
        np.savez(src / f"shards.{p}.npz", **{f"leaf_{i}.s0": whole[a:b]})
        (src / f"shards.{p}.json").write_text(json.dumps(
            [{"leaf": i, "key": f"leaf_{i}.s0",
              "index": [[a, b], [0, whole.shape[1]]]}]))
    np.savez(src / "leaves.npz", **leaves)
    man["sharded_leaves"] = {str(i): {"shape": list(whole.shape),
                                      "dtype": "float32"}}
    (src / "manifest.json").write_text(json.dumps(man))
    state = ckpt.restore(str(d), _state(**kw))
    assert np.array_equal(state.model.head.weight.detach().numpy(), whole.T)
    os.remove(src / "shards.1.npz")
    os.remove(src / "shards.1.json")
    with pytest.raises(ValueError, match="shard files from some writer"):
        ckpt.restore(str(d), _state(**kw))


def test_a_jax_leaf_without_counterpart_raises_naming_it(tmp_path):
    d = str(tmp_path / "jax")
    _jax_convnet_checkpoint(d, dict(optimizer="adam", learning_rate=1e-3),
                            steps=1)
    with pytest.raises(ValueError, match=r"\.opt_state\[0\]\.mu\['"
                                         r"BatchNorm_0'\]\['bias'\].*SGD"):
        ckpt.restore(d, _state(optimizer="sgd", momentum=0.9))
    assert ckpt.parse_keystr(".opt_state.inner_opt_state[1][0].mu['a']") \
        == ("opt_state", "inner_opt_state", 1, 0, "mu", "a")
    with pytest.raises(ValueError, match="not a JAX keystr"):
        ckpt.parse_keystr("model.head.weight")


LM = dict(vocab_size=64, max_len=32)


def _tokens(seed, b=2, s=16):
    return np.random.default_rng(seed).integers(0, 64, (b, s + 1))


# the JAX side builds and compiles lm_tiny's AdamW state and step at the
# registry widths; beside the suite's other workers the case ran past the
# tier-1 slow line
@pytest.mark.slow
def test_restore_a_jax_lm_tiny_adamw_checkpoint_and_step_on(tmp_path):
    """lm_tiny at its registry widths (d 256, depth 4, 8 heads of 32)
    under AdamW: mu, nu and count land as exp_avg, exp_avg_sq and step;
    the next step agrees (Adam's noise-floor elements held to its
    per-step bound, as tests/test_torch_lm_train.py does)."""
    kw = dict(optimizer="adamw", learning_rate=1e-3, weight_decay=0.01)
    jm = jax_create_model("lm_tiny", **LM)
    tx = jax_optimizer(JaxConfig(**kw), 4)
    key = jax.random.PRNGKey(1)
    jstate = jit_quick(lambda r: jax_create_state(
        jm, tx, rng=r, sample_input=jnp.zeros((1, 8), jnp.int32)), key)(key)
    batches = [{"tokens": jnp.asarray(_tokens(i), jnp.int32)}
               for i in range(2)]
    jstep = jit_quick(jax_lm_step(jm, tx, seed=1), jstate, batches[0])
    for b in batches:
        jstate, _ = jstep(jstate, b)
    d = str(tmp_path / "jax")
    jax_ckpt.save(d, jstate, extra={"step": 2, "model": "lm_tiny"})
    model = create_model("lm_tiny", device="cpu", **LM)
    state = ckpt.restore(d, TrainState(step=0, model=model,
                                       optimizer=make_optimizer(
                                           TrainConfig(**kw), model, 4)))
    host = jax.device_get(jstate)
    mu = flax_to_state_dict(host.opt_state[0].mu)
    nu = flax_to_state_dict(host.opt_state[0].nu)
    for name, p in model.named_parameters():
        st = state.optimizer.inner.state[p]
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
        assert float(st["step"]) == 2.0
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tokens = _tokens(7)
    jstate, jmetrics = jstep(jstate, {"tokens": jnp.asarray(tokens,
                                                            jnp.int32)})
    state, metrics = make_lm_train_step(model, seed=1)(
        state, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    want = flax_to_state_dict(jax.device_get(jstate.params))
    for name, p in model.named_parameters():
        got, ref = p.detach(), want[name]
        held = p.grad.abs() >= 1e-6
        np.testing.assert_allclose(got[held].numpy(), ref[held].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
        bound = 2 * kw["learning_rate"] * (
            1 + 0.01 * float(before[name].abs().max()) + 1e-3)
        assert (got - before[name]).abs().max() <= bound, name
