"""K steps a call under every mesh axis (train/steps.py's chunked and
resident steps through `parallelize`'s layouts), FSDP under the pipeline
schedules (parallel/fsdp.py `DataShards`) and several devices in one
process (`--cpu N`), on the CPU, the ranks as threads of this process:

- K = 4 chunked steps (stacked host batches) and K = 4 resident steps
  (the corpus on the device, each rank gathering its columns of the
  epoch's grid) equal 4 single steps from host batches on every rank,
  bit for bit (`torch.equal` over the parameters, the optimizer state and
  the last step's metrics) for tensor 2, fsdp over data 2, seq 2 (ring
  and Ulysses), expert 2 (lm_moe, the sorted path) and pipe 2 (GPipe,
  1F1B, interleaved): ranks as threads run the step eagerly, row by row
  (utils/graphs.py `eager_reason`);
- the same chunked steps against the JAX package's `make_chunked_lm_
  train_step` on one device, from converted weights and the same
  batches, at tests/test_chunked.py's loss tolerance (rtol 1e-5) and the
  port-vs-JAX chunked tolerance of tests/test_torch_chunked.py for the
  parameters (1e-5); lm_moe's sorted path against the reference's
  einsum path at capacity factor E / k (it drops nothing, so it computes
  the sorted path's function), lm_pipe against the reference's
  sequential model (num_stages 1);
- lm_pipe at pipe 2 x data 2 with FSDP under GPipe, 1F1B and
  interleaved, and vit_tiny_pipe under GPipe, equal one rank's losses
  and parameters at tests/test_torch_pipeline_lm.py's pipe x data
  tolerances (losses rtol 1e-4, parameters rtol 1e-3 / atol 1e-5), and
  each rank stores only its data region of the cut leaves;
- `--cpu 8 ... --model vit_tiny_moe --expert 4 --fsdp` (the reference's
  verify command, at narrow widths and 2 steps) gives the same losses as
  the same run under tests/_torch_port.py `ranks`; `--devices N` raises
  without N cards.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from _torch_port import _perturb, ranks
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu.train import steps as jax_steps
from ddp_practice_tpu.train.state import TrainState as JaxState
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu_torch import cli
from ddp_practice_tpu_torch.config import MeshConfig, TrainConfig
from ddp_practice_tpu_torch.convert import (
    flax_to_state_dict,
    load_flax_params,
)
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.ops.moe import moe_layers
from ddp_practice_tpu_torch.parallel.mesh import (
    batch_shard,
    build_mesh,
    full_parameters,
    local_tensor,
    parallelize,
)
from ddp_practice_tpu_torch.train.loop import Trainer
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
from ddp_practice_tpu_torch.train.steps import make_chunked_lm_train_step

# name -> (model, TrainConfig fields, ranks)
LAYOUTS = {
    "tensor2": ("lm_tiny", dict(mesh=MeshConfig(tensor=2)), 2),
    "fsdp2": ("lm_tiny", dict(mesh=MeshConfig(data=2), fsdp=True), 2),
    "seq2_ring": ("lm_tiny", dict(mesh=MeshConfig(seq=2),
                                  sp_impl="ring"), 2),
    "seq2_ulysses": ("lm_tiny", dict(mesh=MeshConfig(seq=2),
                                     sp_impl="ulysses"), 2),
    "expert2_sorted": ("lm_moe", dict(mesh=MeshConfig(expert=2),
                                      num_experts=4), 2),
    "pipe2_gpipe": ("lm_pipe", dict(mesh=MeshConfig(pipe=2),
                                    num_microbatches=2), 2),
    "pipe2_1f1b": ("lm_pipe", dict(mesh=MeshConfig(pipe=2),
                                   num_microbatches=2,
                                   pipe_schedule="1f1b"), 2),
    "pipe2_interleaved": ("lm_pipe", dict(mesh=MeshConfig(pipe=2),
                                          num_microbatches=2,
                                          pipe_schedule="interleaved",
                                          num_virtual=2), 2),
}
K = 4


def _trainer(name, **kw):
    model, fields, _ = LAYOUTS[name]
    base = dict(model=model, device="cpu", seq_len=16, batch_size=4,
                synthetic_size=20000, num_heads=4, optimizer="adam",
                learning_rate=1e-3, log_every_steps=0,
                max_steps_per_epoch=K, epochs=1)
    t = Trainer(TrainConfig(**{**base, **fields, **kw}))
    for m in moe_layers(t.model):
        m.impl = "sorted"
    return t


def _record(trainer, attr):
    """The metrics of each call of `trainer.<attr>`."""
    seen, step = [], getattr(trainer, attr)

    def recorded(*args):
        state, metrics = step(*args)
        seen.append(metrics)
        return state, metrics

    setattr(trainer, attr, recorded)
    return seen


def _state(trainer) -> dict:
    """Every tensor of the rank's train state (its local shards)."""
    opt = trainer.state.optimizer
    out = {n: local_tensor(p.detach()).clone()
           for n, p in trainer.model.named_parameters()}
    for i, q in enumerate(opt.inner_params):
        for key, value in opt.inner.state.get(q, {}).items():
            if isinstance(value, torch.Tensor):
                out[f"opt.{i}.{key}"] = value.clone()
    return out


@pytest.mark.parametrize("placement", ["chunked", "resident"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_k_steps_a_call_equal_k_single_steps(name, placement):
    world = LAYOUTS[name][2]

    def rank(r):
        one = _trainer(name, data_placement="host")
        many = _trainer(name, steps_per_call=K, data_placement=(
            "host" if placement == "chunked" else "device"))
        attr = ("chunk_step" if placement == "chunked"
                else "resident_train_step")
        assert getattr(many, attr) is not None
        single, grouped = _record(one, "train_step"), _record(many, attr)
        one.train_epoch(0)
        many.train_epoch(0)
        assert len(single) == K and len(grouped) == 1
        assert many.state.step == one.state.step == K
        return _state(one), _state(many), single[-1], grouped[-1]

    for a, b, ma, mb in ranks(rank, world):
        assert set(a) == set(b)
        for n in a:
            assert torch.equal(a[n], b[n]), n
        assert set(ma) == set(mb)
        for n in ma:
            assert torch.equal(ma[n], mb[n]), n


# ------------------------------------------- against the JAX package
SMALL = dict(vocab_size=64, hidden_dim=64, num_heads=4, depth=2,
             mlp_dim=128, max_len=32)
# the interleaved schedule needs depth a multiple of pipe x virtual
JAX_FIELDS = {"lm_moe": dict(num_experts=4, capacity_factor=2.0),
              "lm_pipe": dict(num_stages=1, depth=4)}
STEP = dict(optimizer="sgd", learning_rate=0.1, momentum=0.9,
            lr_schedule="cosine", epochs=1)
_TOKENS = np.random.default_rng(9).integers(
    0, SMALL["vocab_size"], (K, 4, 17)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(model: str):
    """The reference's chunked step on one device over `_TOKENS`: the
    params and batch_stats before, the metrics and the params after (one
    run a model, shared by its layouts)."""
    tokens = _TOKENS
    jm = jax_create_model(model, **{**SMALL, **JAX_FIELDS.get(model, {})})
    variables = jax.jit(jm.init)(jax.random.PRNGKey(4),
                                 jnp.zeros((1, 8), jnp.int32))
    params = _perturb(jax.device_get(variables["params"]),
                      np.random.default_rng(4))
    stats = variables.get("batch_stats")
    stats = stats and jax.device_get(stats)    # the step donates its state
    tx = jax_optimizer(JaxConfig(**STEP), 5)
    state = JaxState(step=jnp.zeros((), jnp.int32),
                     params=jax.tree.map(jnp.asarray, params),
                     batch_stats=stats and jax.tree.map(jnp.asarray, stats),
                     opt_state=tx.init(params))
    chunk = jax_steps.make_chunked_lm_train_step(jm, tx, num_steps=K,
                                                 seed=1)
    state, metrics = chunk(state, {"tokens": jnp.asarray(tokens)})
    assert int(state.step) == K
    return (params, stats,
            {k: float(v) for k, v in metrics.items()},
            flax_to_state_dict(jax.device_get(state.params)))


@pytest.mark.parametrize("model", ["lm_moe", "lm_pipe", "lm_tiny"])
def test_the_references_chunked_runs(model):
    """The reference's K-step call on each model the layouts train (run
    once here, then shared by the layouts' comparisons below): K steps,
    finite metrics."""
    _, _, metrics, params = _jax_run(model)
    assert all(np.isfinite(v) for v in metrics.values())
    assert all(np.isfinite(p.numpy()).all() for p in params.values())


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_chunked_steps_match_the_references_chunked_step(name):
    model_name, fields, world = LAYOUTS[name]
    tokens = _TOKENS
    params, stats, want_metrics, want = _jax_run(model_name)
    mesh_cfg = fields["mesh"]
    kw = {}
    if model_name == "lm_pipe":
        kw = dict(depth=4, num_stages=2, num_microbatches=2,
                  schedule=fields.get("pipe_schedule", "gpipe"),
                  num_virtual=fields.get("num_virtual", 2))
    elif model_name == "lm_moe":
        kw = dict(num_experts=4)
    elif "sp_impl" in fields:
        kw = dict(seq_axis="seq", sp_impl=fields["sp_impl"])

    def rank(r):
        model = create_model(model_name, device="cpu", **{**SMALL, **kw})
        load_flax_params(model, params, stats)
        for m in moe_layers(model):
            m.impl = "sorted"
        mesh = build_mesh(mesh_cfg, "cpu")
        forward, after = parallelize(model, mesh, model_name=model_name,
                                     fsdp=fields.get("fsdp", False))
        state = TrainState(0, model, make_optimizer(
            TrainConfig(**STEP, device="cpu"), model, 5))
        step = make_chunked_lm_train_step(model, num_steps=K, seed=1,
                                          forward=forward,
                                          after_backward=after)
        rows = batch_shard(mesh).local_slice(4)
        state, m = step(state, {"tokens": torch.from_numpy(
            tokens[:, rows]).long()})
        return {k: float(v) for k, v in m.items()}, full_parameters(model)

    for metrics, got in ranks(rank, world):
        for k in ("loss", "grad_norm", "accuracy"):
            np.testing.assert_allclose(metrics[k], want_metrics[k],
                                       rtol=1e-5, err_msg=k)
        assert set(got) == set(want)
        for n in want:
            np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=n)


# --------------------------------------------------- FSDP under pipe
PIPE_FSDP = {
    "lm_pipe_gpipe": ("lm_pipe", "gpipe"),
    "lm_pipe_1f1b": ("lm_pipe", "1f1b"),
    "lm_pipe_interleaved": ("lm_pipe", "interleaved"),
    "vit_tiny_pipe_gpipe": ("vit_tiny_pipe", "gpipe"),
}


@pytest.mark.parametrize("case", sorted(PIPE_FSDP))
def test_fsdp_under_pipe_equals_one_rank(case):
    model, schedule = PIPE_FSDP[case]
    base = dict(model=model, device="cpu", batch_size=4, num_heads=4,
                optimizer="sgd", learning_rate=0.1, log_every_steps=0,
                max_steps_per_epoch=3, epochs=1, data_placement="host",
                num_microbatches=2)
    if model == "lm_pipe":
        base.update(seq_len=16, synthetic_size=20000)
    else:
        base.update(dataset="cifar10", synthetic_size=64)

    def steps(t):
        t.train_loader.set_epoch(0)
        batches = t._device_batches(t.train_loader)
        losses = []
        for _ in range(3):
            t.state, m = t.train_step(t.state, next(batches))
            losses.append(float(m["loss"]))
        return losses

    one = Trainer(TrainConfig(**{**base, "batch_size": 8}))
    want = steps(one)
    want_params = {n: p.detach() for n, p in one.model.named_parameters()}

    def rank(r):
        t = Trainer(TrainConfig(mesh=MeshConfig(pipe=2, data=2), fsdp=True,
                                pipe_schedule=schedule, **base))
        losses = steps(t)
        cut = sum(p.numel() for p in t.model.parameters())
        accuracy = t.evaluate()
        return losses, full_parameters(t.model), cut, accuracy

    res = ranks(rank, 4)
    stage = sum(p.numel() for n, p in one.model.named_parameters()
                if n.startswith("blocks.")) // 2
    for losses, got, cut, accuracy in res:
        np.testing.assert_allclose(losses, want, rtol=1e-4)
        assert cut < stage          # the stage's blocks cut over data too
        assert accuracy == res[0][3]
        for n, w in want_params.items():
            np.testing.assert_allclose(got[n].numpy(), w.numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=n)


# ---------------------------------------- several devices, one process
def test_cpu_n_runs_the_verify_command_as_threaded_ranks(tmp_path, capsys,
                                                         monkeypatch):
    """The reference's `--cpu 8 ... --model vit_tiny_moe --expert 4
    --fsdp` at 2 steps on a small corpus, the model at narrow widths
    (`NARROW` through the loop's `create_model`): rank 0's summary with
    8 devices, and the same run under `ranks` gives the same losses (rank
    0's metrics records)."""
    import ddp_practice_tpu_torch.train.loop as loop

    make = loop.create_model
    monkeypatch.setattr(loop, "create_model",
                        lambda name, **kw: make(name, **{**kw, **NARROW}))
    argv = ["-e", "1", "-b", "2", "--dataset", "synthetic", "--model",
            "vit_tiny_moe", "--expert", "4", "--fsdp", "--optimizer",
            "adamw", "--lr", "1e-3", "--max_steps", "2", "--log_every", "1",
            "--synthetic_size", "64", "--json"]

    def losses(path):
        return [json.loads(x)["loss"] for x in path.read_text().splitlines()
                if json.loads(x)["kind"] == "train"]

    cpu, threads = tmp_path / "cpu.jsonl", tmp_path / "threads.jsonl"
    assert cli.main(["--cpu", "8", "--metrics_file", str(cpu)] + argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["devices"] == 8 and summary["steps"] == 2
    assert summary["global_batch"] == 4
    ranks(lambda r: cli.main(argv + ["--device", "cpu", "--metrics_file",
                                     str(threads)]), 8)
    assert len(losses(cpu)) == 2 and losses(cpu) == losses(threads)


NARROW = dict(hidden_dim=32, depth=2, num_heads=2, mlp_dim=64)


def test_devices_n_needs_n_cards():
    """--devices N raises when fewer than N cards are visible, instead of
    taking fewer."""
    with pytest.raises(ValueError, match=r"--devices 64: \d+ CUDA device"):
        cli.main(["--devices", "64", "--model", "lm_tiny"])
