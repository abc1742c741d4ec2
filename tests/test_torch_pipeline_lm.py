"""The port's pipelined LM (models/pipeline_lm.py: GPipe through
parallel/pipeline.py, 1F1B and interleaved through
parallel/pipeline_1f1b.py) against the JAX package's lm_pipe, on the
CPU, the ranks as threads (tests/_torch_port.py `ranks`). The yardstick
is the reference's own: the sequential `num_stages=1` model on one
device (built once a module), whose params (biases and LayerNorms moved
off their init values) load into every rank through convert.py:

- the GPipe forward at pipe 4, M 2, learned positions and RoPE (2e-5);
  its loss (1e-5) and grads (5e-4);
- 1F1B at M 2 and 4 and interleaved (pipe 2, V 2) at M 4: loss 1e-5,
  the accuracy counts exact, grads 5e-4; one case against the
  reference's own `PipelinedLM.loss_and_grad(schedule="1f1b")` on its
  8-device mesh, which pins the loss-sum rescale and the counts;
- causality through the schedule (test_pipeline_lm.py's perturbation);
- lm_pipe == lm_tiny: dense weights mapped into the stacked layout give
  lm_tiny's logits, in the port and in JAX;
- the data 2 x pipe 2 x tensor 2 train step (GPipe and 1F1B, SGD with
  momentum and clipping on), two steps: the loss, the grad norm and
  every updated parameter against the JAX sequential step's;
- placements leaf by leaf against the reference's `_lm_pipe_rule`; the
  clipping norm's groups; the loop's and the CLI's refusals.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from _torch_port import _perturb, ranks
from ddp_practice_tpu.config import MeshConfig as JaxMesh
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu.ops.losses import accuracy_counts as jax_counts
from ddp_practice_tpu.ops.losses import cross_entropy as jax_ce
from ddp_practice_tpu.parallel.sharding_rules import (
    param_sharding_rules as jax_rules,
)
from ddp_practice_tpu.train.state import TrainState as JaxState
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu.train.steps import make_lm_train_step as jax_lm_step
from ddp_practice_tpu_torch import cli
from ddp_practice_tpu_torch.config import MeshConfig, TrainConfig
from ddp_practice_tpu_torch.convert import (
    _torch_name,
    flax_to_state_dict,
    load_flax_params,
    state_dict_to_flax,
)
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.ops.losses import cross_entropy
from ddp_practice_tpu_torch.parallel.mesh import (
    build_mesh,
    full_parameters,
    is_replica0,
    parallelize,
    place,
    shard_state,
)
from ddp_practice_tpu_torch.parallel.sharding_rules import (
    layouts,
    param_sharding_rules,
)
from ddp_practice_tpu_torch.train.loop import Trainer
from ddp_practice_tpu_torch.train.state import (
    TrainState,
    global_norm,
    make_optimizer,
    norm_groups,
)
from ddp_practice_tpu_torch.train.steps import make_lm_train_step

VOCAB = 32
KW = dict(vocab_size=VOCAB, max_len=32, hidden_dim=32, depth=4,
          num_heads=4, mlp_dim=64)
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)


def _tokens(b=8, s=17, seed=5):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s))


def _reference(pos_emb: str, grads: bool):
    """The sequential JAX lm_pipe's params, the batch, its logits and,
    with `grads`, its loss, accuracy counts and grads (port names)."""
    jm = jax_create_model("lm_pipe", num_stages=1, pos_emb=pos_emb, **KW)
    tokens = _tokens()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    params = _perturb(jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(2), jnp.asarray(inputs))["params"]),
        np.random.default_rng(1))
    out = dict(jm=jm, params=params, inputs=inputs, targets=targets)

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(inputs))
        return jax_ce(logits, jnp.asarray(targets)), logits

    if not grads:
        out["logits"] = np.asarray(jax.jit(jm.apply)(
            {"params": params}, jnp.asarray(inputs)))
        return out
    (loss, logits), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    correct, total = jax_counts(logits, jnp.asarray(targets))
    out.update(logits=np.asarray(logits), loss=float(loss),
               correct=float(correct), total=float(total),
               grads=flax_to_state_dict(jax.device_get(g)))
    return out


@pytest.fixture(scope="module")
def ref():
    return _reference("learned", grads=True)


def _whole(model, tensors: dict) -> dict:
    """Each rank-local tensor of `tensors` (by parameter name) whole, in
    the single-rank layout (a collective: every rank calls it)."""
    import torch.distributed as tdist

    sharding = model.sharding
    out = {}
    for name, t in tensors.items():
        whole = torch.zeros(sharding.layouts[name].shape)
        if is_replica0(sharding, name):
            place(t.detach(), sharding, name, whole)
        tdist.all_reduce(whole)
        out[name] = whole
    return out


def _pipelined(ref, mesh: dict, world: int, mode: str, **kw):
    """Per rank: (loss, counts, grads whole) of `mode` ("gpipe": autograd
    through the GPipe forward; else the model's loss_and_grad) or the
    logits ("forward"), lm_pipe laid out on `mesh`."""
    def rank(r):
        model = create_model("lm_pipe", device="cpu",
                             pos_emb=ref["jm"].embed.pos_emb, **KW, **kw)
        load_flax_params(model, ref["params"])
        shard_state(model, build_mesh(MeshConfig(**mesh), "cpu"),
                    param_sharding_rules("lm_pipe"), "lm_pipe")
        x = torch.from_numpy(ref["inputs"])
        y = torch.from_numpy(ref["targets"])
        if mode == "forward":
            with torch.no_grad():
                return model(x).numpy()
        if mode == "gpipe":
            loss, counts = cross_entropy(model(x), y), None
            loss.backward()
        else:
            loss, counts = model.loss_and_grad(x, y)
        grads = _whole(model, {n: p.grad for n, p in
                               model.named_parameters()})
        counts = counts and {k: float(v) for k, v in counts.items()}
        return float(loss.detach()), counts, grads

    return ranks(rank, world)


def _assert_grads(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("pos_emb", ["learned", "rope"])
def test_pipelined_lm_forward_matches_sequential(ref, pos_emb):
    r = ref if pos_emb == "learned" else _reference("rope", grads=False)
    for logits in _pipelined(r, dict(pipe=4), 4, "forward", num_stages=4,
                             num_microbatches=2):
        np.testing.assert_allclose(logits, r["logits"], **FWD_TOL)


def test_pipelined_lm_grads_match_sequential(ref):
    res = _pipelined(ref, dict(pipe=4), 4, "gpipe", num_stages=4,
                     num_microbatches=2)
    for loss, _, grads in res:
        np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
        _assert_grads(grads, ref["grads"])


@pytest.mark.parametrize("schedule,pipe,microbatches", [
    ("1f1b", 4, 2), ("1f1b", 4, 4), ("interleaved", 2, 4)])
def test_scheduled_loss_and_grads_match_sequential(ref, schedule, pipe,
                                                   microbatches):
    """1F1B (M 2: bubble-heavy; M 4: the steady state) and interleaved
    (pipe 2, V 2: a chunk a block) compute the sequential model's mean
    loss, accuracy counts and grads on every rank."""
    res = _pipelined(ref, dict(pipe=pipe), pipe, "scheduled",
                     num_stages=pipe, num_microbatches=microbatches,
                     schedule=schedule)
    for loss, counts, grads in res:
        np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
        assert counts == {"correct": ref["correct"], "total": ref["total"]}
        _assert_grads(grads, ref["grads"])


def test_1f1b_matches_the_references_schedule(ref):
    """The reference's own 1F1B (`PipelinedLM.loss_and_grad`, its
    8-device mesh at data 4 x pipe 2, M 2) and the port's at pipe 2:
    the loss (the sum rescaled by the weight sum), the counts and the
    grads."""
    from ddp_practice_tpu.parallel.mesh import build_mesh as jax_mesh
    from ddp_practice_tpu.parallel.ring import set_current_mesh

    set_current_mesh(jax_mesh(JaxMesh(data=4, pipe=2)))
    try:
        piped = jax_create_model("lm_pipe", num_stages=2, schedule="1f1b",
                                 num_microbatches=2, **KW)
        (loss, counts), grads = jax.jit(lambda p: piped.loss_and_grad(
            p, jnp.asarray(ref["inputs"]), jnp.asarray(ref["targets"])))(
            ref["params"])
    finally:
        set_current_mesh(None)
    want = flax_to_state_dict(jax.device_get(grads))
    res = _pipelined(ref, dict(pipe=2), 2, "scheduled", num_stages=2,
                     num_microbatches=2, schedule="1f1b")
    for got_loss, got_counts, got in res:
        np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
        assert got_counts == {k: float(v) for k, v in counts.items()}
        _assert_grads(got, want)


def test_pipelined_lm_is_causal(ref):
    """Perturbing token t leaves the logits before t unchanged, through
    the GPipe schedule at pipe 4."""
    t = 9
    bumped = ref["inputs"].copy()
    bumped[:, t] = (bumped[:, t] + 1) % VOCAB
    base = _pipelined(ref, dict(pipe=4), 4, "forward", num_stages=4,
                      num_microbatches=2)[0]
    moved = _pipelined({**ref, "inputs": bumped}, dict(pipe=4), 4,
                       "forward", num_stages=4, num_microbatches=2)[0]
    np.testing.assert_allclose(moved[:, :t], base[:, :t], rtol=1e-6,
                               atol=1e-6)
    assert np.abs(moved[:, t:] - base[:, t:]).max() > 1e-4


def test_pipelined_lm_numerically_equals_dense_lm():
    """lm_tiny's params mapped into the pipelined layout (blocks stacked
    on a depth dim, embed and head split out): the port's lm_pipe gives
    the port's lm_tiny logits, and both JAX's lm_tiny's."""
    dense = jax_create_model("lm_tiny", **KW)
    inputs = _tokens()[:, :-1]
    dp = _perturb(jax.device_get(jax.jit(dense.init)(
        jax.random.PRNGKey(4), jnp.asarray(inputs))["params"]),
        np.random.default_rng(2))
    want = np.asarray(jax.jit(dense.apply)({"params": dp},
                                           jnp.asarray(inputs)))
    blocks = [dp[f"block{i}"] for i in range(KW["depth"])]
    piped = {"embed": {"tok_embed": dp["tok_embed"],
                       "pos_embed": dp["pos_embed"]},
             "blocks": jax.tree.map(lambda *xs: np.stack(xs), *blocks),
             "head": {"ln_f": dp["ln_f"], "lm_head": dp["lm_head"]}}
    x = torch.from_numpy(inputs)
    tiny = load_flax_params(create_model("lm_tiny", device="cpu", **KW), dp)
    pipe = load_flax_params(create_model("lm_pipe", device="cpu", **KW),
                            piped)
    with torch.no_grad():
        got_dense, got_pipe = tiny(x).numpy(), pipe(x).numpy()
    np.testing.assert_array_equal(got_pipe, got_dense)
    np.testing.assert_allclose(got_pipe, want, **FWD_TOL)
    # and back: the stacked state is the flax tree it came from
    back = state_dict_to_flax(pipe.state_dict(), piped)
    for (path, a), b in zip(tree_flatten_with_path(piped)[0],
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=keystr(path))


STEP_CFG = dict(optimizer="sgd", learning_rate=0.1, momentum=0.9,
                clip_norm=0.05)


@pytest.fixture(scope="module")
def jax_steps(ref):
    """Two SGD steps (momentum 0.9, clipping at 0.05: on) of the JAX
    sequential lm_pipe on a global batch of 8: each step's loss and grad
    norm, and the params after."""
    tx = jax_optimizer(JaxConfig(**STEP_CFG), 1)
    params = jax.tree.map(jnp.asarray, ref["params"])
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=None, opt_state=tx.init(params))
    step = jax_lm_step(ref["jm"], tx, seed=1)
    batch = {"tokens": jnp.asarray(_tokens(), jnp.int32)}
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return metrics, flax_to_state_dict(jax.device_get(state.params))


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_dp_pp_tp_train_step_matches_the_jax_step(ref, jax_steps, schedule):
    """data 2 x pipe 2 x tensor 2 (8 ranks), M 2: two train steps through
    `parallelize` (DDP under GPipe; the once-a-step data mean under 1F1B)
    give the JAX step's losses and grad norms (the clipping norm sums
    each stage's blocks once) and its parameters."""
    want_metrics, want = jax_steps
    tokens = torch.from_numpy(_tokens())

    def rank(r):
        from ddp_practice_tpu_torch.parallel.mesh import batch_shard

        model = create_model("lm_pipe", device="cpu", num_stages=2,
                             num_microbatches=2, schedule=schedule, **KW)
        load_flax_params(model, ref["params"])
        mesh = build_mesh(MeshConfig(data=2, pipe=2, tensor=2), "cpu")
        forward, after = parallelize(model, mesh, model_name="lm_pipe",
                                     fsdp=False)
        state = TrainState(0, model, make_optimizer(
            TrainConfig(**STEP_CFG, device="cpu"), model))
        step = make_lm_train_step(model, seed=1, forward=forward,
                                  after_backward=after)
        batch = {"tokens": tokens[batch_shard(mesh).local_slice(8)]}
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        return metrics, full_parameters(model)

    res = ranks(rank, 8)
    for metrics, _ in res:
        for got, w in zip(metrics, want_metrics):
            for k in w:
                np.testing.assert_allclose(got[k], w[k], rtol=1e-4,
                                           err_msg=k)
    got = res[0][1]
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def _ref_tree():
    return jax.eval_shape(
        jax_create_model("lm_pipe", num_stages=1, **KW).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.mark.parametrize("schedule", ["gpipe", "interleaved"])
def test_placements_equal_the_references_lm_pipe_rule(schedule):
    """Every leaf's Spec is the reference's `_lm_pipe_rule` spec mapped
    through its Layout: the stacked blocks' stage sub-dim over pipe,
    their inner dims Megatron over tensor, the vocabulary cuts of the
    embed and head; under interleaving the same spec cuts each rank's
    chunks."""
    tree = _ref_tree()
    model = create_model("lm_pipe", device="cpu", num_stages=2,
                         schedule=schedule, **KW)
    lay = layouts(model)
    ref, port = jax_rules("lm_pipe"), param_sharding_rules("lm_pipe")
    flat = tree_flatten_with_path(tree)[0]
    assert len(flat) == len(lay)
    for path, leaf in flat:
        tname = _torch_name(tuple(k.key for k in path))
        layout = lay[tname]
        assert layout.ref_shape == tuple(leaf.shape), tname
        want = layout.from_ref(ref(path, leaf))
        assert (port(tname, layout) or layout.unsharded()) == want, tname
    v = 2 if schedule == "interleaved" else 1
    assert lay["blocks.mlp.fc_in.weight"].dims[0] == (v, 2, 4 // (2 * v))


def test_interleaved_ranks_hold_their_chunks():
    """Under interleaving (pipe 2, V 2) rank i holds blocks [i, 2 + i]
    (chunks v P + i), each stacked leaf's local slice in chunk order."""
    whole = create_model("lm_pipe", device="cpu", num_stages=2,
                         schedule="interleaved", **KW)
    want = whole.blocks.mlp.fc_in.weight.detach()

    def rank(r):
        model = create_model("lm_pipe", device="cpu", num_stages=2,
                             schedule="interleaved", **KW)
        shard_state(model, build_mesh(MeshConfig(pipe=2), "cpu"),
                    param_sharding_rules("lm_pipe"), "lm_pipe")
        return model.blocks.mlp.fc_in.weight.detach()

    for r, local in enumerate(ranks(rank, 2)):
        torch.testing.assert_close(local, want[[r, 2 + r]], rtol=0, atol=0)


def test_clipping_norm_counts_every_leaf_once():
    """Under pipe 2 x tensor 2 the global norm of the laid-out grads (its
    groups: the pipe group for the stacked blocks, tensor for their
    Megatron cuts, none for the whole embed and head) is the one-rank
    norm of the same grads."""
    torch.manual_seed(0)
    whole = create_model("lm_pipe", device="cpu", num_stages=2, **KW)
    grads = {n: torch.randn(p.shape) for n, p in whole.named_parameters()}
    want = float(global_norm(list(grads.values())))

    def rank(r):
        from ddp_practice_tpu_torch.parallel.sharding_rules import (
            take_region,
        )

        model = create_model("lm_pipe", device="cpu", num_stages=2, **KW)
        sharding = shard_state(model, build_mesh(
            MeshConfig(pipe=2, tensor=2), "cpu"),
            param_sharding_rules("lm_pipe"), "lm_pipe")
        local = [take_region(grads[n], sharding.layouts[n],
                             sharding.spec(n), sharding.coords)
                 for n, _ in model.named_parameters()]
        return float(global_norm(local, norm_groups(model)))

    for got in ranks(rank, 4):
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("argv,world,err,match", [
    (["--model", "lm_pipe", "--pipe_schedule", "1f1b"], 1, ValueError,
     "needs a pipeline mesh axis"),
    (["--model", "lm_pipe", "--dropout", "0.1"], 1, ValueError,
     "--dropout is wired for the dense transformer families"),
    (["--model", "lm_pipe", "--tied"], 1, ValueError,
     "--tied is not wired for the pipelined LM"),
    (["--model", "lm_tiny", "--pipe", "2"], 2, ValueError,
     "stage-sharded variant: --model lm_pipe"),
    (["--model", "vit_tiny_pipe", "--dataset", "cifar10", "--pipe", "2",
      "--pipe_schedule", "1f1b"], 2, ValueError,
     "schedules with GPipe only"),
    (["--model", "lm_pipe", "--pipe", "2", "--microbatches", "3"], 2,
     ValueError, "not divisible by microbatches 3"),
])
def test_the_loops_pipeline_refusals(argv, world, err, match):
    """The reference's checks (train/loop.py), with its messages."""
    common = ["--device", "cpu", "--seq_len", "16", "-b", "4",
              "--max_steps", "1", "-e", "1", "--synthetic_size", "20000",
              "--log_every", "0", "--num_heads", "4"]
    if world == 1:
        with pytest.raises(err, match=match):
            cli.main(argv + common)
        return
    with pytest.raises(RuntimeError) as raised:
        ranks(lambda r: cli.main(argv + common), world)
    assert isinstance(raised.value.__cause__, err)
    assert match in str(raised.value.__cause__)


@pytest.mark.parametrize("argv,world", [
    (["--pipe", "2", "--pipe_schedule", "1f1b", "--microbatches", "2"], 2),
    (["--pipe", "2", "--pipe_schedule", "interleaved", "--num_virtual",
      "2", "--microbatches", "2"], 2),
    (["--pipe", "2", "--tensor", "2", "--microbatches", "2"], 4),
    (["--pipe", "2", "--fsdp", "--pipe_schedule", "1f1b",
      "--microbatches", "2"], 4),
], ids=["1f1b", "interleaved", "gpipe-tensor", "1f1b-fsdp"])
def test_pipeline_flags_run_through_the_cli(argv, world, capsys):
    """--pipe, --microbatches, --pipe_schedule and --num_virtual reach
    the loop: lm_pipe trains two steps and evaluates on every rank."""
    common = ["--model", "lm_pipe", "--device", "cpu", "--seq_len", "16",
              "-b", "4", "--max_steps", "2", "-e", "1", "--num_heads", "4",
              "--synthetic_size", "20000", "--log_every", "0", "--json"]
    assert ranks(lambda r: cli.main(argv + common), world) == [0] * world
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 2 and summary["devices"] == world
    assert np.isfinite(summary["perplexity"])


def test_trainer_builds_the_stages_from_the_mesh():
    """The trainer passes the stage count, microbatches and schedule to
    lm_pipe; each rank keeps its half of the stacked blocks."""
    cfg = TrainConfig(model="lm_pipe", device="cpu", seq_len=16,
                      batch_size=4, synthetic_size=20000, num_heads=4,
                      mesh=MeshConfig(pipe=2), pipe_schedule="interleaved",
                      num_microbatches=2, num_virtual=2)

    def rank(r):
        t = Trainer(cfg)
        m = t.model
        return (m.num_stages, m.num_microbatches, m.schedule,
                m.block_stack, m.pipe.rank,
                tuple(m.blocks.ln1.weight.shape))

    for r, got in enumerate(ranks(rank, 2)):
        assert got == (2, 2, "interleaved", (2, 2, 1), r, (2, 256))
