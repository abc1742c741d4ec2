"""The port's sequence parallelism (parallel/ring.py, parallel/ulysses.py,
`seq_axis` through the models, the steps and the loop) against the JAX
package's, on the CPU, the ranks as threads of this process
(tests/_torch_port.py `ranks`: torch's threaded process group, no new
process), inputs from numpy seeds:

- ring and Ulysses attention, impl "xla" and "flash", causal and not, on
  8 seq ranks, against the reference's `ring_attention` /
  `ulysses_attention` on its 8-device CPU mesh and against dense
  attention: output 2e-5, gradients of sum(out^2) 5e-5 (the tolerances
  of tests/test_ring.py and tests/test_ulysses.py);
- Ulysses at data 2 x seq 2 x tensor 2 (the reference's
  `test_ulysses_composes_with_tp`) and its indivisible-heads error;
- the seq-sharded lm_tiny logits, learned and RoPE positions, ring and
  Ulysses, against the reference's SP model at 2e-4 (tests/test_lm.py,
  tests/test_rope.py);
- one LM train step under seq 2 (ring; Ulysses with the flash route) and
  under data 2 x seq 2 with FSDP, against the reference's step: loss and
  grad_norm rtol 1e-4, parameters rtol 1e-3 / atol 1e-5 (the
  tolerances of tests/test_torch_parallel.py), clipping on;
- vit_tiny with ring attention at seq 2, two steps against the dense
  reference's;
- port against port: dropout masks at global positions, a weighted loss,
  the eval sums and the mesh's seq layout equal the one-rank ones;
- `--seq 2 --sp_impl ...` through the CLI; lm_moe builds under seq
  (ROADMAP A8f: tests/test_torch_expert_parallel.py holds it to the
  reference), decode under seq refuses with the reference's message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import ranks
from ddp_practice_tpu.config import MeshConfig as JaxMesh
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu.ops.attention import _attention as jax_attention
from ddp_practice_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention,
)
from ddp_practice_tpu.parallel.mesh import build_mesh as jax_build_mesh
from ddp_practice_tpu.parallel.ring import ring_attention as jax_ring
from ddp_practice_tpu.parallel.ring import set_current_mesh
from ddp_practice_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from ddp_practice_tpu.train.state import TrainState as JaxState
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu.train.steps import make_lm_train_step as jax_lm_step
from ddp_practice_tpu_torch import cli
from ddp_practice_tpu_torch.config import MeshConfig, TrainConfig
from ddp_practice_tpu_torch.convert import flax_to_state_dict, load_flax_params
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.ops.attention import dot_product_attention
from ddp_practice_tpu_torch.parallel.fsdp import fsdp_rules
from ddp_practice_tpu_torch.parallel.mesh import (
    batch_shard,
    build_mesh,
    coords,
    full_parameters,
    is_replica0,
    parallelize,
    seq_group,
    shard_state,
)
from ddp_practice_tpu_torch.parallel.sharding_rules import (
    layouts,
    param_sharding_rules,
)
from ddp_practice_tpu_torch.train.loop import Trainer
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
from ddp_practice_tpu_torch.train.steps import (
    make_lm_eval_step,
    make_lm_train_step,
    make_train_step,
)

LM = dict(vocab_size=32, max_len=64, hidden_dim=64, depth=2, num_heads=4,
          mlp_dim=128)
OUT_TOL, GRAD_TOL = 2e-5, 5e-5


@pytest.fixture
def jax_mesh(devices):
    """make(**axes): the reference's mesh on the 8 CPU devices, set as its
    current mesh until the test ends."""

    def make(**axes):
        set_current_mesh(jax_build_mesh(JaxMesh(**axes)))

    yield make
    set_current_mesh(None)


def _qkv(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax_out_and_grads(fn, qkv):
    """fn(q, k, v) and the grads of sum(fn(q, k, v)^2), jitted once."""

    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, qkv))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_out_and_grads(mesh_cfg, qkv, attend, world):
    """Each rank's chunk (its data rows, seq chunk and tensor heads) of
    q, k, v through `attend(q, k, v, sp)`, and the grads of sum(out^2),
    reassembled whole."""

    def rank(r):
        mesh = build_mesh(mesh_cfg, "cpu")
        c = coords(mesh)
        sp = seq_group(mesh)
        rows = batch_shard(mesh).local_slice(qkv[0].shape[0])
        (tc, tn), (sc, sn) = c["tensor"], c["seq"]
        h = qkv[0].shape[2] // tn
        s = qkv[0].shape[1] // sn
        box = (rows, slice(sc * s, (sc + 1) * s), slice(tc * h, (tc + 1) * h))
        xs = [torch.from_numpy(t[box]).requires_grad_(True) for t in qkv]
        out = attend(*xs, sp)
        (out ** 2).sum().backward()
        return box, out.detach().numpy(), [x.grad.numpy() for x in xs]

    out = np.zeros_like(qkv[0])
    grads = [np.zeros_like(t) for t in qkv]
    for box, o, gs in ranks(rank, world):
        out[box] = o
        for g, part in zip(grads, gs):
            g[box] = part
    return out, grads


def _assert_close(got, want, tol):
    out, grads = got
    np.testing.assert_allclose(out, want[0], rtol=tol[0], atol=tol[0])
    for g, w, name in zip(grads, want[1], "qkv"):
        np.testing.assert_allclose(g, w, rtol=tol[1], atol=tol[1],
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_attention_matches_the_reference_and_dense(jax_mesh, sp_impl, impl,
                                                   causal):
    """8 seq ranks, (b, s, h, d) = (2, 32, 8, 8): 4 positions a rank;
    Ulysses one head a rank."""
    qkv = _qkv(2, 32, 8, 8, seed=3)
    jax_mesh(data=1, seq=8, tensor=1)
    ref = jax_ring if sp_impl == "ring" else jax_ulysses
    want_sp = _jax_out_and_grads(lambda q, k, v: ref(
        q, k, v, axis_name="seq", causal=causal, impl=impl), qkv)
    want_dense = _jax_out_and_grads(
        lambda q, k, v: jax_attention(q, k, v, causal=causal), qkv)
    got = _port_out_and_grads(
        MeshConfig(seq=8), qkv, lambda q, k, v, sp: dot_product_attention(
            q, k, v, causal=causal, seq_axis=sp, sp_impl=sp_impl,
            impl=impl), 8)
    _assert_close(got, want_sp, (OUT_TOL, GRAD_TOL))
    _assert_close(got, want_dense, (OUT_TOL, GRAD_TOL))


def test_ulysses_composes_with_data_and_tensor(jax_mesh):
    """data 2 x seq 2 x tensor 2: heads over tensor, the rest of them
    scattered over seq (the reference's test_ulysses_composes_with_tp)."""
    qkv = _qkv(4, 16, 4, 8, seed=2)
    jax_mesh(data=2, seq=2, tensor=2)
    want_sp = _jax_out_and_grads(lambda q, k, v: jax_dot_product_attention(
        q, k, v, seq_axis="seq", sp_impl="ulysses"), qkv)
    want_dense = _jax_out_and_grads(
        lambda q, k, v: jax_attention(q, k, v, causal=False), qkv)
    got = _port_out_and_grads(
        MeshConfig(seq=2, tensor=2), qkv,
        lambda q, k, v, sp: dot_product_attention(
            q, k, v, seq_axis=sp, sp_impl="ulysses"), 8)
    _assert_close(got, want_sp, (OUT_TOL, GRAD_TOL))
    _assert_close(got, want_dense, (OUT_TOL, GRAD_TOL))


def test_ulysses_refuses_indivisible_heads_and_unknown_schemes():
    qkv = _qkv(2, 32, 4, 8, seed=0)

    def rank(r):
        sp = seq_group(build_mesh(MeshConfig(seq=8), "cpu"))
        q, k, v = (torch.from_numpy(t[:, 4 * r:4 * r + 4]) for t in qkv)
        errors = []
        for sp_impl in ("ulysses", "zigzag"):
            try:
                dot_product_attention(q, k, v, seq_axis=sp, sp_impl=sp_impl)
            except ValueError as exc:
                errors.append(str(exc))
        return errors

    for errors in ranks(rank, 8):
        assert errors == [
            "ulysses needs local heads (4) divisible by 'seq' axis size (8)",
            "unknown sp_impl 'zigzag' (want 'ring'|'ulysses')"]


# ------------------------------------------------------------- the LM
@pytest.fixture(scope="module")
def lm_params():
    """lm_tiny's flax params at 8 heads, learned and rope positions."""
    tokens = jnp.zeros((2, 32), jnp.int32)
    out = {}
    for pos in ("learned", "rope"):
        jm = jax_create_model("lm_tiny", **{**LM, "num_heads": 8},
                              pos_emb=pos)
        out[pos] = jax.device_get(jax.jit(jm.init)(
            jax.random.PRNGKey(0), tokens)["params"])
    return out


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
@pytest.mark.parametrize("pos_emb", ["learned", "rope"])
def test_lm_logits_match_the_references_sp_model(jax_mesh, lm_params,
                                                 pos_emb, sp_impl):
    """lm_tiny (8 heads) cut over 8 seq ranks, 4 tokens a rank, against
    the reference's seq-sharded decoder on its 8-device mesh (which its
    own tests hold to the dense one at 2e-4)."""
    params = lm_params[pos_emb]
    tokens = np.random.default_rng(0).integers(0, 32, (2, 32))
    jax_mesh(data=1, seq=8)
    kw = {**LM, "num_heads": 8, "pos_emb": pos_emb}
    jm = jax_create_model("lm_tiny", **kw, seq_axis="seq", sp_impl=sp_impl)
    want = np.asarray(jax.jit(jm.apply)({"params": params},
                                        jnp.asarray(tokens, jnp.int32)))

    def rank(r):
        model = create_model("lm_tiny", device="cpu", **kw, seq_axis="seq",
                             sp_impl=sp_impl)
        load_flax_params(model, params)
        shard_state(model, build_mesh(MeshConfig(seq=8), "cpu"), None,
                    "lm_tiny")
        with torch.no_grad():
            return model(torch.from_numpy(tokens[:, 4 * r:4 * r + 4])
                         ).numpy()

    got = np.concatenate(ranks(rank, 8), axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


STEP = dict(optimizer="sgd", learning_rate=0.1, clip_norm=0.05)
STEP_CASES = {
    "ring": (MeshConfig(seq=2), False, "ring", "xla", 2),
    "ulysses-flash": (MeshConfig(seq=2), False, "ulysses", "flash", 2),
    "ring-fsdp": (MeshConfig(seq=2), True, "ring", "flash", 4),
}


@pytest.fixture(scope="module")
def lm_step_reference():
    """The reference's dense LM step on 4 rows of 17 tokens: its params
    before, its metrics and params after."""
    jm = jax_create_model("lm_tiny", **LM)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"])
    tokens = np.random.default_rng(7).integers(0, 32, (4, 17))
    tx = jax_optimizer(JaxConfig(**STEP), 1)
    jparams = jax.tree.map(jnp.asarray, params)   # the step donates them
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=jparams,
                      batch_stats=None, opt_state=tx.init(jparams))
    jstate, metrics = jax_lm_step(jm, tx, seed=1)(
        jstate, {"tokens": jnp.asarray(tokens, jnp.int32)})
    assert float(metrics["grad_norm"]) > 2 * STEP["clip_norm"]
    return params, tokens, metrics, jax.device_get(jstate.params)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_lm_train_step_matches_the_reference(lm_step_reference, case):
    """One SGD step with clipping through the port's step laid out as
    the train loop lays it out (parallelize: DDP over seq, or FSDP over
    data with the seq mean), each rank its rows and its chunk."""
    params, tokens, want, want_params = lm_step_reference
    mesh_cfg, fsdp, sp_impl, attn, world = STEP_CASES[case]

    def rank(r):
        model = create_model("lm_tiny", device="cpu", **LM, seq_axis="seq",
                             sp_impl=sp_impl, attn_impl=attn)
        load_flax_params(model, params)
        mesh = build_mesh(mesh_cfg, "cpu")
        forward, after = parallelize(model, mesh, model_name="lm_tiny",
                                     fsdp=fsdp, min_leaf_size=128)
        state = TrainState(0, model, make_optimizer(
            TrainConfig(**STEP, device="cpu"), model))
        step = make_lm_train_step(model, seed=1, forward=forward,
                                  after_backward=after)
        rows = batch_shard(mesh).local_slice(tokens.shape[0])
        state, m = step(state, {"tokens": torch.from_numpy(tokens[rows])})
        return {k: float(v) for k, v in m.items()}, full_parameters(model)

    res = ranks(rank, world)
    for metrics, _ in res:
        for k in ("loss", "grad_norm", "accuracy"):
            np.testing.assert_allclose(metrics[k], float(want[k]),
                                       rtol=1e-4, err_msg=k)
    ref = flax_to_state_dict(want_params)
    for name, w in ref.items():
        np.testing.assert_allclose(res[0][1][name].numpy(), w.numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_vit_ring_matches_the_dense_reference():
    """vit_tiny (4 heads, 16 patch tokens: 8 a rank) with ring attention
    at seq 2: two SGD steps against the reference's dense run (its
    tests/test_tensor_parallel.py setup). The pool sums over the seq
    group, so both ranks report the whole batch's loss."""
    from test_tensor_parallel import _batch
    from test_torch_parallel import VIT, _vit_reference

    batch = _batch(8, seed=4)
    params0, want, want_losses = _vit_reference(2, batch)

    def rank(r):
        model = create_model("vit_tiny", device="cpu", **VIT,
                             image_shape=(16, 16, 3), seq_axis="seq")
        load_flax_params(model, jax.device_get(params0))
        mesh = build_mesh(MeshConfig(seq=2), "cpu")
        forward, after = parallelize(model, mesh, model_name="vit_tiny",
                                     fsdp=False)
        assert model.classifier is not None and model.sp.size == 2
        state = TrainState(0, model, make_optimizer(
            TrainConfig(optimizer="sgd", learning_rate=1e-2, device="cpu"),
            model))
        step = make_train_step(model, forward=forward, after_backward=after)
        b = {"image": torch.from_numpy(np.array(batch["image"])),
             "label": torch.from_numpy(np.array(batch["label"])).long()}
        losses = []
        for _ in range(2):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return losses, full_parameters(model)

    res = ranks(rank, 2)
    ref = flax_to_state_dict(jax.device_get(want))
    for losses, got in res:
        np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
        for name, w in ref.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=name)


# ------------------------------------------------- the port against itself
def _tiny(seed=0, **kw):
    return create_model("lm_tiny", device="cpu", seed=seed, **{**LM, **kw})


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_dropout_and_weighted_loss_equal_one_rank(sp_impl):
    """Dropout masks are drawn at global positions and a weighted loss
    divides by the whole sequences' weight: an lm_tiny step with dropout
    0.2 and a position mask at seq 2 equals the one-rank step (loss,
    grad_norm and every parameter)."""
    tokens = np.random.default_rng(5).integers(0, 32, (2, 17))
    weight = (np.random.default_rng(6).random((2, 16)) > 0.3).astype(
        np.float32)
    weight[:, 8:] = 0.0           # rank 1 holds no weight at all
    weight[0, 9] = 1.0
    cfg = TrainConfig(optimizer="sgd", learning_rate=0.1, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens),
             "weight": torch.from_numpy(weight)}

    def run(model, forward=None, after=None):
        state = TrainState(0, model, make_optimizer(cfg, model))
        step = make_lm_train_step(model, seed=4, forward=forward,
                                  after_backward=after)
        _, m = step(state, batch)
        return {k: float(v) for k, v in m.items()}

    one = _tiny(dropout_rate=0.2)
    want = run(one)
    want_params = {n: p.detach() for n, p in one.named_parameters()}

    def rank(r):
        model = _tiny(dropout_rate=0.2, seq_axis="seq", sp_impl=sp_impl)
        forward, after = parallelize(
            model, build_mesh(MeshConfig(seq=2), "cpu"),
            model_name="lm_tiny", fsdp=False)
        return run(model, forward, after), full_parameters(model)

    for metrics, params in ranks(rank, 2):
        for k in ("loss", "grad_norm", "accuracy"):
            np.testing.assert_allclose(metrics[k], want[k], rtol=1e-5,
                                       err_msg=k)
        for name, w in want_params.items():
            torch.testing.assert_close(params[name], w, rtol=1e-4,
                                       atol=1e-6, msg=name)


def test_eval_sums_cover_the_seq_group():
    """The LM eval step under seq 2 returns the whole sequences' (correct,
    total, nll) on every rank."""
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 32,
                                                                (3, 17)))
    want = [float(x) for x in make_lm_eval_step(_tiny(1))(
        None, {"tokens": tokens})]

    def rank(r):
        model = _tiny(1, seq_axis="seq", sp_impl="ring")
        shard_state(model, build_mesh(MeshConfig(seq=2), "cpu"), None)
        return [float(x) for x in make_lm_eval_step(model)(
            None, {"tokens": tokens})]

    for got in ranks(rank, 2):
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert got[1] == 48.0


def test_the_seq_axis_cuts_no_parameter():
    """data 2 x seq 2 x tensor 2: the seq ranks of a data replica read
    the same rows; under FSDP every leaf keeps the reference's data and
    tensor placement (no spec names seq), and a leaf's seq replica 1
    writes nothing."""

    def rank(r):
        model = _tiny(seq_axis="seq")
        mesh = build_mesh(MeshConfig(seq=2, tensor=2), "cpu")
        lay = layouts(model)
        sharding = shard_state(model, mesh, fsdp_rules(
            2, param_sharding_rules("lm_tiny"), min_leaf_size=128))
        c = coords(mesh)
        want = fsdp_rules(2, param_sharding_rules("lm_tiny"),
                          min_leaf_size=128)
        for name, spec in sharding.specs.items():
            assert spec == want(name, lay[name])
            assert "seq" not in str(spec) and "seq" not in \
                sharding.sharded_axes(name)
        writes = [is_replica0(sharding, n) for n in lay]
        return (r, c["data"], c["seq"], c["tensor"],
                batch_shard(mesh).local_slice(8), any(writes))

    for r, data, seq, tensor, rows, writes in ranks(rank, 8):
        assert data == (r // 4, 2) and seq == (r // 2 % 2, 2)
        assert tensor == (r % 2, 2)
        assert rows == slice(4 * (r // 4), 4 * (r // 4) + 4)
        assert writes == (seq[0] == 0)


# ------------------------------------------------------- entry points
@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_seq_flags_run_through_the_cli(capsys, sp_impl):
    """ROADMAP A8b's flags through the CLI, the ranks as threads: 2
    steps at data 2 x seq 2, a refused seq_len, and no card asked for
    without --device cpu."""
    common = ["--model", "lm_tiny", "--device", "cpu", "-b", "2",
              "--max_steps", "2", "-e", "1", "--num_heads", "4",
              "--synthetic_size", "20000", "--log_every", "0", "--json",
              "--seq", "2", "--sp_impl", sp_impl]
    assert ranks(lambda r: cli.main(common + ["--seq_len", "16"]), 4) \
        == [0] * 4
    summary = __import__("json").loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 2 and summary["devices"] == 4
    assert summary["global_batch"] == 4
    with pytest.raises(RuntimeError) as err:
        ranks(lambda r: cli.main(common + ["--seq_len", "15"]), 2)
    assert ("sequence length 15 does not split into seq=2 equal chunks"
            in str(err.value.__cause__))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([a if a != "cpu" else "cuda" for a in common]
                     + ["--seq_len", "16"])


def test_moe_decode_and_conv_refuse_under_seq():
    """lm_moe builds under seq (its routed MLPs take the seq group:
    ROADMAP A8f); decode raises the reference's message; a model without
    seq_axis, or without tokens, refuses."""
    cfg = dict(device="cpu", seq_len=16, batch_size=2, synthetic_size=20000,
               mesh=MeshConfig(seq=2))

    def rank(r):
        errors = []
        moe = Trainer(TrainConfig(model="lm_moe", num_experts=4, **cfg))
        assert moe.model.blocks[1].moe.sp.size == 2
        try:
            Trainer(TrainConfig(model="convnet", **cfg))
        except ValueError as e:
            errors.append(str(e))
        model = _tiny(seq_axis="seq")
        mesh = build_mesh(MeshConfig(seq=2), "cpu")
        try:
            shard_state(_tiny(), mesh, None, "lm_tiny")
        except ValueError as e:
            errors.append(str(e))
        shard_state(model, mesh, None, "lm_tiny")
        try:
            model(torch.zeros((1, 4), dtype=torch.long),
                  cache=model.init_cache(1, 8))
        except ValueError as e:
            errors.append(str(e))
        return errors

    for errors in ranks(rank, 2):
        assert len(errors) == 3, errors
        assert "has none" in errors[0]
        assert "built without seq_axis" in errors[1]
        assert errors[2] == (
            "decode (KV-cache) mode does not compose with sequence "
            "parallelism — generate on a data/tensor-sharded mesh")


def test_the_trainer_lays_out_data_by_seq():
    """data 2 x seq 2 through the Trainer: the model gets its seq group,
    DDP averages over the four ranks, the optimizer holds each parameter
    once, and --scale_lr counts the data degree only (the reference's)."""
    import torch.distributed as tdist

    cfg = TrainConfig(model="lm_tiny", device="cpu", seq_len=16,
                      batch_size=2, synthetic_size=20000, num_heads=4,
                      learning_rate=0.1, scale_lr_by_replicas=True,
                      mesh=MeshConfig(seq=2), sp_impl="ulysses")

    def rank(r):
        t = Trainer(cfg)
        opt = t.state.optimizer
        return (t.dp, t.sp, t.model.blocks[0].attn.sp.size,
                t.model.sp.rank, t.model.blocks[0].attn.sp_impl,
                tdist.get_world_size(t.forward.process_group),
                float(opt.lr), len(opt.inner_params),
                len(list(t.model.parameters())), t.global_batch)

    for r, got in enumerate(ranks(rank, 4)):
        dp, sp, attn_sp, seq_rank, impl, ddp, lr, n_opt, n_params, gb = got
        assert (dp, sp, attn_sp, seq_rank, impl) == (2, 2, 2, r % 2,
                                                     "ulysses")
        assert ddp == 4 and n_opt == n_params and gb == 4
        assert lr == pytest.approx(0.2)
