"""MoE decode and serving in the port (ops/moe.py `decode`, the routed
blocks of models/lm.py under a KV cache, generate.py and the serving
engines over lm_moe) against the JAX package on the CPU, from seeded numpy
inputs and converted weights: lm_moe at depth 2 (block 1 routed), d 128,
2 heads of 64 (packable: the JAX side's single-token steps reach its
Pallas decode kernel in interpret mode), 4 experts, top-2.

The router biases (the reference's `batch_stats`) are drawn N(0, 1), the
size of the router logits, so they really move the routing (pinned by
`test_router_bias_changes_the_routing`); the reference gets them as
`batch_stats`, the port as its `router_bias` buffers.

Capacity makes results depend on which tokens share a call: a prefill of
a left-padded batch routes its pads too, and they compete for capacity
under token choice. That is the reference's behaviour. So the token
choice model runs at capacity factor 1.0 (a 12-token prefill keeps at most
6 of its 24 assignments an expert: drops happen, and must be the
reference's), and its engines are held against the reference's engines
on one trace, spec-verify windows and prefill chunks included. The
dropless paths (`impl="sorted"`, and expert choice, whose decode routes
per token with capacity t) are also held against `generate`.

The reference selects `impl` only through `MoEMlp`'s field (no entry
point sets it), so its gather and sorted decodes run with `MoEMlp`
swapped for a subclass whose `impl` default is the one under test, as the
reference's `EncoderBlock` imports it by name when it builds the block.

Tolerances: logits at the reference MoE tests' 2e-5 (`OUT`), greedy
tokens identical.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import _perturb
from ddp_practice_tpu import checkpoint as jax_ckpt
from ddp_practice_tpu import generate as jax_generate
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.inference import decode_apply as jax_decode_apply
from ddp_practice_tpu.inference import make_cache as jax_make_cache
from ddp_practice_tpu.inference import make_generate_fn as jax_generate_fn
from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu.ops import moe as jmoe
from ddp_practice_tpu.serve import EngineConfig as JaxEngineConfig
from ddp_practice_tpu.serve import PagedEngine as JaxPagedEngine
from ddp_practice_tpu.serve import SlotEngine as JaxSlotEngine
from ddp_practice_tpu.serve import kv_pages as jax_kv
from ddp_practice_tpu.serve.scheduler import FakeClock as JaxFakeClock
from ddp_practice_tpu.serve.scheduler import Request as JaxRequest
from ddp_practice_tpu.serve.scheduler import Scheduler as JaxScheduler
from ddp_practice_tpu.train.state import create_state as jax_create_state
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu_torch import checkpoint as ckpt
from ddp_practice_tpu_torch import generate
from ddp_practice_tpu_torch.config import TrainConfig
from ddp_practice_tpu_torch.convert import load_flax_params
from ddp_practice_tpu_torch.inference import (
    decode_apply,
    encode_bytes,
    make_generate_fn,
    pad_left_prompts,
)
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.ops.moe import moe_layers
from ddp_practice_tpu_torch.serve import (
    EngineConfig,
    FakeClock,
    PagedEngine,
    Request,
    Scheduler,
    SlotEngine,
)
from ddp_practice_tpu_torch.serve import bench
from ddp_practice_tpu_torch.serve import kv_pages as port_kv
from ddp_practice_tpu_torch.serve.bench import build_lookup_trace, build_trace
from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer

OUT = dict(rtol=2e-5, atol=2e-5)
VOCAB = 64
E, TOP_K = 4, 2
CFG = dict(vocab_size=VOCAB, hidden_dim=128, num_heads=2, depth=2,
           mlp_dim=256, max_len=128, pos_emb="rope", num_experts=E,
           capacity_factor=1.0)
# the prefill batch: left-padded prompts of 12, 7 and 3 tokens
B, S, STEPS = 3, 12, 3
LENS = np.array([12, 7, 3])
BS, MB = 16, 2                   # paged: block size, blocks a slot
SLOT = dict(max_slots=3, max_len=64, prompt_buckets=(8, 16))
PAGED = dict(max_slots=3, max_len=128, prompt_buckets=(16, 32),
             block_size=16)


def _impl_class(impl):
    """The reference's MoEMlp with `impl` as its default (None: as is)."""
    if impl in (None, "auto", "einsum"):
        return None
    return type(f"MoEMlp_{impl}", (jmoe.MoEMlp,),
                {"__annotations__": {"impl": str}, "impl": impl})


@contextlib.contextmanager
def jax_impl(impl):
    """Build (and trace) the reference's routed blocks with `impl`."""
    cls = _impl_class(impl)
    if cls is None:
        yield
        return
    with mock.patch.object(jmoe, "MoEMlp", cls):
        yield


def _build(router="topk", seed=0, **kw):
    """(jax model, params, batch_stats or None, port model): converted
    weights; biases, LayerNorm scales and expert biases off their init;
    router biases N(0, 1)."""
    cfg = {**CFG, "moe_router": router, **kw}
    jm = jax_create_model("lm_moe", **cfg)
    variables = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.default_rng(seed)
    params = _perturb(variables["params"], rng)
    for blk in params.values():
        if isinstance(blk, dict) and "moe" in blk:
            for name in ("expert_b_in", "expert_b_out"):
                blk["moe"][name] = blk["moe"][name] + rng.normal(
                    0, 0.05, blk["moe"][name].shape).astype(np.float32)
    stats = None
    if "batch_stats" in variables:
        stats = jax.tree.map(
            lambda v: rng.normal(0, 1.0, v.shape).astype(np.float32),
            variables["batch_stats"])
    tm = create_model("lm_moe", device="cpu", **cfg)
    load_flax_params(tm, params, stats)
    return (jm, jax.tree.map(jnp.asarray, params),
            None if stats is None else jax.tree.map(jnp.asarray, stats), tm)


@pytest.fixture(scope="module")
def topk():
    return _build("topk")


@pytest.fixture(scope="module")
def ec():
    return _build("expert_choice")


@pytest.fixture(scope="module")
def dropless():
    """Token choice at capacity factor E/k: capacity = t, so the einsum
    and gather paths drop nothing and equal the sorted path."""
    return _build("topk", seed=1, capacity_factor=E / TOP_K)


def _set_impl(tm, impl):
    for m in moe_layers(tm):
        m.impl = impl


def _prompt(seed):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, VOCAB, (B, S))
    start = (S - LENS).astype(np.int32)
    feeds = rng.integers(0, VOCAB, (STEPS, B, 1))
    return prompt, start, feeds


def _flat_runs(pair, impl, seed):
    """Prefill + STEPS single-token steps through both packages' flat
    caches: [(jax logits, port logits)] per application."""
    jm, params, stats, tm = pair
    prompt, start, feeds = _prompt(seed)
    total = S + STEPS
    _set_impl(tm, impl)
    out = []
    with jax_impl(impl):
        apply = jax.jit(lambda c, t: jax_decode_apply(
            jm, params, c, t, attn_start=jnp.asarray(start),
            batch_stats=stats))
        jc = jax_make_cache(jm, B, total)
        tc = tm.init_cache(B, total)
        for tokens in [prompt, *feeds]:
            jc, jl = apply(jc, jnp.asarray(tokens, jnp.int32))
            _, tl = decode_apply(tm, tc, torch.from_numpy(tokens).long(),
                                 attn_start=torch.from_numpy(start))
            out.append((np.asarray(jl), tl.numpy()))
    _set_impl(tm, "auto")
    return out


def _paged_runs(pair, impl, seed):
    """The same through block pools: slot b owns blocks 1 + b*MB ..., the
    prompt is a paged prefill at kv_lengths 0, then paged steps."""
    jm, params, stats, tm = pair
    prompt, start, feeds = _prompt(seed)
    nb = 1 + B * MB
    table = (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB)
    _set_impl(tm, impl)
    out = []
    with jax_impl(impl):
        apply = jax.jit(lambda c, t, n: jax_decode_apply(
            jm, params, c, t, attn_start=jnp.asarray(start),
            batch_stats=stats, page_table=jnp.asarray(table),
            kv_lengths=n))
        jc = jax_kv.make_paged_cache(jm, nb, BS)
        tc = port_kv.make_paged_cache(tm, nb, BS, "cpu")
        n = 0
        for tokens in [prompt, *feeds]:
            lengths = np.full((B,), n, np.int32)
            jc, jl = apply(jc, jnp.asarray(tokens, jnp.int32),
                           jnp.asarray(lengths))
            _, tl = decode_apply(
                tm, tc, torch.from_numpy(tokens).long(),
                attn_start=torch.from_numpy(start),
                page_table=torch.from_numpy(table),
                kv_lengths=torch.from_numpy(lengths))
            out.append((np.asarray(jl), tl.numpy()))
            n += tokens.shape[1]
    _set_impl(tm, "auto")
    return out


DECODE_CASES = [("topk", "einsum"), ("topk", "gather"), ("topk", "sorted"),
                ("expert_choice", "einsum")]


@pytest.mark.parametrize("layout", ["flat", "paged"])
@pytest.mark.parametrize("router,impl", DECODE_CASES)
def test_decode_logits_match_jax(request, router, impl, layout):
    """Prefill (left-padded, pads routed) and three single-token steps:
    every position's logits at 2e-5, flat cache and block pool."""
    pair = request.getfixturevalue("topk" if router == "topk" else "ec")
    runs = (_flat_runs if layout == "flat" else _paged_runs)(pair, impl, 3)
    for i, (want, got) in enumerate(runs):
        np.testing.assert_allclose(got, want, err_msg=f"application {i}",
                                   **OUT)


def test_router_bias_changes_the_routing(topk):
    """The N(0, 1) biases pick other experts than the raw gates would:
    with the port's buffers zeroed the prefill's logits move far past the
    tolerance (and the reference without `batch_stats` moves with it)."""
    jm, params, stats, tm = topk
    prompt, start, _ = _prompt(3)
    biases = [m.router_bias.clone() for m in moe_layers(tm)]
    assert all(b.abs().min() > 0 for b in biases)
    runs = {}
    for zeroed in (False, True):
        if zeroed:
            for m in moe_layers(tm):
                m.router_bias.zero_()
        _, tl = decode_apply(tm, tm.init_cache(B, S),
                             torch.from_numpy(prompt).long(),
                             attn_start=torch.from_numpy(start))
        runs[zeroed] = tl.numpy()
    for m, b in zip(moe_layers(tm), biases):
        m.router_bias.copy_(b)
    _, jl = jax.jit(lambda c, t: jax_decode_apply(
        jm, params, c, t, attn_start=jnp.asarray(start)))(
        jax_make_cache(jm, B, S), jnp.asarray(prompt, jnp.int32))
    assert np.abs(runs[True] - runs[False]).max() > 1e-2
    np.testing.assert_allclose(runs[True], np.asarray(jl), **OUT)


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
def test_greedy_generation_matches_jax(request, router):
    """Left-padded greedy generation, token for token against the
    reference's `make_generate_fn(batch_stats=...)`."""
    jm, params, stats, tm = request.getfixturevalue(
        "topk" if router == "topk" else "ec")
    prompts = [[5, 9, 2, 44, 17, 3, 8], [60, 1, 33], [7] * 5]
    tokens, lens = pad_left_prompts(prompts)
    got = make_generate_fn(tm, max_new_tokens=10, temperature=0.0)(
        tokens, prompt_lens=lens)
    gen = jax.jit(jax_generate_fn(jm, max_new_tokens=10, temperature=0.0,
                                  batch_stats=stats))
    want = gen(params, jnp.asarray(tokens.numpy(), jnp.int32),
               jax.random.PRNGKey(0), prompt_lens=jnp.asarray(lens.numpy()))
    assert got.tolist() == np.asarray(want).tolist()


def test_expert_choice_lm_generates():
    """The reference's tests/test_moe.py::test_expert_choice_lm_generates
    on the port (its widths: vocab 32, d 32, 4 heads of 8, mlp 64, 4
    experts, expert choice at cf 1.0): decode routes per token, the
    prompt is copied through, and greedy tokens equal the reference's."""
    cfg = dict(vocab_size=32, max_len=64, hidden_dim=32, depth=2,
               num_heads=4, mlp_dim=64, num_experts=4,
               moe_router="expert_choice", capacity_factor=1.0)
    jm = jax_create_model("lm_moe", policy=None, **cfg)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 16), jnp.int32))["params"])
    tm = create_model("lm_moe", device="cpu", **cfg)
    load_flax_params(tm, params)
    prompt = np.random.default_rng(0).integers(0, 32, (2, 8))
    out = make_generate_fn(tm, max_new_tokens=6, temperature=0.0)(
        torch.from_numpy(prompt))
    assert tuple(out.shape) == (2, 14)
    assert (out[:, :8].numpy() == prompt).all()
    want = jax.jit(jax_generate_fn(jm, max_new_tokens=6, temperature=0.0))(
        params, jnp.asarray(prompt, jnp.int32))
    assert out.tolist() == np.asarray(want).tolist()


# ------------------------------------------------------------- checkpoints
EXTRA = {"precision_policy": "fp32", "model": "lm_moe",
         "optimizer": "adamw", "momentum": 0.0, "clip_norm": 0.0,
         "weight_decay": 0.0, "accum_steps": 1, "seq_len": 48,
         "vocab_size": 256, "remat": False, "pos_emb": "rope",
         "tied_embeddings": False, "step": 0}


@pytest.fixture(scope="module")
def jax_moe_ckpt(tmp_path_factory):
    """(checkpoint dir, its router biases): the reference writes an lm_moe
    train state (registry widths, RoPE, AdamW) whose router biases are
    N(0, 1)."""
    jm = jax_create_model("lm_moe", vocab_size=256, max_len=48,
                          pos_emb="rope")
    tx = jax_optimizer(JaxConfig(optimizer="adamw"), 4)
    jstate = jax.jit(lambda r: jax_create_state(
        jm, tx, rng=r, sample_input=jnp.zeros((1, 8), jnp.int32)))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    stats = jax.tree.map(
        lambda v: jnp.asarray(rng.normal(0, 1.0, v.shape), jnp.float32),
        jstate.batch_stats)
    d = str(tmp_path_factory.mktemp("jax_moe") / "ck")
    jax_ckpt.save(d, jstate.replace(batch_stats=stats), extra=EXTRA)
    return d, [np.asarray(stats[f"block{i}"]["moe"]["router_bias"])
               for i in (1, 3)]


PROMPT = encode_bytes("hello moe")


def _greedy(model):
    return make_generate_fn(model, max_new_tokens=12, temperature=0.0)(
        torch.from_numpy(PROMPT).long())[0].tolist()


def test_jax_written_lm_moe_checkpoint_restores_its_router_biases(
        jax_moe_ckpt):
    """`load_lm` restores the reference's router biases into the
    `router_bias` buffers, fp32 under the bf16 streaming cast too."""
    d, want_bias = jax_moe_ckpt
    model, step = generate.load_lm(d, device="cpu")
    assert step == 0 and model.moe_every == 2
    np.testing.assert_array_equal(
        [m.router_bias.numpy() for m in moe_layers(model)], want_bias)
    bf16, _ = generate.load_lm(d, device="cpu", precision="bf16")
    assert bf16.blocks[1].moe.router.weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        [m.router_bias.numpy() for m in moe_layers(bf16)], want_bias)


def test_jax_written_lm_moe_checkpoint_generates_as_the_reference(
        jax_moe_ckpt):
    """Both packages generate the same greedy tokens from the reference's
    lm_moe checkpoint, each routing with its router biases."""
    d, _ = jax_moe_ckpt
    model, _ = generate.load_lm(d, device="cpu")
    jmodel, jparams, jstats, _ = jax_generate.load_lm(d)
    want = jax.jit(jax_generate_fn(jmodel, max_new_tokens=12,
                                   temperature=0.0, batch_stats=jstats))(
        jparams, jnp.asarray(PROMPT), jax.random.PRNGKey(0))
    assert _greedy(model) == np.asarray(want)[0].tolist()


def test_lm_moe_checkpoint_serves_and_round_trips_the_port_layout(
        jax_moe_ckpt, tmp_path):
    """`serve/bench.py --ckpt_dir` serves the reference's lm_moe
    checkpoint, and the port's own layout, written back from the restored
    state, restores the same router biases and generates the same."""
    d, want_bias = jax_moe_ckpt
    completions, _, _ = bench.serve_checkpoint(
        d, ["hello moe", "ab"], max_new_tokens=6, device="cpu")
    assert [c.status for c in completions] == ["length", "length"]
    model, _ = generate.load_lm(d, device="cpu")
    p = str(tmp_path / "port")
    state = TrainState(step=0, model=model, optimizer=make_optimizer(
        TrainConfig(optimizer="adamw", device="cpu"), model))
    ckpt.save(p, state, extra=EXTRA)
    again, _ = generate.load_lm(p, device="cpu")
    np.testing.assert_array_equal(
        [m.router_bias.numpy() for m in moe_layers(again)], want_bias)
    assert _greedy(again) == _greedy(model)


# ----------------------------------------------------------------- engines
def _replay(sched_cls, req_cls, engine, clock, trace):
    sched = sched_cls(engine, clock=clock, max_queue=64)
    for t in trace:
        sched.submit(req_cls(rid=t["rid"], prompt=t["prompt"],
                             max_new_tokens=t["max_new_tokens"]))
    return {c.rid: (c.status, list(c.tokens))
            for c in sched.run_until_idle()}


def _engines(pair, impl, trace, paged, **cfg):
    """The trace through the reference's engine and the port's: (jax
    engine, jax tokens, port engine, port tokens)."""
    jm, params, stats, tm = pair
    jcls, pcls = ((JaxPagedEngine, PagedEngine) if paged
                  else (JaxSlotEngine, SlotEngine))
    with jax_impl(impl):
        je = jcls(jm, params, JaxEngineConfig(**cfg), batch_stats=stats)
        want = _replay(JaxScheduler, JaxRequest, je, JaxFakeClock(), trace)
    _set_impl(tm, impl)
    try:
        pe = pcls(tm, EngineConfig(**cfg))
        got = _replay(Scheduler, Request, pe, FakeClock(), trace)
    finally:
        _set_impl(tm, "auto")
    return je, want, pe, got


def _trace(seed, n=5, plen=(2, 16), new=(2, 10)):
    return build_trace(n_requests=n, rate_hz=8.0, vocab=VOCAB,
                       prompt_len_range=plen, max_new_range=new, seed=seed)


def _generate_each(tm, impl, trace):
    """Each request alone through `generate` (greedy)."""
    _set_impl(tm, impl)
    try:
        out = {}
        for t in trace:
            gen = make_generate_fn(tm, max_new_tokens=t["max_new_tokens"],
                                   temperature=0.0)
            tokens = gen(torch.tensor([t["prompt"]]))[0].tolist()
            out[t["rid"]] = ("length", tokens[len(t["prompt"]):])
        return out
    finally:
        _set_impl(tm, "auto")


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_topk_engines_match_jax_engines(topk, paged):
    """Token choice with capacity on the einsum path: per rid the same
    tokens as the reference's engine on the same trace, at decode burst
    4."""
    cfg = dict(PAGED if paged else SLOT, decode_burst=4)
    *_, want, _, got = _engines(topk, "einsum", _trace(7), paged, **cfg)
    assert got == want
    assert all(status == "length" for status, _ in got.values())


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_sorted_engines_match_jax_engines_and_generate(dropless, paged):
    """The dropless sorted path: the reference's engine (its sorted path,
    the grouped matmul in interpret mode) gives the same tokens, and so
    does `generate`, one request at a time."""
    trace = _trace(8, n=4)
    # one bucket: each bucket is another interpret-mode program there
    cfg = dict(PAGED if paged else SLOT, prompt_buckets=(16,),
               decode_burst=2)
    *_, want, _, got = _engines(dropless, "sorted", trace, paged, **cfg)
    assert got == want
    assert got == _generate_each(dropless[3], "sorted", trace)


def test_expert_choice_slot_engine_matches_jax_and_generate(ec):
    """Expert choice decodes per token with capacity t, prefill included:
    nothing drops, so the engine's tokens equal `generate`'s as well as
    the reference engine's."""
    trace = _trace(9, n=4)
    *_, want, _, got = _engines(ec, "einsum", trace, False,
                                decode_burst=2, **SLOT)
    assert got == want
    assert got == _generate_each(ec[3], "einsum", trace)


def test_topk_chunked_prefill_matches_jax(topk):
    """Chunked prefill routes each 16-token chunk as its own group, so its
    drops may differ from a whole prefill's: the port reproduces the
    reference's engine whatever they are."""
    trace = _trace(5, n=4, plen=(20, 60), new=(2, 8))
    cfg = dict(PAGED, prompt_buckets=(16, 64), prefix_cache=True)
    je, want, pe, got = _engines(topk, "einsum", trace, True,
                                 prefill_chunk=16, **cfg)
    assert got == want


@pytest.mark.parametrize("pair_name,impl", [("topk", "einsum"),
                                            ("dropless", "sorted")])
def test_spec_decode_matches_jax(request, pair_name, impl):
    """Speculative decoding on lm_moe: the reference's engine's tokens and
    drafted/accepted counts. On the dropless sorted path a verify window
    routes each token as a single step would, so speculation also keeps
    the plain engine's tokens (token identity 1.0)."""
    pair = request.getfixturevalue(pair_name)
    trace = build_lookup_trace(n_requests=4, rate_hz=8.0, vocab=VOCAB,
                               motif_range=(2, 4), prompt_len_range=(6, 16),
                               max_new_range=(8, 12), seed=2)
    cfg = dict(PAGED, prompt_buckets=(16,))
    je, want, pe, got = _engines(pair, impl, trace, True, spec_decode=True,
                                 **cfg)
    assert got == want
    for attr in ("spec_drafted_tokens", "spec_accepted_tokens",
                 "spec_dispatches"):
        assert getattr(pe, attr) == getattr(je, attr), attr
    if impl == "sorted":
        _set_impl(pair[3], impl)
        try:
            plain = _replay(Scheduler, Request,
                            PagedEngine(pair[3], EngineConfig(**cfg)),
                            FakeClock(), trace)
        finally:
            _set_impl(pair[3], "auto")
        assert plain == got
