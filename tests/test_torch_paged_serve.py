"""The port's paged serving engine (ddp_practice_tpu_torch/serve/engine.py
`PagedEngine`) against the JAX package's, from one set of converted
weights (head_dim 64, depth 2), greedy, on the fake clock.

Per rid the tokens are identical to the JAX engine's for: the plain paged
engine at decode_burst 1 and 4; the prefix cache on a shared-prefix trace
(with the same hit/miss counters); an undersized pool that preempts (with
the same preemption count); fork with a copy-on-write split; chunked
prefill (also against whole prefill); speculative decoding (also against
plain paged, with the same drafted/accepted counts); and an int8 pool.
`compile_stats` (here: distinct shapes per path, there: jit cache sizes)
agree as well, but for the CoW count (see `_same_compile_stats`).

On the CPU the JAX engine's single-token steps take its gather reference
(`paged_decode_attention` routes there off the TPU), the port's the plain
version of kernels C and D. In fp32 the two differ by summation order
only (2e-5 in tests/test_torch_paged_attention.py), far below the logit
gaps greedy decoding turns into tokens here, so tokens are held to
identity; the int8 pool too, where the port folds the scales into the
score and probability rows and the JAX reference dequantizes first.

Inside the port: paged greedy equals slot greedy on one trace, and the
reference's pins of block reuse (a freed block's old contents never
reach its next occupant) and of the garbage block (a retired slot's
writes never touch shared prefix pages) hold.
"""

import numpy as np
import pytest

from _torch_port import build_pair
from ddp_practice_tpu.serve import EngineConfig as JaxEngineConfig
from ddp_practice_tpu.serve import PagedEngine as JaxPagedEngine
from ddp_practice_tpu.serve.scheduler import FakeClock as JaxFakeClock
from ddp_practice_tpu.serve.scheduler import Request as JaxRequest
from ddp_practice_tpu.serve.scheduler import Scheduler as JaxScheduler
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.serve import (
    EngineConfig,
    FakeClock,
    PagedEngine,
    Request,
    Scheduler,
    SlotEngine,
)
from ddp_practice_tpu_torch.serve.bench import (
    build_lookup_trace,
    build_shared_prefix_trace,
    build_trace,
)
from ddp_practice_tpu_torch.serve.kv_pages import GARBAGE_BLOCK

VOCAB = 64
PAGED = dict(max_slots=3, max_len=128, prompt_buckets=(16, 32),
             block_size=16)


@pytest.fixture(scope="module")
def pair():
    return build_pair(0, max_len=128, pos_emb="rope")


def _replay(sched_cls, req_cls, engine, clock, trace):
    sched = sched_cls(engine, clock=clock, max_queue=64)
    for t in trace:
        sched.submit(req_cls(rid=t["rid"], prompt=t["prompt"],
                             max_new_tokens=t["max_new_tokens"]))
    return {c.rid: (c.status, list(c.tokens))
            for c in sched.run_until_idle()}


def _both(pair, trace, **cfg):
    """The trace through the JAX and the port's paged engine:
    (jax engine, jax tokens, port engine, port tokens)."""
    jm, params, tm = pair
    je = JaxPagedEngine(jm, params, JaxEngineConfig(**cfg))
    want = _replay(JaxScheduler, JaxRequest, je, JaxFakeClock(), trace)
    pe = PagedEngine(tm, EngineConfig(**cfg))
    got = _replay(Scheduler, Request, pe, FakeClock(), trace)
    return je, want, pe, got


def _same_compile_stats(port, ref):
    """compile_stats agree, but for the CoW copy: the JAX engine jits the
    module-level `copy_block`, whose cache counts every engine of the
    process, so its count depends on which tests ran before."""
    got, want = port.compile_stats(), ref.compile_stats()
    got.pop("cow_compiles")
    want.pop("cow_compiles")
    return got == want


def _trace(seed, n=5, plen=(2, 30), new=(2, 12)):
    return build_trace(n_requests=n, rate_hz=8.0, vocab=VOCAB,
                       prompt_len_range=plen, max_new_range=new, seed=seed)


@pytest.mark.parametrize("burst", [1, 4])
def test_paged_trace_matches_jax_and_slot_engine(pair, burst):
    trace = _trace(burst)
    je, want, pe, got = _both(pair, trace, decode_burst=burst, **PAGED)
    assert got == want
    assert all(status == "length" for status, _ in got.values())
    assert _same_compile_stats(pe, je)
    assert pe.blocks.num_used == 0 and pe.num_active == 0
    # paged greedy == slot greedy on the same schedule
    slot = SlotEngine(pair[2], EngineConfig(
        decode_burst=burst, max_slots=3, max_len=128,
        prompt_buckets=(16, 32)))
    assert _replay(Scheduler, Request, slot, FakeClock(), trace) == got


def test_prefix_cache_matches_jax_counters(pair):
    trace = build_shared_prefix_trace(
        n_requests=6, rate_hz=8.0, vocab=VOCAB, k_prefixes=2,
        prefix_len=32, tail_range=(1, 8), max_new_range=(4, 8), seed=3)
    cfg = dict(PAGED, prompt_buckets=(16, 48), decode_burst=2,
               prefix_cache=True)
    je, want, pe, got = _both(pair, trace, **cfg)
    assert got == want
    assert pe.radix.hit_tokens > 0
    for attr in ("hit_tokens", "miss_tokens", "edit_seq"):
        assert getattr(pe.radix, attr) == getattr(je.radix, attr), attr
    assert len(pe.radix) == len(je.radix)
    assert pe.preemptions == je.preemptions
    assert _same_compile_stats(pe, je)


def test_preemption_matches_jax_and_an_uncontended_pool(pair):
    """6 real blocks < 3 requests x 3 blocks: the youngest slot is
    preempted and re-prefilled, and the tokens equal a full pool's."""
    trace = [{"rid": rid, "arrival": 0.0, "prompt": [1 + rid],
              "max_new_tokens": 16} for rid in range(3)]
    cfg = dict(max_slots=4, max_len=128, prompt_buckets=(8,), block_size=8,
               max_blocks_per_slot=3)
    je, want, pe, got = _both(pair, trace, num_blocks=7, **cfg)
    assert got == want
    assert pe.preemptions == je.preemptions > 0
    assert all(s == "length" and len(t) == 16 for s, t in got.values())
    assert pe.blocks.num_used == 0
    full = PagedEngine(pair[2], EngineConfig(**cfg))
    assert _replay(Scheduler, Request, full, FakeClock(), trace) == got
    assert full.preemptions == 0
    assert pe.admit_gate(3, 100) == "never"


def _fork_run(engine, steps):
    """Admit, decode, fork (the siblings share every block), decode on
    (the first burst splits the shared tail block), release the parent,
    decode the child alone. Token rows per step for (parent, child)."""
    prompt = [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5, 9, 0, 4, 5, 2, 3]
    sa = engine.admit(prompt, max_positions=24)
    rows = [int(engine.step()[sa]) for _ in range(3)]
    child = engine.fork(sa, seed=0)
    shared = engine.blocks.num_shared
    for _ in range(steps):
        toks = engine.step()
        rows.append((int(toks[sa]), int(toks[child])))
    engine.release(sa)
    rows += [int(engine.step()[child]) for _ in range(steps)]
    engine.release(child)
    return rows, shared


def test_fork_copy_on_write_matches_jax(pair):
    jm, params, tm = pair
    cfg = dict(max_slots=3, max_len=128, prompt_buckets=(32,),
               block_size=16, max_blocks_per_slot=4, prefix_cache=True)
    je = JaxPagedEngine(jm, params, JaxEngineConfig(**cfg))
    pe = PagedEngine(tm, EngineConfig(**cfg))
    want, jshared = _fork_run(je, 4)
    got, pshared = _fork_run(pe, 4)
    assert got == want and pshared == jshared >= 1
    assert pe.compile_stats()["cow_compiles"] == 1
    assert _same_compile_stats(pe, je)
    assert pe.blocks.num_shared == 0
    # siblings fork off the same context: greedy keeps them equal
    assert all(a == b for a, b in got[3:7])
    pe.radix.clear()
    assert pe.blocks.num_used == 0          # no leaked references


def test_chunked_prefill_matches_whole_prefill_and_jax(pair):
    trace = _trace(5, n=4, plen=(20, 60), new=(2, 8))
    cfg = dict(PAGED, prompt_buckets=(16, 64), prefix_cache=True)
    je, want, pe, got = _both(pair, trace, prefill_chunk=16, **cfg)
    assert got == want
    assert _same_compile_stats(pe, je)
    whole = PagedEngine(pair[2], EngineConfig(**cfg))
    assert _replay(Scheduler, Request, whole, FakeClock(), trace) == got


def test_spec_decode_matches_plain_and_jax_counts(pair):
    trace = build_lookup_trace(n_requests=5, rate_hz=8.0, vocab=VOCAB,
                               motif_range=(2, 4), prompt_len_range=(6, 16),
                               max_new_range=(8, 16), seed=2)
    cfg = dict(PAGED, prompt_buckets=(16,))
    je, want, pe, got = _both(pair, trace, spec_decode=True, **cfg)
    assert got == want
    for attr in ("spec_drafted_tokens", "spec_accepted_tokens",
                 "spec_dispatches"):
        assert getattr(pe, attr) == getattr(je, attr), attr
    assert pe.spec_accepted_tokens > 0
    plain = PagedEngine(pair[2], EngineConfig(**cfg))
    assert _replay(Scheduler, Request, plain, FakeClock(), trace) == got
    assert _same_compile_stats(pe, je)


def test_int8_pool_matches_jax(pair):
    int8_pair = build_pair(0, max_len=128, pos_emb="rope",
                           kv_cache_dtype="int8")
    trace = build_shared_prefix_trace(
        n_requests=5, rate_hz=8.0, vocab=VOCAB, k_prefixes=2,
        prefix_len=32, tail_range=(1, 8), max_new_range=(4, 8), seed=4)
    cfg = dict(PAGED, prompt_buckets=(16, 48), decode_burst=2,
               prefix_cache=True)
    je, want, pe, got = _both(int8_pair, trace, **cfg)
    assert got == want
    assert pe.radix.hit_tokens == je.radix.hit_tokens > 0
    assert pe._cache["block0"]["attn"]["cached_key_scale"].shape == (
        pe.blocks.num_blocks, 2, 16)


def _pins_engine(tm, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("prompt_buckets", (16,))
    kw.setdefault("block_size", 16)
    kw.setdefault("max_blocks_per_slot", 3)
    return PagedEngine(tm, EngineConfig(max_len=128, **kw))


def test_freed_block_contents_never_visible_to_new_occupant(pair):
    """Two real blocks in the pool: B can only run inside A's released
    pages, and it decodes exactly its solo tokens."""
    tm = pair[2]
    eng = _pins_engine(tm, max_slots=1, max_blocks_per_slot=2, num_blocks=3)
    pa, pb = [3, 1, 4, 1, 5], [2, 7, 1]
    sa = eng.admit(pa, max_positions=16)
    for _ in range(16):
        eng.step()
    blocks_a = {int(b) for b in eng._pt[sa, :int(eng._nblk[sa])]}
    eng.release(sa)
    sb = eng.admit(pb, max_positions=16)
    got = [int(eng.step()[sb]) for _ in range(16)]
    blocks_b = {int(b) for b in eng._pt[sb, :int(eng._nblk[sb])]}
    solo = _pins_engine(tm, max_slots=1, max_blocks_per_slot=2,
                        num_blocks=3)
    ss = solo.admit(pb, max_positions=16)
    assert got == [int(solo.step()[ss]) for _ in range(16)]
    assert blocks_b == blocks_a


def test_retired_slot_garbage_writes_never_touch_shared_blocks(pair):
    """A retired slot's table row points at block 0 and keeps writing
    there every step; a later hit on the cached prefix sees the original
    occupant's next-token logits."""
    eng = _pins_engine(pair[2], prompt_buckets=(16, 32), prefix_cache=True)
    prompt = [4, 2] * 8 + [6]                     # one full block + 1
    sa = eng.admit(prompt, max_positions=16)
    first = eng._last_logits[sa].clone()
    eng.admit([9, 9, 9], max_positions=16)        # keeps the batch busy
    for _ in range(4):
        eng.step()
    eng.release(sa)
    assert all(int(b) == GARBAGE_BLOCK for b in eng._pt[sa])
    for node in eng.radix._iter_nodes():
        assert node.block != GARBAGE_BLOCK
    for _ in range(4):
        eng.step()
    hit0 = eng.radix.hit_tokens
    sc = eng.admit(prompt, max_positions=16)
    assert eng.radix.hit_tokens == hit0 + 16
    np.testing.assert_allclose(eng._last_logits[sc].numpy(), first.numpy(),
                               atol=1e-5, rtol=1e-5)


def test_paged_engine_refusals(pair):
    flat = create_model("lm_tiny", device="cpu", vocab_size=VOCAB,
                        max_len=64, hidden_dim=128, depth=1, num_heads=2,
                        mlp_dim=256)
    with pytest.raises(ValueError, match="rope"):
        PagedEngine(flat, EngineConfig())
    with pytest.raises(ValueError, match="temperature"):
        PagedEngine(pair[2], EngineConfig(spec_decode=True,
                                          temperature=0.5, **PAGED))
    with pytest.raises(ValueError, match="prefix_cache"):
        PagedEngine(pair[2], EngineConfig(prefill_chunk=8, **PAGED))
    eng = _pins_engine(pair[2])
    s = eng.admit([1, 2, 3], max_positions=16)
    for _ in range(16):
        eng.step()
    free = eng.blocks.num_free
    with pytest.raises(RuntimeError, match="budget"):
        eng.step()                     # past the admit-time budget
    assert eng.blocks.num_free == free
    eng.release(s)


@pytest.mark.parametrize("bench", ["paged_row", "shared_prefix",
                                   "shared_prefix_int8", "spec"])
def test_benches_serve_every_request(bench):
    """The paged benches at lm_tiny width on the CPU: every request of
    every row completes. The shared-prefix trace's 32 simultaneous
    requests evict parts of the two prefix chains, so some admissions
    match a partial prefix and prefill a 128-wide suffix bucket at its
    offset; the per-slot capacity covers that."""
    from ddp_practice_tpu_torch.serve import bench as sb

    small = dict(device="cpu", heads=2, seed=0)
    if bench == "paged_row":
        report = sb.serve_bench(n_requests=6, rate_hz=100.0, paged=True,
                                max_new_range=(2, 16), **small)
        rows = [report["continuous"], report["paged"]]
    elif bench == "spec":
        report = sb.spec_decode_bench(n_requests=8, rate_hz=100.0, **small)
        rows = [report["paged"], report["paged_spec"]]
        assert report["token_identity"] == 1.0
    else:
        int8 = bench == "shared_prefix_int8"
        report = sb.shared_prefix_bench(n_requests=32, kv_int8=int8,
                                        **small)
        rows = [report["paged"], report["paged_prefix"]]
        assert report["paged_prefix"]["prefix_cache"]["hit_tokens"] > 0
        # the two arms differ in the prefix cache alone: one capacity
        cap = report["pool"]["max_blocks_per_slot"] * 16
        assert [r["max_servable_context"] for r in rows] == [cap, cap]
        if int8:
            # 2 layers x (2 x 128 int8 + 2 x 2 heads x 4-byte scales)
            assert rows[1]["kv_bytes_per_token"] == 2 * (256 + 16)
            assert report["kv_bytes_per_token_f32"] == 2 * 2 * 128 * 4
    for r in rows:
        assert r["statuses"] == {"length": r["completions"]}
        assert not any(r["kernel_launches"].values())   # CPU: plain only
