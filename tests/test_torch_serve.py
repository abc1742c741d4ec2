"""The port's serving path (ddp_practice_tpu_torch/serve) against the JAX
package's, from one set of converted weights.

- One seeded `build_trace` through the JAX Scheduler + SlotEngine and the
  port's, on the fake clock: greedy tokens identical per rid, at
  decode_burst 1 and 4. The JAX side's token steps run its Pallas decode
  kernel in interpret mode (head_dim 64, packable).
- The port's one-shot generator is token-identical to the port's engine.
- The slot-reuse, epoch-rewind and bucket-overflow behaviours of
  tests/test_serve_engine.py, replayed on the port.
- Sampling cannot match bit for bit (threefry is not Philox), so it is
  held by support: top_k=1 equals greedy, and every sampled token lies in
  the set the JAX k-then-p filter keeps.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import build_pair
from ddp_practice_tpu.inference import decode_bytes as jax_decode_bytes
from ddp_practice_tpu.inference import encode_bytes as jax_encode_bytes
from ddp_practice_tpu.inference import sample_logits as jax_sample_logits
from ddp_practice_tpu.serve import EngineConfig as JaxEngineConfig
from ddp_practice_tpu.serve import SlotEngine as JaxSlotEngine
from ddp_practice_tpu.serve.scheduler import FakeClock as JaxFakeClock
from ddp_practice_tpu.serve.scheduler import Request as JaxRequest
from ddp_practice_tpu.serve.scheduler import Scheduler as JaxScheduler
from ddp_practice_tpu_torch.inference import (
    decode_bytes,
    encode_bytes,
    make_generate_fn,
    pad_left_prompts,
    sample_logits,
)
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.serve import (
    EngineConfig,
    FakeClock,
    Request,
    Scheduler,
    SlotEngine,
)
from ddp_practice_tpu_torch.serve.bench import build_trace
from ddp_practice_tpu_torch.serve.kv_slots import SlotAllocator, read_cursor

VOCAB = 64
ENGINE = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16))


@pytest.fixture(scope="module")
def pair():
    return build_pair(0, max_len=64, pos_emb="rope")


def _replay(sched_cls, req_cls, engine, clock, trace):
    sched = sched_cls(engine, clock=clock, max_queue=64)
    for t in trace:
        sched.submit(req_cls(rid=t["rid"], prompt=t["prompt"],
                             max_new_tokens=t["max_new_tokens"]))
    return {c.rid: (c.status, list(c.tokens))
            for c in sched.run_until_idle()}


@pytest.mark.parametrize("burst", [1, 4])
def test_trace_greedy_tokens_match_jax(pair, burst):
    jm, params, tm = pair
    trace = build_trace(n_requests=6, rate_hz=8.0, vocab=VOCAB,
                        prompt_len_range=(2, 16), max_new_range=(2, 12),
                        seed=burst)
    want = _replay(
        JaxScheduler, JaxRequest,
        JaxSlotEngine(jm, params, JaxEngineConfig(decode_burst=burst,
                                                  **ENGINE)),
        JaxFakeClock(), trace)
    eng = SlotEngine(tm, EngineConfig(decode_burst=burst, **ENGINE))
    got = _replay(Scheduler, Request, eng, FakeClock(), trace)
    assert got == want
    assert all(status == "length" for status, _ in got.values())
    assert eng.compile_stats() == {"prefill_compiles": 2,
                                   "decode_compiles": 1}


def _poisoned(sched_cls, req_cls, engine, clock):
    """Two requests; after the first token step, slot of rid 0 gets NaN
    logits. Returns {rid: (status, tokens)}."""
    sched = sched_cls(engine, clock=clock, max_queue=8)
    for rid, prompt in enumerate([[3, 1, 4], [2, 7, 1, 8]]):
        sched.submit(req_cls(rid=rid, prompt=prompt, max_new_tokens=5))
    sched.step()
    slot = next(s for s, st in sched.running.items() if st.req.rid == 0)
    engine.poison_slot(slot)
    return {c.rid: (c.status, list(c.tokens))
            for c in sched.run_until_idle()}


def test_poisoned_slot_fails_one_request_like_jax(pair):
    """Non-finite logits end only their own request, with status "error"
    and the tokens sampled before the fault; the batchmate completes."""
    jm, params, tm = pair
    cfg = dict(ENGINE, decode_burst=1)
    want = _poisoned(JaxScheduler, JaxRequest,
                     JaxSlotEngine(jm, params, JaxEngineConfig(**cfg)),
                     JaxFakeClock())
    eng = SlotEngine(tm, EngineConfig(**cfg))
    got = _poisoned(Scheduler, Request, eng, FakeClock())
    assert got == want
    assert got[0][0] == "error" and len(got[0][1]) == 1
    assert got[1][0] == "length" and len(got[1][1]) == 5
    assert eng.num_active == 0


def test_byte_codec_matches_jax():
    text = "héllo, wörld \u2603\n"
    got = encode_bytes(text)
    np.testing.assert_array_equal(got, jax_encode_bytes(text))
    assert got.dtype == np.int32 and got.shape == (1, len(text.encode()))
    assert decode_bytes(torch.from_numpy(got[0])) == text
    bad = [104, 0xC3, 105]            # a lone UTF-8 lead byte
    assert decode_bytes(bad) == jax_decode_bytes(bad) == "h\ufffdi"


def test_generate_fn_matches_engine(pair):
    """One-shot generation (single prompts and a left-padded batch) is
    token-identical to three requests sharing the engine."""
    _, _, tm = pair
    prompts = [[3, 1, 4, 1, 5], [2, 7], [9, 9, 8, 1, 2, 3, 6, 11, 4]]
    n = 6
    eng = SlotEngine(tm, EngineConfig(**ENGINE))
    slots = [eng.admit(p) for p in prompts]
    served = [[] for _ in prompts]
    for _ in range(n):
        toks = eng.step()
        for i, s in enumerate(slots):
            served[i].append(int(toks[s]))
    gen = make_generate_fn(tm, max_new_tokens=n, temperature=0.0)
    for p, want in zip(prompts, served):
        out = gen(torch.tensor([p]))
        assert out[0, len(p):].tolist() == want
    batch, lens = pad_left_prompts(prompts)
    out = gen(batch, None, lens)
    assert out[:, batch.shape[1]:].tolist() == served


def _engine(tm, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prompt_buckets", (8,))
    return SlotEngine(tm, EngineConfig(**kw))


def test_allocator_reuses_freed_slots():
    a = SlotAllocator(2)
    s0, s1 = a.alloc(), a.alloc()
    assert (s0, s1) == (0, 1) and a.alloc() is None
    a.free(s0)
    assert a.num_used == 1 and a.alloc() == 0
    with pytest.raises(ValueError):
        a.free(7)


def test_engine_requires_rope():
    tm = create_model("lm_tiny", device="cpu", vocab_size=VOCAB,
                      max_len=64, hidden_dim=128, depth=1, num_heads=2,
                      mlp_dim=256)
    with pytest.raises(ValueError, match="rope"):
        SlotEngine(tm, EngineConfig())


def test_slot_reuse_after_release(pair):
    """A released slot's successor generates as if alone: the admission
    overwrite hides the previous occupant's cache."""
    _, _, tm = pair
    eng = _engine(tm)
    s0 = eng.admit([3, 1, 4])
    eng.admit([2, 7])
    for _ in range(4):
        eng.step()
    eng.release(s0)
    s2 = eng.admit([5, 5, 1, 2])
    assert s2 == s0
    got = [int(eng.step()[s2]) for _ in range(5)]
    gen = make_generate_fn(tm, max_new_tokens=5, temperature=0.0)
    assert got == gen(torch.tensor([[5, 5, 1, 2]]))[0, 4:].tolist()


def test_admit_when_full_raises(pair):
    eng = _engine(pair[2])
    eng.admit([1]), eng.admit([2])
    with pytest.raises(RuntimeError, match="free slot"):
        eng.admit([3])


def test_bucket_selection_and_overflow(pair):
    eng = _engine(pair[2], prompt_buckets=(4, 8))
    assert eng.bucket_for(1) == 4 and eng.bucket_for(5) == 8
    with pytest.raises(ValueError, match="bucket"):
        eng.bucket_for(9)
    assert eng.fits_prompt(8) and not eng.fits_prompt(9)
    assert eng.admit_gate(9, 8) == "never"


def test_headroom_and_epoch_reset(pair):
    eng = _engine(pair[2], max_len=24, prompt_buckets=(8,))
    assert eng.cursor == 8 and eng.headroom == 16
    s = eng.admit([1, 2, 3])
    assert eng.num_active == 1
    eng.step()
    assert eng.headroom == 15 and read_cursor(eng._cache) == 9
    with pytest.raises(RuntimeError, match="active slots"):
        eng.reset_epoch()
    eng.release(s)
    eng.reset_epoch()
    assert eng.cursor == 8 and eng.headroom == 16
    assert read_cursor(eng._cache) == 8
    s2 = eng.admit([4, 4])
    assert 0 <= int(eng.step()[s2]) < VOCAB


def test_decode_burst_matches_single_steps(pair):
    single = _engine(pair[2])
    s = single.admit([3, 1, 4, 1, 5])
    want = [int(single.step()[s]) for _ in range(8)]
    burst = _engine(pair[2], decode_burst=4)
    sb = burst.admit([3, 1, 4, 1, 5])
    got = []
    for _ in range(2):
        got.extend(int(row[sb]) for row in burst.step_burst())
    assert got == want and burst.cursor == single.cursor
    with pytest.raises(RuntimeError, match="decode_burst"):
        burst.step()


def test_decode_shapes_stable_across_churn(pair):
    eng = _engine(pair[2], prompt_buckets=(4, 8))
    for i in range(6):
        s = eng.admit([1 + i] * (2 if i % 2 else 6))
        eng.step()
        eng.release(s)
    assert eng.compile_stats() == {"prefill_compiles": 2,
                                   "decode_compiles": 1}


def test_top_k_one_equals_greedy(pair):
    _, _, tm = pair
    prompts = [[3, 1, 4], [2, 7, 1, 8]]

    def run(**cfg):
        eng = SlotEngine(tm, EngineConfig(**{**ENGINE, **cfg}))
        slots = [eng.admit(p, seed=11 + i) for i, p in enumerate(prompts)]
        rows = [eng.step_burst()[0] for _ in range(6)]
        return [[int(r[s]) for r in rows] for s in slots]

    greedy = run()
    assert run(temperature=0.8, top_k=1) == greedy
    # per-slot sampling: one greedy-by-top_k request beside a sampled one
    eng = SlotEngine(tm, EngineConfig(per_slot_sampling=True, **ENGINE))
    s0 = eng.admit(prompts[0], seed=1, sampling=(0.8, 1, None))
    eng.admit(prompts[1], seed=2, sampling=(1.3, 0, 0.9))
    assert [int(eng.step()[s0]) for _ in range(6)] == greedy[0]


@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.7), (6, 0.6)])
def test_sampled_tokens_lie_in_jax_kept_set(top_k, top_p):
    rng = np.random.default_rng(top_k)
    logits = rng.normal(0.0, 2.0, size=(3, VOCAB)).astype(np.float32)
    captured = {}

    def capture(key, filtered, axis=-1):
        captured["logits"] = np.asarray(filtered)
        return jnp.zeros(filtered.shape[:-1], jnp.int32)

    with mock.patch.object(jax.random, "categorical", capture):
        jax_sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0),
                          temperature=0.7, top_k=top_k, top_p=top_p)
    kept = captured["logits"] > -1e29
    for seed in range(40):
        g = torch.Generator().manual_seed(seed)
        toks = sample_logits(torch.from_numpy(logits), g, temperature=0.7,
                             top_k=top_k, top_p=top_p)
        assert all(kept[i, int(t)] for i, t in enumerate(toks))
