"""The port's fair share (serve/fairshare.py) and dispatch affinity
(serve/affinity.py) against the JAX package's, on the CPU.

Each case runs one scenario through both packages and holds the port's
observables to the reference's (and to the values tests/test_fairshare.py
and tests/test_affinity.py pin):

- the virtual token counter: weighted accrual, the floor lift of a late
  tenant, weights, the least/most-served queries and their tie-break,
  its snapshot; the scheduler's fair head pick over a queue;
- the tenant ledger: per-tenant cost metering, the prompt-token stamp
  fallback, shares with and without a counter, its registry counters;
  `jains_index` and `federate_tenant_reports`;
- affinity: prefix hashes equal the reference's integers (digests cross
  process boundaries, so they must not lean on Python's salted hash),
  rendezvous placement and its stickiness, the digest publisher's full,
  delta and resync frames over a radix cache, the view's apply rules,
  both dispatch policies, and `kv_summary`.
"""

import types

import pytest

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from ddp_practice_tpu.serve import affinity as jax_affinity
from ddp_practice_tpu.serve import fairshare as jax_fairshare
from ddp_practice_tpu.serve import health as jax_health
from ddp_practice_tpu.serve import kv_pages as jax_kv_pages
from ddp_practice_tpu.serve import scheduler as jax_scheduler
from ddp_practice_tpu.utils import metrics as jax_metrics
from ddp_practice_tpu_torch.serve import (
    affinity,
    fairshare,
    health,
    kv_pages,
    scheduler,
)
from ddp_practice_tpu_torch.utils import metrics

REF = types.SimpleNamespace(fs=jax_fairshare, aff=jax_affinity,
                            health=jax_health, kv=jax_kv_pages,
                            sched=jax_scheduler, metrics=jax_metrics)
PORT = types.SimpleNamespace(fs=fairshare, aff=affinity, health=health,
                             kv=kv_pages, sched=scheduler, metrics=metrics)
BS = 4


def both(scenario):
    return scenario(REF), scenario(PORT)


# ------------------------------------------------------------------- VTC
def _vtc_run(pkg):
    VTC = pkg.fs.VirtualTokenCounter
    out = []
    vtc = VTC(prefill_weight=0.5)
    out += [vtc.charge("a", decode=10), vtc.charge("a", prefill=8),
            vtc.service("a"), vtc.service("missing")]
    vtc2 = VTC()
    vtc2.charge(None, decode=3)
    out += [vtc2.service(None), vtc2.service("default")]
    late = VTC()                      # floor lift
    late.charge("bulk", decode=100)
    late.touch("late")
    out.append(late.service("late"))
    late.charge("late", decode=20)
    late.touch("later-still")
    late.touch("late")
    out += [late.service("later-still"), late.service("late")]
    w = VTC(weights={"paid": 2.0})    # weights
    w.touch("paid")
    w.touch("free")
    w.charge("paid", decode=100)
    w.charge("free", decode=100)
    out += [w.service("paid"), w.service("free"),
            w.least_served(["paid", "free"])]
    q = VTC()                         # queries and tie-break
    q.charge("a", decode=5)
    q.charge("b", decode=50)
    q.touch("c")
    out += [q.least_served(["a", "b", "c"]),
            q.most_over_served(["a", "b", "c"]), q.least_served([None]),
            q.snapshot(), q.jain()]
    for bad in (dict(weights={"bad": 0.0}), dict(prefill_weight=-0.1)):
        with pytest.raises(ValueError):
            VTC(**bad)
    return out


def test_vtc_accrual_floor_lift_and_tie_break():
    ref, port = both(_vtc_run)
    assert port == ref
    assert port[:4] == [10.0, 14.0, 14.0, 0.0]
    assert port[6] == 100.0 and port[8] == 120.0
    assert port[9:12] == [50.0, 100.0, "paid"]
    assert port[12:15] == ["a", "b", None]


class _IdleEngine:
    """No free slots: the scheduler only queues, so the head is
    observable."""

    class config:
        decode_burst = 1

    num_free = 0


def _fair_head_run(pkg):
    orders = []
    for charge in (None, {}, {"a": 100}, {"b": 7, "a": 3}):
        vtc = None if charge is None else pkg.fs.VirtualTokenCounter()
        sched = pkg.sched.Scheduler(_IdleEngine(),
                                    clock=pkg.sched.FakeClock(),
                                    max_queue=16, vtc=vtc)
        for rid, tenant in enumerate(["a", "b", "a", "b", None, "c"]):
            sched.submit(pkg.sched.Request(rid=rid, prompt=[1, 2],
                                           max_new_tokens=4, tenant=tenant))
        for tenant, n in (charge or {}).items():
            vtc.charge(tenant, decode=n)
        sched._rotate_fair_head()
        orders.append([r.rid for r in sched.queue])
        sched._rotate_fair_head()       # idempotent
        orders.append([r.rid for r in sched.queue])
    return orders


def test_scheduler_fair_head_pick_as_the_reference():
    ref, port = both(_fair_head_run)
    assert port == ref
    assert port[0] == [0, 1, 2, 3, 4, 5]            # no vtc: FIFO
    assert port[4][0] == 1                          # b starved by a's 100


# ---------------------------------------------------------------- ledger
class _C:
    def __init__(self, tenant=None, tokens=(1, 2), status="eos",
                 ttft=0.05, tpot=0.01, flight=None):
        self.tenant = tenant
        self.tokens = list(tokens)
        self.status = status
        self.ttft = ttft
        self.tpot = tpot
        self.flight = flight if flight is not None else {}


def _ledger_run(pkg):
    reg = pkg.metrics.MetricsRegistry()
    vtc = pkg.fs.VirtualTokenCounter()
    vtc.touch("a")
    vtc.touch("b")
    vtc.charge("a", decode=30)
    vtc.charge("b", decode=10)
    ledger = pkg.fs.TenantLedger(registry=reg, vtc=vtc)
    flight = {"queue_s": 0.1, "prefill_s": 0.2, "decode_s": 0.3,
              "stall_s": 0.0, "prefix_hit_tokens": 4}
    ledger.on_completion(_C(tenant="acme", tokens=[1, 2, 3],
                            flight=flight), prompt_tokens=10)
    ledger.on_completion(_C(tenant="acme", status="error", tokens=[],
                            ttft=None, tpot=None), prompt_tokens=5)
    ledger.on_completion(_C(tenant=None, tokens=[1]), prompt_tokens=2)
    ledger.on_completion(_C(tenant="t", flight={"prompt_tokens": 7}))
    ledger.on_completion(_C(tenant="t", flight={"prompt_tokens": 7}),
                         prompt_tokens=3)
    plain = pkg.fs.TenantLedger()
    plain.on_completion(_C(tenant="a", tokens=[1, 2, 3]))
    plain.on_completion(_C(tenant="b", tokens=[1]))
    fed = pkg.fs.federate_tenant_reports(
        [ledger.report(), plain.report(), "not-a-dict"])
    return (ledger.report(), plain.report(), reg.snapshot(),
            reg.render_text(), fed, pkg.fs.federate_tenant_reports([]),
            [pkg.fs.jains_index(v) for v in
             ([], [0, 0], [1, 1, 1], [3, 1], [30.0, 10.0], [1, 0, 0, 0])],
            pkg.fs.tenant_name(None))


def test_ledger_jain_and_federation_as_the_reference():
    ref, port = both(_ledger_run)
    for got, want in zip(port, ref):
        assert got == want
    rep, plain, snap = port[:3]
    acme = rep["tenants"]["acme"]
    assert acme["requests"] == {"eos": 1, "error": 1}
    assert acme["prompt_tokens"] == 15 and acme["output_tokens"] == 3
    assert rep["tenants"]["t"]["prompt_tokens"] == 10
    assert rep["share"]["a"] == pytest.approx(0.75)
    assert plain["service"] == {"a": 3.0, "b": 1.0}
    assert snap["tenant_output_tokens_total{tenant=acme}"] == 3
    assert port[6][:3] == [1.0, 1.0, 1.0] and port[6][5] == 0.25
    assert port[7] == "default"


# -------------------------------------------------------------- affinity
def test_prefix_hashes_and_rendezvous_equal_the_references():
    prompts = [list(range(1, 13)), list(range(64)), [5] * 40,
               list(range(400)), [1, 2], list(range(1, 13)) + [99]]
    for p in prompts:
        for bs in (0, 1, 4, 16):
            got = affinity.prompt_prefix_hashes(p, bs)
            assert got == jax_affinity.prompt_prefix_hashes(p, bs)
            assert all(isinstance(h, int) for h in got)
        assert affinity.prompt_prefix_hashes(p, 1, max_depth=5) == \
            jax_affinity.prompt_prefix_hashes(p, 1, max_depth=5)
    # fixed integers: the hash is FNV-1a, the same in every process
    assert affinity.hash_extend(0, []) == 0
    assert affinity.hash_extend(0xABCDEF, (1, 2, 3)) == \
        jax_affinity.hash_extend(0xABCDEF, (1, 2, 3))
    hs = affinity.prompt_prefix_hashes(list(range(1, 13)), BS)
    assert affinity.hash_extend(hs[0], list(range(5, 9))) == hs[1]
    families = [affinity.hash_extend(0xABCDEF, (f,)) for f in range(200)]
    for ids in ([0, 1, 2], [0, 1, 2, 3], [0, 2], [7], []):
        got = [affinity.rendezvous_pick(f, ids) for f in families]
        assert got == [jax_affinity.rendezvous_pick(f, ids)
                       for f in families]
    before = {f: affinity.rendezvous_pick(f, [0, 1, 2]) for f in families}
    grown = {f: affinity.rendezvous_pick(f, [0, 1, 2, 3]) for f in families}
    moved = [f for f in families if grown[f] != before[f]]
    assert moved and all(grown[f] == 3 for f in moved)
    assert (affinity.DIGEST_MAX_DEPTH, affinity.DIGEST_MAX_ENTRIES,
            affinity.DIGEST_FULL_EVERY) == (
        jax_affinity.DIGEST_MAX_DEPTH, jax_affinity.DIGEST_MAX_ENTRIES,
        jax_affinity.DIGEST_FULL_EVERY)


def _strip_epoch(frame):
    return {k: v for k, v in frame.items() if k != "epoch"}


def _publisher_run(pkg):
    alloc = pkg.kv.BlockAllocator(32)
    radix = pkg.kv.RadixPrefixCache(alloc, BS)

    def insert(tokens):
        blocks = alloc.alloc(len(tokens) // BS)
        radix.insert(tokens, blocks)
        alloc.free(blocks)

    insert(list(range(8)))
    pub = pkg.aff.DigestPublisher(radix, full_every=3)
    frames = [pub.frame()]
    insert([70 + i for i in range(8)])
    frames += [pub.frame(), pub.frame(), pub.frame()]
    radix.evict(2)
    frames.append(pub.frame())
    insert([40 + i for i in range(8)])
    shallow = pkg.aff.DigestPublisher(radix, max_depth=1).frame()
    radix.match([40 + i for i in range(8)])
    tight = pkg.aff.DigestPublisher(radix, max_entries=1).frame()
    eng = types.SimpleNamespace(blocks=alloc, radix=radix)
    summary = pkg.aff.kv_summary(eng, pkg.aff.DigestPublisher(radix))
    summary["digest"] = _strip_epoch(summary["digest"])
    bare = pkg.aff.kv_summary(types.SimpleNamespace(blocks=None,
                                                    radix=None))
    epochs = {pub.epoch, pkg.aff.DigestPublisher(radix).epoch}
    return ([_strip_epoch(f) for f in frames + [shallow, tight]],
            summary, bare, len(epochs))


def test_digest_publisher_and_kv_summary_as_the_reference():
    ref, port = both(_publisher_run)
    assert port == ref
    frames = port[0]
    assert frames[0]["v"] == 1 and "full" in frames[0]
    assert frames[1]["base"] == 1 and frames[1]["dels"] == []
    assert "full" in frames[3]                      # the resync beat
    assert frames[4]["dels"]                        # eviction shows
    assert port[2]["blocks_total"] == 0 and "digest" not in port[2]
    assert port[3] == 2                             # a fresh epoch each


def _full(hashes, v=1, epoch="e1"):
    return {"v": v, "epoch": epoch, "bs": BS, "n": len(hashes),
            "full": sorted(hashes)}


def _delta(v, adds=(), dels=(), epoch="e1"):
    return {"v": v, "epoch": epoch, "bs": BS, "n": 0, "base": v - 1,
            "adds": sorted(adds), "dels": sorted(dels)}


def _view_run(pkg):
    view = pkg.aff.DigestView()
    out = [view.usable(0.0, 10.0)]
    steps = [(_full([10, 20]), 0.0), (_delta(2, adds=[30], dels=[10]), 1.0),
             (_delta(2, adds=[30], dels=[10]), 8.0),
             (_delta(4, adds=[40]), 9.0), (_full([40, 50], v=4), 9.5),
             (_delta(5, adds=[60], epoch="e2"), 10.0),
             (_full([60], v=5, epoch="e2"), 10.5), (None, 11.0)]
    for frame, now in steps:
        view.apply(frame, now=now)
        out.append((sorted(view.hashes), view.version, view.stale,
                    view.updated_at, view.usable(now, 10.0),
                    view.usable(now + 10.1, 10.0)))
    prompt = list(range(16))
    hs = pkg.aff.prompt_prefix_hashes(prompt, BS)
    gap = pkg.aff.DigestView()
    gap.apply(_full([hs[0], hs[1], hs[3]]), now=0.0)
    out += [gap.expected_hit_tokens(hs),
            gap.expected_hit_tokens(pkg.aff.prompt_prefix_hashes([99] * 16,
                                                                 BS))]
    return out


def test_digest_view_apply_rules_as_the_reference():
    ref, port = both(_view_run)
    assert port == ref
    assert port[0] is False and port[-2] == 2 * BS and port[-1] == 0


def _policy_run(pkg):
    HS = pkg.health.HealthState

    def cand(hid, load=0.0, state=HS.HEALTHY, kv=None):
        return types.SimpleNamespace(
            id=hid, load=load, health=types.SimpleNamespace(state=state),
            kv_summary=kv)

    def kv(hashes, **kw):
        return {"block_size": BS, "digest": _full(hashes, **kw)}

    def show(result):
        ordered, decisions, exp = result
        return [h.id for h in ordered], decisions, exp

    prompt = list(range(16))
    hs = pkg.aff.prompt_prefix_hashes(prompt, BS)
    out = []
    cands = [cand(0, load=2.0), cand(2, load=1.0),
             cand(1, load=1.0, state=HS.DEGRADED)]
    out.append(show(pkg.aff.AffinityPolicy().order(cands, prompt, 0.0)))
    out.append(show(pkg.aff.LeastLoadedPolicy().order(cands, prompt, 0.0)))
    out.append([pkg.aff.least_loaded_key(c) for c in cands])
    for load in (1.0, 4.0, 5.0):          # warm vs cold, the imbalance cap
        warm = cand(1, load=load, kv=kv(hs, epoch="w1"))
        cold = cand(0, load=0.0, kv=kv([777], epoch="w0"))
        out.append(show(pkg.aff.AffinityPolicy().order([cold, warm],
                                                       prompt, 0.0)))
    home = pkg.aff.rendezvous_pick(hs[0], [0, 1])
    first = [cand(i, load=float(i == home), kv=kv([777 + i]))
             for i in (0, 1)]
    out.append(show(pkg.aff.AffinityPolicy().order(first, prompt, 0.0)))
    out.append(show(pkg.aff.AffinityPolicy().order(first, [1, 2], 0.0)))
    pol = pkg.aff.AffinityPolicy(max_age_s=10.0)   # stale and decayed
    a = cand(0, kv=kv(hs, epoch="a"))
    b = cand(1, kv=kv([777], epoch="b"))
    out.append(show(pol.order([a, b], prompt, 0.0)))
    a.kv_summary = {"block_size": BS,
                    "digest": _delta(5, adds=[42], epoch="a")}
    b.kv_summary = None
    out.append(show(pol.order([a, b], prompt, 1.0)))
    a.kv_summary = kv(hs, v=5, epoch="a")
    out.append(show(pol.order([a, b], prompt, 2.0)))
    a.kv_summary = None
    out.append(show(pol.order([a, b], prompt, 13.0)))
    pol.forget(0)
    out.append(sorted(pol.views))
    return out


def test_dispatch_policies_order_as_the_reference():
    ref, port = both(_policy_run)
    assert port == ref
    assert port[0][0] == port[1][0] == [2, 0, 1]          # fallback = LL
    assert set(port[0][1].values()) == {"fallback"}
    assert port[3][0] == [1, 0] and port[5][0] == [0, 1]  # cap at 4
    assert port[9][1][0] == "fallback"                    # stale: a miss
    assert 0 not in port[-1]
