"""The port's failure detection and restarts (train/elastic.py,
utils/backoff.py, the metrics registry of utils/metrics.py and the
loop's hooks) against the JAX package's, on the CPU:

- tests/test_elastic.py's eleven behaviours held against the port: the
  watchdog fires on a stall, waits out the first-beat grace, stays
  quiet while beaten, fires while a probe hangs and beats when it
  resolves; the sync check is a no-op on one rank; the restart driver
  retries with resume, waits the deterministic backoff schedule and
  counts `train_restarts_total`, restarts at once without a delay and
  re-raises when exhausted; an injected failure after epoch 0's save is
  recovered in-process (two attempts, 8 steps), and the resumed run's
  parameters equal an uninterrupted run's bit for bit (the reference
  runs this fit in a subprocess for an XLA-CPU crash torch does not
  have);
- `backoff_delay` equals the reference's exactly over a grid, and the
  registry's snapshot and text exposition equal the reference's for
  the same counters, gauges, labelled metrics and histograms (with
  exemplars);
- `assert_in_sync` over two ranks as threads: equal fingerprints pass,
  differing ones raise the reference's message on every rank;
- the loop: the resident group capped at the probe interval with a
  watchdog (tests/test_resident.py), the probe waiting on the oldest
  unconfirmed rung, `--watchdog`, `--sync_check` and `--max_restarts`
  through the CLI, and a driver whose ranks drift caught by the sync
  check.
"""

import json
import time

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from _torch_port import ranks
from ddp_practice_tpu.utils import backoff as jax_backoff
from ddp_practice_tpu.utils import metrics as jax_metrics
from ddp_practice_tpu_torch import cli
from ddp_practice_tpu_torch.config import MeshConfig, TrainConfig
from ddp_practice_tpu_torch.train import loop
from ddp_practice_tpu_torch.train.elastic import (
    Rung,
    StepWatchdog,
    assert_in_sync,
    run_with_restarts,
)
from ddp_practice_tpu_torch.utils import backoff, metrics


# ------------------------------------------------ tests/test_elastic.py
def test_watchdog_fires_on_stall():
    fired = []
    wd = StepWatchdog(0.2, on_timeout=lambda s: fired.append(s)).start()
    wd.beat()  # steady state reached; grace window over
    time.sleep(0.6)
    wd.stop()
    assert fired and fired[0] >= 0.2


def test_watchdog_grace_before_first_beat():
    """The first window (kernel builds, graph captures) gets timeout x
    first_beat_grace."""
    fired = []
    wd = StepWatchdog(
        0.1, on_timeout=lambda s: fired.append(s), first_beat_grace=10
    ).start()
    time.sleep(0.5)  # > timeout, < timeout * grace
    wd.stop()
    assert not fired


def test_watchdog_quiet_with_beats():
    fired = []
    wd = StepWatchdog(0.4, on_timeout=lambda s: fired.append(s)).start()
    for _ in range(6):
        time.sleep(0.1)
        wd.beat()
    wd.stop()
    assert not fired


def test_watchdog_probe_detects_hung_device():
    """probe() beats only after the value resolves: a fetch that never
    returns ends the beats, and the watchdog fires while the host could
    keep dispatching."""
    fired = []
    wd = StepWatchdog(0.2, on_timeout=lambda s: fired.append(s)).start()
    wd.beat()

    def hung_fetch(_):
        time.sleep(1.0)  # a collective that never completes

    wd.probe(object(), fetch=hung_fetch)  # blocks; no beat until done
    wd.stop()
    assert fired, "watchdog did not fire while the probe was hung"


def test_watchdog_probe_beats_on_resolution():
    """Instant resolutions (a host value, a CPU tensor, a CPU rung) beat
    the watchdog through the default fetch too."""
    fired = []
    wd = StepWatchdog(0.3, on_timeout=lambda s: fired.append(s)).start()
    values = [np.float32(1.0), torch.ones(()), Rung(torch.device("cpu"))]
    for i in range(4):
        time.sleep(0.1)
        wd.probe(values[i % 3] if i else np.float32(1.0),
                 fetch=(lambda v: v) if i == 0 else None)
    wd.stop()
    assert not fired


def test_assert_in_sync_single_process_noop():
    assert_in_sync(12345)  # 1 process: trivially in sync


def test_run_with_restarts_retries_then_succeeds():
    calls = []

    class FlakyTrainer:
        def __init__(self, resume):
            self.resume = resume

        def fit(self):
            calls.append(self.resume)
            if len(calls) < 3:
                raise RuntimeError("injected failure")
            return {"ok": True, "resumed": self.resume}

    out = run_with_restarts(FlakyTrainer, max_restarts=2)
    assert out["ok"] and out["resumed"] is True
    assert calls == [False, True, True]  # first cold, retries resume


def test_run_with_restarts_backoff_and_counter():
    """The waits follow the deterministic backoff schedule (the
    reference's helper gives the same delays) and each restart counts in
    `train_restarts_total`."""
    calls, slept = [], []
    registry = metrics.MetricsRegistry()

    class Flaky:
        def __init__(self, resume):
            pass

        def fit(self):
            calls.append(1)
            if len(calls) < 4:
                raise RuntimeError("injected")
            return {"ok": True}

    out = run_with_restarts(
        Flaky, max_restarts=3, restart_delay_s=0.1, jitter=0.5, seed=5,
        metrics=registry, sleep=slept.append,
    )
    assert out["ok"] and len(calls) == 4
    want = [jax_backoff.backoff_delay(i, base_s=0.1, factor=2.0,
                                      max_s=300.0, jitter=0.5, seed=5)
            for i in range(3)]
    assert slept == want          # deterministic schedule, replayable
    assert want[0] < want[1] < want[2]  # and actually growing
    assert registry.counter("train_restarts_total").value == 3


def test_run_with_restarts_zero_delay_never_sleeps():
    calls, slept = [], []

    class FailOnce:
        def __init__(self, resume):
            pass

        def fit(self):
            calls.append(1)
            if len(calls) < 2:
                raise RuntimeError("injected")
            return {"ok": True}

    out = run_with_restarts(FailOnce, max_restarts=1, sleep=slept.append)
    assert out["ok"] and slept == []


def test_run_with_restarts_exhausts():
    class AlwaysFails:
        def __init__(self, resume):
            pass

        def fit(self):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        run_with_restarts(AlwaysFails, max_restarts=1)


def _elastic_config(workdir, **kw):
    """tests/elastic_worker.py's run: the ConvNet on the synthetic set,
    two epochs of 4 steps, a checkpoint each epoch, one restart."""
    base = dict(
        dataset="synthetic", epochs=2, batch_size=8, optimizer="adam",
        learning_rate=1e-3, log_every_steps=0, max_steps_per_epoch=4,
        checkpoint_dir=str(workdir / "ck"), checkpoint_every_epochs=1,
        max_restarts=1, mesh=MeshConfig(data=-1), device="cpu",
        synthetic_size=256)
    return TrainConfig(**{**base, **kw})


def test_fit_recovers_from_injected_failure(tmp_path, monkeypatch):
    """End to end, in-process: the first attempt trains epoch 0, saves
    and dies; `fit` restores that checkpoint and trains only epoch 1
    (2 x 4 steps in all), and its parameters equal an uninterrupted
    run's bit for bit."""
    original = loop.Trainer._fit_inner
    state = {"attempts": 0}
    final = {}

    def sabotaged(self):
        state["attempts"] += 1
        if state["attempts"] == 1:
            self.train_epoch(0)
            self.save()
            raise RuntimeError("injected mid-training failure")
        out = original(self)
        final.update({n: p.detach().clone()
                      for n, p in self.model.named_parameters()})
        return out

    monkeypatch.setattr(loop.Trainer, "_fit_inner", sabotaged)
    summary = loop.fit(_elastic_config(tmp_path))
    monkeypatch.setattr(loop.Trainer, "_fit_inner", original)
    assert state["attempts"] == 2, state
    assert np.isfinite(summary["accuracy"]), summary
    assert summary["steps"] == 8, summary
    plain = loop.Trainer(_elastic_config(tmp_path, max_restarts=0,
                                         checkpoint_dir=None))
    want = plain.fit()
    assert want["accuracy"] == summary["accuracy"]
    for name, p in plain.model.named_parameters():
        assert torch.equal(final[name], p.detach()), name


# ---------------------------------------- backoff and the registry
@pytest.mark.parametrize("seed", [0, 1, 5, 12345])
def test_backoff_delay_equals_the_references(seed):
    for attempt in range(8):
        for base in (0.0, 0.01, 0.1, 3.0):
            for factor in (1.0, 1.5, 2.0, 3.0):
                for jitter in (0.0, 0.25, 0.5, 1.0):
                    kw = dict(base_s=base, factor=factor, max_s=60.0,
                              jitter=jitter, seed=seed)
                    assert backoff.backoff_delay(attempt, **kw) == \
                        jax_backoff.backoff_delay(attempt, **kw)
    for bad in (dict(base_s=-1.0), dict(base_s=1.0, factor=0.5),
                dict(base_s=1.0, jitter=-0.1)):
        with pytest.raises(ValueError):
            backoff.backoff_delay(0, **bad)
    with pytest.raises(ValueError):
        backoff.backoff_delay(-1, base_s=1.0)


def _fill(mod):
    reg = mod.MetricsRegistry()
    reg.counter("train_restarts_total").inc(3)
    reg.counter(mod.labelled("shed_total", reason='q"ueue\\')).inc()
    reg.counter(mod.labelled("shed_total", reason="slo")).inc(2.5)
    reg.gauge("queue_depth").set(7)
    reg.gauge(mod.labelled("slots", replica="r1", zone="b")).set(0.25)
    h = reg.histogram("ttft_s", max_samples=8)
    for i, v in enumerate([0.003, 0.2, 0.05, 1.7, 0.004, 0.6, 12.0, 0.09,
                           0.3, 0.02]):
        h.observe(v, exemplar=f"t{i}" if i % 3 else None)
    plain = reg.histogram(mod.labelled("tpot_s", engine="paged"))
    for v in (0.01, 0.02, 0.015):
        plain.observe(v)
    return reg, h


def test_registry_renders_as_the_references():
    mine, h = _fill(metrics)
    ref, rh = _fill(jax_metrics)
    assert mine.render_text() == ref.render_text()
    assert mine.snapshot() == ref.snapshot()
    assert h.exemplar_for(99) == rh.exemplar_for(99)
    assert metrics.percentile_summary([3, 1, 2, 5, 8]) == \
        jax_metrics.percentile_summary([3, 1, 2, 5, 8])
    with pytest.raises(ValueError, match="counters only go up"):
        mine.counter("x").inc(-1)


def test_label_guard_buckets_overflow_as_the_reference():
    old = metrics.set_label_limit(2)
    old_ref = jax_metrics.set_label_limit(2)
    try:
        metrics.reset_label_guard()
        jax_metrics.reset_label_guard()
        got = [metrics.labelled("m", id=i) for i in range(4)]
        want = [jax_metrics.labelled("m", id=i) for i in range(4)]
        assert got == want == ["m{id=0}", "m{id=1}", "m{id=other}",
                               "m{id=other}"]
        assert metrics.labelled("m", id=1, a="x") == "m{a=x,id=1}"
    finally:
        metrics.set_label_limit(old)
        jax_metrics.set_label_limit(old_ref)
        metrics.reset_label_guard()
        jax_metrics.reset_label_guard()


# ------------------------------------------------------ the sync check
@pytest.mark.parametrize("drift", [False, True])
def test_assert_in_sync_over_two_ranks(drift):
    def rank(r):
        fingerprint = 10 + (r if drift else 0)
        try:
            assert_in_sync(fingerprint, what="driver step")
        except RuntimeError as e:
            return str(e)
        return None

    got = ranks(rank, 2)
    if not drift:
        assert got == [None, None]
        return
    assert got == [
        f"hosts out of sync on driver step: process {r} sees {10 + r}, "
        "fleet sees [10, 11]" for r in range(2)]


# -------------------------------------------------------------- the loop
def _lm(**kw):
    base = dict(model="lm_tiny", device="cpu", seq_len=16, batch_size=4,
                synthetic_size=20000, optimizer="sgd", learning_rate=0.1,
                log_every_steps=0, epochs=1, max_steps_per_epoch=6)
    return TrainConfig(**{**base, **kw})


def test_resident_group_capped_by_watchdog():
    """With a watchdog, whole-epoch groups are capped at the probe
    interval, so a probe never waits an epoch without a beat."""
    tr = loop.Trainer(_lm(data_placement="device", steps_per_call=-1,
                          watchdog_timeout_s=300.0,
                          watchdog_probe_every_steps=10))
    assert tr._resident_group(128) == 10
    tr2 = loop.Trainer(_lm(data_placement="device", steps_per_call=-1))
    assert tr2._resident_group(128) == 128


class _Rung(Rung):
    def __init__(self, name, done, log):
        self.name, self.done, self.log = name, done, log

    def ready(self):
        return self.done

    def wait(self):
        self.log.append(self.name)


def test_probe_waits_on_the_oldest_unconfirmed_rung():
    """A due probe skips the rungs already done and waits on the oldest
    one that is not (never the newest: it would wait for the whole
    backlog); the epoch's fence then drains the rest, beating on each."""
    tr = loop.Trainer(_lm(watchdog_probe_every_steps=4))
    waited, beats = [], []

    class Watchdog(StepWatchdog):
        def beat(self):
            beats.append(len(waited))

    tr._watchdog = Watchdog(100.0)
    tr._pending.extend(_Rung(n, d, waited) for n, d in
                       [("a", True), ("b", True), ("c", False),
                        ("d", False)])
    tr._probe_if_due(2, 3)            # no boundary, not starving: no probe
    assert waited == []
    tr._probe_if_due(3, 4)            # the boundary of 4
    assert waited == ["c"] and [r.name for r in tr._pending] == ["d"]
    tr._drain_pending()
    assert waited == ["c", "d"] and beats == [1, 2]
    tr._watchdog = None


def test_a_watched_run_beats_and_stays_quiet(monkeypatch):
    """An epoch with the watchdog on: a rung a call, probes at the
    interval and at the fence, no firing."""
    fired = []
    monkeypatch.setattr(StepWatchdog, "_default_timeout",
                        staticmethod(fired.append))
    probes = []
    probe = StepWatchdog.probe
    monkeypatch.setattr(StepWatchdog, "probe",
                        lambda self, v, fetch=None: (probes.append(v),
                                                     probe(self, v, fetch)))
    tr = loop.Trainer(_lm(watchdog_timeout_s=30.0, steps_per_call=2,
                          data_placement="device",
                          watchdog_probe_every_steps=4,
                          sync_check_every_steps=2))
    summary = tr.fit()
    assert summary["steps"] == 6 and not fired
    assert all(isinstance(p, Rung) for p in probes)
    # three train calls (one rung each: one probed at step 4, two at the
    # fence), then eval's rungs
    assert len(probes) >= 3 and tr._watchdog is None


def test_sync_check_catches_a_drifting_driver():
    """Two ranks whose drivers stand in different epochs (the same
    collectives, other host counts): the sync check raises at its first
    boundary on every rank."""
    def rank(r):
        t = loop.Trainer(_lm(mesh=MeshConfig(data=2), batch_size=2,
                             sync_check_every_steps=2,
                             data_placement="host"))
        try:
            t.train_epoch(r)               # rank 1's driver drifted
        except RuntimeError as e:
            return str(e)
        return None

    for r, msg in enumerate(ranks(rank, 2)):
        assert msg.startswith(f"hosts out of sync on driver step: process "
                              f"{r}"), msg


@pytest.mark.parametrize("argv", [
    ["--watchdog", "30"], ["--sync_check", "1"], ["--max_restarts", "2"]],
    ids=["watchdog", "sync_check", "max_restarts"])
def test_failure_detection_flags_run_through_the_cli(argv, capsys):
    common = ["--model", "lm_tiny", "--device", "cpu", "--seq_len", "16",
              "-b", "2", "-e", "1", "--max_steps", "3", "--log_every", "1",
              "--synthetic_size", "20000", "--json"]
    assert cli.main(argv + common) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 3 and np.isfinite(summary["perplexity"])
