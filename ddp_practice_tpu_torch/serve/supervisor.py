"""Supervisor: worker-process lifecycles for the cross-process fleet.

(Host-pure Python: a copy of ddp_practice_tpu/serve/supervisor.py with
its imports pointed at the port; the port imports nothing of the
reference package. Workers start as `python -m
ddp_practice_tpu_torch.serve.worker`, each a fresh interpreter with its
own CUDA context — never a fork of a process that touched CUDA. The
fleet trace plane (`WorkerSpec.trace`, the TraceCollector) and the
federated scrape server are ROADMAP A6d and raise naming it.)

The in-process router's "restart" was a lie a real fleet can't tell:
`ReplicaHandle.restart()` reused the same Python objects, so every
recovery the chaos suite proved was a simulated one. This module owns
REAL lifecycles:

- **spawn**: `python -m ddp_practice_tpu_torch.serve.worker --spec @file` with
  stdout routed to a log file; the supervisor tails the log for the
  ``WORKER_READY`` line (ports + pid), connects the RPC client, and
  health-probes it — a worker is only ever visible to dispatch warm and
  answering.
- **liveness**: `poll()` waitpid-checks every child (a SIGKILLed worker
  is seen the tick after it dies) — heartbeat staleness (the SIGSTOP
  case: alive but silent) is judged by the RemoteReplicaHandle, which
  owns the RPC cadence and puts the zombie down with a real SIGKILL
  before failing over.
- **restart with backoff + budget**: a dead slot respawns after
  utils/backoff.py delays (exponential, capped, per-slot seeded); after
  `restart_budget` restarts the slot's circuit breaks to FAILED — a
  crash-looping replica must page an operator, not burn CPU forever.
  Respawns run on a background thread: a surviving fleet keeps serving
  through a replacement's import, model build and warmup; it does not
  stop to watch.
- **graceful drain on stop()**: RPC ``shutdown`` first, then SIGTERM,
  then SIGKILL, then ALWAYS waitpid — no test run ever leaks a child.

Every spawned pid is registered in a module-level table with an atexit
reaper (`reap_all`); the fleet tests call it from a fixture on top, so
even a SIGSTOPped orphan cannot outlive — or hang — a pytest run.

`RemoteReplicaHandle` is the router-facing half: the same narrow
replica interface as serve/router.py's in-process ReplicaHandle
(`submit`/`step`/`poll`/`evacuate`/`shed_queued` + observables), spoken
over serve/rpc.py. Its `step()` is the heartbeat: one watermark poll
that also refreshes the SALVAGE POINT — each outstanding request's
tokens-so-far — so a later SIGKILL re-admits prompt+tokens on a
survivor exactly like the in-process failover (token-identical
under greedy, original trace_id preserved).
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

from ddp_practice_tpu_torch.serve.faults import ReplicaCrashed
from ddp_practice_tpu_torch.serve.health import ReplicaHealth
from ddp_practice_tpu_torch.serve.rpc import (
    RpcClient,
    RpcError,
    RpcRemoteError,
    open_stream,
)
from ddp_practice_tpu_torch.serve.scheduler import (
    Completion,
    MonotonicClock,
    Request,
    TokenChunk,
)
from ddp_practice_tpu_torch.serve.worker import READY_PREFIX, WorkerSpec
from ddp_practice_tpu_torch.utils.backoff import backoff_delay

# the directory holding the ddp_practice_tpu_torch package
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# ------------------------------------------------------------ pid registry
# every child this module ever spawns, alive until explicitly reaped —
# the belt under the supervisor's own bookkeeping. The fleet tests'
# fixture asserts this drains; atexit is the suspenders.
_CHILDREN: Dict[int, subprocess.Popen] = {}
_CHILDREN_LOCK = threading.Lock()


def _register_child(proc: subprocess.Popen) -> None:
    with _CHILDREN_LOCK:
        _CHILDREN[proc.pid] = proc


def _unregister_child(pid: int) -> None:
    with _CHILDREN_LOCK:
        _CHILDREN.pop(pid, None)


def live_worker_pids() -> List[int]:
    """Registered children still running (reaped ones drop out)."""
    with _CHILDREN_LOCK:
        procs = list(_CHILDREN.values())
    return [p.pid for p in procs if p.poll() is None]


def reap_all() -> List[int]:
    """SIGKILL + waitpid every still-live registered child; returns the
    pids that were alive (= leaked — a clean run returns []). SIGKILL
    works on SIGSTOPped processes too, which is the whole point: a
    stopped orphan would otherwise hang any wait()er forever."""
    with _CHILDREN_LOCK:
        procs = list(_CHILDREN.values())
    leaked = []
    for p in procs:
        if p.poll() is None:
            leaked.append(p.pid)
            try:
                p.kill()
            except OSError:
                pass
            try:
                p.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
        _unregister_child(p.pid)
    return leaked


atexit.register(reap_all)


# ---------------------------------------------------------------- spawning
class SpawnedWorker:
    """One live worker process attempt: Popen + ready info + RPC client."""

    def __init__(self, proc: subprocess.Popen, ready: dict,
                 client: RpcClient, log_path: str,
                 spec_path: str) -> None:
        self.proc = proc
        self.pid = proc.pid
        self.rpc_port = ready["rpc_port"]
        self.telemetry_port = ready["telemetry_port"]
        self.client = client
        self.log_path = log_path
        self._spec_path = spec_path

    def poll(self) -> Optional[int]:
        """None while running, else the exit code (waitpid, WNOHANG)."""
        return self.proc.poll()

    def kill_signal(self, sig: str) -> None:
        os.kill(self.pid, getattr(signal, sig))

    def reap(self, timeout_s: float = 5.0) -> None:
        """Ensure the process is collected and the registry is clean."""
        self.client.close()
        if self.proc.poll() is None:
            try:
                self.proc.kill()
            except OSError:
                pass
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            pass
        _unregister_child(self.pid)
        try:
            os.unlink(self._spec_path)
        except OSError:
            pass


def spawn_worker(spec: WorkerSpec, *, log_dir: Optional[str] = None,
                 ready_timeout_s: float = 300.0,
                 rpc_timeout_s: float = 5.0) -> SpawnedWorker:
    """Spawn one worker process and block until it is READY and
    answering pings (raises RuntimeError with the log tail otherwise).
    stdout/stderr go to a LOG FILE, not a pipe — a chatty worker can
    never deadlock against a parent that stopped reading."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="ddp_worker_")
    os.makedirs(log_dir, exist_ok=True)
    fd, spec_path = tempfile.mkstemp(
        suffix=".json", prefix=f"spec_r{spec.replica}_", dir=log_dir
    )
    with os.fdopen(fd, "w") as f:
        f.write(spec.to_json())
    log_path = os.path.join(
        log_dir, f"worker_r{spec.replica}_{int(time.time()*1e3)}.log"
    )
    log_fh = open(log_path, "wb")
    # the child imports the same package as this process, whatever its
    # working directory
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PACKAGE_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ddp_practice_tpu_torch.serve.worker",
             "--spec", "@" + spec_path],
            stdout=log_fh, stderr=subprocess.STDOUT, env=env,
        )
    finally:
        log_fh.close()  # the child holds its own descriptor
    _register_child(proc)
    ready = None
    deadline = time.monotonic() + ready_timeout_s
    while time.monotonic() < deadline:
        try:
            with open(log_path, errors="replace") as f:
                for line in f:
                    if line.startswith(READY_PREFIX):
                        ready = json.loads(line[len(READY_PREFIX):])
                        break
        except OSError:
            pass
        if ready is not None:
            break
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    if ready is None:
        rc = proc.poll()
        tail = ""
        try:
            with open(log_path, errors="replace") as f:
                tail = f.read()[-2000:]
        except OSError:
            pass
        # never leave a half-booted child behind
        try:
            proc.kill()
        except OSError:
            pass
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            pass
        _unregister_child(proc.pid)
        raise RuntimeError(
            f"worker {spec.replica} never became ready "
            f"(rc={rc}); log tail:\n{tail}"
        )
    client = RpcClient("127.0.0.1", ready["rpc_port"],
                       timeout_s=rpc_timeout_s, seed=spec.replica)
    # the health probe: ready AND answering before anyone dispatches
    client.call("ping", timeout_s=rpc_timeout_s)
    return SpawnedWorker(proc, ready, client, log_path, spec_path)


# --------------------------------------------------------------- supervisor
@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    # restart backoff schedule (per slot, utils/backoff.py)
    restart_base_s: float = 0.25
    restart_factor: float = 2.0
    restart_max_s: float = 10.0
    restart_jitter: float = 0.0
    seed: int = 0
    # restart-budget circuit breaker: after this many restarts a slot
    # goes FAILED for good (operator territory — a crash loop must not
    # burn the machine forever). Counts spawn FAILURES too.
    restart_budget: int = 5
    # rolling window for the budget: None = lifetime count (FAILED is
    # permanent until revive(slot)); a float makes the budget count
    # only restarts within the last window — a slot that exhausted its
    # budget during a transient storm rejoins once the storm ages out
    restart_window_s: Optional[float] = None
    # how long a spawn may take to reach READY (import, model build,
    # warmup)
    ready_timeout_s: float = 300.0
    rpc_timeout_s: float = 5.0
    # stop(): how long to wait after a graceful rpc shutdown before
    # escalating to SIGTERM, then SIGKILL
    drain_timeout_s: float = 5.0
    # shrink(): how long a DRAINING slot may take to finish its
    # in-flight streams and exit before poll() escalates to SIGKILL
    # (a drain that never converges is a hang, not a graceful exit)
    shrink_kill_after_s: float = 60.0


# slot states
RUNNING = "running"
BACKOFF = "backoff"      # dead, respawn scheduled at _next_at
SPAWNING = "spawning"    # respawn in flight on the spawn thread
FAILED = "failed"        # restart budget exhausted — breaker open
STOPPED = "stopped"
DRAINING = "draining"    # scale-down in flight: refusing submits,
#                          finishing streams, exiting on its own — a
#                          death here is RETIREMENT, never a respawn


class Supervisor:
    """Owns N worker slots: spawn, liveness, backoff restarts, drain.

    `spawn_fn(spec)` is injectable (defaults to `spawn_worker`) so the
    restart state machine is host-pure testable with fakes;
    `spawn_in_thread=False` makes respawns synchronous inside `poll()`
    for deterministic tests (the default keeps the fleet serving while
    a replacement compiles)."""

    def __init__(self, specs: List[WorkerSpec],
                 config: SupervisorConfig = SupervisorConfig(), *,
                 spawn_fn: Optional[Callable] = None,
                 spawn_in_thread: bool = True,
                 clock=None) -> None:
        self.specs = list(specs)
        self.config = config
        self.spawn_fn = spawn_fn or self._default_spawn
        self.spawn_in_thread = spawn_in_thread
        self.clock = clock or MonotonicClock()
        self._log_dir = None  # lazily created by _default_spawn
        n = len(specs)
        self.workers: List[Optional[object]] = [None] * n
        self.states: List[str] = [STOPPED] * n
        self.restarts: List[int] = [0] * n    # lifetime restarts/slot
        # budget accounting, separate from the lifetime telemetry
        # counter above: revive() zeroes THESE, never the telemetry
        self._budget_used: List[int] = [0] * n
        self._restart_times: List[List[float]] = [[] for _ in range(n)]
        self._next_at: List[float] = [0.0] * n
        self._spawn_threads: List[Optional[threading.Thread]] = [None] * n
        self._spawn_results: List[Optional[tuple]] = [None] * n
        # scale-down bookkeeping: SIGKILL deadline per DRAINING slot,
        # and a cancel flag a shrink() of a SPAWNING slot leaves for
        # _collect_spawn (the fresh worker is reaped, never joined)
        self._drain_deadline: List[Optional[float]] = [None] * n
        self._cancel_spawn: List[bool] = [False] * n
        self._lock = threading.Lock()

    def _default_spawn(self, spec: WorkerSpec):
        if self._log_dir is None:
            self._log_dir = tempfile.mkdtemp(prefix="ddp_fleet_")
        return spawn_worker(
            spec, log_dir=self._log_dir,
            ready_timeout_s=self.config.ready_timeout_s,
            rpc_timeout_s=self.config.rpc_timeout_s,
        )

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Spawn every slot and return once all are up (first boot is
        setup, not serving — the fleet exists only once all replicas
        are warm). With `spawn_in_thread` the slots boot together, each
        a fresh process, so a fleet's start costs one boot, not N; the
        first failure is raised after every attempt has ended, and the
        slots that did boot stay registered for `stop()`."""
        n = len(self.specs)
        if not self.spawn_in_thread or n < 2:
            for slot in range(n):
                self.workers[slot] = self.spawn_fn(self.specs[slot])
                self.states[slot] = RUNNING
            return
        results: List[Optional[tuple]] = [None] * n

        def attempt(slot: int) -> None:
            try:
                results[slot] = ("ok", self.spawn_fn(self.specs[slot]))
            except BaseException as e:
                results[slot] = ("err", e)

        threads = [threading.Thread(target=attempt, args=(slot,),
                                    name=f"start-w{slot}", daemon=True)
                   for slot in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        err = None
        for slot, (kind, val) in enumerate(results):
            if kind == "ok":
                self.workers[slot] = val
                self.states[slot] = RUNNING
            elif err is None:
                err = val
        if err is not None:
            raise err

    def worker(self, slot: int):
        """The slot's CURRENT process (None while down) — callers must
        re-resolve per use; a restarted slot has a new pid/client. A
        DRAINING worker is still a live process (its handle keeps
        pumping completions out of it) — only dispatch eligibility is
        gone, and that is `alive()`'s job, not this one's."""
        if self.states[slot] in (RUNNING, DRAINING):
            return self.workers[slot]
        return None

    def alive(self, slot: int) -> bool:
        return self.states[slot] == RUNNING

    def draining(self, slot: int) -> bool:
        return self.states[slot] == DRAINING

    def state(self, slot: int) -> str:
        return self.states[slot]

    def active_slots(self) -> int:
        """Slots that serve or will serve again (RUNNING + the restart
        pipeline) — the autoscaler's notion of fleet size. DRAINING
        slots are already leaving; STOPPED/FAILED are gone."""
        return sum(
            1 for s in self.states if s in (RUNNING, BACKOFF, SPAWNING)
        )

    def kill(self, slot: int, sig: str = "SIGKILL") -> None:
        """Deliver a REAL signal to the slot's current process (the
        chaos driver's kill_fn, and the handle's stale-heartbeat
        put-down). No-op when the slot is already down."""
        if not 0 <= slot < len(self.workers):
            raise ValueError(
                f"kill targets slot {slot}; this fleet has "
                f"{len(self.workers)} (a kill plan naming a replica "
                f"the fleet doesn't have is a plan bug)"
            )
        w = self.workers[slot]
        if w is not None and w.poll() is None:
            w.kill_signal(sig)

    # ----------------------------------------------- elastic actuators
    def grow(self, spec: WorkerSpec, worker=None) -> int:
        """Append a NEW slot and return its id. Slot ids are stable and
        monotonically increasing: a shrunk slot becomes a STOPPED
        tombstone, never a hole, so every federated label minted for a
        slot stays true across scale events. With `worker` (a warm
        standby) the slot joins RUNNING immediately — promotion is a
        list append, not a ~15 s spawn; without one the slot enters
        BACKOFF due NOW and the next poll() spawns it cold through the
        normal (budget-free first) pipeline."""
        with self._lock:
            slot = len(self.specs)
            self.specs.append(spec)
            self.workers.append(worker)
            self.states.append(RUNNING if worker is not None else BACKOFF)
            self.restarts.append(0)
            self._budget_used.append(0)
            self._restart_times.append([])
            self._next_at.append(self.clock.now())
            self._spawn_threads.append(None)
            self._spawn_results.append(None)
            self._drain_deadline.append(None)
            self._cancel_spawn.append(False)
            return slot

    def shrink(self, slot: int) -> str:
        """Scale one slot away, gracefully; returns the slot's state
        after the call. A RUNNING slot drains via the worker's SIGTERM path
        (rpc `drain` first so refusals start even if signal delivery
        lags): it refuses new submits, finishes its in-flight streams,
        and exits on its own — poll() then retires it to STOPPED with
        NO restart-budget charge and NO respawn. A BACKOFF slot's
        pending respawn is cancelled outright; a SPAWNING slot's
        in-flight attempt is flagged for _collect_spawn to reap.
        Intentional scale-down is not a crash: none of these touch
        `restarts`, `_budget_used`, or the rolling window."""
        if not 0 <= slot < len(self.specs):
            raise ValueError(
                f"shrink targets slot {slot}; this fleet has "
                f"{len(self.specs)}"
            )
        now = self.clock.now()
        with self._lock:
            st = self.states[slot]
            if st == RUNNING:
                w = self.workers[slot]
                if w is not None and w.poll() is None:
                    try:
                        w.client.call("drain", timeout_s=1.0, retries=0)
                    except (RpcError, RpcRemoteError):
                        pass  # SIGTERM below carries the same intent
                    try:
                        w.kill_signal("SIGTERM")
                    except OSError:
                        pass
                    self.states[slot] = DRAINING
                    self._drain_deadline[slot] = (
                        now + self.config.shrink_kill_after_s
                    )
                else:
                    # already a corpse: collect it without the budget
                    # charge a poll()-observed death would levy
                    if w is not None:
                        w.reap()
                    self.workers[slot] = None
                    self.states[slot] = STOPPED
            elif st == BACKOFF:
                self.states[slot] = STOPPED
            elif st == SPAWNING:
                self._cancel_spawn[slot] = True
            elif st == FAILED:
                self.states[slot] = STOPPED
            return self.states[slot]

    # ------------------------------------------------------ the state loop
    def poll(self, now: Optional[float] = None) -> None:
        """One liveness pass: waitpid every RUNNING slot (dead ->
        schedule restart with backoff, or FAILED past the budget),
        launch due respawns, collect finished spawn attempts."""
        now = self.clock.now() if now is None else now
        with self._lock:
            for slot in range(len(self.specs)):
                st = self.states[slot]
                if st == RUNNING:
                    w = self.workers[slot]
                    if w is None or w.poll() is not None:
                        self._on_death(slot, now)
                elif st == DRAINING:
                    w = self.workers[slot]
                    if w is None or w.poll() is not None:
                        # drained clean (exit 0) or chaos-killed
                        # mid-drain: either way the slot RETIRES —
                        # an intentional scale-down is not a crash,
                        # so no budget charge and no respawn
                        if w is not None:
                            w.reap()
                        self.workers[slot] = None
                        self.states[slot] = STOPPED
                        self._drain_deadline[slot] = None
                    elif (self._drain_deadline[slot] is not None
                          and now >= self._drain_deadline[slot]):
                        # the drain never converged: put it down for
                        # real (the handle already salvaged its work)
                        try:
                            w.kill_signal("SIGKILL")
                        except OSError:
                            pass
                        self._drain_deadline[slot] = None
                elif st == BACKOFF and now >= self._next_at[slot]:
                    self._begin_spawn(slot, now)
                elif st == SPAWNING:
                    self._collect_spawn(slot, now)
                elif st == FAILED \
                        and self.config.restart_window_s is not None \
                        and self._budget_spent(slot, now) \
                        < self.config.restart_budget:
                    # the crash storm aged out of the rolling window:
                    # the breaker half-closes and the slot rejoins
                    self._next_at[slot] = now
                    self.states[slot] = BACKOFF

    def _budget_spent(self, slot: int, now: float) -> int:
        """Restarts counting against the budget: the lifetime count by
        default, only those inside the rolling window when one is
        configured (pruning as a side effect — old entries never count
        again)."""
        w = self.config.restart_window_s
        if w is None:
            return self._budget_used[slot]
        times = self._restart_times[slot]
        times[:] = [t for t in times if now - t < w]
        return len(times)

    def revive(self, slot: int) -> None:
        """Operator escape hatch: put a FAILED slot back in play NOW,
        with a fresh budget (a revive that instantly re-tripped would
        be no escape at all). Lifetime restart telemetry is preserved."""
        if self.states[slot] != FAILED:
            return
        with self._lock:
            self._budget_used[slot] = 0
            self._restart_times[slot] = []
            self._next_at[slot] = self.clock.now()
            self.states[slot] = BACKOFF

    def _on_death(self, slot: int, now: float) -> None:
        w = self.workers[slot]
        if w is not None:
            w.reap()
        self.workers[slot] = None
        if self._budget_spent(slot, now) >= self.config.restart_budget:
            # the restart-budget circuit breaker: slot is done (for
            # good without a window — see revive(); until the storm
            # ages out with one — see poll())
            self.states[slot] = FAILED
            return
        c = self.config
        delay = backoff_delay(
            self.restarts[slot], base_s=c.restart_base_s,
            factor=c.restart_factor, max_s=c.restart_max_s,
            jitter=c.restart_jitter, seed=c.seed + slot,
        )
        self.restarts[slot] += 1
        self._budget_used[slot] += 1
        self._restart_times[slot].append(now)
        self._next_at[slot] = now + delay
        self.states[slot] = BACKOFF

    def _begin_spawn(self, slot: int, now: float) -> None:
        self.states[slot] = SPAWNING
        self._spawn_results[slot] = None

        def attempt():
            try:
                self._spawn_results[slot] = ("ok",
                                             self.spawn_fn(self.specs[slot]))
            except BaseException as e:
                self._spawn_results[slot] = ("err", e)

        if self.spawn_in_thread:
            t = threading.Thread(
                target=attempt, name=f"spawn-w{slot}", daemon=True
            )
            t.start()
            self._spawn_threads[slot] = t
        else:
            attempt()
            self._collect_spawn(slot, now)

    def _collect_spawn(self, slot: int, now: float) -> None:
        res = self._spawn_results[slot]
        if res is None:
            return  # still compiling/importing on the spawn thread
        self._spawn_results[slot] = None
        self._spawn_threads[slot] = None
        kind, val = res
        if self._cancel_spawn[slot]:
            # shrink() landed while the spawn was in flight: the slot
            # is being scaled away, so the fresh worker (if the spawn
            # even succeeded) is reaped, and a spawn FAILURE costs no
            # budget — cancellation is intent, not a crash
            self._cancel_spawn[slot] = False
            if kind == "ok":
                val.reap()
            self.workers[slot] = None
            self.states[slot] = STOPPED
            return
        if kind == "ok":
            self.workers[slot] = val
            self.states[slot] = RUNNING
        else:
            # a failed spawn consumes restart budget like a death —
            # a spec that cannot boot must trip the breaker, not spin
            self.states[slot] = RUNNING  # let _on_death do the math
            self.workers[slot] = None
            self._on_death(slot, now)

    # -------------------------------------------------------------- stop
    def stop(self) -> None:
        """Graceful drain: rpc shutdown -> wait -> SIGTERM -> SIGKILL ->
        ALWAYS waitpid. Also joins any in-flight spawn attempt and
        reaps its result, so no child survives a stop() however
        mid-restart it was called."""
        with self._lock:
            for slot, t in enumerate(self._spawn_threads):
                if t is not None:
                    t.join(timeout=self.config.ready_timeout_s)
                    self._collect_spawn(slot, self.clock.now())
            for slot in range(len(self.specs)):
                w = self.workers[slot]
                self.states[slot] = STOPPED
                self.workers[slot] = None
                if w is None:
                    continue
                try:
                    w.client.call("shutdown", timeout_s=2.0, retries=0)
                except (RpcError, RpcRemoteError):
                    pass
                try:
                    w.proc.wait(timeout=self.config.drain_timeout_s)
                except (subprocess.TimeoutExpired, AttributeError):
                    if w.poll() is None:
                        try:
                            w.kill_signal("SIGTERM")
                            w.proc.wait(timeout=2.0)
                        except (subprocess.TimeoutExpired, OSError,
                                AttributeError):
                            pass
                w.reap()

    def __enter__(self) -> "Supervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# ------------------------------------------------------ router-facing handle
_ZERO_PHASES = {"queue_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0}


class RemoteReplicaHandle:
    """serve/router.py's replica interface over the RPC wire.

    `step()` is the heartbeat/watermark poll (fail-fast timeout, no
    transport retries — staleness accounting judges); `submit` rides
    the retry budget (the worker dedups by rid, so a replayed frame is
    safe). Outstanding requests carry their last-polled tokens-so-far:
    `evacuate()` after a real death hands the router the same
    (request, tokens, ftt, phases) tuples the in-process scheduler
    harvest gives, built from the last salvage point instead of a
    scheduler that no longer exists."""

    def __init__(self, slot: int, supervisor: Supervisor,
                 spec: WorkerSpec, *, clock=None,
                 heartbeat_timeout_s: float = 2.0,
                 poll_timeout_s: float = 1.0,
                 poll_interval_s: float = 0.005,
                 trace_collector=None) -> None:
        self.id = slot
        self.supervisor = supervisor
        self.spec = spec
        self.clock = clock or supervisor.clock
        self.health = ReplicaHealth()   # re-armed by the Router
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.poll_timeout_s = poll_timeout_s
        # optional utils/trace.py TraceCollector: `trace` push frames
        # (the worker's streamed spans) merge through it into the fleet
        # recorder, and every timestamped ping/poll round trip feeds its
        # per-worker clock-offset estimator
        self.trace_collector = trace_collector
        # min spacing between heartbeat RPCs: the router ticks as fast
        # as it can, but hammering the worker's lock with a poll per
        # tick steals the very core the decode needs (measured: the
        # unthrottled loop costs the fleet ~25% decode p50 on a 1-core
        # box). Liveness (waitpid) is still checked EVERY step.
        self.poll_interval_s = poll_interval_s
        self._last_poll = -1e18
        self._pub_version = None   # worker snapshot version (poll dedup)
        # push stream (rpc.py FrameStream): the worker pushes every
        # published snapshot; step() drains it without blocking, so
        # steady-state completion delivery costs no round trips. The
        # poll op demotes to a slow reconciliation heartbeat while the
        # stream is up, and is the sole path when it is not.
        self._stream = None
        self.stream_poll_interval_s = 0.25
        self.consumed = 0               # watermark into the CURRENT
        #                                 process's completions list
        self.chunks_consumed = 0        # same contract, TokenChunk list
        self.outstanding: Dict[int, dict] = {}
        # fire-and-forget submits awaiting confirmation: rid -> casts
        # sent. Confirmation is the rid surfacing in a pub/poll frame
        # (completion or inflight salvage) or the reconcile poll's
        # `confirmed` answer; a rid the worker never saw is resubmitted
        # (idempotent by rid), a refused one surfaces as a typed
        # "refused" completion so the router re-dispatches penalty-free
        self._unconfirmed: Dict[int, int] = {}
        self._pending: List[Completion] = []
        self._pending_chunks: List[TokenChunk] = []
        # set when the worker refused a submit as DRAINING (typed, not
        # a fault): the router retries its next candidate instead of
        # writing the replica off; has_queue_space goes False until the
        # stats say otherwise (or the drained process exits)
        self.last_submit_refused = False
        self._remote_draining = False
        # scale-down lifecycle: begin_drain() is stamped by the
        # autoscaler when it shrinks this slot; once the drained
        # process exits with nothing left to salvage, step() sets
        # `drained` and goes quiet instead of raising ReplicaCrashed —
        # a retirement, not a failover
        self._drain_requested = False
        self.drained = False
        # rids shed via shed_queued(): their worker-side sub-completions
        # are already finalized by the router from the op's reply, so
        # when they replay through the push stream / poll they must be
        # DROPPED — the rid may have been legitimately reused by then
        # (the same double-booking the in-process handle's watermark
        # advance prevents)
        self._shed_skip: set = set()
        self._stats: dict = {}
        self._last_heartbeat: Optional[float] = None
        self._broken = False            # rpc failed since last step
        buckets = spec.engine.get("prompt_buckets") or (8, 16, 32, 64)
        self._max_bucket = max(buckets)
        self._max_slots = spec.engine.get("max_slots", 4)
        self._max_queue = spec.max_queue

    # ------------------------------------------------------------ plumbing
    def _client(self) -> Optional[RpcClient]:
        w = self.supervisor.worker(self.id)
        return w.client if w is not None else None

    @staticmethod
    def _request_dict(req: Request) -> dict:
        return {
            "rid": req.rid, "prompt": list(req.prompt),
            "max_new_tokens": req.max_new_tokens,
            "deadline": req.deadline, "seed": req.seed,
            "arrival": req.arrival, "priority": req.priority,
            "trace_id": req.trace_id, "sampled": req.sampled,
            "tenant": req.tenant,
            "temperature": req.temperature, "top_k": req.top_k,
            "top_p": req.top_p,
        }

    @staticmethod
    def _to_completion(d: dict) -> Completion:
        return Completion(
            rid=d["rid"], tokens=list(d["tokens"]), status=d["status"],
            arrival=d["arrival"], finish=d["finish"],
            ttft=d.get("ttft"), tpot=d.get("tpot"),
            flight=d.get("flight"), trace_id=d.get("trace_id"),
            trace_sampled=d.get("sampled", True),
            tenant=d.get("tenant"),
        )

    # ---------------- the seam: submit down, completions watermark up
    def submit(self, req: Request) -> None:
        if req.trace_id is None:
            req.trace_id = f"r{req.rid}"
        self.last_submit_refused = False
        # track BEFORE the wire: if the call fails mid-flight the
        # request is outstanding either way, and evacuate() re-admits
        # it on a survivor (the worker-side dedup absorbs the case
        # where the frame did land)
        self.outstanding[req.rid] = {
            "req": req, "tokens": [], "ftt": None,
            "phases": dict(_ZERO_PHASES),
        }
        c = self._client()
        if c is None:
            self._broken = True
            return
        cast = getattr(c, "cast", None)
        if cast is not None:
            # fire-and-forget: ship the frame, wait for NO ack — the
            # ack round trip was most of the remaining TTFT hop at the
            # RPC seam. The worker dedups by rid, so delivery is
            # confirmed (and re-driven) by the reconcile poll instead:
            # step() asks the worker to `confirm` every unconfirmed
            # rid, resubmits the lost ones, and surfaces a draining
            # refusal as a typed "refused" completion.
            try:
                cast("submit", request=self._request_dict(req))
            except (RpcError, RpcRemoteError):
                self._broken = True
                return
            self._unconfirmed[req.rid] = 1
            return
        # legacy blocking path (test fakes without one-way support)
        try:
            r = c.call("submit", request=self._request_dict(req))
        except (RpcError, RpcRemoteError):
            self._broken = True
            return
        if not r.get("accepted", False):
            if r.get("draining"):
                # graceful-drain refusal (SIGTERM path): the worker is
                # finishing its in-flight streams and will exit — not a
                # fault. Untrack (no completion will ever come from
                # here) and tell the router to try its next candidate.
                self.outstanding.pop(req.rid, None)
                self.last_submit_refused = True
                self._remote_draining = True
                return
            # refused at the door otherwise: the request must not
            # strand in `outstanding` with no completion ever coming
            # — treat like a replica failure, so the next step() raises
            # and the evacuation re-dispatches it on a survivor
            self._broken = True

    def _apply_snapshot(self, *, version, from_wm, completions, upto,
                        inflight, stats, chunks=(), chunks_from=None,
                        chunks_upto=None) -> None:
        """Fold one published worker snapshot (push frame or poll
        reply) into client state. `from_wm` is where the payload's
        completion slice starts — anything below our own watermark is a
        replay (stream/poll overlap) and is skipped, never re-pended.
        The TokenChunk slice rides the same replay-skip contract on its
        own watermark (defaults keep pre-streaming fakes working)."""
        self._pub_version = version
        if upto > self.consumed:
            start = max(0, self.consumed - from_wm)
            for d in completions[start:]:
                self._unconfirmed.pop(d["rid"], None)
                if d["rid"] in self._shed_skip:
                    self._shed_skip.discard(d["rid"])
                    continue  # already finalized from the shed reply
                self._pending.append(self._to_completion(d))
            self.consumed = upto
        if chunks_from is None:
            chunks_from = self.chunks_consumed
        if chunks_upto is None:
            chunks_upto = chunks_from + len(chunks)
        if chunks_upto > self.chunks_consumed:
            start = max(0, self.chunks_consumed - chunks_from)
            for d in chunks[start:]:
                self._pending_chunks.append(TokenChunk(
                    rid=d["rid"], trace_id=d.get("trace_id"),
                    seq=d["seq"], start=d["start"],
                    tokens=list(d["tokens"]), t=d.get("t", 0.0),
                    final=d.get("final", False),
                    status=d.get("status"),
                ))
            self.chunks_consumed = chunks_upto
        for item in inflight:
            self._unconfirmed.pop(item["rid"], None)
            st = self.outstanding.get(item["rid"])
            if st is not None:
                st["tokens"] = list(item["tokens"])
                st["ftt"] = item["ftt"]
                st["phases"] = {
                    k: item["phases"].get(k, 0.0) for k in _ZERO_PHASES
                }
        if stats is not None:
            self._stats = stats
            # drain state rides the stats: a draining worker stops
            # being a dispatch candidate even before its first refusal
            self._remote_draining = bool(stats.get("draining", False))

    def _ensure_stream(self) -> None:
        if self._stream is not None:
            return
        w = self.supervisor.worker(self.id)
        port = getattr(w, "rpc_port", None)  # fakes have no stream plane
        if port is None:
            return
        try:
            self._stream = open_stream(
                "127.0.0.1", port, watermark=self.consumed,
                chunks_watermark=self.chunks_consumed,
                timeout_s=self.poll_timeout_s,
            )
        except (RpcError, RpcRemoteError):
            self._stream = None  # poll path carries on

    def _drop_stream(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None

    def _apply_pub_frame(self, f: dict) -> None:
        self._apply_snapshot(
            version=f.get("version"), from_wm=f["from"],
            completions=f["completions"],
            upto=f["watermark"], inflight=f["inflight"],
            stats=f["stats"],
            chunks=f.get("chunks", ()),
            chunks_from=f.get("chunks_from"),
            chunks_upto=f.get("chunks_watermark"),
        )

    def _final_drain(self) -> None:
        """Best-effort drain of a DEAD process's push stream (TCP
        buffers outlive the process): apply any pub frames that made it
        out before the kill, then drop the stream. Completions that
        surface here finalize normally; their rids are excluded from
        the evacuation salvage (see evacuate())."""
        if self._stream is None:
            return
        try:
            while True:
                frames = self._stream.drain()
                if not frames:
                    break
                for f in frames:
                    if f.get("kind") == "pub":
                        self._apply_pub_frame(f)
        except RpcError:
            pass
        self._drop_stream()

    def step(self) -> None:
        """Heartbeat + completion intake + salvage refresh. Fast path:
        drain the push stream (no blocking, no round trips); slow path:
        the poll op, per `poll_interval_s` when the stream is down and
        per `stream_poll_interval_s` as reconciliation when it is up.
        Raises ReplicaCrashed on process death, on a broken submit, or
        when heartbeats stayed stale past the budget (the SIGSTOP case
        — after SIGKILLing the silent process so the supervisor's
        waitpid sees a real corpse and schedules the restart)."""
        now = self.clock.now()
        self.supervisor.poll(now)
        if (not self.supervisor.alive(self.id)
                and not self.supervisor.draining(self.id)):
            # one FINAL stream drain before the failover: frames the
            # kernel buffered before the death survive the process, and
            # the salvage point + chunk slice they carry are fresher
            # than our last applied snapshot — minutes of resume gap
            # become the one burst the frame missed
            self._final_drain()
            if self._drain_requested \
                    and self.supervisor.state(self.id) == STOPPED:
                done = {c.rid for c in self._pending}
                if all(rid in done for rid in self.outstanding):
                    # clean scale-down retirement: every stream this
                    # worker owed is finalized (or pending finalize),
                    # the process exited on its own, nothing to fail
                    # over — the autoscaler reaps the handle
                    self.drained = True
                    return
                # chaos killed the draining worker mid-stream: this IS
                # a failover — the salvage below re-admits the leftovers
            raise ReplicaCrashed(f"worker {self.id}: process down")
        if self._broken:
            self._broken = False
            raise ReplicaCrashed(f"worker {self.id}: rpc failed")
        self._ensure_stream()
        if self._stream is not None:
            try:
                frames = self._stream.drain()
            except RpcError:
                self._drop_stream()
                frames = []
            for f in frames:
                self._last_heartbeat = now
                if f.get("kind") == "pub":
                    self._apply_pub_frame(f)
                elif f.get("kind") == "trace" \
                        and self.trace_collector is not None:
                    # worker spans -> the fleet timeline (the collector
                    # dedups by frame seq and applies the clock offset)
                    self.trace_collector.ingest(self.id, f)
        interval = (self.stream_poll_interval_s
                    if self._stream is not None
                    else self.poll_interval_s)
        if now - self._last_poll < interval:
            return  # stream current / throttled; liveness was checked
        self._last_poll = now
        c = self._client()
        sent_wm = self.consumed
        sent_cwm = self.chunks_consumed
        # reconcile fire-and-forget submits: ask the worker which of
        # the unconfirmed rids it has seen (answered from its dedup
        # map, on the same connection the casts rode)
        asked = list(self._unconfirmed) if self._unconfirmed else None
        extra = {"confirm": asked} if asked else {}
        t0 = self.clock.now()
        try:
            r = c.call("poll", watermark=sent_wm,
                       chunks_watermark=sent_cwm,
                       version=self._pub_version,
                       timeout_s=self.poll_timeout_s, retries=0,
                       **extra)
        except (RpcError, RpcRemoteError):
            hb = self._last_heartbeat
            if hb is None:
                self._last_heartbeat = hb = now
            if now - hb > self.heartbeat_timeout_s:
                # alive by waitpid but silent on the wire: put it down
                # for real so restart machinery takes over
                self.supervisor.kill(self.id, "SIGKILL")
                raise ReplicaCrashed(
                    f"worker {self.id}: heartbeat stale "
                    f"({now - hb:.2f}s)"
                )
            return  # transient blip: skip the tick, keep the salvage
        self._last_heartbeat = now
        self._clock_sample(r, t0, self.clock.now())
        if r.get("unchanged"):
            self._pub_version = r.get("version", self._pub_version)
            if asked:
                self._reconcile_confirm(r.get("confirmed"), asked)
            return  # heartbeat only: salvage/stats still current
        self._apply_snapshot(
            version=r.get("version"), from_wm=sent_wm,
            completions=r["completions"], upto=r["watermark"],
            inflight=r["inflight"], stats=r["stats"],
            chunks=r.get("chunks", ()),
            chunks_from=r.get("chunks_from", sent_cwm),
            chunks_upto=r.get("chunks_watermark"),
        )
        if asked:
            self._reconcile_confirm(r.get("confirmed"), asked)

    def _reconcile_confirm(self, confirmed: Optional[dict],
                           asked: list) -> None:
        """Resolve fire-and-forget submits against the worker's dedup
        answer. True = accepted (confirmed); False = refused at the
        door (draining) — surface a typed "refused" completion so the
        router re-dispatches without burning a retry, the one-way twin
        of `last_submit_refused`; absent = the cast never landed —
        resubmit (idempotent by rid), and after the resubmit budget
        treat the replica as broken so evacuation re-homes the work."""
        if confirmed is None:
            return
        now = self.clock.now()
        for rid in asked:
            if rid not in self._unconfirmed:
                continue  # resolved by a frame in the meantime
            verdict = confirmed.get(str(rid))
            if verdict is True:
                self._unconfirmed.pop(rid, None)
                continue
            if verdict is False:
                self._unconfirmed.pop(rid, None)
                st = self.outstanding.pop(rid, None)
                self._remote_draining = True
                if st is not None:
                    req = st["req"]
                    self._pending.append(Completion(
                        rid=rid, tokens=[], status="refused",
                        arrival=req.arrival, finish=now,
                        ttft=None, tpot=None, flight=None,
                        trace_id=req.trace_id, tenant=req.tenant,
                    ))
                continue
            # never seen by the worker: the one-way frame was lost
            tries = self._unconfirmed.get(rid, 1)
            st = self.outstanding.get(rid)
            if st is None:
                self._unconfirmed.pop(rid, None)
                continue
            if tries >= 3:
                self._unconfirmed.pop(rid, None)
                self._broken = True  # evacuation re-admits it elsewhere
                continue
            c = self._client()
            cast = getattr(c, "cast", None) if c is not None else None
            if cast is None:
                self._unconfirmed.pop(rid, None)
                self._broken = True
                continue
            try:
                cast("submit", request=self._request_dict(st["req"]))
            except (RpcError, RpcRemoteError):
                self._broken = True
                return
            self._unconfirmed[rid] = tries + 1

    def _clock_sample(self, reply: dict, t0: float, t3: float) -> None:
        """Feed one timestamped round trip to the collector's offset
        estimator (every poll/ping reply carries the worker's clock)."""
        if self.trace_collector is None:
            return
        tw = reply.get("t")
        if tw is not None:
            self.trace_collector.add_clock_sample(self.id, t0, tw, t3)

    def measure_clock(self, samples: int = 4) -> Optional[float]:
        """Eagerly sample the worker's clock offset over `samples`
        pings; returns the resulting skew bound (None without a
        collector or a reachable worker). Run against an IDLE fleet
        (fleet build, post-restart probe) the RTT is tens of
        microseconds — far tighter than anything measured mid-decode,
        which is exactly why the eager pass exists: every trace frame
        merged later rides an offset whose error bound was set here."""
        if self.trace_collector is None:
            return None
        c = self._client()
        if c is None:
            return None
        for _ in range(max(1, samples)):
            t0 = self.clock.now()
            try:
                r = c.call("ping", timeout_s=self.poll_timeout_s,
                           retries=0)
            except (RpcError, RpcRemoteError):
                break
            self._clock_sample(r, t0, self.clock.now())
        return self.trace_collector.skew_bound(self.id)

    def set_trace(self, enabled: bool,
                  sample: Optional[float] = None,
                  tenant_rates: Optional[dict] = None) -> bool:
        """Toggle the worker's span recording (the overhead bench's
        on/off lever); `sample` adjusts the worker's head rate in place
        (the sampling bench's per-arm knob, the adaptive controller's
        fleet push), `tenant_rates` replaces its per-tenant override
        table. False when the worker has no tracer or the call failed
        (a disabled plane, not an error)."""
        c = self._client()
        if c is None:
            return False
        try:
            r = c.call("trace", enabled=enabled, sample=sample,
                       tenant_rates=tenant_rates,
                       timeout_s=self.poll_timeout_s)
        except (RpcError, RpcRemoteError):
            return False
        return bool(r.get("supported"))

    def poll(self) -> List[Completion]:
        out, self._pending = self._pending, []
        for comp in out:
            self.outstanding.pop(comp.rid, None)
        return out

    def poll_chunks(self) -> List[TokenChunk]:
        """TokenChunks folded from worker frames since the last call
        (consume-once) — the streaming twin of poll(), same shape as
        the in-process ReplicaHandle's."""
        out, self._pending_chunks = self._pending_chunks, []
        return out

    def evacuate(self) -> List[tuple]:
        # a rid whose COMPLETION already surfaced (the final stream
        # drain beat the failover) finalizes through poll() — salvaging
        # it TOO would deliver prefix + full tokens, a double-count
        done = {c.rid for c in self._pending}
        out = [
            (st["req"], list(st["tokens"]), st["ftt"], st["phases"])
            for rid, st in self.outstanding.items() if rid not in done
        ]
        self.outstanding.clear()
        self._unconfirmed.clear()  # salvage owns the rids now
        return out

    def shed_queued(self, min_priority: int,
                    covers=None, tenants=None) -> List[int]:
        """`covers` (a callable) cannot cross the wire — the remote
        form of a tenant-scoped shed is the `tenants` name list, which
        the worker matches against folded tenant labels. None = shed
        every priority-eligible waiter (the global brown-out)."""
        c = self._client()
        if c is None:
            return []
        try:
            kw = {} if tenants is None else {"tenants": list(tenants)}
            r = c.call("shed", min_priority=min_priority, **kw)
        except (RpcError, RpcRemoteError):
            self._broken = True
            return []
        for rid in r["rids"]:
            self.outstanding.pop(rid, None)
            self._shed_skip.add(rid)
        return list(r["rids"])

    def begin_drain(self) -> None:
        """Handle-side half of a scale-down: stop offering this replica
        to dispatch NOW (before the worker's first refusal can round
        trip) and remember that a coming death is a retirement. The
        process-side half — rpc drain + SIGTERM — is
        `Supervisor.shrink()`."""
        self._drain_requested = True
        self._remote_draining = True

    # ------------------------------------------------------- observables
    @property
    def kv_summary(self) -> Optional[dict]:
        """The worker's last-heartbeat KV/radix-cache summary (blocks
        in use, prefix hit rate, evictable count) — None until a stats
        frame carried one. Federated into per-worker gauges by
        fleet_targets/ScrapeFederator; the groundwork for cache-aware
        routing."""
        return self._stats.get("kv")

    @property
    def load(self) -> float:
        # `outstanding` is this handle's live work SYNCHRONOUSLY (the
        # polled stats lag one heartbeat — a submit burst between polls
        # would otherwise all pile onto the same replica)
        return float(max(
            len(self.outstanding),
            self._stats.get("queue", 0) + self._stats.get("active", 0),
        ))

    @property
    def has_queue_space(self) -> bool:
        if self._remote_draining:
            return False   # drain refusals are certain — stop offering
        return len(self.outstanding) < self._max_queue + self._max_slots

    @property
    def max_slots(self) -> int:
        return self._stats.get("max_slots", self._max_slots)

    @property
    def queue_len(self) -> int:
        return self._stats.get("queue", 0)

    @property
    def active(self) -> int:
        return self._stats.get("active", 0)

    def fits_prompt(self, n_tokens: int) -> bool:
        # conservative client-side mirror of engine.bucket_for — the
        # client knows the spec's buckets (it wrote them)
        return n_tokens <= self._max_bucket

    def stream_fileno(self) -> Optional[int]:
        """Push-stream fd for select()-driven drive loops (None while
        the stream is down — callers fall back to a timed nap)."""
        if self._stream is None:
            return None
        try:
            return self._stream.fileno()
        except OSError:
            return None

    def heartbeat_age(self, now: Optional[float] = None) -> Optional[float]:
        if self._last_heartbeat is None:
            return None
        now = self.clock.now() if now is None else now
        return max(0.0, now - self._last_heartbeat)

    # --------------------------------------------------------- lifecycle
    def probe_ok(self, now: float) -> bool:
        """Health probe for re-admission: a NEW process exists AND
        answers a ping. The router's breaker gates how often this runs
        (half-open backoff)."""
        self.supervisor.poll(now)
        c = self._client()
        if c is None:
            return False
        t0 = self.clock.now()
        try:
            r = c.call("ping", timeout_s=self.poll_timeout_s, retries=0)
        except (RpcError, RpcRemoteError):
            return False
        self._clock_sample(r, t0, self.clock.now())
        return True

    def restart(self) -> None:
        """Join a freshly probed process. Usually that is a NEW
        incarnation (fresh completions list -> watermark 0), but after
        a transport-blip 'death' the SAME process may still be alive —
        then the rpc `reset` drops its stale work (already
        re-dispatched on survivors; letting it finish would
        double-spend the engine) and hands back the completions
        watermark, so the client resyncs instead of replaying the
        whole history against possibly-reused rids. Heartbeat clock
        restarts; outstanding was already evacuated at death."""
        self.consumed = 0
        self.chunks_consumed = 0
        self._pending_chunks.clear()   # old incarnation's, if any
        c = self._client()
        if c is not None:
            try:
                r = c.call("reset", timeout_s=self.poll_timeout_s,
                           retries=0)
                self.consumed = int(r.get("completions", 0))
                self.chunks_consumed = int(r.get("chunks", 0))
            except (RpcError, RpcRemoteError):
                pass  # probe_ok just passed; a blip here resolves via
                #       the normal poll path (worst case: a fresh
                #       process replays nothing anyway)
        self._stats = {}           # also drops any cached digest: a
        #                            fresh radix publishes a new epoch
        self._unconfirmed.clear()  # old incarnation's casts are moot
        self._remote_draining = False
        self.last_submit_refused = False
        self._pub_version = None   # a fresh process numbers its own
        #                            snapshots — never alias the old one's
        self._drop_stream()        # re-subscribes to the NEW process
        self._shed_skip.clear()    # the old process's stream died with it
        if self.trace_collector is not None:
            # new incarnation = new trace-frame numbering AND a new
            # clock domain: re-measure the offset from scratch — NOW,
            # while the freshly probed worker is still idle (tight RTT)
            self.trace_collector.on_worker_restart(self.id)
            self.measure_clock()
        self._last_heartbeat = self.clock.now()
        self._broken = False

    def warmup(self, widths=None) -> None:
        pass  # workers warm before READY; nothing to do from here

    def compile_stats(self) -> dict:
        return self._stats.get("compile_stats", {})


# ------------------------------------------------------------ fleet builder
def make_fleet_router(
    base_spec: WorkerSpec,
    n_workers: int,
    *,
    clock=None,
    config=None,
    sup_config: SupervisorConfig = SupervisorConfig(),
    registry=None,
    tracer=None,
    slo=None,
    telemetry=None,
    ledger=None,
    heartbeat_timeout_s: float = 2.0,
    spawn_fn: Optional[Callable] = None,
):
    """Spawn `n_workers` worker processes from `base_spec` (replica ids
    stamped per slot) and build a Router over their RemoteReplicaHandles
    — the cross-process mirror of serve/router.py `make_router`.
    Returns (router, supervisor, handles); the caller owns
    `supervisor.stop()` (use `with supervisor:`)."""
    from ddp_practice_tpu_torch.serve.metrics import RouterMetrics
    from ddp_practice_tpu_torch.serve.router import Router, RouterConfig

    clock = clock or MonotonicClock()
    specs = [
        dataclasses.replace(base_spec, replica=i) for i in range(n_workers)
    ]
    if base_spec.trace:
        raise NotImplementedError(
            "WorkerSpec.trace: the fleet trace plane (worker span streams "
            "merged by a TraceCollector) is ROADMAP A6d, not ported yet")
    supervisor = Supervisor(specs, sup_config, spawn_fn=spawn_fn,
                            clock=clock)
    try:
        supervisor.start()
    except BaseException:
        supervisor.stop()   # a worker that booted must not outlive this
        raise
    handles = [
        RemoteReplicaHandle(
            i, supervisor, specs[i], clock=clock,
            heartbeat_timeout_s=heartbeat_timeout_s,
        )
        for i in range(n_workers)
    ]
    router = Router(
        handles, clock=clock, config=config or RouterConfig(),
        metrics=RouterMetrics(registry), tracer=tracer,
        slo=slo, telemetry=telemetry, ledger=ledger,
    )
    router.trace_collector = None
    return router, supervisor, handles


def make_federated_server(supervisor: Supervisor,
                          handles, *,
                          port: int = 0, stale_after_s: float = 5.0,
                          autoscaler=None):
    """The reference's fleet-level TelemetryServer over every worker's
    endpoints, built on utils/telemetry.py ScrapeFederator (ROADMAP A6d):
    refused by name until that is ported."""
    raise NotImplementedError(
        "make_federated_server: the fleet scrape federator "
        "(utils/telemetry.py ScrapeFederator) is ROADMAP A6d, not "
        "ported yet")


def fleet_targets(supervisor: Supervisor,
                  handles: List[RemoteReplicaHandle]) -> Dict[int, dict]:
    """The scrape federator's view of the fleet: per slot, where the
    worker's telemetry endpoints live and how fresh its heartbeat is
    (utils/telemetry.py ScrapeFederator consumes this). Keyed by the
    handle's STABLE slot id — an elastic fleet appends slots and
    tombstones shrunk ones, so ids never alias across scale events."""
    out: Dict[int, dict] = {}
    for h in handles:
        w = supervisor.worker(h.id)
        out[h.id] = {
            "host": "127.0.0.1",
            "port": w.telemetry_port if w is not None else None,
            "pid": w.pid if w is not None else None,
            "up": w is not None,
            "state": supervisor.state(h.id),
            "draining": supervisor.draining(h.id),
            "restarts": supervisor.restarts[h.id],
            "heartbeat_age_s": h.heartbeat_age(),
            "kv": h.kv_summary,
        }
    return out
