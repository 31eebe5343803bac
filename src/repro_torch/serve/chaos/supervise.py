"""Failure detection and crash-consistent recovery for a ServingCluster
(the port's copy of ``repro.serve.chaos.supervise``; host logic only).

:class:`ChaosSupervisor` installs itself on a cluster
(``cluster.supervisor = self``) and takes over per-replica stepping:
each live replica's step is priced (sim) or measured (wall), beaten into
the repo's existing :class:`~repro_torch.distributed.fault_tolerance.
HeartbeatRegistry`, and the detection sweep runs once per cluster tick:

* **dead** — a crashed replica stops beating; ``registry.sweep`` trips
  after ``miss_limit`` missed intervals.
* **straggler** — a hung replica keeps beating but its step-time EWMA
  crosses ``straggler_abs_limit_s`` (or the MAD criterion on >= 3
  replicas).  Synchronous serving makes one straggler everyone's
  straggler, so the verdict is the same as death: evict and recover.
* **corrupt** — the engine's drain-side integrity probe
  (``EngineStats.integrity_failures``) moved, or the block pool fails
  ``BlockAllocator.check`` after an eviction/compaction.

Recovery is crash-consistent because prompts are retained on every
``Request``: the router reclaims the dead replica's in-flight requests
(:meth:`~repro_torch.serve.cluster.router.Router.reclaim_replica`) and
re-places each on a survivor under its original cluster id and
``submitted_s``, with a per-request retry budget and exponential
backoff between attempts; requests over budget are abandoned (shed
after admission — loud in ``RouteStats.abandoned``, never silent).
Admission meanwhile brownouts: every surviving controller's SLO token
bucket is tightened to the surviving-capacity fraction.  The failed
replica restarts under a per-replica
:class:`~repro_torch.distributed.fault_tolerance.RestartPolicy` — the
crash-loop breaker quarantines a flapping replica instead of letting it
rejoin forever — and warm-rejoins via the caller's ``engine_factory`` (a fresh engine
over the same weights), a fresh telemetry bind, a
fresh heartbeat identity, and the router resuming placement to it.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Dict, List, Optional

from repro_torch.distributed.fault_tolerance import (HeartbeatRegistry,
                                               RestartPolicy)


@dataclasses.dataclass
class FailureRecord:
    """One detected failure and what recovery did about it."""
    replica: int
    kind: str                      # "dead" | "straggler" | "corrupt"
    t_detect_s: float
    generation: int                # which incarnation failed (0 = original)
    n_reclaimed: int = 0
    n_resubmitted: int = 0
    n_abandoned: int = 0
    t_rejoin_s: Optional[float] = None   # None while down / if quarantined
    quarantined: bool = False

    @property
    def recovery_s(self) -> Optional[float]:
        return (None if self.t_rejoin_s is None
                else self.t_rejoin_s - self.t_detect_s)


@dataclasses.dataclass
class _Retry:
    ready_s: float
    crid: int
    req: object
    failure: "FailureRecord"


class ChaosSupervisor:
    """Detection + recovery policy over one ServingCluster.

    Parameters
    ----------
    cluster:
        The :class:`~repro_torch.serve.cluster.cluster.ServingCluster` to
        supervise; ``cluster.supervisor`` is set to this object.
    clock:
        The shared clock (``SimClock`` or the ``time`` module).
    engine_factory:
        ``factory(i, generation, controller) -> engine`` builds the
        restarted replica ``i`` (wrap it in the fault plan yourself for
        crash-loop drills).  ``None`` disables rejoin: failed replicas
        stay down and the cluster runs degraded.
    step_seconds:
        Optional deterministic step pricer
        (``traffic.unit_latency``-shaped); when None the step wall is
        measured.  A replica's ``wall_scale`` (hang injection) scales
        the priced wall.
    heartbeat_interval_s / miss_limit:
        Failure-detector cadence: a silent replica is dead after
        ``miss_limit`` missed intervals.
    straggler_abs_limit_s:
        Absolute step-time EWMA ceiling (works at any fleet size; the
        MAD criterion also runs when >= 3 replicas are live).  None
        disables straggler eviction.
    retry_budget:
        Cross-failure resubmission attempts per request before it is
        abandoned.
    resubmit_backoff_s:
        Base of the per-request exponential backoff between reclaim and
        resubmit (doubles per attempt).
    """

    def __init__(self, cluster, clock=None, *,
                 engine_factory: Optional[Callable] = None,
                 step_seconds: Optional[Callable] = None,
                 heartbeat_interval_s: float = 1.0,
                 miss_limit: int = 3,
                 straggler_abs_limit_s: Optional[float] = None,
                 retry_budget: int = 3,
                 resubmit_backoff_s: float = 0.5,
                 restart_policy: Optional[Callable[[], RestartPolicy]]
                 = None):
        self.cluster = cluster
        self.clock = clock if clock is not None else _time
        self.engine_factory = engine_factory
        self.step_seconds = step_seconds
        self.straggler_abs_limit_s = straggler_abs_limit_s
        self.retry_budget = retry_budget
        self.resubmit_backoff_s = resubmit_backoff_s
        n = len(cluster.replicas)
        self.registry = HeartbeatRegistry(
            interval_s=heartbeat_interval_s, miss_limit=miss_limit)
        make_policy = restart_policy or (lambda: RestartPolicy(
            backoff_base_s=heartbeat_interval_s, backoff_cap_s=60.0,
            crash_loop_limit=3))
        self.restart_policies = [make_policy() for _ in range(n)]
        self.generation = [0] * n
        self.alive = [True] * n
        self.failures: List[FailureRecord] = []
        self.walls = [0.0] * n
        self._stepped = [False] * n
        self._int_seen = [0] * n          # integrity_failures watermark
        self._pool_seen = [(0, 0)] * n    # (preemptions, compactions)
        self._retries: List[_Retry] = []
        self._attempts: Dict[int, int] = {}     # crid -> resubmit attempts
        self._rejoin_at: Dict[int, float] = {}  # replica -> ready time
        self._open_failure: Dict[int, FailureRecord] = {}
        now = self.clock.time()
        for i in range(n):
            self.registry.register(self._host(i), now=now)
        cluster.supervisor = self

    def _host(self, i: int) -> str:
        return f"replica-{i}.g{self.generation[i]}"

    # -- stepping -------------------------------------------------------------
    def step_replica(self, i: int) -> int:
        """Step replica ``i`` if it is live; price/measure its wall.
        Returns the engine's step() result (0 for a dead replica)."""
        if not self.alive[i]:
            self.walls[i] = 0.0
            self._stepped[i] = False
            return 0
        eng = self.cluster.replicas[i]
        chunks0 = _prefill_units(eng)
        wall0 = _time.perf_counter()
        produced = eng.step()
        if getattr(eng, "crashed", False):
            # the process died inside this tick: no beat, no wall
            self.walls[i] = 0.0
            self._stepped[i] = False
            return produced
        if self.step_seconds is None:
            wall = _time.perf_counter() - wall0
        else:
            wall = self.step_seconds(eng, _prefill_units(eng) - chunks0,
                                     eng._pending is not None)
        self.walls[i] = wall * getattr(eng, "wall_scale", 1.0)
        self._stepped[i] = True
        return produced

    # -- the per-tick sweep ---------------------------------------------------
    def after_tick(self) -> List[FailureRecord]:
        """Heartbeats, detection, recovery and rejoin — run once per
        cluster tick AFTER the shared clock advanced, so the failure
        detector sees the tick's time passing."""
        now = self.clock.time()
        newly: List[FailureRecord] = []
        for i in range(len(self.cluster.replicas)):
            if self.alive[i] and self._stepped[i]:
                self.registry.beat(self._host(i), self.walls[i], now=now)
        # corrupt: drain-probe watermark + pool audit on eviction traffic
        for i, eng in enumerate(self.cluster.replicas):
            if not self.alive[i]:
                continue
            if getattr(eng.stats, "integrity_failures", 0) > self._int_seen[i]:
                newly.append(self._fail(i, "corrupt", now))
                continue
            if not self._pool_ok(i, eng):
                newly.append(self._fail(i, "corrupt", now))
        # dead: missed heartbeats
        host_to_i = {self._host(i): i
                     for i in range(len(self.cluster.replicas))
                     if self.alive[i]}
        for host in self.registry.sweep(now=now):
            i = host_to_i.get(host)
            if i is not None and self.alive[i]:
                newly.append(self._fail(i, "dead", now))
        # stragglers: inflated-but-beating replicas.  Only the ABSOLUTE
        # ceiling votes here: the registry's MAD criterion assumes the
        # near-uniform step walls of synchronous SPMD training, and a
        # serving fleet under skewed load legitimately has one busy
        # replica walking away from idle peers — MAD would evict the
        # healthy busy one.  The cost model gives us the healthy step
        # price, so the ceiling is the calibrated signal.
        if self.straggler_abs_limit_s is not None:
            for host in self.registry.stragglers(
                    z_threshold=float("inf"),
                    abs_limit_s=self.straggler_abs_limit_s):
                i = host_to_i.get(host)
                if i is not None and self.alive[i]:
                    newly.append(self._fail(i, "straggler", now))
        self._pump_retries(now)
        self._pump_rejoins(now)
        # hygiene: retry counters for requests that completed (collected
        # by the router) or were abandoned must not accumulate forever
        tracked = (set(self.cluster.router._local)
                   | {r.crid for r in self._retries})
        self._attempts = {c: a for c, a in self._attempts.items()
                          if c in tracked}
        return newly

    def _pool_ok(self, i: int, eng) -> bool:
        """Audit the block pool when eviction/compaction traffic moved
        (the cheap moments a poisoned free list becomes reachable)."""
        alloc = getattr(eng, "allocator", None)
        if alloc is None:
            return True
        st = eng.stats
        marks = (st.preemptions, st.compactions)
        if marks == self._pool_seen[i]:
            return True
        self._pool_seen[i] = marks
        try:
            alloc.check()
            return True
        except AssertionError:
            return False

    # -- failure --------------------------------------------------------------
    def _fail(self, i: int, kind: str, now: float) -> FailureRecord:
        """Declare replica ``i`` failed: stop routing to it, reclaim its
        requests, brownout admission, schedule restart."""
        router = self.cluster.router
        self.alive[i] = False
        router.set_live(i, False)
        self.registry.deregister(self._host(i))
        rec = FailureRecord(i, kind, now, self.generation[i])
        tel = self.cluster.telemetry
        if tel is not None and hasattr(tel, "tag_dead"):
            tel.tag_dead(i, now, kind)
        # reclaim + resubmit-with-backoff (or abandon over budget)
        reclaimed = router.reclaim_replica(i)
        rec.n_reclaimed = len(reclaimed)
        for crid, req in reclaimed:
            attempts = self._attempts.get(crid, 0)
            if attempts >= self.retry_budget:
                router.abandon(crid)
                self._attempts.pop(crid, None)
                rec.n_abandoned += 1
                continue
            self._attempts[crid] = attempts + 1
            delay = self.resubmit_backoff_s * (2 ** attempts)
            self._retries.append(_Retry(now + delay, crid, req, rec))
        # brownout: tighten every surviving bucket to surviving capacity
        live = router.live_indices()
        if tel is not None and live:
            frac = len(live) / len(self.cluster.replicas)
            for j in live:
                ctrl = tel.controllers[j]
                if getattr(ctrl, "bucket", None) is not None:
                    ctrl.bucket.tighten(frac)
        # restart under the crash-loop breaker
        if self.engine_factory is not None:
            backoff = self.restart_policies[i].on_failure(now)
            if backoff is None:
                rec.quarantined = True
            else:
                self._rejoin_at[i] = now + backoff
        self.failures.append(rec)
        self._open_failure[i] = rec
        return rec

    # -- recovery pumps -------------------------------------------------------
    def _pump_retries(self, now: float) -> None:
        due = [r for r in self._retries if r.ready_s <= now]
        if not due:
            return
        self._retries = [r for r in self._retries if r.ready_s > now]
        router = self.cluster.router
        for r in due:
            if router.resubmit(r.crid, r.req):
                r.failure.n_resubmitted += 1
                continue
            # no live capacity: retry again later (or abandon over budget)
            attempts = self._attempts.get(r.crid, 0)
            if attempts >= self.retry_budget:
                router.abandon(r.crid)
                self._attempts.pop(r.crid, None)
                r.failure.n_abandoned += 1
            else:
                self._attempts[r.crid] = attempts + 1
                delay = self.resubmit_backoff_s * (2 ** attempts)
                self._retries.append(_Retry(now + delay, r.crid, r.req,
                                            r.failure))

    def _pump_rejoins(self, now: float) -> None:
        for i in [i for i, t in list(self._rejoin_at.items()) if t <= now]:
            del self._rejoin_at[i]
            self._rejoin(i, now)

    def _rejoin(self, i: int, now: float) -> None:
        """Warm-rejoin a restarted replica: fresh engine, fresh telemetry
        bind, fresh heartbeat identity, router routing to it again."""
        self.generation[i] += 1
        tel = self.cluster.telemetry
        ctrl = (tel.rebind(i) if tel is not None and hasattr(tel, "rebind")
                else None)
        eng = self.engine_factory(i, self.generation[i], ctrl)
        self.cluster.replace_replica(i, eng)
        self.registry.register(self._host(i), now=now)
        self.cluster.router.set_live(i, True)
        self.alive[i] = True
        self._int_seen[i] = 0
        self._pool_seen[i] = (0, 0)
        rec = self._open_failure.pop(i, None)
        if rec is not None:
            rec.t_rejoin_s = now

    # -- introspection --------------------------------------------------------
    @property
    def idle(self) -> bool:
        """No recovery work outstanding (retries queued or rejoins
        scheduled)."""
        return not self._retries and not self._rejoin_at

    def resubmitted_count(self) -> int:
        return self.cluster.router.stats.recovered


def _prefill_units(engine) -> int:
    st = engine.stats
    return st.prefill_chunks if getattr(engine, "chunk_size", None) else \
        st.prefills
