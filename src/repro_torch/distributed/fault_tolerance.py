"""Fault-tolerance runtime: heartbeats, straggler detection, restart
policy (the port's copy of ``repro.distributed.fault_tolerance``; stdlib
only).

The registry is in-process; the POLICY layer, what the framework does
about missing heartbeats and stragglers, is the production logic:

  * straggler mitigation: per-host step-time EWMA; hosts slower than
    `z_threshold` MADs from the fleet median are flagged, and the policy
    recommends checkpoint-and-evict before they stall the collectives
    (synchronous SPMD makes one straggler everyone's straggler);
  * failure handling: hosts missing `miss_limit` consecutive heartbeats are
    declared dead -> policy = restart from the last complete checkpoint
    with a re-formed (elastic) mesh;
  * restart budget: exponential backoff with a crash-loop breaker.

The serving cluster's chaos supervisor (``serve.chaos.supervise``) drives
the registry and the restart policy.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional


@dataclasses.dataclass
class HostState:
    host_id: str
    last_heartbeat: float = 0.0
    missed: int = 0
    step_times: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=32))
    ewma_s: float = 0.0
    alive: bool = True


class HeartbeatRegistry:
    """Membership is dynamic: the constructor list is a convenience for
    a fixed fleet, while :meth:`register`/:meth:`deregister` admit and
    remove hosts at runtime — a restarted replica rejoins under a fresh
    host id (its EWMA history died with the old process), and a declared-
    dead host is deregistered so it stops skewing the straggler median.
    ``beat`` for an unregistered host stays a loud ``KeyError``:
    membership changes are an explicit supervisor action, never a side
    effect of a stray heartbeat."""

    def __init__(self, hosts: Optional[List[str]] = None, *,
                 interval_s: float = 10.0,
                 miss_limit: int = 3, ewma_alpha: float = 0.2):
        self.hosts: Dict[str, HostState] = {h: HostState(h)
                                            for h in (hosts or ())}
        self.interval_s = interval_s
        self.miss_limit = miss_limit
        self.alpha = ewma_alpha

    # -- membership ----------------------------------------------------------
    def register(self, host_id: str,
                 now: Optional[float] = None) -> HostState:
        """Admit a host (idempotent reset if already present): fresh
        state, first heartbeat stamped now — a just-joined host must not
        be instantly dead because its ``last_heartbeat`` is 0."""
        st = HostState(host_id)
        st.last_heartbeat = time.time() if now is None else now
        self.hosts[host_id] = st
        return st

    def deregister(self, host_id: str) -> None:
        """Remove a host from membership (no-op if absent).  Its beats
        raise ``KeyError`` until it registers again."""
        self.hosts.pop(host_id, None)

    def beat(self, host_id: str, step_time_s: Optional[float] = None,
             now: Optional[float] = None):
        st = self.hosts[host_id]
        st.last_heartbeat = time.time() if now is None else now
        st.missed = 0
        st.alive = True
        if step_time_s is not None:
            st.step_times.append(step_time_s)
            st.ewma_s = (step_time_s if st.ewma_s == 0.0
                         else self.alpha * step_time_s
                         + (1 - self.alpha) * st.ewma_s)

    def sweep(self, now: Optional[float] = None) -> List[str]:
        """Advance failure detection; returns newly-dead host ids."""
        now = time.time() if now is None else now
        dead = []
        for st in self.hosts.values():
            if not st.alive:
                continue
            st.missed = int((now - st.last_heartbeat) / self.interval_s)
            if st.missed >= self.miss_limit:
                st.alive = False
                dead.append(st.host_id)
        return dead

    def alive_hosts(self) -> List[str]:
        return [h for h, st in self.hosts.items() if st.alive]

    # -- straggler detection -------------------------------------------------
    def stragglers(self, z_threshold: float = 4.0,
                   abs_limit_s: Optional[float] = None) -> List[str]:
        """Hosts whose step-time EWMA is an outlier.  The MAD criterion
        needs >= 3 live hosts (a median of two cannot vote); ``abs_limit_s``
        adds an absolute ceiling that works at any fleet size — a
        two-replica cluster flags a hung peer against the known-healthy
        step price instead of a majority it doesn't have."""
        ew = {h: st.ewma_s for h, st in self.hosts.items()
              if st.alive and st.ewma_s > 0}
        out = []
        if abs_limit_s is not None:
            out = [h for h, v in ew.items() if v > abs_limit_s]
        if len(ew) < 3:
            return out
        vals = sorted(ew.values())
        med = vals[len(vals) // 2]
        mad = sorted(abs(v - med) for v in vals)[len(vals) // 2]
        mad = max(mad, 1e-3 * med, 1e-9)
        return sorted(set(out) | {h for h, v in ew.items()
                                  if (v - med) / mad > z_threshold})


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 20
    backoff_base_s: float = 5.0
    backoff_cap_s: float = 300.0
    window_s: float = 3600.0
    crash_loop_limit: int = 5

    def __post_init__(self):
        self._restarts: deque = deque()

    def on_failure(self, now: Optional[float] = None) -> Optional[float]:
        """Returns backoff seconds before restarting, or None = give up."""
        now = time.time() if now is None else now
        while self._restarts and now - self._restarts[0] > self.window_s:
            self._restarts.popleft()
        if len(self._restarts) >= self.crash_loop_limit:
            return None
        self._restarts.append(now)
        n = len(self._restarts)
        if n > self.max_restarts:
            return None
        return min(self.backoff_base_s * 2 ** (n - 1), self.backoff_cap_s)


@dataclasses.dataclass
class FaultEvent:
    kind: str          # "dead_host" | "straggler" | "restart"
    host: str
    step: int
    action: str


class FaultTolerantRunner:
    """Glue: registry + policy + checkpoint manager -> step-loop callbacks."""

    def __init__(self, registry: HeartbeatRegistry,
                 policy: Optional[RestartPolicy] = None):
        self.registry = registry
        self.policy = policy or RestartPolicy()
        self.events: List[FaultEvent] = []

    def on_step(self, host_id: str, step: int, step_time_s: float,
                now: Optional[float] = None) -> List[FaultEvent]:
        self.registry.beat(host_id, step_time_s, now=now)
        out = []
        for dead in self.registry.sweep(now=now):
            out.append(FaultEvent("dead_host", dead, step,
                                  "restore_last_checkpoint+elastic_remesh"))
        for slow in self.registry.stragglers():
            out.append(FaultEvent("straggler", slow, step,
                                  "checkpoint_and_evict"))
        self.events.extend(out)
        return out
