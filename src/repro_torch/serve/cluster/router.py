"""The cluster's front door (the port's copy of
``repro.serve.cluster.router``): one :class:`Router` in front of N engine
replicas, owning the cluster-wide request id space and the two routing
decisions — where a fresh request lands (``policy.place``) and whether
an eviction victim moves to another replica (``policy.reroute``).

The router does NOT re-implement batching.  Each replica keeps its own
shadow-step pipeline (chunked prefill, fused decode, preemption) exactly
as a bare engine; the router only chooses which replica's ``submit``
a request reaches, then sweeps finished requests out of the replicas'
``done`` dicts into its own, keyed by cluster id.  That is what makes
admission O(1) per request regardless of replica count: continuous
batching stays inside each replica, and cross-replica work only happens
at the two seams (placement, eviction).

Re-routing rides the scheduler's ``requeue_policy`` hook: when a replica
evicts a victim, the router's reclaim closure asks the policy whether
another replica would finish it sooner (counting the route traffic —
see ``CostAwarePolicy.reroute``).  If yes, the victim is re-submitted to
the target WITH ITS ORIGINAL ``submitted_s`` so latency accounting
survives the move, and the closure returns True — the source scheduler
drops it.  If no (or the request already moved ``max_reroutes`` times —
a ping-pong damper), the closure returns False and the source
front-requeues as a single-replica engine would.  The port's paged
engine evicts through ``scheduler.requeue`` (``_evict_for``), so every
eviction reaches the closure; the slot engine never evicts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.cluster.policy import (PlacementPolicy,
                                              make_policy,
                                              predicted_queue_seconds)


@dataclasses.dataclass
class RouteStats:
    """Cumulative router counters (the cluster-tier analogue of
    ``EngineStats``)."""
    submitted: int = 0              # requests accepted and placed
    shed: int = 0                   # requests refused at admission
    reroutes: int = 0               # eviction victims moved cross-replica
    front_requeues: int = 0         # eviction victims kept on their source
    decisions: int = 0              # placement + reroute decisions taken
    recovered: int = 0              # reclaimed from a dead replica, re-placed
    abandoned: int = 0              # reclaimed but shed (retry budget spent)
    routed: List[int] = dataclasses.field(default_factory=list)  # per replica


class Router:
    """Place requests across replicas; reclaim eviction victims.

    Parameters
    ----------
    replicas:
        Live engine objects (``ServingEngine`` or ``PagedServingEngine``).
        Replicas with a chunked-prefill scheduler get the reclaim closure
        installed on ``scheduler.requeue_policy``; slot engines never
        preempt, so they route at placement only.
    policy:
        A :class:`PlacementPolicy` instance or its name
        ('round_robin' | 'least_loaded' | 'cost_aware').
    shed_wait_s:
        Optional admission ceiling: a request whose chosen replica already
        carries more than this many predicted queue-seconds is SHED
        (``submit`` returns None) instead of enqueued.  None = never shed.
    max_reroutes:
        Per-request cap on cross-replica moves; after this many the
        victim always front-requeues at its current replica.
    """

    def __init__(self, replicas: List, policy="cost_aware",
                 shed_wait_s: Optional[float] = None,
                 max_reroutes: int = 3):
        if not replicas:
            raise ValueError("Router needs at least one replica")
        self.replicas = list(replicas)
        self.policy: PlacementPolicy = make_policy(policy)
        self.shed_wait_s = shed_wait_s
        self.max_reroutes = max_reroutes
        self.done: Dict[int, object] = {}           # crid -> Request
        self.stats = RouteStats(routed=[0] * len(self.replicas))
        self._next_crid = 0
        self._local: Dict[int, Tuple[int, int]] = {}    # crid -> (i, rid)
        self._origin: Dict[Tuple[int, int], int] = {}   # (i, rid) -> crid
        self._moves: Dict[int, int] = {}                # crid -> reroute count
        self._live: List[bool] = [True] * len(self.replicas)
        for i, eng in enumerate(self.replicas):
            self._install_reclaim(i, eng)

    def _install_reclaim(self, i: int, eng) -> None:
        sched = getattr(eng, "scheduler", None)
        if sched is not None:
            if sched.requeue_policy is not None:
                raise ValueError(
                    f"replica {i} already has a requeue_policy; "
                    f"a replica can serve at most one router")
            sched.requeue_policy = self._make_reclaim(i)

    # -- liveness -------------------------------------------------------------
    def live_indices(self) -> List[int]:
        return [i for i in range(len(self.replicas)) if self._live[i]]

    def set_live(self, i: int, alive: bool) -> None:
        """Mark a replica (in)eligible for placement and reroute.  A dead
        replica keeps its slot in ``replicas`` (indices stay stable for
        bookkeeping and warm-rejoin); it simply stops receiving work."""
        self._live[i] = bool(alive)

    # -- admission ------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               eos_id: Optional[int] = None) -> Optional[int]:
        """Place one request; returns its cluster id, or None if shed."""
        live = self.live_indices()
        if not live:
            self.stats.shed += 1            # total outage: shed at the door
            return None
        self.stats.decisions += 1
        i = live[self.policy.place(len(prompt), max_new_tokens,
                                   [self.replicas[j] for j in live])]
        if (self.shed_wait_s is not None
                and predicted_queue_seconds(self.replicas[i])
                > self.shed_wait_s):
            self.stats.shed += 1
            return None
        rid = self.replicas[i].submit(prompt, max_new_tokens=max_new_tokens,
                                      eos_id=eos_id)
        crid = self._next_crid
        self._next_crid += 1
        self._local[crid] = (i, rid)
        self._origin[(i, rid)] = crid
        self.stats.submitted += 1
        self.stats.routed[i] += 1
        return crid

    # -- eviction reclaim -----------------------------------------------------
    def _make_reclaim(self, src: int):
        def reclaim(req) -> bool:
            crid = self._origin.get((src, req.rid))
            if crid is None:            # not router-owned (direct submit)
                return False
            self.stats.decisions += 1
            if self._moves.get(crid, 0) >= self.max_reroutes:
                self.stats.front_requeues += 1
                return False
            # reroute candidates: live replicas (plus the source itself,
            # whose index the policy needs for its stay-vs-move price)
            cand = [j for j in range(len(self.replicas))
                    if self._live[j] or j == src]
            tgt_k = self.policy.reroute(req, cand.index(src),
                                        [self.replicas[j] for j in cand])
            tgt = None if tgt_k is None else cand[tgt_k]
            if tgt is None or tgt == src:
                self.stats.front_requeues += 1
                return False
            self._move(crid, req, src, tgt)
            return True
        return reclaim

    def _move(self, crid: int, req, src: int, tgt: int) -> None:
        """Re-submit an eviction victim on ``tgt``.  The victim replays
        from scratch there (its KV was freed by the eviction); keeping
        the original ``submitted_s`` keeps its latency honest."""
        del self._origin[(src, self._local[crid][1])]
        new_rid = self.replicas[tgt].submit(
            req.prompt, max_new_tokens=req.max_new_tokens,
            eos_id=req.eos_id, submitted_s=req.submitted_s)
        self._local[crid] = (tgt, new_rid)
        self._origin[(tgt, new_rid)] = crid
        self._moves[crid] = self._moves.get(crid, 0) + 1
        self.stats.reroutes += 1
        self.stats.routed[tgt] += 1

    # -- failure recovery -----------------------------------------------------
    def reclaim_replica(self, i: int) -> List[Tuple[int, object]]:
        """Pull every router-owned request off a failed replica.

        Returns ``[(crid, request), ...]`` — the prompts are retained on
        ``Request``, so each one can replay from scratch elsewhere
        (:meth:`resubmit`).  All bookkeeping for the reclaimed ids is
        dropped here; the dead replica's internal state is NOT mutated
        (a crashed process can't be asked to clean up).  Requests that
        already finished on the replica but were never collected are
        reclaimed too: a dead replica's uncollected output is treated as
        lost and recomputed, which keeps recovery independent of how far
        the crash let the final drain get."""
        eng = self.replicas[i]
        by_rid: Dict[int, object] = {}
        for req in list(getattr(eng, "queue", ()) or ()):   # still waiting
            by_rid[req.rid] = req
        for row in getattr(eng, "rows", None) or ():        # paged rows
            if row is not None:
                by_rid[row.req.rid] = row.req
        for req in getattr(eng, "slot_req", None) or ():    # slot engine
            if req is not None:
                by_rid[req.rid] = req
        by_rid.update(eng.done)                             # uncollected
        out = []
        for crid in sorted(c for c, (j, _) in self._local.items() if j == i):
            _, rid = self._local.pop(crid)
            self._origin.pop((i, rid), None)
            self._moves.pop(crid, None)
            req = by_rid.get(rid)
            if req is None:
                raise KeyError(
                    f"crid {crid} (replica {i} rid {rid}) is tracked by "
                    f"the router but not found on the replica — "
                    f"bookkeeping is corrupt")
            out.append((crid, req))
        return out

    def resubmit(self, crid: int, req) -> bool:
        """Re-place one reclaimed request on a live replica UNDER ITS
        ORIGINAL cluster id and ``submitted_s`` (recovery must not
        launder latency).  Returns False when no replica is live — the
        caller decides between retrying later and :meth:`abandon`."""
        if crid in self._local:
            raise ValueError(f"crid {crid} is still tracked; reclaim it "
                             f"before resubmitting")
        live = self.live_indices()
        if not live:
            return False
        self.stats.decisions += 1
        i = live[self.policy.place(len(req.prompt), req.max_new_tokens,
                                   [self.replicas[j] for j in live])]
        rid = self.replicas[i].submit(
            req.prompt, max_new_tokens=req.max_new_tokens,
            eos_id=req.eos_id, submitted_s=req.submitted_s)
        self._local[crid] = (i, rid)
        self._origin[(i, rid)] = crid
        self.stats.recovered += 1
        self.stats.routed[i] += 1
        return True

    def abandon(self, crid: int) -> None:
        """Give up on a reclaimed request (retry budget exhausted or no
        capacity).  The id is gone from all bookkeeping after reclaim;
        this just records the shed-after-admission outcome."""
        self.stats.abandoned += 1

    def replace_replica(self, i: int, engine) -> None:
        """Swap a (restarted) engine into slot ``i`` and install the
        reclaim closure on it.  Does NOT flip liveness — the supervisor
        marks the slot live once the rejoin is complete."""
        self.replicas[i] = engine
        self._install_reclaim(i, engine)

    # -- completion -----------------------------------------------------------
    def collect(self) -> int:
        """Sweep finished requests from every replica's ``done`` dict into
        ``self.done`` keyed by cluster id.  Returns how many moved this
        sweep.  Non-router-owned requests are left in place."""
        n = 0
        for i, eng in enumerate(self.replicas):
            for rid in [r for r in eng.done if (i, r) in self._origin]:
                crid = self._origin.pop((i, rid))
                self.done[crid] = eng.done.pop(rid)
                del self._local[crid]
                self._moves.pop(crid, None)
                n += 1
        return n

    # -- introspection --------------------------------------------------------
    @property
    def in_flight(self) -> int:
        """Router-owned requests admitted but not yet collected."""
        return len(self._local)

    def assert_drained(self) -> None:
        """Invariant check for a fully-drained trace: every admitted
        request was collected and every per-request bookkeeping dict
        (``_local``, ``_origin`` and the ``_moves`` reroute counters —
        all pruned by ``collect``) is empty.  A leftover entry means a
        per-request leak: the dicts would grow without bound on a
        long-running cluster.  Call after ``run_until_done`` /
        a drained acceptance trace; raises AssertionError with the
        leaked ids."""
        leaks = {name: d for name, d in (("_local", self._local),
                                         ("_origin", self._origin),
                                         ("_moves", self._moves)) if d}
        assert not leaks, (
            "router bookkeeping leaked after drain: "
            + "; ".join(f"{k}={sorted(v)!r}" for k, v in leaks.items()))

    def queue_depths(self) -> List[int]:
        return [len(eng.queue) for eng in self.replicas]

    def predicted_waits(self) -> List[float]:
        return [predicted_queue_seconds(eng) for eng in self.replicas]
