"""One chaos drill, end to end, with the invariants checked (the port's
copy of ``repro.serve.chaos.drill``; the fake model's tensors on
``device``, the card unless the caller asks for the CPU).

:func:`run_chaos_drill` plays the SAME deterministic skewed trace twice
— once on a fault-free twin cluster, once under a :class:`FaultPlan`
with a :class:`ChaosSupervisor` — and gates the recovery claims the
campaign and CI rely on:

* ``survivors_identical`` — every request the chaos run completed whose
  cluster id also completed fault-free has byte-identical tokens, and
  every completed request matches ``expected_tokens`` exactly (recovery
  replays from the retained prompt, so even a twice-moved request must
  land on the same ids).
* ``tokens_lost == 0`` — completed requests are never short a token:
  the drain-drop + replay path recomputes, it never truncates.
* ``blocks_leaked == 0`` and ``BlockAllocator.check`` on every LIVE
  replica after the final flush (a dead replica's pool died with its
  process — it is replaced, not audited).
* ``assert_drained`` — router bookkeeping is empty: everything admitted
  was collected or loudly abandoned within the retry budget.

Everything runs under a :class:`~repro_torch.serve.sim.SimClock` with the
``unit_latency`` step pricer, so the whole drill — fault instant,
detection latency, backoff, rejoin — is an exact computation.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np

from repro_torch.serve.chaos.faults import FaultPlan
from repro_torch.serve.chaos.supervise import ChaosSupervisor
from repro_torch.serve.cluster.cluster import ServingCluster
from repro_torch.serve.cluster.traffic import skewed_trace, unit_latency
from repro_torch.serve.sim import (FakeCostModel, FakeModel, SimClock,
                             expected_tokens)

# one shared sim shape for every drill (mirrors tests/test_cluster.py)
VOCAB = 97
ENGINE_KW = dict(max_batch=4, max_len=64, n_blocks=24, block_size=8,
                 chunk_size=8)
DECODE_S, CHUNK_S, OVERHEAD_S = 0.5, 0.25, 0.01


def _build(n_replicas: int, clock, plan: Optional[FaultPlan],
           telemetry=None, policy: str = "cost_aware", device=None):
    """A paged cluster over FakeModel replicas, optionally fault-wrapped,
    the fake's tensors on ``device`` (the card by default)."""
    from repro_torch.serve.engine import PagedServingEngine
    model = FakeModel(vocab=VOCAB, device=device)
    cost = FakeCostModel(decode_s=DECODE_S, prefill_s=CHUNK_S)

    def make_engine(i: int, controller=None):
        return PagedServingEngine(model, None, clock=clock, cost_model=cost,
                                  telemetry=controller, **ENGINE_KW)

    replicas = []
    for i in range(n_replicas):
        ctrl = telemetry.controller(i) if telemetry is not None else None
        eng = make_engine(i, ctrl)
        if plan is not None:
            eng = plan.wrap(eng, i, 0, clock=clock)
        replicas.append(eng)
    cluster = ServingCluster(replicas, policy=policy, telemetry=telemetry)
    return cluster, make_engine


def _armed_crash(eng) -> bool:
    """True while a wrapped replica still carries an unfired crash spec
    (it steps every tick, so the spec WILL fire in bounded ticks)."""
    specs = getattr(eng, "specs", None)
    if not specs:
        return False
    return any(s.kind in ("crash", "crashloop") and eng.calls <= s.at_step
               for s in specs)


def _drive(cluster, arrivals, clock, *, supervisor: Optional[ChaosSupervisor],
           max_ticks: int, min_dt: float = 0.25) -> Dict[int, int]:
    """serve_trace with the supervisor in the loop: per tick, submit due
    arrivals, step every replica through the supervisor (priced walls,
    heartbeats), advance the shared clock by the max wall, then run the
    detection/recovery sweep.  Returns ``{crid: trace_index}``."""
    step_seconds = unit_latency(DECODE_S, CHUNK_S, OVERHEAD_S)
    pending = deque(sorted(enumerate(arrivals), key=lambda a: a[1][0]))
    admitted: Dict[int, int] = {}
    router = cluster.router
    for _ in range(max_ticks):
        now = clock.time()
        while pending and pending[0][1][0] <= now:
            k, (t, prompt, max_new, eos) = pending.popleft()
            crid = cluster.submit(np.asarray(prompt, np.int32),
                                  max_new_tokens=max_new, eos_id=eos)
            if crid is not None:
                admitted[crid] = k
        dt = min_dt
        if supervisor is not None:
            for i in range(len(cluster.replicas)):
                supervisor.step_replica(i)
                dt = max(dt, supervisor.walls[i])
        else:
            from repro_torch.serve.cluster.traffic import _prefill_units
            for eng in cluster.replicas:
                c0 = _prefill_units(eng)
                eng.step()
                dt = max(dt, step_seconds(eng, _prefill_units(eng) - c0,
                                          eng._pending is not None))
        clock.advance(dt)
        router.collect()
        if supervisor is not None:
            supervisor.after_tick()
        live = (cluster.replicas if supervisor is None
                else [cluster.replicas[j] for j in router.live_indices()])
        # an exit while a crashed replica is still awaiting its death
        # verdict — or while a crash spec is armed but unfired (a
        # replica rejoined on this very tick hasn't stepped yet) —
        # would end the drill mid-detection and the crash-loop breaker
        # would never trip; keep ticking until the failure detector has
        # nothing left to say
        undetected = any(getattr(eng, "crashed", False) or _armed_crash(eng)
                         for eng in live)
        if (not pending and router.in_flight == 0
                and not any(len(eng.queue) for eng in live)
                and not undetected
                and (supervisor is None or supervisor.idle)):
            break
    for eng in (cluster.replicas if supervisor is None
                else [cluster.replicas[j] for j in router.live_indices()]):
        if eng._pending is not None:
            eng._drain(eng._pending)
            eng._pending = None
    router.collect()
    return admitted


def run_chaos_drill(fault: str, n_replicas: int, *, n_requests: int = 12,
                    seed: int = 0, max_ticks: int = 600,
                    device=None) -> Dict[str, object]:
    """Run one ``{fault} x {n_replicas}`` drill; returns the flat metrics
    dict the campaign cell consumes.  ``device`` holds the fake model's
    tensors (None: the card); the dict does not depend on it."""
    from repro_torch.serve.cluster.metrics import ClusterTelemetry
    from repro_torch.serve.sim import work_latency_model
    from repro_torch.serve.telemetry.slo import SLO

    trace = skewed_trace(n_requests, vocab=VOCAB, period=2, long_len=24,
                         short_len=4, long_new=12, short_new=4,
                         interval_s=1.0, load=2.0)
    plan = FaultPlan.random(fault, n_replicas, seed)

    # --- fault-free twin -----------------------------------------------------
    clock0 = SimClock()
    base, _ = _build(n_replicas, clock0, plan=None, device=device)
    base_admitted = _drive(base, trace, clock0, supervisor=None,
                           max_ticks=max_ticks)
    base_tokens = {k: list(base.done[crid].tokens)
                   for crid, k in base_admitted.items()}

    # --- the chaos run -------------------------------------------------------
    clock = SimClock()
    latency = work_latency_model(DECODE_S, CHUNK_S, OVERHEAD_S)
    tel = ClusterTelemetry(n_replicas, latency_model=latency,
                           slo=SLO(target_p99_s=60.0))
    cluster, make_engine = _build(n_replicas, clock, plan=plan, telemetry=tel,
                                  device=device)

    def factory(i: int, generation: int, controller):
        return plan.wrap(make_engine(i, controller), i, generation,
                         clock=clock)

    sup = ChaosSupervisor(
        cluster, clock, engine_factory=factory,
        step_seconds=unit_latency(DECODE_S, CHUNK_S, OVERHEAD_S),
        heartbeat_interval_s=1.0, miss_limit=3,
        straggler_abs_limit_s=4.0 * (DECODE_S + OVERHEAD_S),
        retry_budget=3, resubmit_backoff_s=0.5)
    admitted = _drive(cluster, trace, clock, supervisor=sup,
                      max_ticks=max_ticks)

    # --- the invariants ------------------------------------------------------
    router = cluster.router
    done_tokens = {admitted[crid]: list(req.tokens)
                   for crid, req in router.done.items() if crid in admitted}
    exact = all(
        toks == expected_tokens(trace[k][1], trace[k][2], VOCAB, trace[k][3])
        for k, toks in done_tokens.items())
    survivors_identical = exact and all(
        done_tokens[k] == base_tokens[k]
        for k in done_tokens if k in base_tokens)
    tokens_lost = sum(
        max(0, len(expected_tokens(trace[k][1], trace[k][2], VOCAB,
                                   trace[k][3])) - len(toks))
        for k, toks in done_tokens.items())
    router.assert_drained()
    live = router.live_indices()
    blocks_leaked = 0
    for j in live:
        eng = cluster.replicas[j]
        eng.allocator.check()
        blocks_leaked += eng.allocator.n_in_use
    recoveries = [f.recovery_s for f in sup.failures
                  if f.recovery_s is not None]
    completed_or_abandoned = (len(done_tokens) + router.stats.abandoned
                              >= len(admitted))
    return {
        "fault": fault,
        "replicas": n_replicas,
        "n_requests": n_requests,
        "admitted": len(admitted),
        "completed": len(done_tokens),
        "shed": router.stats.shed,
        "abandoned": router.stats.abandoned,
        "recovered": router.stats.recovered,
        "failures": len(sup.failures),
        "failure_kinds": ",".join(sorted({f.kind for f in sup.failures})),
        "quarantined": any(f.quarantined for f in sup.failures),
        "reclaimed": sum(f.n_reclaimed for f in sup.failures),
        "recovery_latency_s": max(recoveries) if recoveries else 0.0,
        "survivors_identical": bool(survivors_identical),
        "all_accounted": bool(completed_or_abandoned),
        "tokens_lost": int(tokens_lost),
        "blocks_leaked": int(blocks_leaked),
        "live_replicas": len(live),
        "t_end_s": clock.time(),
    }
