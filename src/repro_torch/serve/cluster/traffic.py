"""Traffic generation and the cluster's trace loop (the port's copy of
``repro.serve.cluster.traffic``).

:func:`skewed_trace` builds the campaign's adversarial workload: every
``period``-th request is LONG (big prompt, many new tokens), the rest
short.  With ``period == n_replicas`` a round-robin router lands every
long request on the same replica — the pathological case the
cost-model-aware policy is supposed to dissolve — while arrival times
stay a deterministic function of the offered ``load``.

:func:`serve_trace` is the cluster analogue of ``serve.sim.drive``,
with one extra idea: the PARALLEL-REPLICA CLOCK.  Each tick steps every
replica once, takes each replica's step wall (``perf_counter`` around
``engine.step()``, or a deterministic ``step_seconds`` price under the
frozen-clock sim), and advances the SHARED clock by the MAX of the
per-replica walls: replicas stand for independent devices running
concurrently, so cluster time is the slowest replica's time, not the
sum.  Latency and tok/s read off that virtual clock.

What a measured wall is on the card: host time around one
``engine.step()``.  The fused step is pipelined one step ahead (it
dispatches step N+1 before it reads step N's echo), so the device work
of a step overlaps the host's; the wall holds the host's dispatch and
the one declared wait, not the device time of the step it dispatched.
Replicas that share one card also share its device: the virtual clock
prices each replica's host wall as if it had a device of its own, it
does not measure devices running concurrently.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

Arrival = Tuple[float, list, int, Optional[int]]   # (t, prompt, max_new, eos)


def skewed_trace(n_requests: int, *, vocab: int = 97, period: int = 4,
                 long_len: int = 48, short_len: int = 4,
                 long_new: int = 24, short_new: int = 4,
                 interval_s: float = 1.0, load: float = 1.0,
                 t0: float = 0.0) -> List[Arrival]:
    """Deterministic skewed arrivals: request ``i`` is long iff
    ``i % period == 0``; arrivals are evenly spaced at
    ``interval_s / load`` (load > 1 = overload).  Prompts are fixed
    arithmetic sequences so every run of the trace is byte-identical."""
    if n_requests < 1 or period < 1:
        raise ValueError("need n_requests >= 1 and period >= 1")
    if load <= 0 or interval_s <= 0:
        raise ValueError("need positive load and interval_s")
    out: List[Arrival] = []
    gap = interval_s / load
    for i in range(n_requests):
        n = long_len if i % period == 0 else short_len
        new = long_new if i % period == 0 else short_new
        prompt = [(7 * i + j) % vocab for j in range(n)]
        out.append((t0 + i * gap, prompt, new, None))
    return out


def unit_latency(decode_s: float, chunk_s: float, overhead_s: float = 0.0):
    """Deterministic per-step wall price for :func:`serve_trace` under
    sim: the same unit costs as ``sim.work_latency_model``, but read
    from the engine's cumulative counters instead of a StepRecord (the
    loop may run without telemetry)."""

    def step_seconds(engine, chunks_delta: int,
                     dispatched_decode: bool) -> float:
        s = overhead_s + chunk_s * chunks_delta
        if dispatched_decode:
            s += decode_s
        return s

    return step_seconds


def steady_step_s(make_engine: Callable, prompts, *,
                  max_new_tokens: int = 4,
                  max_steps: int = 20_000) -> float:
    """The mean step wall of a warm engine, the unit a trace's arrival gap
    is scaled by: ``make_engine()`` serves ``prompts`` twice, each time a
    fresh engine, and the second (steady) run's wall over its steps is
    returned (floored at 10 us).  On the card this is host time, as
    :func:`serve_trace`'s walls are."""
    interval = 0.0
    for _ in range(2):                  # the first run pays the warm-up
        eng = make_engine()
        for p in prompts:
            eng.submit(p, max_new_tokens=max_new_tokens)
        t0 = time.perf_counter()
        st = eng.run_until_done(max_steps=max_steps)
        interval = max((time.perf_counter() - t0) / max(st.steps, 1), 1e-5)
    return interval


def trace_summary(cluster, admitted: Dict[int, float], clock,
                  n_arrivals: int) -> Dict[str, object]:
    """The reading of one drained :func:`serve_trace` run: tok/s over the
    clock's time, p50/p99 latency (arrival to finish), shed rate over the
    ``n_arrivals`` offered, completions, reroutes, preemptions summed over
    the replicas, and whether tokens were conserved (every admitted
    request completed with ``max_new_tokens`` tokens)."""
    done = cluster.done
    lats = sorted(done[c].finished_s - admitted[c] for c in done)

    def grab(q):
        return lats[int(q * (len(lats) - 1))] if lats else 0.0

    return {
        "tok_per_s": sum(len(q.tokens) for q in done.values())
        / max(clock.t, 1e-9),
        "p50_s": grab(0.50),
        "p99_s": grab(0.99),
        "shed_rate": cluster.stats.shed / max(n_arrivals, 1),
        "completed": len(done),
        "reroutes": cluster.stats.reroutes,
        "preemptions": sum(e.stats.preemptions for e in cluster.replicas),
        "conserved": bool(len(done) == len(admitted) and all(
            len(q.tokens) == q.max_new_tokens for q in done.values())),
    }


def tokens_by_index(cluster, admitted: Dict[int, float],
                    gap: float) -> Dict[int, list]:
    """{trace index: tokens} of a drained cluster whose arrivals were
    ``gap`` apart."""
    return {round(admitted[c] / gap): list(cluster.done[c].tokens)
            for c in cluster.done}


def decode_topology(cfg, max_len: int, max_batch: int, n_devices: int,
                    cost_model):
    """The cost model's best topology for an ``n_devices`` budget serving
    decode at ``max_len`` x ``max_batch``."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.sharding.plans import rank_cluster_topologies

    cell = ShapeCell("cluster", "decode", max_len, max_batch)
    return rank_cluster_topologies(cfg, cell, n_devices, cost_model)[0]


def _prefill_units(engine) -> int:
    """Cumulative prefill work counter: chunks on the paged engine,
    whole prefills on the slot engine."""
    st = engine.stats
    return st.prefill_chunks if getattr(engine, "chunk_size", None) else \
        st.prefills


def serve_trace(cluster, arrivals: List[Arrival], clock=None, *,
                max_ticks: int = 10_000,
                step_seconds: Optional[Callable] = None,
                min_dt: float = 0.0) -> Dict[int, float]:
    """Drive a :class:`ServingCluster` through a scripted trace.

    Per tick: submit every due arrival through the router, step each
    replica once (measuring its wall), advance the shared clock by the
    max per-replica wall (see module docstring), sweep completions.
    Stops when the trace is exhausted and nothing is in flight.

    ``step_seconds(engine, chunks_delta, dispatched_decode)`` prices a
    replica's step deterministically (sim mode); when None the wall is
    measured with ``time.perf_counter`` (real arrays).  ``min_dt`` puts
    a floor under idle ticks so a frozen SimClock still advances while
    replicas wait for the next arrival.

    Returns ``{crid: arrival_t}`` for every ADMITTED request; shed
    requests are counted in ``cluster.stats.shed`` but absent here.
    """
    if clock is None:
        clock = time
    pending = deque(sorted(arrivals, key=lambda a: a[0]))
    admitted: Dict[int, float] = {}
    for _ in range(max_ticks):
        now = clock.time()
        while pending and pending[0][0] <= now:
            t, prompt, max_new, eos = pending.popleft()
            crid = cluster.submit(np.asarray(prompt, np.int32),
                                  max_new_tokens=max_new, eos_id=eos)
            if crid is not None:
                admitted[crid] = t
        dt = min_dt
        for eng in cluster.replicas:
            chunks0 = _prefill_units(eng)
            wall0 = time.perf_counter()
            eng.step()
            if step_seconds is None:
                wall = time.perf_counter() - wall0
            else:
                wall = step_seconds(eng, _prefill_units(eng) - chunks0,
                                    eng._pending is not None)
            dt = max(dt, wall)
        if clock is not time:
            clock.advance(dt)
        cluster.router.collect()
        if not pending and cluster.router.in_flight == 0 \
                and not any(len(eng.queue) for eng in cluster.replicas):
            break
    # flush one-step-ahead pipelines so the last tokens land
    for eng in cluster.replicas:
        if eng._pending is not None:
            eng._drain(eng._pending)
            eng._pending = None
    cluster.router.collect()
    return admitted
