""":class:`ServingCluster` — N engine replicas behind one Router, with
the device budget optionally factorized by the cost model (the port's
copy of ``repro.serve.cluster.cluster``).

``build`` is the one-stop constructor: it can be told the replica count
directly, or handed a device budget + serving shape and let
``sharding.rank_cluster_topologies`` choose — the same pricing that
ranks per-replica meshes decides how many replicas the budget buys (the
chosen :class:`~repro_torch.sharding.plans.ClusterTopology` is kept on
``cluster.topology`` for reporting).  Every replica is a full engine
with its own KV pool, scheduler, and (optionally) its own bound
TelemetryController from a :class:`ClusterTelemetry`; they share one
clock so cross-replica latency accounting is comparable, and they share
the caller's weights: a replica holds a reference to ``params``, never a
copy.

Replicas stay unsharded: the port's paged engine refuses ``mesh=``
(sharding over ``torch.distributed`` is not ported), so a topology whose
replicas span several devices is recorded, not laid out.

``step`` advances every replica by one engine step, then sweeps
completions into ``router.done``.  Under the frozen-clock sim harness
this is the cluster's tick: ``serve_trace`` advances the shared SimClock by
the MAX of the per-replica step walls (see ``cluster.traffic``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class ClusterStalled(RuntimeError):
    """``run_until_done`` exhausted its step budget with requests still
    in flight — a wedged cluster must be LOUD, not indistinguishable
    from a drained one.  Carries the leftover state for the post-mortem."""

    def __init__(self, steps: int, in_flight: int, queued: int,
                 produced: int):
        self.steps = steps
        self.in_flight = in_flight
        self.queued = queued
        self.produced = produced
        super().__init__(
            f"cluster stalled: {in_flight} request(s) in flight "
            f"({queued} queued) after {steps} steps; "
            f"{produced} tokens delivered")


class ServingCluster:
    """Replicas + router; delegates admission/completion to the router."""

    def __init__(self, replicas: List, policy="cost_aware",
                 shed_wait_s: Optional[float] = None,
                 max_reroutes: int = 3, telemetry=None, topology=None):
        from repro_torch.serve.cluster.router import Router
        self.replicas = list(replicas)
        self.router = Router(self.replicas, policy=policy,
                             shed_wait_s=shed_wait_s,
                             max_reroutes=max_reroutes)
        self.telemetry = telemetry
        self.topology = topology
        # optional chaos/fault supervisor (serve.chaos.supervise) — when
        # installed it owns per-replica stepping and the detection sweep
        self.supervisor = None

    # -- construction ---------------------------------------------------------
    @classmethod
    def build(cls, model, params, n_replicas: Optional[int] = None, *,
              engine: str = "paged", policy="cost_aware",
              clock=None, cost_model=None, telemetry=None,
              shed_wait_s: Optional[float] = None, max_reroutes: int = 3,
              n_devices: Optional[int] = None, cell=None,
              **engine_kwargs) -> "ServingCluster":
        """Stand up a cluster of identical replicas.

        Either pass ``n_replicas`` directly, or pass a device budget
        (``n_devices``) plus the serving shape (``cell``) and the
        replica count is read off ``rank_cluster_topologies(...)[0]`` —
        the cost-model-chosen topology.  ``engine_kwargs`` (max_batch,
        n_blocks, chunk_size, fused, ...) go to every replica verbatim.
        ``telemetry`` may be a :class:`ClusterTelemetry` (one controller
        per replica) — a single TelemetryController cannot be shared,
        its ``bind`` refuses a second engine.

        The replicas are unsharded whatever the topology (see the module
        docstring); ``topology`` still records the ranked plan.
        """
        topology = None
        if n_replicas is None:
            if n_devices is None or cell is None:
                raise ValueError("build needs n_replicas, or n_devices+cell "
                                 "for the cost model to choose")
            from repro_torch.sharding.plans import rank_cluster_topologies
            topology = rank_cluster_topologies(
                model.cfg, cell, n_devices, cost_model)[0]
            n_replicas = topology.n_replicas
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")

        if engine == "paged":
            from repro_torch.serve.engine import PagedServingEngine as Engine
        elif engine == "slot":
            from repro_torch.serve.engine import ServingEngine as Engine
        else:
            raise ValueError(f"unknown engine kind {engine!r} "
                             f"(want 'paged' or 'slot')")
        replicas = []
        for i in range(n_replicas):
            controller = telemetry.controller(i) if telemetry else None
            replicas.append(Engine(model, params, clock=clock,
                                   cost_model=cost_model,
                                   telemetry=controller, **engine_kwargs))
        return cls(replicas, policy=policy, shed_wait_s=shed_wait_s,
                   max_reroutes=max_reroutes, telemetry=telemetry,
                   topology=topology)

    # -- admission / completion ----------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               eos_id: Optional[int] = None) -> Optional[int]:
        """Route one request; returns its cluster id, or None if shed."""
        return self.router.submit(prompt, max_new_tokens=max_new_tokens,
                                  eos_id=eos_id)

    @property
    def done(self) -> Dict[int, object]:
        return self.router.done

    @property
    def stats(self):
        return self.router.stats

    # -- failure recovery -----------------------------------------------------
    def replace_replica(self, i: int, engine) -> None:
        """Swap a restarted engine into slot ``i`` on BOTH lists — the
        router copies the replicas list at construction, so the cluster's
        and the router's views must be updated together or they diverge
        on the first warm-rejoin."""
        self.replicas[i] = engine
        self.router.replace_replica(i, engine)

    def _live_replicas(self) -> List:
        """Replicas eligible for work (all of them without a supervisor;
        the router's live set under one — a dead replica's frozen queue
        must not keep ``run_until_done`` spinning)."""
        if self.supervisor is None:
            return self.replicas
        return [self.replicas[j] for j in self.router.live_indices()]

    # -- stepping -------------------------------------------------------------
    def step(self) -> int:
        """One cluster tick: every replica takes one engine step, then
        completions are swept.  Returns total tokens delivered.

        With a chaos supervisor installed, stepping is delegated per
        replica (the supervisor wraps the step with heartbeat + fault
        bookkeeping and skips dead replicas) and the detection/recovery
        sweep runs after the tick."""
        produced = 0
        if self.supervisor is not None:
            for i in range(len(self.replicas)):
                produced += self.supervisor.step_replica(i)
            self.router.collect()
            self.supervisor.after_tick()
        else:
            for eng in self.replicas:
                produced += eng.step()
            self.router.collect()
        return produced

    def run_until_done(self, max_steps: int = 10_000, *,
                       raise_on_stall: bool = True) -> int:
        """Step until every admitted request is collected (or the step
        budget runs out).  Returns total tokens delivered.

        Exhausting ``max_steps`` with requests still in flight raises
        :class:`ClusterStalled` (set ``raise_on_stall=False`` to get the
        old silent return while inspecting the wreckage) — a wedged
        cluster used to return normally, indistinguishable from success.
        """
        produced = 0
        steps = 0
        for _ in range(max_steps):
            if self.router.in_flight == 0 and not any(
                    len(eng.queue) for eng in self._live_replicas()):
                break
            produced += self.step()
            steps += 1
        # flush any one-step-ahead pipelines left in flight
        for eng in self._live_replicas():
            if eng._pending is not None:
                eng._drain(eng._pending)
                eng._pending = None
        self.router.collect()
        if raise_on_stall and self.router.in_flight > 0:
            raise ClusterStalled(
                steps, self.router.in_flight,
                sum(len(eng.queue) for eng in self._live_replicas()),
                produced)
        return produced
