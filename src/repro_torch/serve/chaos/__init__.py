"""Deterministic fault injection and recovery over the cluster tier (the
port's copy of ``repro.serve.chaos``).

Three layers, one per module:

* :mod:`~repro_torch.serve.chaos.faults` — WHAT goes wrong: a seeded
  :class:`FaultPlan` of :class:`FaultSpec` entries, realized as
  :class:`FaultyReplica` wrappers around the engines (crash-at-step-N,
  hang/straggle step-time multiplier, corrupted-step token echo).
  Replayable byte-for-byte: same plan, same trace, same tokens.
* :mod:`~repro_torch.serve.chaos.supervise` — WHO notices and what happens
  next: :class:`ChaosSupervisor` wires the repo's existing
  ``distributed.fault_tolerance`` policy layer (heartbeats, straggler
  MAD/ceiling verdicts, restart budget with crash-loop breaker) into
  ``ServingCluster.step``, reclaims a dead replica's requests through
  the router, brownouts admission to surviving capacity, and
  warm-rejoins restarted replicas.
* :mod:`~repro_torch.serve.chaos.drill` — the PROOF: :func:`run_chaos_drill`
  plays one deterministic trace against a fault-free twin and gates
  token byte-identity, zero lost tokens, zero leaked blocks, and a
  drained router after every recovery.
"""
from repro_torch.serve.chaos.faults import FaultPlan, FaultSpec, FaultyReplica
from repro_torch.serve.chaos.supervise import ChaosSupervisor, FailureRecord
from repro_torch.serve.chaos.drill import run_chaos_drill

__all__ = ["FaultPlan", "FaultSpec", "FaultyReplica", "ChaosSupervisor",
           "FailureRecord", "run_chaos_drill"]
