"""Admission policy for the paged engine: chunked prefill as a policy
object.  The port's own copy of ``repro.serve.scheduler`` (pure Python);
the port's engine runs it ungated until its cost-model slice lands.

The slot engine admits a request by prefilling its whole prompt in one
call; a long prompt therefore stalls every in-flight decode behind a wall
of prefill compute.  :class:`ChunkedPrefillScheduler` instead splits each
prompt into fixed-size chunks and interleaves at most a budgeted amount of
prefill work with every decode step:

* **FIFO admission** — work items are ordered by request id: first the
  chunks of requests already placed in rows (admitted earlier, smaller
  rids), then new admissions from the queue head, capped by free rows.
* **Cost-model gating** — each chunk is priced through the engine's
  ``_predict_prefill`` path (``CostModel.predict`` over an analytic
  census) and the planned iteration time (decode step + admitted chunks)
  must stay under ``step_budget_s``.  The first chunk of an iteration is
  always admitted, so a too-tight budget degrades to one-chunk-per-step
  instead of starving prefill.
* **Exact deferral accounting** — ``deferred`` counts only candidates
  that had capacity this step (a row, or a free row for queued requests)
  and were rejected by the budget.  Candidates waiting on row capacity
  are not "deferred by the budget" and are not counted — the corrected
  semantics of the slot engine's ``deferred_prefills`` fix.  (Chunks are
  uniformly priced, so unlike the slot engine's per-prompt-length
  prefills, a budget gate rejects every remaining candidate at once.)

Preemption is the engine's job (it owns the allocator); the scheduler
only owns the queue and exposes ``requeue`` so an evicted request goes
back to the queue *front* and is replayed from scratch (greedy decode is
deterministic, so a restart reproduces the same tokens).  A
``requeue_policy`` hook lets an external owner — the cluster router
(``serve.cluster``) — *reclaim* an evicted request instead (re-route it
to another replica); with no hook installed the front-requeue behavior
is byte-identical to the single-replica engine.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ChunkItem:
    """One planned unit of prefill work.  ``row`` is None for a fresh
    admission (the engine places the request into a free row first);
    ``rid`` pins the identity so a mid-step eviction can be detected."""
    rid: int
    row: Optional[int]
    request: object


@dataclasses.dataclass
class StepPlan:
    """What one engine iteration should do, and what it will cost."""
    items: List[ChunkItem]
    run_decode: bool
    predicted_s: float
    deferred: int


class ChunkedPrefillScheduler:
    """Chunked-prefill admission policy (see module docstring)."""

    def __init__(self, chunk_size: int = 32, *,
                 step_budget_s: Optional[float] = None,
                 requeue_policy: Optional[Callable[[object], bool]] = None):
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        self.chunk_size = chunk_size
        self.step_budget_s = step_budget_s
        self.requeue_policy = requeue_policy
        self.queue: Deque = deque()

    # -- queue ownership ------------------------------------------------------
    def submit(self, req) -> None:
        self.queue.append(req)

    def requeue(self, req) -> None:
        """Re-enqueue an evicted request at the FRONT: it was admitted
        before anything still waiting, so it keeps its FIFO priority.

        When a ``requeue_policy`` hook is installed (the cluster router's
        reclaim point) and it returns True, the request has been CLAIMED
        by the hook's owner — typically re-routed to another replica —
        and does not re-enter this queue.  A hook returning False (or no
        hook, the default) preserves the single-replica front-requeue
        byte-for-byte."""
        if self.requeue_policy is not None and self.requeue_policy(req):
            return
        self.queue.appendleft(req)

    def take(self, req) -> None:
        """Remove a specific planned request from the queue (by identity —
        evictions may have prepended other requests since the plan was
        made, so popleft would grab the wrong one)."""
        self.queue.remove(req)

    def __len__(self) -> int:
        return len(self.queue)

    # -- the policy -----------------------------------------------------------
    def plan(self, *, unfinished: Sequence[Tuple[int, int, object]],
             n_free_rows: int, any_ready: bool,
             decode_s: float, chunk_s: float,
             gated: bool, budget_s: Optional[float] = None) -> StepPlan:
        """Choose this iteration's prefill chunks.

        unfinished   (row, rid, request) for rows mid-prefill, FIFO order
        n_free_rows  rows a fresh admission could take
        any_ready    True when a decode step will run this iteration
        decode_s     predicted decode-step time (0.0 without a cost model)
        chunk_s      predicted time of one prefill chunk
        gated        True when a cost model + step budget are attached
        budget_s     per-call budget override: the engine passes its
                     effective budget here (the SLO token bucket's
                     adaptive per-step allowance, ``serve.telemetry``)
                     instead of the static ``step_budget_s``
        """
        budget = self.step_budget_s if budget_s is None else budget_s
        cands: List[ChunkItem] = [
            ChunkItem(rid, row, req) for row, rid, req in unfinished]
        for req in list(self.queue)[:max(n_free_rows, 0)]:
            cands.append(ChunkItem(req.rid, None, req))

        planned = decode_s if any_ready else 0.0
        items: List[ChunkItem] = []
        deferred = 0
        for c in cands:
            if gated and items and planned + chunk_s > budget:
                # budget gate: every remaining candidate had capacity (a
                # row, or a free row by the queue cap above) and — chunks
                # being uniformly priced, unlike the slot engine's
                # per-prompt-length prefills — every one of them is
                # budget-rejected, so all count as deferred
                deferred = len(cands) - len(items)
                break
            items.append(c)
            planned += chunk_s
        return StepPlan(items=items, run_decode=any_ready,
                        predicted_s=planned, deferred=deferred)
