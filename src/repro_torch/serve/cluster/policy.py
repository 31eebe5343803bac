"""Placement policies: where the router puts each request, and whether an
eviction victim is worth moving to another replica (the port's copy of
``repro.serve.cluster.policy``; host arithmetic only).

All three policies see the same inputs — the candidate replicas (live
engine objects) and the request's shape — and return a replica index.
What separates them is how much of the cost model they consult:

* :class:`RoundRobinPolicy` — none.  The baseline the traffic-scaling
  campaign measures against: blind cycling, so a trace whose long
  requests recur with the replica period piles every one of them onto
  the same replica.
* :class:`LeastLoadedPolicy` — queue awareness.  Each replica's pending
  work is converted to predicted queue-seconds through the engine's own
  cached ``_predict_*`` prices (uniform work units without a cost
  model), and the emptiest replica wins.
* :class:`CostAwarePolicy` — queue awareness plus the request's own
  MARGINAL cost on each candidate (its prefill + decode seconds there)
  plus the inter-replica route traffic
  (``costmodel.analytic.analytic_route_bytes`` over a wire bandwidth).
  It is also the only policy that re-routes eviction victims: a victim
  moves only when another replica's queue + replay + route price beats
  replaying at the front of the source's queue.

``predicted_queue_seconds`` is duck-typed over both engines (paged rows
or slot occupancy) so a cluster can stand either kind of replica.  The
prices are the engines' cached ``_predict_chunk``/``_predict_prefill``/
``_predict_decode`` (analytic censuses over the engine's cost model):
host arithmetic, no device work and no sync.
"""
from __future__ import annotations

from typing import List, Optional


def _prefill_seconds(engine, n_tokens: int) -> float:
    """Predicted seconds to prefill ``n_tokens`` on this replica, through
    the engine's own cached pricing paths.  Without a cost model the
    unit is chunks (paged) or prompts (slot) — dimensionless but still a
    valid relative load signal."""
    if n_tokens <= 0:
        return 0.0
    chunk = getattr(engine, "chunk_size", None)
    if engine.cost_model is None:
        return float(-(-n_tokens // chunk)) if chunk else 1.0
    if chunk:
        return -(-n_tokens // chunk) * engine._predict_chunk().step_s
    return engine._predict_prefill(n_tokens).step_s


def _decode_token_seconds(engine) -> float:
    """Per-delivered-token decode seconds at full batch: one step serves
    up to ``max_batch`` rows, so a replica's decode backlog amortizes."""
    step_s = (engine._predict_decode().step_s
              if engine.cost_model is not None else 1.0)
    return step_s / max(engine.max_batch, 1)


def predicted_queue_seconds(engine, include_queue: bool = True) -> float:
    """Predicted seconds of work already committed to one replica:
    remaining prefill + remaining decode for every placed row, plus (by
    default) everything still waiting in its queue."""
    per_tok = _decode_token_seconds(engine)
    total = 0.0
    rows = getattr(engine, "rows", None)
    if rows is not None:                       # paged engine
        for row in rows:
            if row is None:
                continue
            req = row.req
            if not row.ready:
                total += _prefill_seconds(engine,
                                          len(req.prompt) - row.filled)
            total += max(req.max_new_tokens - len(req.tokens), 0) * per_tok
    else:                                      # slot engine
        for req in engine.slot_req:
            if req is None:
                continue
            total += max(req.max_new_tokens - len(req.tokens), 0) * per_tok
    if include_queue:
        for req in engine.queue:
            total += _prefill_seconds(engine, len(req.prompt))
            total += req.max_new_tokens * per_tok
    return total


class PlacementPolicy:
    """Interface: ``place`` picks the replica for a fresh request;
    ``reroute`` may claim an eviction victim for another replica (None =
    leave it to the source scheduler's front-requeue, today's behavior)."""

    name = "?"

    def place(self, prompt_len: int, max_new_tokens: int,
              replicas: List) -> int:
        raise NotImplementedError

    def reroute(self, req, src: int, replicas: List) -> Optional[int]:
        return None


class RoundRobinPolicy(PlacementPolicy):
    """Blind cycling — the campaign's baseline."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def place(self, prompt_len: int, max_new_tokens: int,
              replicas: List) -> int:
        i = self._next % len(replicas)
        self._next = (i + 1) % len(replicas)
        return i


class LeastLoadedPolicy(PlacementPolicy):
    """Emptiest predicted queue wins; ties go to the lowest index (so a
    drained cluster degenerates to replica 0, deterministically)."""

    name = "least_loaded"

    def place(self, prompt_len: int, max_new_tokens: int,
              replicas: List) -> int:
        return min(range(len(replicas)),
                   key=lambda i: (predicted_queue_seconds(replicas[i]), i))


class CostAwarePolicy(PlacementPolicy):
    """Marginal-completion placement (see module docstring).

    ``route_bw_bps`` prices ``analytic_route_bytes`` into seconds — the
    inter-replica fabric, defaulting to a 25 GB/s NIC.  On engines
    without a cost model the queue/marginal terms are unit-work, so the
    route term is scaled by ``unit_route_s`` per byte-free move instead
    (keeps the comparison dimensionally consistent either way).
    """

    name = "cost_aware"

    def __init__(self, route_bw_bps: float = 25e9,
                 unit_route_s: float = 0.25):
        if route_bw_bps <= 0:
            raise ValueError("route_bw_bps must be positive")
        self.route_bw_bps = route_bw_bps
        self.unit_route_s = unit_route_s

    # -- pricing helpers ------------------------------------------------------
    def _route_s(self, engine, prompt_len: int, filled: int = 0) -> float:
        if engine.cost_model is None:
            return self.unit_route_s
        from repro_torch.core.costmodel.analytic import analytic_route_bytes
        nbytes = analytic_route_bytes(engine.model.cfg, prompt_len, filled)
        return nbytes / self.route_bw_bps

    def _marginal_s(self, engine, prompt_len: int,
                    max_new_tokens: int) -> float:
        return (_prefill_seconds(engine, prompt_len)
                + max_new_tokens * _decode_token_seconds(engine))

    # -- the decisions --------------------------------------------------------
    def place(self, prompt_len: int, max_new_tokens: int,
              replicas: List) -> int:
        def completion_s(i):
            eng = replicas[i]
            return (predicted_queue_seconds(eng)
                    + self._marginal_s(eng, prompt_len, max_new_tokens)
                    + self._route_s(eng, prompt_len))
        return min(range(len(replicas)), key=lambda i: (completion_s(i), i))

    def reroute(self, req, src: int, replicas: List) -> Optional[int]:
        """Move an eviction victim only when it wins: staying means a
        front-requeue (it waits behind the source's PLACED rows only,
        then replays), moving means waiting behind the target's whole
        queue, replaying there, and paying the route traffic — including
        the abandoned KV of the already-prefilled prefix."""
        if len(replicas) < 2:
            return None
        n, new = len(req.prompt), req.max_new_tokens
        stay_s = (predicted_queue_seconds(replicas[src], include_queue=False)
                  + self._marginal_s(replicas[src], n, new))
        best, best_s = None, stay_s
        for j, eng in enumerate(replicas):
            if j == src:
                continue
            move_s = (predicted_queue_seconds(eng)
                      + self._marginal_s(eng, n, new)
                      + self._route_s(eng, n, filled=n))
            if move_s < best_s:
                best, best_s = j, move_s
        return best


POLICIES = {p.name: p for p in
            (RoundRobinPolicy, LeastLoadedPolicy, CostAwarePolicy)}


def make_policy(name_or_policy) -> PlacementPolicy:
    """'round_robin' | 'least_loaded' | 'cost_aware', or a ready instance."""
    if isinstance(name_or_policy, PlacementPolicy):
        return name_or_policy
    try:
        return POLICIES[name_or_policy]()
    except KeyError:
        raise ValueError(f"unknown placement policy {name_or_policy!r}; "
                         f"known: {', '.join(sorted(POLICIES))}") from None
