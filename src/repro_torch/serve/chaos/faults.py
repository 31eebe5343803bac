"""Fault injection: what goes wrong, scripted and replayable (the port's
copy of ``repro.serve.chaos.faults``).

A :class:`FaultSpec` names one fault; a :class:`FaultPlan` is the full
scripted schedule for a drill — either hand-written or drawn from a
seeded RNG (:meth:`FaultPlan.random`), so a chaos run replays
byte-for-byte from ``(plan, trace)`` alone.  Faults are realized by
wrapping each replica engine in a :class:`FaultyReplica`: the wrapper
delegates every attribute to the engine (the router, scheduler hooks and
trace loops all see a normal replica) and intercepts only ``step()``,
where the plan can

* **crash** — the replica stops dead at step N: no more stepping, no
  more heartbeats, its in-flight pipeline never drains.  The process is
  gone; recovery may not ask it to clean up.
* **hang** (straggle) — steps keep completing but take ``factor``×
  longer for ``duration`` steps: the heartbeat carries the inflated
  step time, which is exactly what the straggler detector eats.
* **corrupt** — one step's ``[2, B]`` token echo is poisoned (negative
  ids — what NaN logits argmax into after a device fault) so the
  engine-side integrity probe must catch it at drain time.  In the port
  the echo is staged: a pinned host buffer and a CUDA event on the card
  (``serve.engine`` ``_stage``), so the poison is written into that
  buffer (:meth:`FaultyReplica._poison_pending`).

``crashloop`` is a crash that RECURS on every restart generation —
:meth:`FaultPlan.wrap` re-arms it on the rewrapped engine, driving the
``RestartPolicy`` crash-loop breaker; every other fault fires only in
generation 0 (a restarted replica is healthy).
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Tuple

KINDS = ("crash", "hang", "corrupt", "crashloop")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault on one replica.

    ``at_step`` counts the WRAPPER's ``step()`` calls (a replica steps
    once per cluster tick, so this is also the tick index for a replica
    present from tick 0).  ``duration``/``factor`` only apply to
    ``hang``.
    """
    kind: str                  # one of KINDS
    replica: int
    at_step: int
    duration: int = 4          # hang: steps the slowdown lasts
    factor: float = 8.0        # hang: step-time multiplier

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(want one of {KINDS})")
        if self.at_step < 0 or self.replica < 0:
            raise ValueError("at_step and replica must be >= 0")
        if self.kind == "hang" and (self.duration < 1 or self.factor <= 1):
            raise ValueError("hang needs duration >= 1 and factor > 1")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """The drill's whole fault schedule; pure data, hashable, replayable."""
    specs: Tuple[FaultSpec, ...]

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))

    @classmethod
    def random(cls, kind: str, n_replicas: int, seed: int = 0, *,
               step_range: Tuple[int, int] = (2, 8)) -> "FaultPlan":
        """One seeded fault of ``kind`` on a seeded replica — the
        campaign's grid axis.  Same ``(kind, n_replicas, seed)`` ⇒ same
        plan, byte-for-byte."""
        rng = random.Random((seed, kind, n_replicas).__repr__())
        return cls((FaultSpec(kind, rng.randrange(n_replicas),
                              rng.randrange(*step_range)),))

    def for_replica(self, i: int, generation: int) -> List[FaultSpec]:
        """Specs live on replica ``i`` at restart ``generation`` (0 =
        the original process).  Only ``crashloop`` survives a restart,
        and a restarted crash-looper dies ON STARTUP (``at_step=0``) —
        that is what crash-looping means, and it guarantees the
        ``RestartPolicy`` breaker trips instead of the loop racing the
        end of the trace."""
        out = []
        for s in self.specs:
            if s.replica != i:
                continue
            if generation == 0:
                out.append(s)
            elif s.kind == "crashloop":
                out.append(dataclasses.replace(s, at_step=0))
        return out

    def wrap(self, engine, i: int, generation: int,
             clock=None) -> "FaultyReplica":
        return FaultyReplica(engine, self.for_replica(i, generation),
                             clock=clock)


class FaultyReplica:
    """Transparent engine wrapper that executes a replica's FaultSpecs.

    Everything except the intercepted surface (``step``, fault state)
    delegates to the wrapped engine, both reads AND writes — the router
    installs its reclaim closure on ``wrapper.scheduler``, the trace
    loop clears ``wrapper._pending``, and both reach the real engine.
    """

    # attributes owned by the wrapper itself; everything else delegates
    _OWN = frozenset({"engine", "specs", "clock", "calls", "crashed",
                      "wall_scale", "injected", "fired"})

    def __init__(self, engine, specs: List[FaultSpec], clock=None):
        object.__setattr__(self, "engine", engine)
        object.__setattr__(self, "specs", list(specs))
        object.__setattr__(self, "clock", clock)
        object.__setattr__(self, "calls", 0)
        object.__setattr__(self, "crashed", False)
        object.__setattr__(self, "wall_scale", 1.0)
        object.__setattr__(self, "injected", [])  # (kind, call#) audit trail
        object.__setattr__(self, "fired", set())  # spec indices already run

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def __setattr__(self, name, value):
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self.engine, name, value)

    # -- the intercepted step -------------------------------------------------
    def step(self) -> int:
        """One engine step, with this replica's faults applied.  A
        crashed replica returns 0 forever without touching the engine —
        its queue, rows and pending pipeline freeze exactly as a dead
        process leaves them."""
        if self.crashed:
            return 0
        call = self.calls
        self.calls = call + 1
        scale = 1.0
        for s in self.specs:
            if s.kind in ("crash", "crashloop") and call >= s.at_step:
                self.crashed = True
                self.injected.append((s.kind, call))
                return 0
            if s.kind == "hang" and s.at_step <= call < s.at_step + s.duration:
                scale = max(scale, s.factor)
        self.wall_scale = scale
        produced = self.engine.step()
        for k, s in enumerate(self.specs):
            if (s.kind == "corrupt" and call >= s.at_step
                    and k not in self.fired and self._poison_pending()):
                self.fired.add(k)
                self.injected.append((s.kind, call))
        return produced

    def _poison_pending(self) -> bool:
        """Corrupt the in-flight step's token echo: wait for its staged
        copy, overwrite the output row of the very buffer the next drain
        reads with negative ids (the host-side face of NaN logits), and
        leave ``(buf, event)`` in ``_pending`` for that drain to refuse
        (``_echo_ok``).  On the card the staged form is a pinned host
        buffer and the CUDA event recorded behind its copy; the wait is
        the fault's own, not an engine sync: it goes through the engine's
        ``_wait_staged``, as ``_sync`` does, but is not counted in
        ``host_syncs``.  On the CPU the staged form is ``(tensor, None)``
        and the same write applies.  With nothing in flight the fault
        stays ARMED (returns False) and fires on the replica's next busy
        step — a bit flip in an idle buffer that nobody ever reads is not
        an observable fault."""
        eng = self.engine
        if eng._pending is None:
            return False
        (buf, event), _ = eng._pending
        eng._wait_staged(event)
        buf[1, :] = -1
        return True
