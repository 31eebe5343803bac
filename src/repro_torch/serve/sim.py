"""Deterministic engine-simulation harness: the port's copy of
``repro.serve.sim``.

Everything nondeterministic about serving is injected through three
fakes, so scheduler/telemetry behaviour is an exact computation instead
of a flaky wall-clock observation:

* :class:`SimClock` replaces ``time.time``/``time.perf_counter`` — both
  engines take a ``clock=`` object, so timestamps advance only when the
  trace driver says so and every submitted/finished time is an exact
  scripted value.
* :class:`FakeModel` replaces the transformer: decode is an integer rule
  on tensors (next token = last token + 1 mod vocab), so the *expected*
  output of every request is computable in the test
  (:func:`expected_tokens`).  It carries the members the port's engines
  call (``cfg``, ``device``, ``decode``, ``decode_step``,
  ``init_paged_cache``), its tensors on an explicit device, and records
  each distinct shape the engine feeds it, in the order first seen (the
  shape census; the reference records one per jit trace).
* :class:`FakeCostModel` replaces calibrated pricing with a constant
  table, making the scheduler's budget arithmetic — and therefore the
  exact ``deferred_prefills`` count per step — a hand-checkable
  computation.  Its :meth:`FakeCostModel.rescale` implements the online-
  recalibration protocol (``serve.telemetry``): a drift event rescales
  the table entry it fired on, exactly like a real ``Calibration``
  update, but as one multiply.

The telemetry layer's drift/overload scenarios
(``serve.telemetry.scenarios``), the ``telemetry_replay`` campaign
experiment, the CI smoke CLI and the tests all drive the engines through
this harness.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.zoo import fused_decode_step


class SimClock:
    """Injected in place of the ``time`` module: advances only on demand.

    ``time()`` and ``perf_counter()`` both read the same scripted value;
    :meth:`advance` is the only way time passes.
    """

    def __init__(self, t0: float = 0.0):
        self.t = t0

    def time(self) -> float:
        return self.t

    def perf_counter(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@dataclasses.dataclass
class _Pred:
    step_s: float


def is_decode_census(census) -> bool:
    """The engines price a decode step and a prefill (or chunk) through the
    same ``predict(census)``; only a decode census carries
    ``boundary_bytes`` (``core.costmodel.analytic.analytic_census``)."""
    return "boundary_bytes" in census


class FakeCostModel:
    """Constant (or census-derived) prices; only ``.step_s`` is consumed.

    ``decode_s`` prices the batched decode step, ``prefill_s`` one
    analytic prefill/chunk; both reach the fake through ``predict``, which
    tells them apart by the census (:func:`is_decode_census`).  A
    ``predict_fn(census)`` overrides the constant prefill price with a
    census-derived one (e.g. proportional to flops).

    ``rescale`` is the online-recalibration hook
    (``serve.telemetry.recalibrate``): multiply the named table entry by
    ``factor`` — the fake's one-row equivalent of rescaling a
    ``Calibration`` table from live measurements.
    """

    def __init__(self, decode_s=1.0, prefill_s=1.0, predict_fn=None):
        self.decode_s = decode_s
        self.prefill_s = prefill_s
        self.predict_fn = predict_fn
        self.rescales = []          # (kind, factor) audit trail

    def predict(self, census, **kw):
        if is_decode_census(census):
            return _Pred(self.decode_s)
        if self.predict_fn is not None:
            return _Pred(self.predict_fn(census))
        return _Pred(self.prefill_s)

    def rescale(self, kind: str, factor: float) -> None:
        """Recalibrate one price in place: ``decode`` scales the step
        table entry, anything else the prefill/chunk entry."""
        if kind == "decode":
            self.decode_s *= factor
        else:
            self.prefill_s *= factor
        self.rescales.append((kind, factor))


class FakeModel:
    """Minimal paged-decodeable model: next token = last + 1 (mod vocab).

    ``decode_shapes`` lists each distinct (tokens, block_tables) shape pair
    the engine has fed ``decode``, in the order first seen.  ``device=None``
    is the card, as at every entry point of the port.
    """

    def __init__(self, vocab=97, cfg=None, device=None):
        from repro_torch.configs import ARCHS, reduced
        self.vocab = vocab
        self.cfg = cfg if cfg is not None else reduced(
            ARCHS["gemma2-2b"], n_layers=2, vocab_size=vocab)
        self.device = resolve_device(device)
        self.decode_shapes = []
        self.decode_step = fused_decode_step(self.decode)

    def decode(self, params, cache, tokens, pos, block_tables=None,
               paged_fn=None):
        shapes = (tuple(tokens.shape),
                  None if block_tables is None else tuple(block_tables.shape))
        if shapes not in self.decode_shapes:
            self.decode_shapes.append(shapes)
        nxt = (tokens[:, -1].long() + 1) % self.vocab
        logits = torch.zeros(tokens.shape[0], self.vocab, device=self.device)
        return logits.scatter_(1, nxt[:, None], 1.0), cache

    def init_paged_cache(self, n_blocks, block_size):
        shape = (1, n_blocks, block_size, 1, 1)
        return {"k": torch.zeros(shape, dtype=torch.bfloat16,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=torch.bfloat16,
                                 device=self.device)}


def expected_tokens(prompt, n, vocab, eos_id=None):
    """What :class:`FakeModel` greedily generates for ``prompt``."""
    out, t = [], int(prompt[-1])
    for _ in range(n):
        t = (t + 1) % vocab
        out.append(t)
        if eos_id is not None and t == eos_id:
            break
    return out


def drive(engine, clock, arrivals, dt=1.0, max_steps=500):
    """Scripted-trace driver: submit each (t, prompt, max_new, eos) at its
    arrival time, stepping the engine once per clock tick.  Returns
    {rid: arrival_time} for every submitted request."""
    pending = deque(sorted(arrivals, key=lambda a: a[0]))
    rids = {}
    for _ in range(max_steps):
        while pending and pending[0][0] <= clock.t:
            t, prompt, max_new, eos = pending.popleft()
            rids[engine.submit(np.asarray(prompt, np.int32),
                               max_new_tokens=max_new, eos_id=eos)] = t
        active = engine.step()
        clock.advance(dt)
        if not pending and active == 0 and not len(engine.queue):
            break
    return rids


def work_latency_model(decode_s: float, chunk_s: float,
                       overhead_s: float = 0.0):
    """A deterministic stand-in for measured step latency: charge the
    "true" per-unit costs for the work one step record says the engine
    actually did.  ``serve.telemetry.TelemetryController`` accepts this
    as ``latency_model=`` so drift and SLO feedback loops close in
    simulation exactly as they would against a wall clock — the sim's
    ground truth replaces ``perf_counter`` deltas, which a
    :class:`SimClock` (frozen within a step) measures as zero."""

    def latency(record) -> float:
        s = overhead_s + chunk_s * record.n_prefill_units
        if record.decode_ran:
            s += decode_s
        return s

    return latency


__all__ = ["SimClock", "FakeCostModel", "FakeModel", "expected_tokens",
           "drive", "work_latency_model", "is_decode_census"]
