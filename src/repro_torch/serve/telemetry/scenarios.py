"""Deterministic drift / overload scenarios on the sim harness (the
port's copy of ``repro.serve.telemetry.scenarios``).

The acceptance demos for the telemetry layer, packaged as plain
functions so three consumers share one implementation:

* the sim tests (``tests/test_torch_telemetry.py``) assert on the returned
  dict with exact expectations;
* the CI telemetry smoke (``python -m repro_torch.serve.telemetry smoke``)
  asserts the same properties and sets the exit code;
* the ``telemetry_replay`` campaign experiment records the dict as a
  result artifact for the report table.

Both scenarios run the **paged engine** on the deterministic harness
(``repro_torch.serve.sim``): a frozen ``SimClock``, the arithmetic
``FakeModel`` (so every request's tokens are computable in closed form),
constant ``FakeCostModel`` prices, and ``work_latency_model`` standing
in for wall-clock step latency (the clock is frozen within a step, so
engine-measured time is 0 — the latency model charges the *true* prices
for the work each step record says the engine did).

:func:`run_drift_scenario` — the cost model is constructed with its
decode price wrong by ``drift_factor``; the true prices flow in through
the latency model.  The drift detector must fire exactly once, the
rescale must bring the windowed prediction error back under the 10%
gate, and no request's tokens may change.

:func:`run_overload_scenario` — a burst of ``load_factor`` × the batch
capacity arrives at t=0 under an SLO-driven token bucket.  The bucket
must hold the measured step-time p99 at/under the target (an ungated
baseline run of the same trace is included to show the spike the bucket
prevents), shed admissions newest-first (deferrals, FIFO order intact),
and every admitted request must complete with byte-identical tokens.

Both take ``device=``, the device the fake model's tensors (and so the
engine's) live on: the CPU by default, since they are the CPU smoke; the
card's phase passes ``"cuda"``.  The fake's arithmetic is integer, so the
returned dicts are the same on every device.
"""
from __future__ import annotations

from typing import Any, Dict, List

from repro_torch.serve.sim import (FakeCostModel, FakeModel, SimClock,
                                   drive, expected_tokens,
                                   work_latency_model)
from repro_torch.serve.telemetry.control import TelemetryController
from repro_torch.serve.telemetry.drift import DriftDetector
from repro_torch.serve.telemetry.metrics import quantile
from repro_torch.serve.telemetry.slo import SLO, TokenBucket

VOCAB = 97


def _paged(model, clock, **kw):
    from repro_torch.serve.engine import PagedServingEngine
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_len", 32)
    kw.setdefault("block_size", 4)
    kw.setdefault("chunk_size", 4)
    return PagedServingEngine(model, params=None, clock=clock, **kw)


def _tokens_exact(engine, rids) -> bool:
    for rid in rids:
        req = engine.done[rid]
        if req.tokens != expected_tokens(req.prompt, req.max_new_tokens,
                                         VOCAB, req.eos_id):
            return False
    return True


def run_drift_scenario(*, drift_factor: float = 2.0, gate: float = 0.10,
                       n_requests: int = 6, device="cpu") -> Dict[str, Any]:
    """Inject a ``drift_factor`` decode-price error; return the
    recalibration evidence (see module docstring)."""
    true_decode_s, true_chunk_s = 1.0, 1.0
    # the table the engine prices admission with is WRONG by drift_factor
    cm = FakeCostModel(decode_s=true_decode_s / drift_factor,
                       prefill_s=true_chunk_s)
    detector = DriftDetector(gate, window=6, min_samples=4, cooldown=12)
    ctl = TelemetryController(
        drift=detector,
        latency_model=work_latency_model(true_decode_s, true_chunk_s))
    clock = SimClock()
    engine = _paged(FakeModel(vocab=VOCAB, device=device), clock,
                    cost_model=cm, telemetry=ctl)
    # long generations => a run of pure-decode steps, the unambiguous
    # samples the detector needs
    arrivals = [(0.0, [10 * i + 3, 10 * i + 4], 24, None)
                for i in range(n_requests)]
    rids = drive(engine, clock, arrivals, max_steps=400)

    events = [e.as_dict() for e in ctl.recalibrations]
    last_step = max((e["step"] for e in events), default=0)
    post = [abs(r.measured_s / r.predicted_decode_s - 1.0)
            for r in ctl.sink.steps()
            if r.decode_ran and r.n_prefill_units == 0
            and r.step > last_step and r.predicted_decode_s > 0]
    return {
        "scenario": "drift",
        "drift_factor": drift_factor,
        "gate": gate,
        "n_events": len(events),
        "events": events,
        "pre_error": events[0]["error"] if events else None,
        "post_error": quantile(post, 0.5) if post else None,
        "post_samples": len(post),
        "rescales": list(cm.rescales),
        "tokens_ok": _tokens_exact(engine, rids),
        "completed": engine.stats.completed,
        "n_requests": len(arrivals),
        "summary": ctl.sink.summary(),
    }


def run_overload_scenario(*, load_factor: int = 2,
                          target_p99_s: float = 3.5,
                          device="cpu") -> Dict[str, Any]:
    """Burst-overload the paged engine under an SLO token bucket; return
    the p99-vs-target evidence plus an ungated baseline of the same
    trace (see module docstring)."""
    true_decode_s, true_chunk_s = 1.0, 1.0
    max_batch = 4
    # 2 chunks per prompt x load_factor x max_batch requests, all at t=0
    prompts: List[List[int]] = [
        [(7 * i + j) % VOCAB for j in range(8)]
        for i in range(load_factor * max_batch)]
    arrivals = [(0.0, p, 4, None) for p in prompts]

    # steady-state SLO: the plan prices a chunk-only step without the
    # decode that fires when that chunk COMPLETES a prefill, so the
    # bucket's initial rate (= the target) overshoots until the first
    # AIMD window observes the violation and cuts the refill rate.  The
    # SLO therefore holds from the first adaptation onward — p99 is
    # measured after one `slo.window` warmup (documented in the
    # runbook's "setting an SLO" section).
    warmup = 8

    def run(slo_on: bool):
        cm = FakeCostModel(decode_s=true_decode_s, prefill_s=true_chunk_s)
        latency = work_latency_model(true_decode_s, true_chunk_s)
        if slo_on:
            # increase=0 pins the post-adaptation rate: the demo shows
            # the bucket HOLDING the SLO, not the AIMD hunting around it
            # (upward adaptation is unit-tested on TokenBucket)
            slo = SLO(target_p99_s=target_p99_s, window=warmup,
                      increase=0.0)
            ctl = TelemetryController(
                slo=TokenBucket(slo, burst_factor=1.0),
                drift=False, latency_model=latency)
        else:
            ctl = TelemetryController(drift=False, latency_model=latency)
        clock = SimClock()
        engine = _paged(FakeModel(vocab=VOCAB, device=device), clock,
                        max_batch=max_batch, cost_model=cm, telemetry=ctl)
        rids = drive(engine, clock, arrivals, max_steps=400)
        meas = [r.measured_s for r in ctl.sink.steps()]
        # warmup applies to the SLO run only; the ungated baseline's
        # spike is exactly the early burst, so it is measured in full
        return engine, ctl, rids, quantile(meas[warmup:] if slo_on
                                           else meas, 0.99)

    engine, ctl, rids, p99 = run(slo_on=True)
    _, _, _, baseline_p99 = run(slo_on=False)
    order = engine.stats.admission_order
    return {
        "scenario": "overload",
        "load_factor": load_factor,
        "target_p99_s": target_p99_s,
        "warmup_steps": warmup,
        "p99_s": p99,
        "baseline_p99_s": baseline_p99,
        "slo_held": p99 <= target_p99_s,
        "baseline_violates": baseline_p99 > target_p99_s,
        "deferred": engine.stats.deferred_prefills,
        "admission_fifo": order == sorted(order),
        "tokens_ok": _tokens_exact(engine, rids),
        "completed": engine.stats.completed,
        "n_requests": len(arrivals),
        "bucket_windows": ctl.bucket.windows,
        "bucket_violations": ctl.bucket.violations,
        "summary": ctl.sink.summary(),
    }
