"""The port's chaos tier (``repro_torch.serve.chaos``) and its
fault-tolerance policy (``repro_torch.distributed.fault_tolerance``)
against the JAX package, on the CPU.

* Every test of ``tests/test_chaos.py``, and the fault-tolerance cases of
  ``tests/test_checkpoint_and_fault.py``, mirrored on the port (the
  drills' fake model on the CPU).
* Cross-package cases: ``run_chaos_drill(fault, r)`` returns the
  reference's dict, field for field, for every fault at 2 and 3
  replicas; the ``chaos_serving`` cell and its table rows are the
  reference's; the registry's detection verdicts follow the reference's
  on one scripted beat sequence.
* The poisoned echo in the port's staged form: ``(buffer, event)`` with
  no event on the CPU, written in place for the next drain to refuse.
* ``chip_smoke.py``'s phase cluster (c) rehearsed on reduced f32 gemma2:
  token parity across policies and against the bare engine, crash and
  corrupt on real replicas against the fault-free twin, and each
  ``CLUSTER_MUST_CATCH`` fault failing the check that names it.
"""
import heapq
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # degrade: property tests skip, unit tests still run
    from _hypothesis_stub import given, settings, st

from repro.core.campaign import registry as jreg
from repro.core.campaign import report as jreport
from repro.distributed import fault_tolerance as jft
from repro.serve.chaos import run_chaos_drill as jrun_chaos_drill
from repro_torch.core.campaign import registry as treg
from repro_torch.core.campaign import report as treport
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.distributed.fault_tolerance import (FaultTolerantRunner,
                                                     HeartbeatRegistry,
                                                     RestartPolicy)
from repro_torch.serve.chaos import (ChaosSupervisor, FaultPlan, FaultSpec,
                                     FaultyReplica, run_chaos_drill)
from repro_torch.serve.chaos import drill as drill_mod
from repro_torch.serve.cluster.cluster import ClusterStalled
from repro_torch.serve.cluster.metrics import ClusterTelemetry
from repro_torch.serve.engine import _echo_ok
from repro_torch.serve.paging import BlockAllocator
from repro_torch.serve.sim import SimClock, expected_tokens
from repro_torch.serve.telemetry.metrics import (MetricsSink, RequestRecord,
                                                 StepRecord,
                                                 schema_field_names)
from repro_torch.serve.telemetry.slo import SLO, TokenBucket
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

KINDS = ("crash", "hang", "corrupt", "crashloop")
_DRILLS = {}


def drill(fault, replicas=2):
    key = (fault, replicas)
    if key not in _DRILLS:
        _DRILLS[key] = run_chaos_drill(fault, replicas, n_requests=8,
                                       device="cpu")
    return _DRILLS[key]


def _build(n, clock, plan=None, telemetry=None):
    return drill_mod._build(n, clock, plan=plan, telemetry=telemetry,
                            device="cpu")


def _step(i, **kw):
    base = dict(engine="paged", step=i, t_s=float(i), n_active=1,
                queue_depth=0, predicted_s=0.5, predicted_decode_s=0.5,
                measured_s=0.5, decode_ran=True, n_prefill_units=0,
                bottleneck="compute", budget_s=0.0, host_syncs=i,
                table_uploads=0, blocks_in_use=2, n_blocks=8,
                decoded_tokens=i, preemptions=0, deferred=0,
                kernel_splits=1, integrity_failures=0)
    base.update(kw)
    return StepRecord(**base)


# ---------------------------------------------------------------------------
# fault plans + the wrapper
# ---------------------------------------------------------------------------

def test_fault_spec_validation():
    with pytest.raises(ValueError):
        FaultSpec("meteor", 0, 1)
    with pytest.raises(ValueError):
        FaultSpec("crash", 0, -1)
    with pytest.raises(ValueError):
        FaultSpec("hang", 0, 2, duration=0)
    with pytest.raises(ValueError):
        FaultSpec("hang", 0, 2, factor=1.0)


def test_fault_plan_random_is_replayable():
    a = FaultPlan.random("crash", 3, seed=7)
    b = FaultPlan.random("crash", 3, seed=7)
    assert a == b
    assert len(a.specs) == 1 and a.specs[0].kind == "crash"
    assert 0 <= a.specs[0].replica < 3
    assert 2 <= a.specs[0].at_step < 8
    assert FaultPlan.random("hang", 3, seed=7).specs[0].kind == "hang"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("replicas", [2, 3])
def test_fault_plan_random_equals_the_reference(kind, replicas):
    """One seed, one plan in both packages: the campaign's grid points
    fault the same replica at the same step."""
    from repro.serve.chaos import FaultPlan as JFaultPlan
    for seed in range(4):
        got = FaultPlan.random(kind, replicas, seed).specs[0]
        want = JFaultPlan.random(kind, replicas, seed).specs[0]
        assert (got.kind, got.replica, got.at_step, got.duration,
                got.factor) == (want.kind, want.replica, want.at_step,
                                want.duration, want.factor)


def test_fault_plan_generation_semantics():
    plan = FaultPlan((FaultSpec("crash", 0, 5), FaultSpec("crashloop", 1, 4)))
    assert plan.for_replica(0, 0) == [FaultSpec("crash", 0, 5)]
    assert plan.for_replica(1, 0) == [FaultSpec("crashloop", 1, 4)]
    assert plan.for_replica(2, 0) == []
    assert plan.for_replica(0, 1) == []
    regen = plan.for_replica(1, 1)
    assert len(regen) == 1 and regen[0].kind == "crashloop"
    assert regen[0].at_step == 0


class _DummyEngine:
    def __init__(self):
        self.queue = []
        self._pending = None
        self.knob = 1
        self.steps = 0

    def step(self):
        self.steps += 1
        return 1


def test_faulty_replica_delegates_and_crashes():
    eng = _DummyEngine()
    rep = FaultyReplica(eng, [FaultSpec("crash", 0, 2)])
    assert rep.knob == 1
    rep.knob = 7
    assert eng.knob == 7
    rep._pending = "x"
    assert eng._pending == "x"
    assert rep.step() == 1 and rep.step() == 1
    assert rep.step() == 0 and rep.crashed
    assert rep.step() == 0
    assert eng.steps == 2
    assert ("crash", 2) in rep.injected


def test_faulty_replica_hang_scales_wall():
    eng = _DummyEngine()
    rep = FaultyReplica(eng, [FaultSpec("hang", 0, 1, duration=2,
                                        factor=6.0)])
    rep.step()
    assert rep.wall_scale == 1.0
    rep.step()
    assert rep.wall_scale == 6.0
    rep.step()
    assert rep.wall_scale == 6.0
    rep.step()
    assert rep.wall_scale == 1.0


def test_echo_ok_flags_poisoned_tokens():
    good = np.zeros((2, 4), np.int32)
    assert _echo_ok(good)
    bad = good.copy()
    bad[1, :] = -1
    assert not _echo_ok(bad)


def test_poison_writes_the_staged_buffer_the_drain_reads():
    """On the CPU the staged echo is ``(tensor, None)``: the corrupt fault
    writes -1 into that tensor's output row in place, keeps the pending
    pair, counts no host sync, and the next drain refuses the step."""
    clock = SimClock()
    plan = FaultPlan((FaultSpec("corrupt", 0, 0),))
    cluster, _ = _build(1, clock, plan=plan)
    rep = cluster.replicas[0]
    assert not rep._poison_pending()            # idle: stays armed
    cluster.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=4)
    while rep._pending is None:
        rep.engine.step()
    (buf, event), snap = pending = rep._pending
    assert event is None and buf.shape == (2, 4)
    syncs = rep.stats.host_syncs
    assert rep._poison_pending()
    assert rep._pending is pending and rep._pending[0][0] is buf
    assert (buf[1] == -1).all() and rep.stats.host_syncs == syncs
    rep.engine.step()                            # drains the poisoned step
    assert rep.stats.integrity_failures == 1


# ---------------------------------------------------------------------------
# the end-to-end drills
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault,kind", [("crash", "dead"),
                                        ("hang", "straggler"),
                                        ("corrupt", "corrupt")])
def test_drill_recovers_crash_consistently(fault, kind):
    m = drill(fault)
    assert m["failures"] >= 1
    assert kind in m["failure_kinds"].split(",")
    assert m["survivors_identical"]
    assert m["all_accounted"]
    assert m["tokens_lost"] == 0
    assert m["blocks_leaked"] == 0
    assert m["recovery_latency_s"] > 0
    assert m["live_replicas"] == m["replicas"]
    assert not m["quarantined"]


def test_drill_crash_reclaims_and_resubmits():
    m = drill("crash")
    assert m["reclaimed"] >= 1
    assert m["recovered"] + m["abandoned"] >= 1
    assert m["completed"] + m["abandoned"] >= m["admitted"]


def test_drill_crashloop_is_quarantined():
    m = drill("crashloop")
    assert m["failures"] >= 4
    assert m["quarantined"]
    assert m["survivors_identical"]
    assert m["all_accounted"]
    assert m["tokens_lost"] == 0 and m["blocks_leaked"] == 0
    assert m["live_replicas"] == m["replicas"] - 1


def test_drill_replays_byte_for_byte():
    again = run_chaos_drill("crash", 2, n_requests=8, device="cpu")
    assert again == drill("crash")


@pytest.mark.parametrize("fault", KINDS)
@pytest.mark.parametrize("replicas", [2, 3])
def test_drill_equals_the_reference(fault, replicas):
    """The full 12-request drill: the port's dict is the reference's."""
    assert run_chaos_drill(fault, replicas, device="cpu") == \
        jrun_chaos_drill(fault, replicas)


def test_drill_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_chaos_drill("crash", 2, n_requests=2)


# ---------------------------------------------------------------------------
# the campaign cell and its table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["chaos_serving", "traffic_scaling"])
def test_grids_costs_and_tags_equal_jax(name):
    ours, theirs = treg.get(name), jreg.get(name)
    for quick in (True, False):
        assert ([c.key for c in ours.cells(quick=quick)]
                == [c.key for c in theirs.cells(quick=quick)])
    assert (ours.cost_per_cell_s, ours.tags, ours.description) == (
        theirs.cost_per_cell_s, theirs.tags, theirs.description)


@pytest.mark.parametrize("fault", KINDS)
def test_chaos_cell_equals_the_reference(fault):
    params = {"fault": fault, "replicas": 2}
    got = treg.run_chaos_serving_cell(params, quick=True, device="cpu")
    assert got == jreg.run_chaos_serving_cell(params, quick=True)
    assert got["ok"]


def test_chaos_serving_table_equals_the_reference(tmp_path):
    from repro_torch.core.campaign import runner as trunner
    from repro_torch.core.campaign.results import load_results
    rep = trunner.run("chaos_serving", out_dir=tmp_path, quick=True,
                      device="cpu")
    doc = load_results(rep.path)
    assert rep.failed == 0 and len(doc["cells"]) == 4
    rows = treport.table_for(doc)
    assert rows == jreport.chaos_serving_table(doc)
    assert all("ok=True" in d for _, _, d in rows)


# ---------------------------------------------------------------------------
# run_until_done stalls loudly
# ---------------------------------------------------------------------------

def test_run_until_done_raises_cluster_stalled():
    clock = SimClock()
    plan = FaultPlan((FaultSpec("crash", 0, 0),))   # dead on arrival
    cluster, _ = _build(1, clock, plan=plan)
    crid = cluster.submit(np.arange(4, dtype=np.int32), max_new_tokens=4)
    assert crid is not None
    with pytest.raises(ClusterStalled) as ei:
        cluster.run_until_done(max_steps=8)
    e = ei.value
    assert e.steps == 8 and e.in_flight == 1 and e.queued == 1
    assert "stalled" in str(e)
    assert cluster.run_until_done(max_steps=3, raise_on_stall=False) == 0
    assert cluster.router.in_flight == 1


# ---------------------------------------------------------------------------
# heartbeat membership + restart breaker
# ---------------------------------------------------------------------------

def test_registry_register_deregister():
    reg = HeartbeatRegistry(interval_s=1.0, miss_limit=3)
    with pytest.raises(KeyError):
        reg.beat("a", now=0.0)
    reg.register("a", now=100.0)
    assert reg.sweep(now=100.5) == []
    reg.beat("a", 0.5, now=101.0)
    assert reg.alive_hosts() == ["a"]
    reg.deregister("a")
    assert reg.alive_hosts() == []
    with pytest.raises(KeyError):
        reg.beat("a", now=102.0)
    reg.deregister("a")
    reg.register("a", now=200.0)
    reg.beat("a", 0.5, now=200.5)
    assert reg.alive_hosts() == ["a"]
    assert set(HeartbeatRegistry(["x", "y"]).hosts) == {"x", "y"}


def test_registry_abs_limit_flags_straggler_at_two_hosts():
    reg = HeartbeatRegistry(interval_s=1.0, miss_limit=3)
    reg.register("fast", now=0.0)
    reg.register("slow", now=0.0)
    for t in range(1, 5):
        reg.beat("fast", 0.1, now=float(t))
        reg.beat("slow", 5.0, now=float(t))
    assert reg.stragglers(z_threshold=4.0) == []
    assert reg.stragglers(z_threshold=4.0, abs_limit_s=1.0) == ["slow"]


def test_restart_policy_breaker_trips():
    pol = RestartPolicy(backoff_base_s=1.0, backoff_cap_s=60.0,
                        crash_loop_limit=3)
    assert pol.on_failure(now=0.0) == 1.0
    assert pol.on_failure(now=1.0) == 2.0
    assert pol.on_failure(now=2.0) == 4.0
    assert pol.on_failure(now=3.0) is None


# the fault-tolerance cases of tests/test_checkpoint_and_fault.py

def test_heartbeat_death_detection():
    reg = HeartbeatRegistry(["a", "b"], interval_s=1.0, miss_limit=3)
    t0 = 1000.0
    reg.beat("a", 0.1, now=t0)
    reg.beat("b", 0.1, now=t0)
    dead = []
    for i in range(1, 5):
        reg.beat("a", 0.1, now=t0 + i)
        dead += reg.sweep(now=t0 + i)
    assert dead == ["b"]
    assert reg.alive_hosts() == ["a"]


def test_straggler_detection():
    hosts = [f"h{i}" for i in range(8)]
    reg = HeartbeatRegistry(hosts)
    for _ in range(10):
        for h in hosts:
            reg.beat(h, 1.0 if h != "h3" else 3.0)
    assert reg.stragglers() == ["h3"]


def test_restart_policy_backoff_and_crashloop():
    p = RestartPolicy(backoff_base_s=1.0, crash_loop_limit=3, window_s=100)
    t = 0.0
    b1 = p.on_failure(now=t)
    b2 = p.on_failure(now=t + 1)
    b3 = p.on_failure(now=t + 2)
    assert (b1, b2, b3) == (1.0, 2.0, 4.0)
    assert p.on_failure(now=t + 3) is None
    assert p.on_failure(now=t + 500) is not None


def test_fault_runner_emits_events():
    reg = HeartbeatRegistry(["a", "b"], interval_s=1.0, miss_limit=2)
    r = FaultTolerantRunner(reg)
    t0 = 0.0
    r.on_step("a", 0, 0.5, now=t0)
    r.on_step("b", 0, 0.5, now=t0)
    evs = []
    for i in range(1, 4):
        evs += r.on_step("a", i, 0.5, now=t0 + i)
    kinds = [(e.kind, e.host) for e in evs]
    assert ("dead_host", "b") in kinds


def test_fault_runner_follows_the_reference():
    """One scripted fleet (a dead host, a straggler, a restart budget)
    through both packages: the same events, verdicts and backoffs."""
    def script(ft):
        hosts = [f"h{i}" for i in range(5)]
        runner = ft.FaultTolerantRunner(
            ft.HeartbeatRegistry(hosts, interval_s=1.0, miss_limit=2),
            ft.RestartPolicy(backoff_base_s=1.0, crash_loop_limit=2))
        events = []
        for step in range(8):
            for h in hosts:
                if h == "h4" and step > 2:
                    continue                      # h4 dies at step 3
                slow = 4.0 if h == "h1" else 1.0
                events += runner.on_step(h, step, slow, now=float(step))
        backoffs = [runner.policy.on_failure(now=float(t)) for t in range(4)]
        return ([(e.kind, e.host, e.step, e.action) for e in events],
                runner.registry.alive_hosts(), backoffs)
    assert script(tft) == script(jft)


# ---------------------------------------------------------------------------
# streaming telemetry
# ---------------------------------------------------------------------------

def test_sink_streams_past_ring_capacity(tmp_path):
    path = tmp_path / "stream.jsonl"
    sink = MetricsSink(capacity=2, stream_path=path)
    for i in range(5):
        sink.record_step(_step(i))
    sink.record_request(RequestRecord("paged", 0, 0.0, 1.0, 1.0, 4, 4))
    sink.stream_note({"record": "fault", "kind": "dead"})
    assert len(sink.steps()) == 2
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["record"] for x in lines] == ["step"] * 5 + ["request",
                                                          "fault"]
    assert [x["step"] for x in lines[:5]] == list(range(5))
    sink.close_stream()
    sink.record_step(_step(9))
    assert len(path.read_text().splitlines()) == 7


def test_sink_stream_redirect_and_off_mode(tmp_path):
    sink = MetricsSink(capacity=4)
    sink.record_step(_step(0))
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    sink.open_stream(a)
    sink.record_step(_step(1))
    sink.open_stream(b)
    sink.record_step(_step(2))
    assert json.loads(a.read_text())["step"] == 1
    assert json.loads(b.read_text())["step"] == 2
    assert sink.stream_path == b


def test_cluster_telemetry_tags_and_rebinds(tmp_path):
    tel = ClusterTelemetry(2, stream_dir=tmp_path)
    tel.sinks[0].record_request(RequestRecord("paged", 0, 0.0, 1.0,
                                              1.0, 4, 4))
    tel.tag_dead(0, 3.5, "dead")
    g0 = [json.loads(x) for x in
          (tmp_path / "replica_0.jsonl").read_text().splitlines()]
    assert g0[-1] == {"record": "fault", "replica": 0, "t_s": 3.5,
                      "kind": "dead"}
    old_sink = tel.sinks[0]
    ctrl = tel.rebind(0)
    assert ctrl is tel.controllers[0]
    assert tel.sinks[0] is not old_sink
    assert tel.retired == [(0, old_sink)]
    tel.sinks[0].record_request(RequestRecord("paged", 1, 2.0, 4.0,
                                              2.0, 4, 4))
    g1_path = tmp_path / "replica_0.g1.jsonl"
    assert json.loads(g1_path.read_text())["rid"] == 1
    s = tel.summary()
    assert s["requests"] == 2
    assert s["faults"] == [{"replica": 0, "t_s": 3.5, "kind": "dead"}]
    assert sorted(tel.request_latencies()) == [1.0, 2.0]
    out = tel.export_jsonl(tmp_path / "all.jsonl")
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["record"] for r in recs] == ["request", "request", "fault"]
    assert all(r["replica"] == 0 for r in recs)


def test_step_schema_carries_integrity_probe():
    assert "integrity_failures" in schema_field_names()


# ---------------------------------------------------------------------------
# brownout + supervisor bookkeeping
# ---------------------------------------------------------------------------

def test_token_bucket_tighten():
    b = TokenBucket(SLO(target_p99_s=8.0))
    r0 = b.rate_s
    b.tokens_s = b.burst_s
    assert b.tighten(0.5) == pytest.approx(r0 / 2)
    assert b.tokens_s == pytest.approx(b.burst_s)
    assert b.rate_trace == [b.rate_s]
    with pytest.raises(ValueError):
        b.tighten(0.0)
    with pytest.raises(ValueError):
        b.tighten(1.5)
    for _ in range(80):
        b.tighten(0.5)
    assert b.rate_s == pytest.approx(SLO(target_p99_s=8.0).min_rate_s)


def test_supervisor_failure_brownouts_survivors():
    clock = SimClock()
    tel = ClusterTelemetry(2, slo=SLO(target_p99_s=8.0))
    cluster, _ = _build(2, clock, telemetry=tel)
    sup = ChaosSupervisor(cluster, clock)
    r0 = tel.controllers[1].bucket.rate_s
    rec = sup._fail(0, "dead", clock.time())
    assert tel.controllers[1].bucket.rate_s == pytest.approx(r0 / 2)
    assert cluster.router.live_indices() == [1]
    assert sup.failures == [rec]
    assert rec.kind == "dead" and rec.generation == 0
    assert rec.recovery_s is None
    assert not rec.quarantined
    assert tel.faults == [{"replica": 0, "t_s": 0.0, "kind": "dead"}]
    assert sup.idle
    assert sup.registry.alive_hosts() == ["replica-1.g0"]


# ---------------------------------------------------------------------------
# router recovery seam (reclaim / resubmit / abandon)
# ---------------------------------------------------------------------------

def test_router_reclaim_resubmit_preserves_tokens():
    clock = SimClock()
    cluster, _ = _build(2, clock)
    router = cluster.router
    prompts = [np.arange(1, 5 + i, dtype=np.int32) for i in range(4)]
    crids = [cluster.submit(p, max_new_tokens=4) for p in prompts]
    assert all(c is not None for c in crids)
    for _ in range(2):
        cluster.step()
    victims = [c for c in crids if router._local[c][0] == 0]
    assert victims, "cost-aware placement left replica 0 empty"
    router.set_live(0, False)
    reclaimed = router.reclaim_replica(0)
    assert sorted(c for c, _ in reclaimed) == sorted(victims)
    survivors = [c for c in crids if c not in victims]
    if survivors:
        with pytest.raises(ValueError):
            router.resubmit(survivors[0], reclaimed[0][1])
    for crid, req in reclaimed:
        assert router.resubmit(crid, req)
    assert router.stats.recovered == len(reclaimed)
    cluster.run_until_done(max_steps=400)
    router.assert_drained()
    for crid, p in zip(crids, prompts):
        assert list(router.done[crid].tokens) == expected_tokens(
            list(p), 4, drill_mod.VOCAB)


def test_router_total_outage_sheds_and_abandons():
    clock = SimClock()
    cluster, _ = _build(2, clock)
    router = cluster.router
    crids = [cluster.submit(np.arange(4, dtype=np.int32), max_new_tokens=4)
             for _ in range(2)]
    router.set_live(0, False)
    router.set_live(1, False)
    assert cluster.submit(np.arange(4, dtype=np.int32)) is None
    assert router.stats.shed == 1
    reclaimed = router.reclaim_replica(0) + router.reclaim_replica(1)
    assert sorted(c for c, _ in reclaimed) == sorted(crids)
    for crid, req in reclaimed:
        assert not router.resubmit(crid, req)
        router.abandon(crid)
    assert router.stats.abandoned == 2
    router.assert_drained()


# ---------------------------------------------------------------------------
# pool integrity under fault storms (property test)
# ---------------------------------------------------------------------------

@settings(max_examples=50, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 63)),
                min_size=1, max_size=80))
def test_pool_integrity_under_fault_storm(ops):
    alloc = BlockAllocator(24, 8)
    held = []
    for op, k in ops:
        if op == 0:
            b = alloc.alloc()
            if b is not None:
                held.append(b)
        elif op == 1 and held:
            alloc.free([held.pop(k % len(held))])
        elif op == 2 and held:
            alloc.free([held.pop(k % len(held))])
            b = alloc.alloc()
            if b is not None:
                held.append(b)
        elif op == 3 and held:
            alloc.free(held)
            held = []
        alloc.check()
        assert alloc.n_in_use == len(held)
        assert alloc.n_free == alloc.n_blocks - len(held)
    alloc.free(held)
    alloc.check()
    assert alloc.n_in_use == 0


def test_pool_poison_is_caught():
    alloc = BlockAllocator(8, 4)
    a, b = alloc.alloc(), alloc.alloc()
    heapq.heappush(alloc._free, a)
    with pytest.raises(AssertionError):
        alloc.check()
    alloc._free.remove(a)
    heapq.heapify(alloc._free)
    alloc.check()
    alloc.free([b])
    with pytest.raises(ValueError):
        alloc.free([b])
    with pytest.raises(ValueError):
        alloc.free([999])


# ---------------------------------------------------------------------------
# chip_smoke.py's phase cluster (c), rehearsed on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_run():
    return chip_smoke.cluster_reduced(torch, np, 0, "cpu")


def test_reduced_cluster_gates_hold_on_the_cpu(reduced_run):
    readings, failures, _ = reduced_run
    assert failures == []
    assert readings["round_robin"]["preemptions"][0] > 0
    assert readings["distinct_tokens"] > 8
    crash, corrupt = readings["crash"], readings["corrupt"]
    assert crash["kinds"] == ["dead"] and crash["recovered"] >= 1
    # the crash must leave delivered tokens behind, or dropped_reclaim
    # would have nothing to drop
    assert crash["reclaimed_tokens"] > 0
    assert corrupt["kinds"] == ["corrupt"]
    assert corrupt["integrity_failures"] == 1 and corrupt["recovered"] >= 1
    for m in (crash, corrupt):
        assert m["completed"] == m["admitted"] == 12
        assert m["live_replicas"] == 2 and m["recovery_s"] > 0


@pytest.mark.parametrize("name", chip_smoke.CLUSTER_MUST_CATCH)
def test_cluster_control_fails_its_check_on_the_cpu(name, reduced_run):
    _, _, caught = reduced_run
    assert caught[name], name
    want = {"leaked_origin": "_origin", "unseen_poison": "integrity",
            "dropped_reclaim": "twin"}[name]
    assert any(want in c for c in caught[name])
