"""The port's serving cluster (``repro_torch.serve.cluster``) and the
pricing half of its sharding ranker (``repro_torch.sharding``) against the
JAX package, on the CPU.

* Every test of ``tests/test_cluster.py`` up to the benchmark-file
  tests, and its topology-ranking test, mirrored on the port's engines
  over ``FakeModel(device="cpu")`` under ``SimClock``.
* Cross-package cases: the same ``serve_trace`` run with ``unit_latency``
  pricing through both packages' clusters gives the same placement
  sequence, the same reroute, requeue and shed counts and the same
  tokens for each trace index, over the fake models (timestamps too) and
  over reduced gemma2-2b in f32 with the JAX weights carried across by
  ``params_from_jax`` (exact); ``rank_plans`` and
  ``rank_cluster_topologies`` give the reference's ordering and values
  when both price with the same calibration table and hardware spec.
* ``chip_smoke.py``'s phase cluster rehearsed: its sim tier equals the
  JAX package's, and its live cluster's gates hold on reduced gemma2.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import ShapeCell as JShapeCell
from repro.core import costmodel as jcm
from repro.core.perfmodel import hardware as jhw
from repro.models.zoo import build_model as jbuild
from repro.serve import cluster as jcluster
from repro.serve import engine as jengine
from repro.serve import sim as jsim
from repro.sharding import plans as jplans
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.core.costmodel import CostModel
from repro_torch.core.costmodel.calibration import CALIB_DIR, load_calibration
from repro_torch.core.perfmodel.hardware import H100_SXM
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zoo import build_model
from repro_torch.serve.cluster import (ClusterTelemetry, CostAwarePolicy,
                                       LeastLoadedPolicy, RoundRobinPolicy,
                                       Router, ServingCluster, make_policy,
                                       predicted_queue_seconds, serve_trace,
                                       skewed_trace, unit_latency)
from repro_torch.serve import cluster as tcluster
from repro_torch.serve import sim as tsim
from repro_torch.serve.engine import PagedServingEngine, ServingEngine
from repro_torch.serve.scheduler import ChunkedPrefillScheduler
from repro_torch.serve.sim import (FakeCostModel, FakeModel, SimClock, drive,
                                   expected_tokens, work_latency_model)
from repro_torch.sharding.cli import main as sharding_main
from repro_torch.sharding.plans import (candidate_mesh_shapes,
                                        rank_cluster_topologies, rank_plans)
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

VOCAB = 97
PRICES = dict(decode_s=0.5, chunk_s=0.25, overhead_s=0.01)
STEP = unit_latency(**PRICES)
ENGINE_KW = dict(max_batch=4, max_len=64, n_blocks=24, block_size=8,
                 chunk_size=8)


def build_cluster(n, policy="cost_aware", clock=None, shed_wait_s=None,
                  **kw):
    clock = clock if clock is not None else SimClock()
    for k, v in ENGINE_KW.items():
        kw.setdefault(k, v)
    kw.setdefault("cost_model", FakeCostModel(decode_s=0.5, prefill_s=0.25))
    cl = ServingCluster.build(FakeModel(vocab=VOCAB, device="cpu"), None,
                              n_replicas=n, policy=policy, clock=clock,
                              shed_wait_s=shed_wait_s, **kw)
    return cl, clock


def run_trace(cl, clock, trace):
    return serve_trace(cl, trace, clock, step_seconds=STEP, min_dt=0.25)


TRACE = skewed_trace(12, vocab=VOCAB, period=2, long_len=24, short_len=4,
                     long_new=12, short_new=4, interval_s=1.0, load=2.0)


def tight_trace(n=10, vocab=VOCAB):
    # pools of 8x8-token blocks per replica: a long request needs 5, so
    # concurrent longs evict each other -> preemptions + reroute chances
    return skewed_trace(n, vocab=vocab, period=2, long_len=24, short_len=4,
                        long_new=12, short_new=4, interval_s=1.0, load=4.0)


# ---------------------------------------------------------------------------
# replica_count=1: the cluster is a transparent wrapper
# ---------------------------------------------------------------------------


def test_single_replica_byte_identical_to_bare_engine():
    cl, clock = build_cluster(1)
    admitted = run_trace(cl, clock, TRACE)
    assert len(cl.done) == len(TRACE) and cl.stats.shed == 0

    clock2 = SimClock()
    eng = PagedServingEngine(FakeModel(vocab=VOCAB, device="cpu"), None,
                             clock=clock2,
                             cost_model=FakeCostModel(decode_s=0.5,
                                                      prefill_s=0.25),
                             **ENGINE_KW)
    rids = drive(eng, clock2, TRACE, dt=0.5)
    assert len(eng.done) == len(TRACE)
    for (crid, t_c), (rid, t_b) in zip(sorted(admitted.items()),
                                       sorted(rids.items())):
        assert t_c == t_b
        assert list(cl.done[crid].tokens) == list(eng.done[rid].tokens)
        assert cl.done[crid].submitted_s >= t_c


def test_single_replica_tokens_greedy_exact():
    cl, clock = build_cluster(1)
    run_trace(cl, clock, TRACE)
    for crid in cl.done:
        _, prompt, new, eos = TRACE[crid]
        assert list(cl.done[crid].tokens) == expected_tokens(
            prompt, new, VOCAB, eos)


# ---------------------------------------------------------------------------
# requeue_policy: default + declining hook are byte-identical
# ---------------------------------------------------------------------------


def _run_bare(requeue_policy, probe):
    clock = SimClock()
    eng = PagedServingEngine(FakeModel(vocab=VOCAB, device="cpu"), None,
                             max_batch=4, max_len=48, n_blocks=8,
                             block_size=8, chunk_size=8, clock=clock)
    if requeue_policy is not None:
        eng.scheduler.requeue_policy = requeue_policy
    trace = skewed_trace(8, vocab=VOCAB, period=2, long_len=24, short_len=4,
                         long_new=12, short_new=4, interval_s=1.0, load=4.0)
    drive(eng, clock, trace, dt=0.5, max_steps=2000)
    assert eng.stats.preemptions > 0, "trace must exercise the requeue path"
    if probe is not None:
        assert probe["calls"] == eng.stats.preemptions
    return [(rid, list(eng.done[rid].tokens), eng.done[rid].finished_s)
            for rid in sorted(eng.done)]


def test_requeue_policy_default_and_declining_hook_identical():
    baseline = _run_bare(None, None)
    probe = {"calls": 0}

    def decline(req):
        probe["calls"] += 1
        return False

    assert _run_bare(decline, probe) == baseline


def test_requeue_policy_claim_removes_from_queue():
    sched = ChunkedPrefillScheduler(chunk_size=8)

    class Req:
        prompt = np.arange(4)
        max_new_tokens = 2
    claimed = []
    sched.requeue_policy = lambda r: claimed.append(r) is None
    sched.requeue(Req())
    assert len(claimed) == 1 and len(sched.queue) == 0
    sched.requeue_policy = lambda r: False
    sched.requeue(Req())
    assert len(sched.queue) == 1


# ---------------------------------------------------------------------------
# replica_count>=2: conservation under preemption + re-route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded",
                                    "cost_aware"])
def test_tokens_conserved_under_preemption_and_reroute(policy):
    cl, clock = build_cluster(2, policy=policy, max_len=48, n_blocks=8)
    trace = tight_trace()
    admitted = run_trace(cl, clock, trace)
    assert sum(e.stats.preemptions for e in cl.replicas) > 0
    assert len(cl.done) == len(admitted) == len(trace)
    total = 0
    for crid in cl.done:
        _, prompt, new, eos = trace[crid]
        assert list(cl.done[crid].tokens) == expected_tokens(
            prompt, new, VOCAB, eos)
        total += len(cl.done[crid].tokens)
    assert total == sum(len(expected_tokens(p, n, VOCAB, e))
                        for _, p, n, e in trace)


def test_cost_aware_reroutes_and_tokens_survive_the_move():
    cl, clock = build_cluster(2, policy="cost_aware", max_len=48, n_blocks=8)
    trace = tight_trace()
    run_trace(cl, clock, trace)
    assert cl.stats.reroutes > 0, "tight pools must trigger a re-route"
    assert cl.stats.reroutes + cl.stats.front_requeues == sum(
        e.stats.preemptions for e in cl.replicas)
    for crid in cl.done:
        _, prompt, new, eos = trace[crid]
        assert list(cl.done[crid].tokens) == expected_tokens(
            prompt, new, VOCAB, eos)


def test_round_robin_never_reroutes():
    cl, clock = build_cluster(2, policy="round_robin", max_len=48,
                              n_blocks=8)
    run_trace(cl, clock, tight_trace())
    assert cl.stats.reroutes == 0
    assert cl.stats.front_requeues == sum(e.stats.preemptions
                                          for e in cl.replicas)


def test_cost_aware_beats_round_robin_on_skewed_trace():
    results = {}
    for policy in ("round_robin", "cost_aware"):
        cl, clock = build_cluster(2, policy=policy)
        admitted = run_trace(cl, clock, TRACE)
        lats = sorted(cl.done[c].finished_s - admitted[c] for c in cl.done)
        results[policy] = {
            "wall": clock.t,
            "p99": lats[int(0.99 * (len(lats) - 1))],
            "tokens": {c: list(cl.done[c].tokens) for c in cl.done},
        }
    rr, ca = results["round_robin"], results["cost_aware"]
    assert ca["wall"] < rr["wall"]
    assert ca["p99"] < rr["p99"]
    assert ca["tokens"] == rr["tokens"]


# ---------------------------------------------------------------------------
# router bookkeeping
# ---------------------------------------------------------------------------


def test_router_shed_and_routed_accounting():
    cl, clock = build_cluster(2, policy="round_robin", shed_wait_s=3.0)
    trace = skewed_trace(16, vocab=VOCAB, period=2, long_len=24,
                         short_len=4, long_new=12, short_new=4,
                         interval_s=1.0, load=8.0)
    admitted = run_trace(cl, clock, trace)
    st = cl.stats
    assert st.shed > 0 and st.submitted == len(admitted)
    assert st.shed + st.submitted == len(trace)
    assert sum(st.routed) >= st.submitted
    assert len(cl.done) == len(admitted)


def test_router_refuses_double_ownership_and_unknown_policy():
    cl, _ = build_cluster(2)
    with pytest.raises(ValueError):
        Router(cl.replicas, policy="round_robin")
    with pytest.raises(ValueError):
        make_policy("nope")


def test_reroute_cap_limits_ping_pong():
    cl, clock = build_cluster(2, policy="cost_aware", max_len=48,
                              n_blocks=8)
    cl.router.max_reroutes = 0
    run_trace(cl, clock, tight_trace())
    assert cl.stats.reroutes == 0
    assert len(cl.done) == len(tight_trace())


def test_router_bookkeeping_drains_and_leaks_are_loud():
    cl, clock = build_cluster(2, policy="cost_aware", max_len=48,
                              n_blocks=8)
    run_trace(cl, clock, tight_trace())
    assert cl.stats.reroutes > 0
    cl.router.assert_drained()
    cl.router._moves[999] = 0
    with pytest.raises(AssertionError, match="_moves"):
        cl.router.assert_drained()


def test_predicted_queue_seconds_empty_and_loaded():
    cl, _ = build_cluster(1)
    eng = cl.replicas[0]
    assert predicted_queue_seconds(eng) == 0.0
    eng.submit(np.arange(8, dtype=np.int32), max_new_tokens=4)
    # 1 chunk * 0.25s + 4 tokens * (0.5s / 4 rows)
    assert predicted_queue_seconds(eng) == pytest.approx(0.75)


def test_policy_place_prefers_empty_replica():
    cl, _ = build_cluster(2)
    cl.replicas[0].submit(np.arange(8, dtype=np.int32), max_new_tokens=8)
    for policy in (LeastLoadedPolicy(), CostAwarePolicy()):
        assert policy.place(4, 4, cl.replicas) == 1
    assert RoundRobinPolicy().place(4, 4, cl.replicas) == 0


def test_resubmit_keeps_the_original_arrival_stamp():
    """Both engines take ``submitted_s``: a request the router moves keeps
    its arrival time, and the default stamps the engine's clock."""
    clock = SimClock(3.0)
    model = build_model(reduced(ARCHS["gemma2-2b"], n_layers=2,
                                vocab_size=128), device="cpu")
    paged = PagedServingEngine(model, None, clock=clock, **ENGINE_KW)
    slot = ServingEngine(model, None, clock=clock, max_batch=2, max_len=64)
    for eng in (paged, slot):
        eng.submit(np.arange(4, dtype=np.int32))
        eng.submit(np.arange(4, dtype=np.int32), submitted_s=1.5)
        assert [q.submitted_s for q in eng.queue] == [3.0, 1.5]


# ---------------------------------------------------------------------------
# cluster telemetry: per-replica controllers, merged views
# ---------------------------------------------------------------------------


def test_cluster_telemetry_merge_and_tags(tmp_path):
    tel = ClusterTelemetry(2, latency_model=work_latency_model(0.5, 0.25))
    cl, clock = build_cluster(2, policy="round_robin", telemetry=tel)
    run_trace(cl, clock, TRACE)
    s = tel.summary()
    assert s["n_replicas"] == 2 and len(s["per_replica"]) == 2
    assert s["requests"] == len(TRACE)
    assert s["latency_p99_s"] >= s["latency_p50_s"] > 0
    lines = tel.export_jsonl(tmp_path / "cluster.jsonl").read_text()
    tags = {json.loads(ln)["replica"] for ln in lines.splitlines()}
    assert tags == {0, 1}


def test_build_from_device_budget_uses_cost_model_topology():
    model = FakeModel(vocab=VOCAB, device="cpu")
    cm = CostModel.from_named("hopper_h100")
    cell = ShapeCell("t", "decode", 64, 4)
    cluster = ServingCluster.build(model, None, clock=SimClock(),
                                   cost_model=cm, n_devices=4, cell=cell,
                                   **ENGINE_KW)
    top = rank_cluster_topologies(model.cfg, cell, 4, cm)[0]
    assert cluster.topology is not None
    assert len(cluster.replicas) == top.n_replicas
    assert cluster.topology.devices_per_replica * top.n_replicas == 4
    # unsharded replicas: one weights object, no mesh
    assert all(e.params is None for e in cluster.replicas)
    with pytest.raises(ValueError):
        ServingCluster.build(model, None)   # neither n_replicas nor budget


def test_replicas_share_the_callers_weights():
    cfg = reduced(ARCHS["gemma2-2b"], n_layers=2, vocab_size=128)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    cl = ServingCluster.build(model, params, n_replicas=3, **ENGINE_KW)
    assert all(e.params is params for e in cl.replicas)
    with pytest.raises(ValueError, match="engine kind"):
        ServingCluster.build(model, params, n_replicas=1, engine="disk")


# ---------------------------------------------------------------------------
# sharding CLI: ranked factorization tables
# ---------------------------------------------------------------------------


def test_sharding_cli_prints_ranked_tables(capsys):
    rc = sharding_main(["--calibration", "hopper_h100", "--topology",
                        "4,8,128", "--devices", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "data=" in out and "<- best" in out
    assert "replicas=" in out
    assert "calibration=hopper_h100" in out


def test_sharding_cli_defaults_to_the_h100_table(capsys):
    assert sharding_main(["--topology", "4,8,128", "--devices", "1"]) == 0
    out = capsys.readouterr().out
    assert "calibration=hopper_h100" in out and "replicas=" not in out


def test_sharding_cli_rejects_bad_topology():
    with pytest.raises(SystemExit):
        sharding_main(["--topology", "8,8"])


def test_rank_cluster_topologies_orders_and_factors():
    cfg = reduced(ARCHS["gemma2-2b"], n_layers=2, vocab_size=128)
    cell = ShapeCell("t", "decode", 128, 8)
    cm = CostModel.from_named("hopper_h100")
    tops = rank_cluster_topologies(cfg, cell, 8, cm)
    assert [t.predicted_tok_s for t in tops] == sorted(
        (t.predicted_tok_s for t in tops), reverse=True)
    for t in tops:
        assert 8 % t.n_replicas == 0
        assert t.devices_per_replica * t.n_replicas == 8
        assert t.predicted_tok_s == pytest.approx(
            t.n_replicas * cell.global_batch / t.plan.step_s)
    assert rank_cluster_topologies(cfg, cell, 8, cm, max_replicas=1)[
        0].n_replicas == 1


# ---------------------------------------------------------------------------
# cross-package: the port's cluster against the JAX package's
# ---------------------------------------------------------------------------


def _placements(cl):
    """Spy on the router's policy: the replica every placement decision
    (fresh or resubmitted) picked, in order."""
    picks, place = [], cl.router.policy.place

    def spy(prompt_len, max_new_tokens, replicas):
        picks.append(place(prompt_len, max_new_tokens, replicas))
        return picks[-1]
    cl.router.policy.place = spy
    return picks


def _summary(cl, admitted, gap):
    st = cl.stats
    return {"picks": cl._picks,
            "tokens": {round(t / gap): list(cl.done[c].tokens)
                       for c, t in admitted.items()},
            "finished": {round(t / gap): cl.done[c].finished_s
                         for c, t in admitted.items()},
            "counts": (st.submitted, st.shed, st.reroutes,
                       st.front_requeues, st.decisions, list(st.routed)),
            "preemptions": [e.stats.preemptions for e in cl.replicas]}


def _both_clusters(jmodel, jparams, tmodel, tparams, jcost, tcost, trace,
                   policy, gap, **kw):
    out = []
    for mod, sim, model, params, cost in (
            (jcluster, jsim, jmodel, jparams, jcost),
            (tcluster, tsim, tmodel, tparams, tcost)):
        clock = sim.SimClock()
        cl = mod.ServingCluster.build(model, params, n_replicas=2,
                                      policy=policy, clock=clock,
                                      cost_model=cost, **kw)
        cl._picks = _placements(cl)
        admitted = mod.serve_trace(cl, trace, clock,
                                   step_seconds=mod.unit_latency(**PRICES),
                                   min_dt=0.25)
        out.append(_summary(cl, admitted, gap))
    return out


OVERLOAD = skewed_trace(16, vocab=VOCAB, period=2, long_len=24, short_len=4,
                        long_new=12, short_new=4, interval_s=1.0, load=8.0)


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded",
                                    "cost_aware"])
@pytest.mark.parametrize("load", ["tight", "overload"])
def test_sim_serve_trace_equals_the_jax_cluster(policy, load):
    """Fake models on tight pools, and overloaded behind a shedding
    ceiling: placements, counters, tokens and finish stamps equal,
    exactly."""
    trace, gap, shed = ((tight_trace(), 0.25, None) if load == "tight"
                        else (OVERLOAD, 0.125, 3.0))
    kw = dict(ENGINE_KW, max_len=48, n_blocks=8) if load == "tight" else {}
    mine, theirs = _both_clusters(
        jsim.FakeModel(vocab=VOCAB), None,
        FakeModel(vocab=VOCAB, device="cpu"), None,
        jsim.FakeCostModel(decode_s=0.5, prefill_s=0.25),
        FakeCostModel(decode_s=0.5, prefill_s=0.25), trace, policy, gap,
        shed_wait_s=shed, **(kw or ENGINE_KW))
    assert mine == theirs
    if load == "tight":
        assert sum(mine["preemptions"]) > 0
        assert policy != "cost_aware" or mine["counts"][2] > 0   # reroutes
    else:
        assert mine["counts"][1] > 0                              # shed


@pytest.fixture(scope="module")
def f32_models():
    kw = dict(n_layers=2, vocab_size=128, compute_dtype="float32")
    jm = jbuild(jreduced(JARCHS["gemma2-2b"], **kw))
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = reduced(ARCHS["gemma2-2b"], **kw)
    tm = build_model(cfg, device="cpu")
    return jm, jparams, tm, params_from_jax(jax.device_get(jparams), cfg,
                                            "cpu")


@pytest.mark.parametrize("policy", ["round_robin", "cost_aware"])
def test_real_serve_trace_equals_the_jax_cluster(policy, f32_models,
                                                 monkeypatch):
    """Reduced f32 gemma2 through both packages' clusters, each priced by
    its own fake table (a real table prices the decode step from the HLO
    in the reference, from a census in the port): the same placements,
    counters and tokens for each trace index.  The JAX replicas take each
    host->device upload from a copy (see ``tests/test_torch_engine.py``:
    an aliased block table races an in-flight step, and changed the
    reference's tokens in 2 of 16 runs on a loaded host)."""
    upload = jengine.PagedServingEngine._dev
    monkeypatch.setattr(
        jengine.PagedServingEngine, "_dev",
        lambda self, x, kind="repl": upload(self, np.array(x, copy=True),
                                            kind))
    jm, jparams, tm, tparams = f32_models
    trace = tight_trace(10, vocab=128)
    mine, theirs = _both_clusters(
        jm, jparams, tm, tparams,
        jsim.FakeCostModel(decode_s=0.5, prefill_s=0.25),
        FakeCostModel(decode_s=0.5, prefill_s=0.25), trace, policy, 0.25,
        **dict(ENGINE_KW, max_len=48, n_blocks=8))
    assert mine["tokens"] == theirs["tokens"]
    assert mine == theirs
    assert len(mine["tokens"]) == len(trace)
    assert sum(mine["preemptions"]) > 0
    assert len({t for r in mine["tokens"].values() for t in r}) > 8


def _jspec(spec):
    return jhw.HardwareSpec(**dataclasses.asdict(spec))


@pytest.mark.parametrize("table", ["hopper_h100", "ampere_a100"])
@pytest.mark.parametrize("arch,devices,kind", [
    ("gemma2-2b", 8, "decode"), ("gemma2-2b", 4, "prefill"),
    ("yi-34b", 16, "decode"), ("rwkv6-1.6b", 4, "train")])
def test_ranking_equals_the_jax_ranking(table, arch, devices, kind):
    """One calibration table and one hardware spec on both sides: the
    candidate meshes, the plans' order and step times, and the cluster
    topologies' order and rates are the reference's."""
    mine = CostModel(load_calibration(table), hw=H100_SXM)
    theirs = jcm.CostModel(jcm.load_calibration(CALIB_DIR / f"{table}.json"),
                           hw=_jspec(H100_SXM))
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    cell = ShapeCell("t", kind, 512, 8)
    jcell = JShapeCell("t", kind, 512, 8)
    assert candidate_mesh_shapes(devices, cfg) == \
        jplans.candidate_mesh_shapes(devices, jcfg)
    got = [(p.mesh_shape, p.step_s, p.prediction.bottleneck)
           for p in rank_plans(cfg, cell, devices, mine)]
    want = [(p.mesh_shape, p.step_s, p.prediction.bottleneck)
            for p in jplans.rank_plans(jcfg, jcell, devices, theirs)]
    assert got == want
    got = [(t.n_replicas, t.plan.mesh_shape, t.predicted_tok_s)
           for t in rank_cluster_topologies(cfg, cell, devices, mine)]
    want = [(t.n_replicas, t.plan.mesh_shape, t.predicted_tok_s)
            for t in jplans.rank_cluster_topologies(jcfg, jcell, devices,
                                                    theirs)]
    assert got == want


def test_rank_plans_defaults_to_the_h100_table():
    cfg = get_config("gemma2-2b")
    cell = ShapeCell("t", "decode", 1024, 4)
    assert [p.step_s for p in rank_plans(cfg, cell, 2)] == [
        p.step_s for p in rank_plans(cfg, cell, 2,
                                     CostModel.from_named("hopper_h100"))]


# ---------------------------------------------------------------------------
# chip_smoke.py's phase cluster, rehearsed on the CPU
# ---------------------------------------------------------------------------


def _jax_cluster_sim():
    """The sim half of ``chip_smoke.cluster_sim`` through the JAX package."""
    from repro.serve.chaos import run_chaos_drill
    kw = dict(chip_smoke.CLUSTER_SIM_TRACE)
    trace = jcluster.skewed_trace(kw.pop("n_requests"), **kw)
    out = {}
    for policy in ("round_robin", "cost_aware"):
        clock = jsim.SimClock()
        cl = jcluster.ServingCluster.build(
            jsim.FakeModel(vocab=kw["vocab"]), None, n_replicas=2,
            policy=policy, clock=clock,
            cost_model=jsim.FakeCostModel(decode_s=0.5, prefill_s=0.25),
            **chip_smoke.CLUSTER_SIM_KW)
        admitted = jcluster.serve_trace(
            cl, trace, clock,
            step_seconds=jcluster.unit_latency(*chip_smoke.CHAOS_PRICES),
            min_dt=0.25)
        lats = sorted(cl.done[c].finished_s - admitted[c] for c in cl.done)
        out[policy] = {
            "wall_s": clock.t, "p99_s": lats[int(0.99 * (len(lats) - 1))],
            "completed": len(cl.done), "routed": list(cl.stats.routed),
            "reroutes": cl.stats.reroutes,
            "front_requeues": cl.stats.front_requeues,
            "preemptions": [e.stats.preemptions for e in cl.replicas],
            "tokens": [list(cl.done[c].tokens) for c in sorted(cl.done)]}
    for fault in chip_smoke.CHAOS_KINDS:
        out[f"chaos_{fault}"] = run_chaos_drill(fault, 2, n_requests=8)
    return out


def test_phase_cluster_sim_equals_the_jax_package():
    got = chip_smoke.cluster_sim("cpu")
    assert chip_smoke.scenario_gate(got, _jax_cluster_sim()) == []
    assert chip_smoke.cluster_sim_gates(got) == []


def test_phase_cluster_live_gates_hold_on_reduced_gemma2():
    """(b)'s run and gates on reduced bf16 gemma2 at the reduced
    engine's sizes: every gate but the kernel count (no kernel on the
    CPU) holds, round-robin piles the long requests on replica 0, and the
    line carries each policy's readings."""
    cfg = reduced(get_config("gemma2-2b"), n_layers=2, vocab_size=128)
    model = build_model(cfg, device="cpu")
    line, bad = chip_smoke.cluster_live(
        torch, model, model.init(0),
        dict(max_batch=4, max_len=64, block_size=8, chunk_size=8),
        CostModel.from_named("hopper_h100"))
    assert bad == []
    rr = line["policies"]["round_robin"]
    assert rr["routed"] == [6, 6] and rr["reroutes"] == 0
    assert rr["replicas"][0]["preemptions"] > 0
    assert rr["front_requeues"] == rr["replicas"][0]["preemptions"]
    assert line["trace"] == {"requests": 12, "prompt_tokens": [16, 31],
                             "new_tokens": [8, 32]}
    assert line["engine"]["n_blocks"] == 19
    for res in line["policies"].values():
        assert res["tok_per_s"] > 0 and res["p99_s"] >= res["p50_s"] > 0
        assert res["shed_rate"] == 0.0


def test_cluster_pool_is_the_campaigns_ratio():
    assert chip_smoke.cluster_pool(4, 1024, 16) == 153
    assert chip_smoke.cluster_pool(4, 64, 8) == 19
    assert chip_smoke.cluster_pool(1, 64, 8) == 8


def test_traffic_scaling_cell_runs_on_the_cpu_and_renders(tmp_path):
    """The port's ``traffic_scaling`` quick grid through the campaign
    runner on the CPU: every cell's gates hold, and ``report`` renders the
    reference's row shape from the document."""
    from repro.core.campaign import report as jreport
    from repro_torch.core.campaign import report as treport
    from repro_torch.core.campaign import runner as trunner
    from repro_torch.core.campaign.results import load_results
    rep = trunner.run("traffic_scaling", out_dir=tmp_path, quick=True,
                      device="cpu")
    doc = load_results(rep.path)
    assert rep.failed == 0 and len(doc["cells"]) == 2
    for rec in doc["cells"].values():
        m = rec["metrics"]
        assert m["identical_tokens"] and m["rr_conserved"]
        assert m["ca_conserved"]
        assert m["topology_replicas"] == m["replicas"]
    rows = treport.table_for(doc)
    assert rows == jreport.traffic_scaling_table(doc)
    assert all("identical=True" in d and "conserved=True" in d
               for _, _, d in rows)

