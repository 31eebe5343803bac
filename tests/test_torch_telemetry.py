"""The port's telemetry layer (``repro_torch.serve.telemetry``) against the
JAX package's, on the CPU.

* Every test of ``tests/test_telemetry.py``, mirrored on the port: the
  metrics pipeline, the drift detector, the SLO token bucket, the
  recalibration over the port's ``CostModel`` (priced from the committed
  ``hopper_h100`` table), the controller, and the drift and overload
  acceptance scenarios on the port's sim harness.
* Cross-package cases: the scenarios' result dicts equal the reference's
  field by field; the record schemas carry the same names; a snapshot
  written by either package loads with the other's ``load_snapshot``;
  ``rescale_calibration`` of one table gives the reference's document;
  ``checkdocs`` passes against the unedited ``docs/reference/metrics.md``;
  ``telemetry_table`` renders the reference's rows.
* Reduced f32 gemma2 through both packages' paged engines under a
  ``SimClock`` with a controller each: identical tokens, and the step
  records' host bookkeeping equal.
* ``chip_smoke.py``'s phase telemetry rehearsed: its reduced runs' gates
  hold on the CPU, and each ``TELEMETRY_MUST_CATCH`` fault fails the check
  that names it.
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
from repro.core.campaign import report as jreport
from repro.core.costmodel import CostModel as JCostModel
from repro.core.costmodel.calibration import load_calibration as jload_cal
from repro.core.perfmodel.hardware import HardwareSpec as JHardwareSpec
from repro.models.zoo import build_model as jbuild
from repro.serve import PagedServingEngine as _JaxEngine
from repro.serve import sim as jsim
from repro.serve import telemetry as jtel
from repro.serve.telemetry import scenarios as jscenarios
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.autotune.cache import TuningCache, entry_key
from repro_torch.core.campaign import report as treport
from repro_torch.core.campaign import runner as trunner
from repro_torch.core.costmodel.calibration import CALIB_DIR, load_calibration
from repro_torch.core.costmodel.model import CostModel
from repro_torch.core.perfmodel.hardware import H100_SXM
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import (PagedServingEngine, ServingEngine,
                                      _DeviceLoop)
from repro_torch.serve.sim import (FakeCostModel, FakeModel, SimClock, drive,
                                   work_latency_model)
from repro_torch.serve.telemetry import (SLO, DriftDetector, MetricsSink,
                                         RequestRecord, StepRecord,
                                         TelemetryController, TokenBucket,
                                         invalidate_tuning_entries,
                                         rescale_calibration,
                                         validate_snapshot)
from repro_torch.serve.telemetry import cli as tcli
from repro_torch.serve.telemetry import scenarios as tscenarios
from repro_torch.serve.telemetry.control import TelemetryController as TC
from repro_torch.serve.telemetry.metrics import (REQUEST_FIELDS, STEP_FIELDS,
                                                 load_snapshot, quantile,
                                                 schema_field_names)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TABLE = "hopper_h100"


def _step(i=0, **kw):
    base = dict(engine="slot", step=i, t_s=float(i), n_active=2,
                queue_depth=0, predicted_s=1.0, predicted_decode_s=1.0,
                measured_s=1.0, decode_ran=True, n_prefill_units=0,
                bottleneck="memory", budget_s=0.0, host_syncs=i,
                table_uploads=0, blocks_in_use=0, n_blocks=0,
                decoded_tokens=2 * i, preemptions=0, deferred=0,
                kernel_splits=0)
    base.update(kw)
    return StepRecord(**base)


# ---------------------------------------------------------------------------
# metrics pipeline (stdlib only)
# ---------------------------------------------------------------------------


def test_schema_covers_every_record_field():
    assert {f.name for f in STEP_FIELDS} == \
        {f.name for f in dataclasses.fields(StepRecord)}
    assert {f.name for f in REQUEST_FIELDS} == \
        {f.name for f in dataclasses.fields(RequestRecord)}
    for f in STEP_FIELDS + REQUEST_FIELDS:
        assert f.unit and f.engines and f.description
    assert "measured_s" in schema_field_names()


def test_quantile_interpolates():
    xs = [1.0, 2.0, 3.0, 4.0]
    assert quantile(xs, 0.0) == 1.0
    assert quantile(xs, 1.0) == 4.0
    assert quantile(xs, 0.5) == 2.5
    assert quantile([], 0.99) == 0.0


def test_sink_ring_snapshot_roundtrip_and_jsonl(tmp_path):
    sink = MetricsSink(capacity=4)
    for i in range(6):                  # overflow the ring
        sink.record_step(_step(i, measured_s=1.0 + i, kernel_splits=4))
    sink.record_request(RequestRecord("slot", 0, 0.0, 3.0, 3.0, 4, 8))
    assert sink.total_steps == 6 and len(sink.steps()) == 4
    assert sink.steps()[0].step == 2    # oldest fell off

    path = sink.save(tmp_path / "snap.json")
    doc = load_snapshot(path)
    assert doc["kind"] == "telemetry_snapshot"
    assert len(doc["steps"]) == 4
    assert all(s["kernel_splits"] == 4 for s in doc["steps"])
    assert doc["summary"]["steps"] == 6
    assert doc["summary"]["request_p99_s"] == 3.0
    assert {f["name"] for f in doc["schema"]["step"]} == \
        {f.name for f in STEP_FIELDS}

    out = sink.export_jsonl(tmp_path / "log.jsonl")
    lines = [json.loads(line) for line in
             out.read_text().strip().splitlines()]
    assert [ln["record"] for ln in lines] == ["step"] * 4 + ["request"]


def test_snapshot_loud_refusal():
    with pytest.raises(ValueError, match="not a telemetry snapshot"):
        validate_snapshot({"entries": {}})          # kind-less JSON
    with pytest.raises(ValueError, match="newer than supported"):
        validate_snapshot({"kind": "telemetry_snapshot", "version": 99})


# ---------------------------------------------------------------------------
# drift detector
# ---------------------------------------------------------------------------


def test_drift_fires_once_past_gate_then_cools_down():
    d = DriftDetector(0.10, window=6, min_samples=4, cooldown=5)
    events = [d.observe("decode", "b4", 1.0, 2.0) for _ in range(10)]
    fired = [e for e in events if e is not None]
    assert len(fired) == 1              # window reset + cooldown
    assert events[3] is not None        # exactly at min_samples
    ev = fired[0]
    assert ev.kind == "decode" and ev.bucket == "b4"
    assert ev.ratio == pytest.approx(2.0) and ev.error == pytest.approx(1.0)
    assert d.events == fired


def test_drift_median_resists_one_outlier_and_in_gate_is_quiet():
    d = DriftDetector(0.10, window=8, min_samples=4)
    for _ in range(7):
        assert d.observe("decode", "b4", 1.0, 1.02) is None
    # one preempted/compacted outlier step must not fake a drift
    assert d.observe("decode", "b4", 1.0, 9.0) is None
    assert d.error("decode", "b4") < 0.10


def test_drift_skips_unpriceable_samples():
    d = DriftDetector(window=4, min_samples=2)
    for _ in range(8):
        assert d.observe("decode", "b4", 0.0, 1.0) is None   # no model
    assert d.error("decode", "b4") is None


# ---------------------------------------------------------------------------
# SLO token bucket
# ---------------------------------------------------------------------------


def test_token_bucket_refill_burst_and_spend_floor():
    b = TokenBucket(SLO(target_p99_s=1.0), burst_factor=2.0)
    assert b.begin_step() == pytest.approx(2.0)     # full + refill -> burst
    b.spend(5.0)                                    # overdraft floors at 0
    assert b.budget_s == 0.0
    assert b.begin_step() == pytest.approx(1.0)     # one refill


def test_token_bucket_aimd_adapts_rate():
    slo = SLO(target_p99_s=1.0, window=4, increase=0.1, decrease=0.5)
    b = TokenBucket(slo)
    for _ in range(4):
        b.observe(2.0)                              # violated window
    assert b.violations == 1 and b.rate_s == pytest.approx(0.5)
    for _ in range(4):
        b.observe(0.1)                              # healthy window
    assert b.windows == 2 and b.rate_s == pytest.approx(0.6)
    assert b.rate_trace == [pytest.approx(0.5), pytest.approx(0.6)]


def test_token_bucket_rate_floor_prevents_starvation():
    slo = SLO(target_p99_s=1.0, window=2, decrease=0.5, min_rate_s=0.25)
    b = TokenBucket(slo)
    for _ in range(20):
        b.observe(9.0)
    assert b.rate_s == pytest.approx(0.25)          # floored, not 0


# ---------------------------------------------------------------------------
# recalibration over the port's cost model
# ---------------------------------------------------------------------------


def test_rescale_calibration_scales_the_implicated_term():
    model = CostModel.from_named(TABLE)
    mem_census = {"flops": 1e6, "hbm_bytes": 1e9}
    mxu_census = {"flops": 1e15, "hbm_bytes": 1.0}
    base_mem = model.predict(mem_census)
    base_mxu = model.predict(mxu_census)
    assert base_mem.bottleneck == "memory"
    assert base_mxu.bottleneck == "compute"

    slow_mem = CostModel(rescale_calibration(model.cal, 2.0,
                                             bottleneck="memory"))
    assert slow_mem.predict(mem_census).memory_s == \
        pytest.approx(2.0 * base_mem.memory_s)
    assert slow_mem.predict(mxu_census).compute_s == \
        pytest.approx(base_mxu.compute_s)

    slow_mxu = CostModel(rescale_calibration(model.cal, 3.0,
                                             bottleneck="compute"))
    assert slow_mxu.predict(mxu_census).compute_s == \
        pytest.approx(3.0 * base_mxu.compute_s)

    # pure-data update: the source calibration is never mutated
    assert model.predict(mem_census).memory_s == \
        pytest.approx(base_mem.memory_s)
    assert rescale_calibration(model.cal, 2.0).name.endswith("+recal")
    with pytest.raises(ValueError, match="positive"):
        rescale_calibration(model.cal, 0.0)


def test_invalidate_tuning_entries_by_calibration_id():
    cache = TuningCache(path=None)
    k_stale = entry_key("paged_attention", "b8", "bf16", "cuda", TABLE)
    k_other = entry_key("paged_attention", "b8", "bf16", "cuda", "fresh")
    cache.put(k_stale, {"config": {"chunk_tokens": 64}})
    cache.put(k_other, {"config": {"chunk_tokens": 128}})
    assert invalidate_tuning_entries(cache, calibration_id=TABLE) == 1
    assert cache.get(k_stale) is None and cache.get(k_other) is not None
    # None = conservative drop-everything
    assert invalidate_tuning_entries(cache, calibration_id=None) == 1
    assert len(cache) == 0


class _StubEngine:
    """Just enough engine surface for the controller's calibration path."""
    max_batch = 4

    def __init__(self, cost_model, autotuner=None):
        self.cost_model = cost_model
        self.autotuner = autotuner
        self._pred_cache = {"stale": object()}

    def set_cost_model(self, cm):
        self.cost_model = cm
        self._pred_cache.clear()


class _StubTuner:
    def __init__(self, cost_model, cache):
        self.cost_model = cost_model
        self.cache = cache


def test_controller_applies_calibration_recalibration_end_to_end():
    """The port's CostModel (no ``rescale`` protocol): a drift event swaps
    in a rescaled calibration, clears the engine's prediction cache, drops
    the stale tuning entries and repoints the autotuner."""
    cm = CostModel.from_named(TABLE)
    cache = TuningCache(path=None)
    cache.put(entry_key("paged_attention", "b4", "bf16", "cuda",
                        cm.cal.name), {"config": {"block_size": 16}})
    cache.put(entry_key("paged_attention", "b4", "bf16", "cuda",
                        "unrelated"), {"config": {"block_size": 32}})
    engine = _StubEngine(cm, _StubTuner(cm, cache))
    ctl = TelemetryController(
        drift=DriftDetector(0.10, window=4, min_samples=3))
    ctl.bind(engine)

    mem = {"flops": 1e6, "hbm_bytes": 1e9}
    base = cm.predict(mem)
    for i in range(3):
        ctl.on_step(_step(i, predicted_decode_s=1e-3, measured_s=2e-3))
    assert len(ctl.recalibrations) == 1
    ev = ctl.recalibrations[0]
    assert ev.applied == "calibration"
    assert ev.calibration_before == TABLE
    assert ev.calibration_after.endswith("+recal")
    assert ev.invalidated == 1                     # only the stale entry
    assert cache.get(entry_key("paged_attention", "b4", "bf16", "cuda",
                               "unrelated")) is not None
    assert engine.cost_model is not cm             # swapped, not mutated
    assert engine.autotuner.cost_model is engine.cost_model
    assert engine._pred_cache == {}                # re-prices next step
    assert engine.cost_model.predict(mem).memory_s == \
        pytest.approx(2.0 * base.memory_s)
    assert ctl.sink.events() == ctl.recalibrations


def test_controller_observe_only_mode_records_but_never_applies():
    cm = CostModel.from_named(TABLE)
    engine = _StubEngine(cm)
    ctl = TelemetryController(
        drift=DriftDetector(0.10, window=4, min_samples=3),
        recalibrate=False)
    ctl.bind(engine)
    for i in range(3):
        ctl.on_step(_step(i, predicted_decode_s=1e-3, measured_s=2e-3))
    assert len(ctl.recalibrations) == 1
    assert ctl.recalibrations[0].applied == "none"
    assert engine.cost_model is cm


def test_controller_rejects_double_bind_and_bad_slo():
    ctl = TelemetryController(drift=False)
    ctl.bind(_StubEngine(None))
    with pytest.raises(ValueError, match="already bound"):
        ctl.bind(_StubEngine(None))
    with pytest.raises(TypeError, match="SLO or TokenBucket"):
        TelemetryController(slo=3.5)


def test_mixed_steps_never_feed_drift():
    ctl = TelemetryController(
        drift=DriftDetector(0.10, window=4, min_samples=1))
    ctl.bind(_StubEngine(None))
    for i in range(8):
        ctl.on_step(_step(i, n_prefill_units=2, decode_ran=True,
                          predicted_decode_s=1e-3, measured_s=1.0))
    assert ctl.recalibrations == []


def test_paged_controller_binds_before_chunk_size_as_the_reference():
    """Both packages bind the controller before ``chunk_size`` is set, so
    its chunk bucket stays empty and pure-chunk steps, drifted 3x here,
    never reach the detector: only the decode bucket is fed."""
    ctl = TelemetryController(
        drift=DriftDetector(0.10, window=4, min_samples=2),
        latency_model=work_latency_model(1.0, 3.0))
    clock = SimClock()
    eng = PagedServingEngine(FakeModel(device="cpu"), None, clock=clock,
                             max_batch=2, max_len=32, block_size=4,
                             chunk_size=4, cost_model=FakeCostModel(),
                             telemetry=ctl)
    assert ctl._chunk_bucket == "" and ctl._decode_bucket == "b2"
    drive(eng, clock, [(0.0, list(range(1, 17)), 2, None),
                       (0.0, list(range(20, 36)), 2, None)])
    assert any(r.n_prefill_units and not r.decode_ran
               for r in ctl.sink.steps())
    assert ctl.recalibrations == []
    assert eng.cost_model.prefill_s == FakeCostModel().prefill_s
    jctl = jtel.TelemetryController()
    _JaxEngine(jsim.FakeModel(), None, clock=jsim.SimClock(), max_batch=2,
               max_len=32, block_size=4, chunk_size=4, telemetry=jctl)
    assert (jctl._chunk_bucket, jctl._decode_bucket) == (
        ctl._chunk_bucket, ctl._decode_bucket)


# ---------------------------------------------------------------------------
# acceptance scenarios on the sim harness
# ---------------------------------------------------------------------------


def test_drift_scenario_exactly_one_event_restores_error_and_tokens():
    res = tscenarios.run_drift_scenario(drift_factor=2.0)
    assert res["n_events"] == 1                    # exactly one, not a storm
    assert res["pre_error"] > 0.10                 # the injected drift
    assert res["post_error"] < 0.10                # restored under the gate
    assert res["post_samples"] >= 4
    assert res["rescales"] == [("decode", pytest.approx(2.0))]
    assert res["tokens_ok"]
    assert res["completed"] == res["n_requests"]


def test_overload_scenario_holds_slo_and_sheds_newest_first():
    res = tscenarios.run_overload_scenario(load_factor=2)
    assert res["slo_held"]                         # p99 <= target at 2x load
    assert res["baseline_violates"]                # ungated would spike
    assert res["deferred"] > 0                     # newest actually shed
    assert res["admission_fifo"]                   # oldest protected
    assert res["tokens_ok"]
    assert res["completed"] == res["n_requests"]


def test_engine_reprices_after_set_cost_model():
    """Swapping the cost model clears the prediction cache; the decode
    step re-prices from its census and the new price takes effect in
    admission (the reference re-prices from stored HLO text)."""
    cm = FakeCostModel(decode_s=1.0, prefill_s=1.0)
    eng = PagedServingEngine(FakeModel(device="cpu"), params=None,
                             clock=SimClock(), max_batch=2, max_len=32,
                             block_size=4, chunk_size=4, cost_model=cm)
    eng.submit(np.asarray([3, 4, 5], np.int32), max_new_tokens=3)
    eng.step()
    assert eng._predict_decode().step_s == 1.0
    cm.rescale("decode", 2.5)
    eng.set_cost_model(cm)
    assert eng._predict_decode().step_s == 2.5
    eng.run_until_done()
    assert eng.stats.completed == 1


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("drift", {}), ("drift", {"drift_factor": 3.0, "n_requests": 5}),
    ("overload", {}), ("overload", {"load_factor": 3})])
def test_scenario_dicts_equal_the_reference(name, kw):
    fn = f"run_{name}_scenario"
    mine = getattr(tscenarios, fn)(**kw)
    theirs = getattr(jscenarios, fn)(**kw)
    assert sorted(mine) == sorted(theirs)
    for key in theirs:
        assert mine[key] == theirs[key], key


@pytest.mark.parametrize("which", ["step", "request"])
def test_record_schemas_equal_the_reference(which):
    mine = STEP_FIELDS if which == "step" else REQUEST_FIELDS
    theirs = (jtel.metrics.STEP_FIELDS if which == "step"
              else jtel.metrics.REQUEST_FIELDS)
    assert [f.name for f in mine] == [f.name for f in theirs]
    assert ([dataclasses.asdict(f) for f in mine]
            == [dataclasses.asdict(f) for f in theirs])
    assert schema_field_names() == jtel.metrics.schema_field_names()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshot_loads_in_the_other_package(writer, tmp_path):
    pkg = {"port": (MetricsSink, StepRecord, RequestRecord),
           "reference": (jtel.MetricsSink, jtel.StepRecord,
                         jtel.RequestRecord)}[writer]
    sink_cls, step_cls, req_cls = pkg
    sink = sink_cls(capacity=8)
    for i in range(3):
        sink.record_step(step_cls(**dataclasses.asdict(_step(i))))
    sink.record_request(req_cls("paged", 0, 1.0, 4.0, 3.0, 5, 4))
    path = sink.save(tmp_path / "snap.json")
    reader = jtel.load_snapshot if writer == "port" else load_snapshot
    doc = reader(path)
    assert doc == json.loads(path.read_text())
    assert doc["summary"]["steps"] == 3 and len(doc["requests"]) == 1
    assert tcli.main(["show", str(path)]) == 0


@pytest.mark.parametrize("bottleneck", ["memory", "compute", ""])
def test_rescale_calibration_equals_the_reference(bottleneck):
    path = CALIB_DIR / f"{TABLE}.json"
    mine = rescale_calibration(load_calibration(path), 1.7,
                               bottleneck=bottleneck)
    theirs = jtel.rescale_calibration(jload_cal(path), 1.7,
                                      bottleneck=bottleneck)
    assert mine.to_dict() == theirs.to_dict()


def test_checkdocs_passes_on_the_unedited_reference_doc(tmp_path, capsys):
    assert tcli.METRICS_DOC == ROOT / "docs" / "reference" / "metrics.md"
    assert tcli.main(["checkdocs"]) == 0
    assert "all 27 schema fields" in capsys.readouterr().out
    short = tmp_path / "metrics.md"
    short.write_text(tcli.METRICS_DOC.read_text().replace("`kernel_splits`",
                                                          "kernel_splits"))
    assert tcli.main(["checkdocs", "--doc", str(short)]) == 2
    assert "kernel_splits" in capsys.readouterr().out


def test_smoke_cli_passes_with_overload(capsys):
    assert tcli.main(["smoke", "--overload", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "drift smoke OK" in out and "overload smoke OK" in out


class _Stop(Exception):
    pass


@pytest.mark.parametrize("argv, want", [([], "cuda"),
                                        (["--device", "cpu"], "cpu")])
def test_smoke_cli_runs_on_the_card_unless_asked(monkeypatch, argv, want):
    """``smoke`` hands both scenarios the card by default and the CPU only
    when asked; without CUDA and without ``--device cpu`` it raises."""
    seen = []

    def drift(*, device):
        seen.append(str(device))
        return {"n_events": 0}

    def overload(*, device):
        seen.append(str(device))
        raise _Stop
    monkeypatch.setattr(tscenarios, "run_drift_scenario", drift)
    monkeypatch.setattr(tscenarios, "run_overload_scenario", overload)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(_Stop):
        tcli.main(["smoke", "--overload", *argv])
    assert seen == [want, want]
    if not argv:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA device by default"):
            tcli.main(["smoke"])


def test_telemetry_table_equals_the_reference(tmp_path):
    """The port's campaign runs ``telemetry_replay`` (the fake model on the
    CPU) and its table renders the reference's rows."""
    report = trunner.run("telemetry_replay", out_dir=tmp_path, device="cpu")
    doc = json.loads(Path(report.path).read_text())
    assert sorted(c["params"]["scenario"] for c in doc["cells"].values()) \
        == ["drift", "overload"]
    rows = treport.table_for(doc)
    assert rows == jreport.telemetry_table(doc)
    assert [r[0] for r in rows] == ["telemetry/drift", "telemetry/overload"]


class JPagedEngine(_JaxEngine):
    """The JAX paged engine, each host->device upload taken from a copy
    (see ``tests/test_torch_engine.py``: an aliased block table races an
    in-flight step)."""

    def _dev(self, x, kind="repl"):
        return super()._dev(np.array(x, copy=True), kind)


# StepRecord fields that are the engines' host bookkeeping (and the
# decode prediction's bottleneck, memory in both): equal in both
HOST_FIELDS = ("engine", "step", "t_s", "n_active", "queue_depth",
               "measured_s", "decode_ran", "n_prefill_units", "bottleneck",
               "budget_s", "host_syncs", "table_uploads", "blocks_in_use",
               "n_blocks", "decoded_tokens", "preemptions", "deferred",
               "kernel_splits", "integrity_failures")
# fields that differ by design: the port prices its decode step from an
# analytic census, the JAX engine from the HLO of its compiled step
BY_DESIGN = ("predicted_s", "predicted_decode_s")


def test_real_model_records_match_the_jax_engine():
    """Reduced f32 gemma2 through both packages' paged engines under a
    SimClock, each with a controller priced from the committed H100
    table: identical tokens, and equal host bookkeeping in every step
    record and request record."""
    assert sorted(HOST_FIELDS + BY_DESIGN) == sorted(
        f.name for f in STEP_FIELDS)
    kw = dict(n_layers=2, vocab_size=128, compute_dtype="float32")
    jm = jbuild(jreduced(JARCHS["gemma2-2b"], **kw))
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = reduced(ARCHS["gemma2-2b"], **kw)
    tm = build_model(cfg, device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    rng = np.random.default_rng(11)
    arrivals = [(float(i // 4), rng.integers(0, 128, size=int(n)), 4, None)
                for i, n in enumerate(rng.integers(1, 31, size=16))]
    ekw = dict(max_batch=4, max_len=48, block_size=8, n_blocks=10,
               chunk_size=8)
    latency = (1e-3, 5e-4)
    spec = JHardwareSpec(**dataclasses.asdict(H100_SXM))

    clock = SimClock()
    ctl = TelemetryController(latency_model=work_latency_model(*latency))
    eng = PagedServingEngine(tm, tparams, clock=clock, telemetry=ctl,
                             cost_model=CostModel.from_named(TABLE), **ekw)
    rids = drive(eng, clock, arrivals)
    jclock = jsim.SimClock()
    jctl = jtel.TelemetryController(
        latency_model=jsim.work_latency_model(*latency))
    jeng = JPagedEngine(jm, jparams, clock=jclock, telemetry=jctl,
                   cost_model=JCostModel.from_named(
                       CALIB_DIR / f"{TABLE}.json", hw=spec), **ekw)
    jrids = jsim.drive(jeng, jclock, arrivals)

    assert sorted(rids) == sorted(jrids)
    assert {r: eng.done[r].tokens for r in rids} == \
        {r: jeng.done[r].tokens for r in jrids}
    assert eng.stats.preemptions > 0           # the pool churns
    mine, theirs = ctl.sink.steps(), jctl.sink.steps()
    assert len(mine) == len(theirs) == eng.stats.steps
    for a, b in zip(mine, theirs):
        for f in HOST_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.step, f)
    assert any(a.predicted_decode_s != b.predicted_decode_s
               for a, b in zip(mine, theirs))
    assert ([dataclasses.asdict(r) for r in ctl.sink.requests()]
            == [dataclasses.asdict(r) for r in jctl.sink.requests()])


# ---------------------------------------------------------------------------
# chip_smoke.py's phase telemetry, rehearsed on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reduced_run():
    return chip_smoke.telemetry_reduced(torch, np, 0, "cpu")


def test_reduced_telemetry_gates_hold_on_the_cpu(reduced_run):
    readings, failures, caught = reduced_run
    assert failures == []
    assert readings["identical_on_off"] and readings["identical_slo"]
    assert readings["distinct_tokens"] > 10
    assert readings["drift"]["events"]        # the H100 table drifts here
    assert sorted(caught) == ["mixed_fed", "record_reads_device"]
    # the faults were taken out again
    assert _DeviceLoop.__dict__["_step_record"].__qualname__ == \
        "_DeviceLoop._step_record"
    assert TC.__dict__["_feed_drift"].__qualname__ == \
        "TelemetryController._feed_drift"


@pytest.mark.parametrize("name", chip_smoke.TELEMETRY_MUST_CATCH)
def test_telemetry_control_fails_its_check_on_the_cpu(name, reduced_run):
    if name == "wall_clock_retire":
        want = chip_smoke.telemetry_scenarios("cpu")
        assert chip_smoke.scenario_gate(
            chip_smoke.telemetry_scenarios("cpu"), want) == []
        with chip_smoke.telemetry_fault(name):
            caught = chip_smoke.scenario_gate(
                chip_smoke.telemetry_scenarios("cpu"), want)
        assert "drift.summary" in caught and "overload.summary" in caught
    else:
        caught = reduced_run[2][name]
        assert caught
    if name == "record_reads_device":
        assert "read a tensor" in caught[0]
    if name == "mixed_fed":
        assert "fed as decode" in caught[1]


@pytest.mark.parametrize("err, caught", [
    ("a step record read a tensor", True),
    ("CUDA out of memory", False)])
def test_record_read_control_counts_only_the_read_refusal(err, caught):
    """``record_reads_device`` is caught only by the refusal of the read
    itself; another error of the served run is raised, not counted."""
    def run():
        raise RuntimeError(err)
    if caught:
        assert chip_smoke.record_read_caught(torch, "cpu", run) == [err]
    else:
        with pytest.raises(RuntimeError, match="out of memory"):
            chip_smoke.record_read_caught(torch, "cpu", run)
    assert chip_smoke.record_read_caught(torch, "cpu", lambda: None) == []


def test_staggered_arrivals_reach_the_engine_on_schedule():
    """(c)'s arrivals: one request every ``gap`` iterations, each stamped
    with the step it could first be placed in, the same in every run."""
    def make(ctl):
        return PagedServingEngine(FakeModel(device="cpu"), None,
                                  max_batch=4, max_len=32, block_size=4,
                                  chunk_size=4, telemetry=ctl)
    prompts = [np.arange(1, 9, dtype=np.int32)] * 4
    runs = [chip_smoke.telemetry_serve(torch, make, prompts, 4, ctl, gap=3)
            for ctl in (chip_smoke.telemetry_controller(),
                        chip_smoke.telemetry_controller(1e9))]
    for run in runs:
        assert run["arrived"] == {0: 1, 1: 4, 2: 7, 3: 10}
        assert chip_smoke.telemetry_run_gates(run, 4) == []
    readings = chip_smoke.slo_readings(runs[1], runs[0], 1.0)
    assert readings["waited_steps"] == readings["ungated_waited_steps"]
    assert readings["shed_newest_first"] == []
    assert readings["most_chunks_a_step"] == 1


@pytest.mark.parametrize("fault", [False, True])
def test_slot_records_pass_the_sync_gate(fault):
    """The slot engine's records read no tensor; a record that does fails
    the gate."""
    kw = dict(n_layers=2, vocab_size=64, compute_dtype="float32")
    model = build_model(reduced(ARCHS["gemma2-2b"], **kw), device="cpu")
    ctl = TelemetryController()
    eng = ServingEngine(model, model.init(0), max_batch=2, max_len=24,
                        cost_model=CostModel.from_named(TABLE),
                        telemetry=ctl)
    for n in (3, 7, 5):
        eng.submit(np.arange(1, n + 1, dtype=np.int32), max_new_tokens=4)

    def run():
        with chip_smoke.record_sync_gate(torch):
            eng.run_until_done()
    if fault:
        with chip_smoke.telemetry_fault("record_reads_device"):
            with pytest.raises(RuntimeError, match="read a tensor"):
                run()
    else:
        run()
        assert len(ctl.sink.steps()) == eng.stats.steps
        assert eng.stats.completed == 3
    assert int(torch.tensor(3)) == 3           # reads restored after
