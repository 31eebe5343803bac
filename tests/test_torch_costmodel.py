"""The port's cost model (``repro_torch.core.{perfmodel,costmodel}``) against
the JAX package's (``repro.core.{perfmodel,costmodel}``), on the CPU.

Both packages load the same tables (the paper's ``ampere_a100``, the port's
measured ``hopper_h100`` and the reference's design-estimate table, each
by path where the other package does not ship it) and price the same
censuses on the same spec values.  Normalized tables, round-trip rows,
analytic censuses and parameter counts must be equal; every ``Prediction``
term within rel 1e-12.  Then the port's CLI, and ``chip_smoke.py``'s cost
phase controls rehearsed on reduced f32 gemma2 on the CPU.
"""
import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs.base import ShapeCell as JCell
from repro.core import costmodel as jcm
from repro.core.costmodel import analytic as janalytic
from repro.core.costmodel.cli import DEMO_CENSUS as JDEMO_CENSUS
from repro.core.perfmodel import hardware as jhw
from repro.models.zoo import count_active_params as jcount_active
from repro.models.zoo import count_params as jcount
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.core import costmodel as tcm
from repro_torch.core.costmodel import analytic as tanalytic
from repro_torch.core.costmodel import cli as tcli
from repro_torch.core.perfmodel.hardware import A100_40G, H100_SXM, SPECS
from repro_torch.models import transformer as lm_mod
from repro_torch.models.zoo import (build_model, count_active_params,
                                    count_params)
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)

ROOT = Path(__file__).resolve().parents[1]
TORCH_CAL = ROOT / "src" / "repro_torch" / "core" / "calibration"
JAX_CAL = ROOT / "src" / "repro" / "core" / "calibration"
# name -> (the port's argument, the JAX package's argument)
TABLES = {"ampere_a100": ("ampere_a100", "ampere_a100"),
          "hopper_h100": ("hopper_h100", TORCH_CAL / "hopper_h100.json"),
          "tpu_v5e": (JAX_CAL / "tpu_v5e.json", "tpu_v5e")}
REL = 1e-12

_spec = importlib.util.spec_from_file_location(
    "costmodel_golden", ROOT / "tests" / "test_costmodel_golden.py")
_golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_golden)
_chip = importlib.util.spec_from_file_location(
    "chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_chip)
_chip.loader.exec_module(chip_smoke)

# the reference tests' census, the CLI's demo census and the golden file's
# five (the two paged ones computed through the JAX package's tunables)
CENSUSES = {
    "base": {"flops": 1e12, "hbm_bytes": 1e9, "collective_bytes_total": 1e8,
             "op_histogram": {"fusion": 100.0, "dot": 10.0, "add": 50.0,
                              "multiply": 20.0, "tanh": 5.0}},
    "demo": JDEMO_CENSUS,
    **{name: census for name, (census, _) in _golden.CENSUSES.items()}}

# the archs the port builds at full width
PORT_ARCHS = []
for _name, _cfg in ARCHS.items():
    try:
        lm_mod.check_supported(_cfg)
    except NotImplementedError:
        continue
    PORT_ARCHS.append(_name)


def _models(table):
    mine, theirs = TABLES[table]
    return tcm.CostModel.from_named(mine), jcm.CostModel.from_named(theirs)


def _jspec(spec):
    return jhw.HardwareSpec(**dataclasses.asdict(spec))


def _same(got, want, rel=REL):
    """Equal numbers within ``rel``, anything else exactly equal."""
    if isinstance(got, float) or isinstance(want, float):
        return math.isclose(got, want, rel_tol=rel, abs_tol=0.0)
    if isinstance(got, dict):
        return got.keys() == want.keys() and all(
            _same(got[k], want[k], rel) for k in got)
    return got == want


@pytest.mark.parametrize("table", sorted(TABLES))
def test_normalized_tables_equal_jax(table):
    mine, theirs = _models(table)
    assert mine.cal.to_dict() == theirs.cal.to_dict()


def test_specs_and_hardware_resolution():
    """The A100 spec is the reference's; the H100 one is the datasheet's;
    the port's measured table and its default name resolve to the H100
    (the reference would resolve the table's "gpu" to its TPU spec)."""
    assert dataclasses.asdict(A100_40G) == dataclasses.asdict(jhw.A100_40G)
    assert set(SPECS) == {"h100-sxm-80g", "a100-40g"}
    assert (H100_SXM.peak_flops_bf16, H100_SXM.peak_flops_f32,
            H100_SXM.hbm_bandwidth, H100_SXM.n_cores) == (
        989e12, 67e12, 3.35e12, 132)
    assert tcm.CostModel.from_named("hopper_h100").hw == H100_SXM
    assert tcm.CostModel.from_named().cal.name == "hopper_h100"
    assert tcm.CostModel.from_named("ampere_a100").hw == A100_40G
    for name in ("gpu", "NVIDIA H100 80GB HBM3", "unknown"):
        cal = dataclasses.replace(tcm.load_calibration("hopper_h100"),
                                  hardware=name)
        assert tcm.CostModel(cal).hw == H100_SXM


@pytest.mark.parametrize("census", sorted(CENSUSES))
@pytest.mark.parametrize("table", sorted(TABLES))
def test_predictions_equal_jax(table, census):
    """Every Prediction field, under both dtypes, dependent or not, with
    or without a tile shape, on the same spec values as ``hw``."""
    c = CENSUSES[census]
    for spec in (H100_SXM, A100_40G):
        mine = tcm.CostModel(tcm.load_calibration(TABLES[table][0]),
                             hw=spec)
        theirs = jcm.CostModel(jcm.load_calibration(TABLES[table][1]),
                               hw=_jspec(spec))
        for dtype in ("bf16", "f32"):
            for dependent in (False, True):
                for shape in (None, (16, 16, 16), (128, 128, 128)):
                    kw = dict(dtype=dtype, dependent=dependent,
                              mxu_shape=shape)
                    got = dataclasses.asdict(mine.predict(c, **kw))
                    want = dataclasses.asdict(theirs.predict(c, **kw))
                    assert _same(got, want), (spec.name, kw, got, want)


@pytest.mark.parametrize("table", sorted(TABLES))
def test_round_trip_rows_equal_jax_and_within_10pct(table):
    mine, theirs = _models(table)
    rows = tcm.prediction_error_rows(mine)
    assert rows == jcm.prediction_error_rows(theirs)
    assert rows and all(r["err_pct"] <= 10.0 for r in rows)
    assert (tcm.prediction_error_summary(rows)
            == jcm.prediction_error_summary(rows))


def test_validate_against_paper_equals_jax():
    table = json.loads((TORCH_CAL / "ampere_a100.json").read_text())
    checks = tcm.validate_against_paper(table)
    assert checks == jcm.validate_against_paper(table)
    assert checks and all(checks.values())


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_param_counts_equal_jax(arch):
    """Counted on the meta device, from shapes alone."""
    cfg = ARCHS[arch]
    assert count_params(cfg) == jcount(JARCHS[arch])
    assert count_active_params(cfg) == jcount_active(JARCHS[arch])


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_analytic_censuses_equal_jax(arch):
    """Prefill, decode (legacy, donated, sampled) and train cells, on one
    device and on a 16-device mesh of 4-way model parallelism."""
    cells = [("prefill", 900, 1, {}), ("decode", 1024, 8, {}),
             ("decode", 1024, 8, dict(donated=True, device_sampling=True)),
             ("train", 4096, 8, dict(accum=2))]
    for kind, seq, batch, kw in cells:
        for n_devices, n_model in ((1, 1), (16, 4)):
            got = tanalytic.analytic_census(
                ARCHS[arch], ShapeCell("c", kind, seq, batch), n_devices,
                n_model=n_model, **kw)
            want = janalytic.analytic_census(
                JARCHS[arch], JCell("c", kind, seq, batch), n_devices,
                n_model=n_model, **kw)
            assert _same(got, want), (kind, kw, n_devices)
    assert tanalytic.analytic_route_bytes(ARCHS[arch], 300, 100) == \
        janalytic.analytic_route_bytes(JARCHS[arch], 300, 100)


def test_gemma2_full_width_predictions():
    """The admission gate's prices for full-width gemma2-2b on the port's
    table: the decode step memory-bound, a 900-token prefill bound by the
    table's bf16 tensor-core rate."""
    cfg = ARCHS["gemma2-2b"]
    assert count_params(cfg) == 2_614_341_888
    preds = chip_smoke.cost_predictions(tcm.CostModel.from_named(), cfg)
    assert preds["decode_b8_1024"]["bottleneck"] == "memory"
    assert preds["chunk_64"]["bottleneck"] == "memory"
    assert preds["prefill_900"]["bottleneck"] == "compute"
    assert 0 < preds["chunk_64"]["step_s"] < preds["prefill_900"]["step_s"]


def test_cli_prediction_error_demo_and_export(tmp_path, capsys):
    assert tcli.main(["--prediction-error"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("prederr/summary")
    assert "hw=h100-sxm-80g" in out[-1] and "max_err_pct=0.00" in out[-1]
    assert tcli.main(["--demo"]) == 0
    demo = capsys.readouterr().out
    assert "hw=h100-sxm-80g" in demo and "defaulted/reshape" in demo
    assert tcli.DEMO_CENSUS == JDEMO_CENSUS
    path = tmp_path / "cal.json"
    assert tcli.main(["--calibration", "hopper_h100",
                      "--export", str(path)]) == 0
    again = tcm.load_calibration(path)
    assert again.to_dict() == tcm.load_calibration("hopper_h100").to_dict()
    census = tmp_path / "census.json"
    census.write_text(json.dumps({"census": CENSUSES["base"]}))
    assert tcli.main(["--census", str(census), "--hw", "a100-40g"]) == 0
    assert "hw=a100-40g" in capsys.readouterr().out


def test_cli_refuses_hlo_text(tmp_path):
    hlo = tmp_path / "step.hlo"
    hlo.write_text("HloModule step\nENTRY main { ROOT c = f32[] "
                   "constant(0) }\n")
    with pytest.raises(SystemExit, match="HLO census"):
        tcli.main(["--census", str(hlo)])


# -- chip_smoke.py's cost phase, rehearsed on the CPU ------------------------

@pytest.fixture(scope="module")
def reduced_lm():
    cfg = reduced(ARCHS["gemma2-2b"], n_layers=2, vocab_size=128,
                  compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, size=int(n)).astype(np.int32)
               for n in rng.integers(1, 40, size=8)]
    return model, model.init(0), prompts


def _engines(model, params, cm):
    from repro_torch.serve.engine import PagedServingEngine, ServingEngine
    return {
        "paged": lambda b: PagedServingEngine(
            model, params, max_batch=4, max_len=64, block_size=8,
            n_blocks=12, chunk_size=8, cost_model=cm, step_budget_s=b),
        "slot": lambda b: ServingEngine(model, params, max_batch=4,
                                        max_len=64, cost_model=cm,
                                        step_budget_s=b)}


@pytest.mark.parametrize("kind", ["paged", "slot"])
def test_cost_phase_gates_hold_and_catch_their_faults(kind, reduced_lm):
    model, params, prompts = reduced_lm
    cm = tcm.CostModel.from_named("hopper_h100")
    make = _engines(model, params, cm)[kind]
    tight = chip_smoke.cost_budget(make(None), prompts)

    def run(eng):
        eng.run_until_done()
    for budget, is_tight in ((1e9, False), (tight, True)):
        eng, toks, _ = chip_smoke.cost_serve(make, prompts, 6, run, budget)
        assert chip_smoke.cost_run_gates(eng, len(prompts), is_tight) == []
    for fault in ("budget_ignored", "prefill_free"):
        assert fault in chip_smoke.COST_MUST_CATCH
        eng, ftoks, _ = chip_smoke.cost_serve(make, prompts, 6, run, tight,
                                              fault)
        assert chip_smoke.cost_run_gates(eng, len(prompts), True), fault
        assert ftoks == toks         # admission order never changes tokens


def test_cost_phase_table_gate_catches_the_wrong_spec():
    cm = tcm.CostModel.from_named("hopper_h100")
    summary, bad = chip_smoke.cost_table_gate(cm)
    assert bad == [] and summary["hw"] == "h100-sxm-80g"
    assert summary["rows"] == 112
    assert "hw_wrong" in chip_smoke.COST_MUST_CATCH
    _, bad = chip_smoke.cost_table_gate(chip_smoke.cost_hw_wrong(cm))
    assert bad == ["hardware resolves to a100-40g"]
