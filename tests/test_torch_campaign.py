"""The port's calibration campaign against the JAX package's, on the CPU.

* The four calibration experiments expand to the same cell keys as the JAX
  registry's, for the quick and the full grids.
* ``fit_latency`` gives JAX's (a, b) on the same inputs (rtol 1e-12: both
  are numpy's ``polyfit``).
* ``calibration_from_results`` turns the same result documents into the
  same table, ``source`` (a timestamp and the package's name) aside.
* A quick ``calibrate(device="cpu")`` runs end to end, and the full grid's
  ``(512,512,128)`` dependent ``mxu_shapes`` cells are errors in both
  packages (a ``[512,512]`` product cannot feed ``A [512,128] @ .``).
"""
import copy
import json

import numpy as np
import pytest
import torch

from repro.core.campaign import registry as jreg
from repro.core.campaign import report as jreport
from repro.core.campaign import runner as jrunner
from repro.core.microbench import harness as jharness
from repro_torch.core.campaign import registry as treg
from repro_torch.core.campaign import report as treport
from repro_torch.core.campaign import runner as trunner
from repro_torch.core.campaign.cli import main as cli_main
from repro_torch.core.campaign.results import STATUS_ERROR, load_results
from repro_torch.core.microbench import harness as tharness
from repro_torch.core.microbench import tables
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)

EXPERIMENTS = tables.CALIBRATION_EXPERIMENTS
# the experiments beyond calibration (tests/test_torch_isa.py,
# tests/test_torch_autotune.py, tests/test_torch_telemetry.py,
# tests/test_torch_cluster.py, tests/test_torch_chaos.py)
PORTED = ("paged_serve", "decode_hotpath", "isa_mapping", "autotune",
          "decode_longctx", "telemetry_replay", "traffic_scaling",
          "chaos_serving")


@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("name", EXPERIMENTS)
def test_cell_keys_match_jax_registry(name, quick):
    ours = [c.key for c in treg.get(name).cells(quick=quick)]
    theirs = [c.key for c in jreg.get(name).cells(quick=quick)]
    assert ours == theirs and len(ours) > 0
    if name == "alu_chain" and not quick:
        assert len(ours) == 92
    assert treg.names() == sorted(EXPERIMENTS + PORTED)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_latency_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k = [4, 16, 64, 256]
    t = list(3e-6 + 2e-9 * np.asarray(k) + rng.normal(size=4) * 1e-8)
    np.testing.assert_allclose(tharness.fit_latency(k, t),
                               jharness.fit_latency(k, t), rtol=1e-12)


def _docs():
    """Result documents in the reference's schema, with numbers chosen
    here (one ok and one error cell each) - no measurement."""
    def doc(exp, cells):
        return {"schema_version": 1, "experiment": exp, "backend": "gpu",
                "quick": False, "created": "", "meta": {}, "cells": cells}

    def ok(params, metrics):
        return {"params": params, "metrics": metrics, "status": "ok"}
    err = {"params": {}, "metrics": {}, "status": "error", "error": "x"}
    return {
        "alu_chain": doc("alu_chain", {
            "dependent=true,dtype=float32,op=add": ok(
                {"op": "add", "dtype": "float32", "dependent": True},
                {"per_op_ns": 2.1, "overhead_ns": 5100.0,
                 "cpi_curve": {"4": 1.5, "16": 1.1}}),
            "dependent=false,dtype=int32,op=xor": ok(
                {"op": "xor", "dtype": "int32", "dependent": False},
                {"per_op_ns": 1.0, "overhead_ns": 4000.0}),
            "dependent=true,dtype=float32,op=exp": err}),
        "memory_chase": doc("memory_chase", {
            "access=chase,size_kib=16": ok(
                {"access": "chase", "size_kib": 16},
                {"per_hop_ns": 17.0, "overhead_ns": 900.0,
                 "working_set_bytes": 16384}),
            "access=stream,size_kib=16": ok(
                {"access": "stream", "size_kib": 16},
                {"gbps": 100.0, "working_set_bytes": 16384})}),
        "mxu_shapes": doc("mxu_shapes", {
            "dependent=true,dtype=bfloat16,shape=128x128x128": ok(
                {"dtype": "bfloat16", "shape": [128, 128, 128],
                 "dependent": True},
                {"per_op_us": 1.5, "tflops": 2.8}),
            "dependent=true,dtype=bfloat16,shape=512x512x128": err}),
        "roofline_calibration": doc("roofline_calibration", {
            "term=hbm_stream_gbs": ok({"term": "hbm_stream_gbs"},
                                      {"value": 2000.0, "unit": "GB/s"})}),
    }


@pytest.mark.parametrize("clock_hz", [None, 1.755e9])
def test_calibration_from_results_matches_jax(clock_hz):
    docs = _docs()
    ours = treport.calibration_from_results(copy.deepcopy(docs),
                                            clock_hz=clock_hz)
    theirs = jreport.calibration_from_results(copy.deepcopy(docs),
                                              clock_hz=clock_hz)
    assert ours.pop("source").startswith("repro_torch.core.campaign results")
    theirs.pop("source")
    assert ours == theirs
    assert ours["vpu"]["add.f32"]["cpi"] == pytest.approx(
        2.1e-9 * (clock_hz or 1e9))


def test_quick_calibrate_on_cpu_end_to_end(tmp_path):
    table = tables.calibrate(out_path=tmp_path / "t.json", quick=True,
                             results_dir=tmp_path / "c", device="cpu")
    assert json.loads((tmp_path / "t.json").read_text()) == table
    assert table["hardware"] == "cpu" and "clock_mhz" not in table
    assert len(table["ops"]) == 8 and len(table["mxu"]) == 2
    assert set(table["roofline"]) == {"mxu_peak_tflops", "hbm_stream_gbs",
                                      "dispatch_overhead_us"}
    assert set(table["memory"]) == {"16384", "4194304"}
    for row in table["ops"].values():
        assert np.isfinite(row["per_op_ns"]) and row["per_op_ns"] >= 0
    assert tables.table_from_results(tmp_path / "c")["ops"] == table["ops"]
    # a rerun skips every measured cell
    rep = trunner.run("alu_chain", out_dir=tmp_path / "c", quick=True,
                      device="cpu")
    assert (rep.ran, rep.skipped) == (0, 8)


def test_full_grid_dependent_512x512x128_cells_error_as_in_jax(tmp_path):
    only = {"shape": (512, 512, 128), "dependent": True}
    ours = trunner.run("mxu_shapes", out_dir=tmp_path / "t", quick=False,
                       only=only, device="cpu")
    theirs = jrunner.run("mxu_shapes", out_dir=tmp_path / "j", quick=False,
                         only=only, backend="cpu")
    assert ours.total_cells == theirs.total_cells == 3
    assert ours.failed == theirs.failed == 3
    for rep in (ours, theirs):
        cells = load_results(rep.path)["cells"]
        assert {rec["status"] for rec in cells.values()} == {STATUS_ERROR}
    # the int8 cell records the bf16 substitution where it succeeds
    ok = trunner.run("mxu_shapes", out_dir=tmp_path / "t", quick=False,
                     only={"shape": (128, 128, 128), "dtype": "int8",
                           "dependent": True}, device="cpu")
    cell = load_results(ok.path)["cells"][
        "dependent=true,dtype=int8,shape=128x128x128"]
    assert cell["status"] == "ok"
    assert cell["metrics"]["compute_dtype"] == "bfloat16"


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.run("alu_chain", out_dir=tmp_path, quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["run", "alu_chain", "--quick", "--out-dir", str(tmp_path)])
    assert trunner._current_backend("cpu") == "cpu"
    assert trunner._current_backend(torch.device("cuda", 0)) == "gpu"


def test_cli_calibrate_on_cpu(tmp_path, capsys):
    out = tmp_path / "t.json"
    rc = cli_main(["calibrate", "--quick", "--device", "cpu", "--out",
                   str(out), "--out-dir", str(tmp_path / "c")])
    assert rc == 0 and "8 op rows" in capsys.readouterr().out
    assert json.loads(out.read_text())["hardware"] == "cpu"
    assert cli_main(["list"]) == 0


def test_committed_hopper_table_is_a_full_measured_calibration():
    """``hopper_h100.json`` is the table the full grids made on the card:
    every ok cell of the four experiments, the SM clock, no folded chain
    (every dependent f32 op, and every op row in either mode, at least one
    cycle), a 64 MiB chase slower per hop than a 16 KiB one, intercepts
    that read one launch (under 20 us, or 1.5x the run's own
    ``launch_reference``), and f32 independent rows of the FMA-pipe and
    MUFU-class ops at most their dependent rows."""
    t = tables.load_table("hopper_h100")
    paper = tables.ampere_table()
    assert t["schema_version"] == paper["schema_version"] == 1
    assert "H100" in t["source"] and "chip_smoke.py" in t["source"]
    assert len(t["ops"]) == 92 and len(t["mxu"]) == 15
    assert set(t["memory"]) == {str(k * 1024) for k in (16, 256, 4096,
                                                          65536)}
    assert set(t["roofline"]) == {"mxu_peak_tflops", "hbm_stream_gbs",
                                  "dispatch_overhead_us"}
    assert 1000 < t["clock_mhz"] < 2100
    assert all(row["cpi"] >= 1 for row in t["vpu"].values())
    mem = t["memory"]
    assert mem[str(64 * 2 ** 20)]["per_hop_ns"] > mem["16384"]["per_hop_ns"]
    # the intercepts read one kernel launch: under 20 us, or, where one
    # PyTorch elementwise launch timed the same way in the same run
    # already costs more than 13 us (the card's host), under 1.5x that
    ref_us = t.get("launch_reference", {}).get("torch_add_us", 0.0)
    limit_us = 1.5 * ref_us if ref_us > 13 else 20.0
    assert t["roofline"]["dispatch_overhead_us"]["value"] < limit_us
    assert all(row["overhead_ns"] < limit_us * 1e3
               for row in t["ops"].values())
    # no folded chain in either mode, and the f32 independent chains of
    # the FMA pipe and of the MUFU-class ops do not serialise: each reads
    # no more cycles than its dependent chain
    per_cycle_ns = 1e3 / t["clock_mhz"]
    assert all(row["per_op_ns"] >= per_cycle_ns for row in t["ops"].values())
    for op in ("add", "mul", "fma", "rsqrt", "sqrt", "exp", "log", "sin",
               "tanh", "sigmoid"):
        ind, dep = t["ops"][f"{op}.float32.ind"], t["ops"][f"{op}.float32.dep"]
        assert ind["per_op_ns"] <= dep["per_op_ns"], op


def test_committed_hopper_table_mxu_rows_are_rates_a_card_can_give():
    """Every ``mxu`` row of ``hopper_h100.json`` and its
    ``roofline.mxu_peak_tflops`` read above 0 and at most the type's dense
    tensor-core peak (int8 rows measure the bf16 path; f32 runs as tf32),
    with a per-op time above the harness's floor; every independent row
    records the products a unit (``reps``) that filled the card."""
    from repro_torch.core.microbench.mxu import (DENSE_PEAK_TFLOPS,
                                                 PER_OP_FLOOR_S)
    t = tables.load_table("hopper_h100")
    assert len(t["mxu"]) == 15
    for key, row in t["mxu"].items():
        peak = DENSE_PEAK_TFLOPS[key.split(".")[0]]
        assert 0 < row["tflops"] <= peak, key
        assert row["per_op_us"] > PER_OP_FLOOR_S * 1e6 * 1.001, key
        if key.endswith(".ind"):
            assert row["reps"] >= 1, key
    peak = t["roofline"]["mxu_peak_tflops"]["value"]
    assert 0 < peak <= DENSE_PEAK_TFLOPS["float32"]
