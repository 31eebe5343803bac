"""The port's ``paged_serve``, ``decode_hotpath`` and ``isa_mapping``
experiments, its paper tables and its ``report`` command, against the JAX
package, on the CPU.

* Grids, quick grids, costs and tags equal the reference registry's.
* The serving cells run on the CPU in f32 through both packages' runners
  on the same weights (the JAX package's seed-0 init, converted): every
  metric but the times and the card's peaks must be equal.  The paged
  engine's resident KV bytes differ by design: the port's pool holds one
  trash page beyond its ``n_blocks`` (``models/transformer.py``
  ``init_paged_decode_cache``), so its bytes are the reference's times
  ``(n_blocks + 1) / n_blocks``.
* Report rows equal the reference's over the same result documents for
  every ported table (``traffic_scaling`` and ``chaos_serving``
  included); ``table_for`` refuses the unported experiment by name.
* The ISA census over PTX and SASS recorded on the H100
  (``tests/data/isa``: the copy baseline, ``add.f32`` and ``rsqrt.f32``,
  and the two built fault controls of ``chip_smoke.py``) with its counts,
  top opcodes and expansions pinned, and the ``ISA_MUST_CATCH`` controls
  rehearsed; ``isa_mapping`` without the CUDA toolkit fails its cells
  naming the missing tool; ``flops`` equals the reference census's.
"""
import importlib.util
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.serve as jserve
from repro.core.campaign import registry as jreg
from repro.core.campaign import report as jreport
from repro.core.campaign.results import new_document
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.campaign import registry as treg
from repro_torch.core.campaign import report as treport
from repro_torch.core.campaign import runner as trunner
from repro_torch.core.campaign.cli import main as cli_main
from repro_torch.core.campaign.results import STATUS_ERROR, load_results
from repro_torch.core.isa import sass_census as sc
from repro_torch.kernels import _build
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zoo import build_model
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data" / "isa"
_chip = importlib.util.spec_from_file_location(
    "chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_chip)
_chip.loader.exec_module(chip_smoke)

PORTED = ("paged_serve", "decode_hotpath", "isa_mapping")


@pytest.mark.parametrize("name", PORTED)
def test_grids_costs_and_tags_equal_jax(name):
    ours, theirs = treg.get(name), jreg.get(name)
    for quick in (True, False):
        assert ([c.key for c in ours.cells(quick=quick)]
                == [c.key for c in theirs.cells(quick=quick)])
    assert (ours.cost_per_cell_s, ours.tags, ours.description) == (
        theirs.cost_per_cell_s, theirs.tags, theirs.description)
    assert treg.ISA_CASES == jreg.ISA_CASES == tuple(sc.CASES)


# -- the serving cells against the reference's runners -------------------------

class _JPagedCopied(jserve.PagedServingEngine):
    """The JAX paged engine with each upload from a private copy (its
    block-table upload may alias the table it then grows in place; see
    ``tests/test_torch_engine.py``)."""

    def _dev(self, x, kind="repl"):
        return super()._dev(np.array(x, copy=True), kind)


@pytest.fixture
def f32_runners(monkeypatch):
    """Both runners on reduced f32 gemma2-2b and the same weights: the
    reference's ``reduced`` made f32 and its paged engine race-free, the
    port's ``_serving_setup`` given the converted JAX weights."""
    jreduced = jconfigs.reduced

    def reduced_f32(cfg, **kw):
        return jreduced(cfg, compute_dtype="float32", **kw)
    monkeypatch.setattr(jconfigs, "reduced", reduced_f32)
    monkeypatch.setattr(jserve, "PagedServingEngine", _JPagedCopied)
    from repro.models.zoo import build_model as jbuild
    jcfg = reduced_f32(jconfigs.ARCHS["gemma2-2b"], n_layers=2,
                       vocab_size=128)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduced(ARCHS["gemma2-2b"], n_layers=2, vocab_size=128,
                  compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    monkeypatch.setattr(treg, "_serving_setup",
                        lambda device: (cfg, model, params))


TIMES = ("slot_tok_per_s", "paged_tok_per_s", "baseline_tok_per_s",
         "fused_tok_per_s", "speedup")
# the paged KV-byte metrics, which count the trash page
TRASH_PAGE = {"paged_serve": ("paged_kv_bytes", "kv_bytes_ratio"),
              "decode_hotpath": ("baseline_kv_bytes", "fused_kv_bytes")}


@pytest.mark.parametrize("name,params,quick", [
    ("paged_serve", {"block_size": 8, "chunk": 8}, True),
    ("paged_serve", {"block_size": 16, "chunk": 16}, False),
    ("decode_hotpath", {"engine": "slot"}, True),
    ("decode_hotpath", {"engine": "paged"}, True),
])
def test_serving_cell_equals_jax_runner(f32_runners, name, params, quick):
    ours = treg.get(name).runner(dict(params), quick=quick, device="cpu")
    theirs = jreg.get(name).runner(dict(params), quick=quick)
    assert not any(k.endswith("_peak_bytes") for k in ours)   # card only
    assert set(ours) == set(theirs)
    paged = name == "paged_serve" or params.get("engine") == "paged"
    if paged:
        if name == "paged_serve":
            bs = params["block_size"]
            n_blocks = max(-(-64 // bs), int(0.6 * 4 * (-(-64 // bs))))
        else:
            n_blocks = 4 * (-(-64 // 8))
        for key in TRASH_PAGE[name]:
            assert ours[key] == pytest.approx(
                theirs[key] * (n_blocks + 1) / n_blocks, rel=1e-12)
    skip = set(TIMES) | (set(TRASH_PAGE[name]) if paged else set())
    assert {k: v for k, v in ours.items() if k not in skip} == {
        k: v for k, v in theirs.items() if k not in skip}
    if name == "paged_serve":
        assert ours["identical_tokens"] and ours["blocks_leaked"] == 0
    else:
        assert ours["identical_tokens"]
        assert ours["baseline_syncs_per_step"] > ours["fused_syncs_per_step"]


# -- the paper tables -----------------------------------------------------------

def _doc(experiment, cells):
    doc = new_document(experiment, "gpu", False)
    for key, params, metrics in cells:
        doc["cells"][key] = {"params": params, "metrics": metrics,
                             "status": "ok", "elapsed_s": 0.1,
                             "quick": False}
    doc["cells"]["broken"] = {"params": {}, "metrics": {},
                              "status": "error", "error": "x"}
    return doc


def _alu(op, dep):
    return {"per_op_ns": 2.1, "overhead_ns": 17900.0, "lengths": [4, 16],
            "times_us": [18.0, 18.3], "cpi_curve": {"4": 2.5, "16": 1.2}}


DOCS = {
    "alu_chain": _doc("alu_chain", [
        (f"op={op},dtype=float32,dependent={d}",
         {"op": op, "dtype": "float32", "dependent": d}, _alu(op, d))
        for op in ("add", "fma") for d in (True, False)]),
    "mxu_shapes": _doc("mxu_shapes", [
        ("k1", {"dtype": "bfloat16", "shape": [128, 128, 128],
                "dependent": True},
         {"per_op_us": 3.25, "overhead_us": 9.0, "flops": 4194304,
          "tflops": 1.29, "compute_dtype": "bfloat16"})]),
    "memory_chase": _doc("memory_chase", [
        ("c", {"access": "chase", "size_kib": 16},
         {"per_hop_ns": 20.5, "overhead_ns": 9.0,
          "working_set_bytes": 16384, "hops": [256], "times_us": [14.0]}),
        ("s", {"access": "stream", "size_kib": 4096},
         {"gbps": 1619.2, "working_set_bytes": 4194304})]),
    "roofline_calibration": _doc("roofline_calibration", [
        ("t", {"term": "hbm_stream_gbs"},
         {"value": 1619.0, "unit": "GB/s", "detail": "reduce"})]),
    "isa_mapping": _doc("isa_mapping", [
        (f"case={c}", {"case": c},
         {"n_source_ops": 17, "n_optimized_ops": 16,
          "top_ops": {"EXIT": 2, "FADD": 1}, "flops": f})
        for c, f in (("add.f32", 0), ("matmul.f32", 524288))]),
    "paged_serve": _doc("paged_serve", [
        ("block_size=8,chunk=16", {"block_size": 8, "chunk": 16},
         {"completed_slot": 16, "completed_paged": 16,
          "slot_tok_per_s": 100.4, "paged_tok_per_s": 188.7,
          "slot_kv_bytes": 65536, "paged_kv_bytes": 40960,
          "kv_bytes_ratio": 0.625, "identical_tokens": True,
          "preemptions": 0, "prefill_chunks": 28,
          "peak_block_occupancy": 0.95, "blocks_leaked": 0})]),
    "decode_hotpath": _doc("decode_hotpath", [
        (f"engine={e}", {"engine": e},
         {"engine": e, "baseline_tok_per_s": 396.9, "baseline_steps": 24,
          "baseline_syncs_per_step": 1.625, "baseline_kv_bytes": 67584,
          "fused_tok_per_s": 399.1, "fused_steps": 26,
          "fused_syncs_per_step": 0.96, "fused_kv_bytes": 67584,
          "identical_tokens": True, "speedup": 1.005,
          "predicted_hbm_bytes_saved": 64512.0,
          "predicted_boundary_bytes_saved": 2016.0})
        for e in ("slot", "paged")]),
    "traffic_scaling": _doc("traffic_scaling", [
        (f"load=2.0,replicas={r}", {"replicas": r, "load": 2.0},
         {"replicas": r, "load": 2.0, "n_requests": 8 * r,
          "interval_s": 0.004, "n_blocks_per_replica": 19,
          "rr_tok_per_s": 447.04, "ca_tok_per_s": 798.01 / r,
          "rr_p50_s": 0.04, "ca_p50_s": 0.03, "rr_p99_s": 0.181,
          "ca_p99_s": 0.0815, "rr_shed_rate": 0.125, "ca_shed_rate": 0.0,
          "rr_completed": 8 * r, "ca_completed": 8 * r,
          "rr_reroutes": 0, "ca_reroutes": r - 1,
          "rr_preemptions": 42, "ca_preemptions": 22,
          "rr_conserved": True, "ca_conserved": r == 1,
          "identical_tokens": True, "speedup_tok_s": 1.785 / r,
          "p99_ratio": 2.22, "topology_replicas": r, "topology_data": 1,
          "topology_model": 1, "topology_pred_tok_s": 5.5e6})
        for r in (1, 2)]),
    "chaos_serving": _doc("chaos_serving", [
        (f"fault={f},replicas=2", {"fault": f, "replicas": 2},
         {"fault": f, "replicas": 2, "n_requests": 8, "admitted": 8,
          "completed": 8, "shed": 0, "abandoned": int(f == "hang"),
          "recovered": 3, "failures": 4 if f == "crashloop" else 1,
          "failure_kinds": kind, "quarantined": f == "crashloop",
          "reclaimed": 3, "recovery_latency_s": 1.01 * (1 + (f == "hang")),
          "survivors_identical": True, "all_accounted": True,
          "tokens_lost": 0, "blocks_leaked": 0,
          "live_replicas": 1 if f == "crashloop" else 2,
          "t_end_s": 20.56, "ok": f != "hang"})
        for f, kind in (("crash", "dead"), ("hang", "straggler"),
                        ("corrupt", "corrupt"), ("crashloop", "dead"))]),
}
FUNCS = {"alu_chain": "cpi_table", "mxu_shapes": "mxu_table",
         "memory_chase": "memory_table", "isa_mapping": "isa_table",
         "roofline_calibration": "roofline_table",
         "paged_serve": "paged_serve_table",
         "decode_hotpath": "decode_hotpath_table",
         "traffic_scaling": "traffic_scaling_table",
         "chaos_serving": "chaos_serving_table"}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_report_rows_equal_jax(name):
    doc = DOCS[name]
    rows = treport.table_for(doc)
    assert rows and rows == jreport.table_for(doc)
    assert getattr(treport, FUNCS[name])(doc) == getattr(
        jreport, FUNCS[name])(doc)
    assert all(len(r) == 3 and isinstance(r[1], float) for r in rows)


def test_report_rows_carry_the_ports_keys():
    """The port's own keys extend a row (the expansion, the card's peaks);
    without them the row is the reference's."""
    isa = json.loads(json.dumps(DOCS["isa_mapping"]))
    isa["cells"]["case=add.f32"]["metrics"]["sass_expansion"] = {"FADD": 1}
    row = dict((n, d) for n, _, d in treport.isa_table(isa))
    want = dict((n, d) for n, _, d in jreport.isa_table(isa))
    assert row["table5/add.f32"] == want["table5/add.f32"] + (
        ";expansion=FADDx1")
    assert row["table5/matmul.f32"] == want["table5/matmul.f32"]
    hot = json.loads(json.dumps(DOCS["decode_hotpath"]))
    m = hot["cells"]["engine=slot"]["metrics"]
    m.update(baseline_peak_bytes=10, fused_peak_bytes=9)
    row = dict((n, d) for n, _, d in treport.decode_hotpath_table(hot))
    want = dict((n, d) for n, _, d in jreport.decode_hotpath_table(hot))
    assert row["decode_hotpath/slot"] == want["decode_hotpath/slot"] + (
        ";baseline_peak_bytes=10;fused_peak_bytes=9")


UNPORTED = ("sharded_decode",)


@pytest.mark.parametrize("name", UNPORTED)
def test_table_for_refuses_an_unported_experiment(name):
    assert name in jreport._TABLE_FOR
    with pytest.raises(ValueError, match=f"{name}.*not ported"):
        treport.table_for({"experiment": name, "cells": {}})


# the port's decode_longctx metrics and row parts -> the reference's: the
# sweep is over the card's token chunk, and the time is the kernel's own
LONGCTX_FIELDS = {"chunk_tokens": "num_splits", "tok_s": "proxy_tok_s",
                  "default_tok_s": "unsplit_proxy_tok_s",
                  "tuned_chunk": "tuned_splits",
                  "predicted_best_chunk": "predicted_best_splits",
                  "kernel_us": "wall_us"}
LONGCTX_ROW = ((".c", ".s"), ("tok_s=", "proxy_tok_s="),
               ("default_proxy_tok_s=", "unsplit_tok_s="),
               ("tuned_chunk=", "tuned_splits="),
               ("pred_best_chunk=", "pred_best_splits="))


def _longctx_as_reference(doc):
    """The port's decode_longctx document with its fields under the
    reference's names."""
    out = json.loads(json.dumps(doc))
    for rec in out["cells"].values():
        for part in (rec["params"], rec["metrics"]):
            for mine, theirs in LONGCTX_FIELDS.items():
                if mine in part:
                    part[theirs] = part.pop(mine)
    return out


@pytest.mark.parametrize("name", ["autotune", "decode_longctx"])
def test_table_for_renders_like_the_reference(name, tmp_path):
    """autotune: the port's rows are the reference's on the same document;
    decode_longctx: they are the reference's on it with the port's fields
    renamed to the reference's, less the port's own max_abs_err column."""
    rep = trunner.run(name, out_dir=tmp_path, quick=True, device="cpu")
    doc = load_results(rep.path)
    rows = treport.table_for(doc)
    assert rows and rep.failed == 0
    if name == "autotune":
        assert rows == jreport.table_for(doc)
        return
    want = jreport.table_for(_longctx_as_reference(doc))
    got = []
    for row_name, us, derived in rows:
        derived = derived.rsplit(";max_abs_err=", 1)[0]
        for mine, theirs in LONGCTX_ROW:
            row_name = row_name.replace(mine, theirs)
            derived = derived.replace(mine, theirs)
        got.append((row_name, us, derived))
    assert got == want


def test_report_command_renders_result_files(tmp_path, capsys):
    paths = []
    for name in ("paged_serve", "isa_mapping"):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(DOCS[name]))
        paths.append(str(path))
    assert cli_main(["report", *paths]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    buf = io.StringIO()
    jreport.render_rows(jreport.table_for(DOCS["paged_serve"])
                        + jreport.table_for(DOCS["isa_mapping"]), file=buf)
    assert out == buf.getvalue().splitlines()
    bad = tmp_path / "sharded_decode.json"
    bad.write_text(json.dumps(dict(DOCS["paged_serve"],
                                   experiment="sharded_decode")))
    with pytest.raises(SystemExit, match="sharded_decode"):
        cli_main(["report", str(bad)])


# -- the ISA census over text recorded on the H100 ------------------------------

def _texts(name):
    return ((DATA / f"{name}.ptx").read_text(),
            (DATA / f"{name}.sass").read_text())


# case -> (PTX, SASS instructions, top 3 SASS opcodes, expansion)
PINNED = {
    "add.f32": (17, 16, {"EXIT": 2, "IMAD.WIDE": 2, "LDC": 2},
                {"FADD": 1}),
    "rsqrt.f32": (19, 17, {"EXIT": 2, "IMAD.WIDE": 2, "LDC": 2},
                  {"FADD": 1, "MUFU.RSQ": 1}),
}


@pytest.mark.parametrize("case", sorted(PINNED))
def test_isa_census_of_recorded_text_is_pinned(case):
    ptx, sass = _texts("cases")
    m = sc.case_metrics(case, ptx, sass)
    n_src, n_opt, top, exp = PINNED[case]
    assert (m["n_source_ops"], m["n_optimized_ops"], m["top_ops"],
            m["sass_expansion"], m["flops"]) == (n_src, n_opt, top, exp, 0)
    assert sum(m["ptx_ops"].values()) == n_src
    assert sum(m["sass_ops"].values()) == n_opt
    assert chip_smoke.isa_gates({case: m}) == []
    # what the census reads is the rule: no directive, label or padding
    table = sc.op_mapping_table(ptx, sass)
    assert set(table) == {sc.BASELINE, sc.CASES[case]} | (
        {sc.CASES[c] for c in PINNED})
    for row in table.values():
        assert not any(op.startswith(".") or op.endswith(":")
                       for op in row["ptx"])
        assert "NOP" not in row["sass"]


def test_isa_parsers_follow_the_counting_rule():
    ptx = """
.visible .entry k(
	.param .u64 k_param_0
)
{
	.reg .pred 	%p<2>;
	.reg .f32 	%f<3>;
	// a comment; with a semicolon
	ld.param.u64 	%rd1, [k_param_0];
	@%p1 bra 	$L__BB0_2;
	{ .reg .b32 %t; mov.b32 %t, 1; }
	ld.global.v2.f32 	{%f1, %f2}, [%rd1];
$L__BB0_2:
	ret;
}
"""
    assert sc.ptx_entries(ptx) == {"k": ["ld.param.u64", "bra", "mov.b32",
                                         "ld.global.v2.f32", "ret"]}
    sass = """
		Function : k
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/               @P0 EXIT ;
        /*0020*/              @!UP1 FADD R5, R2, 1 ;
        /*0030*/                   EXIT ;
        /*0040*/                   BRA 0x40;
        /*0050*/                   NOP;
"""
    assert sc.sass_functions(sass) == {"k": ["LDC", "EXIT", "FADD", "EXIT"]}


def test_isa_controls_are_caught_on_recorded_text():
    """``ISA_MUST_CATCH`` over the card's text: the dead store leaves no
    SASS beyond the baseline; rsqrt built as sqrt changes the case's SASS
    and its values by far more than the value check allows; a parser that
    counts directives and labels fails the scaffold gate and the pins."""
    assert set(chip_smoke.ISA_MUST_CATCH) == {
        "dead_store", "wrong_op", "scaffold_counted"}
    ptx, sass = _texts("dead_store")
    m = sc.case_metrics("add.f32", ptx, sass)
    assert m["sass_expansion"] == {}
    assert any("no SASS beyond" in b
               for b in chip_smoke.isa_gates({"add.f32": m}))
    ptx, sass = _texts("wrong_op")
    m = sc.case_metrics("rsqrt.f32", ptx, sass)
    assert m["sass_expansion"] != PINNED["rsqrt.f32"][3]
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    want = chip_smoke.isa_plain(torch, "rsqrt.f32", x)
    wrong = torch.sqrt(x.abs() + 1e-3)
    assert ((wrong - want).abs().max()
            > 100 * chip_smoke.ISA_TOL * want.abs().max())
    ptx, sass = _texts("cases")
    m = chip_smoke.isa_scaffold_counted(ptx, sass, "add.f32")
    assert m["n_source_ops"] != PINNED["add.f32"][0]
    assert any("directives or labels" in b
               for b in chip_smoke.isa_gates({"add.f32": m}))
    assert sc.case_metrics("add.f32", ptx, sass)["n_source_ops"] == (
        PINNED["add.f32"][0])               # the sound parser is back


def test_isa_variants_substitute_once():
    src = sc.SOURCE.read_text()
    for name, (old, new) in chip_smoke.ISA_VARIANTS.items():
        text = chip_smoke.isa_variant(name)
        assert old not in text and new in text
        assert len(text) - len(src) == len(new) - len(old)


def test_isa_mapping_without_the_toolkit_names_the_tool(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_BIN", tmp_path)
    rep = trunner.run("isa_mapping", out_dir=tmp_path, quick=True,
                      device="cpu")
    assert rep.failed == rep.total_cells == 4
    doc = load_results(rep.path)
    for rec in doc["cells"].values():
        assert rec["status"] == STATUS_ERROR
        assert "nvcc not found" in rec["error"]
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        _build.sass(tmp_path / "lib.so")


@pytest.mark.parametrize("case", jreg.ISA_CASES)
def test_isa_flops_equal_the_reference_census(case):
    assert jreg.run_isa_cell({"case": case})["flops"] == (
        sc.CASE_FLOPS.get(case, 0))
