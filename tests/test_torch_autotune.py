"""The port's autotuner (``repro_torch.core.autotune``), its tuned dispatch,
the engines' ``autotuner=`` and the ``autotune`` and ``decode_longctx``
experiments, against the JAX package on the CPU.

* The cache: documents written by either package load in the other with
  equal entries; keys, refusals and migration are the reference's.
* The space: ``shape_bucket``, ``divisor_clamp``, the five names, their
  shape keys and default shapes equal the reference's.  The candidates are
  the card's launch choices: every one launchable, deduped after
  clamping, the default always present.
* Pricing: ``mxu_probe``'s predicted times over the candidates both
  spaces keep equal the reference Autotuner's within rel 1e-12 on each
  table of ``tests/test_torch_costmodel.py``, with the H100 spec on both
  sides; the paged census's FLOPs and page bytes equal the reference's at
  one split.
* The Autotuner mirrors ``tests/test_autotune.py``'s behaviour, and tuned
  kernels match the JAX oracles at its shapes and tolerances.
* Engines: a port and a JAX paged engine, each with a tuner whose cache
  holds ``block_size`` 32, read 32 and give identical tokens on reduced
  f32 gemma2's 32-request trace; the slot engine installs its handle for
  one step only.
* The campaign's quick grids run on the CPU; ``decode_longctx``'s tokens
  equal the JAX oracle's (``repro.kernels.ref.paged_attention_ref``);
  both tables render, also through ``report``.
* ``chip_smoke.py``'s ``AUTOTUNE_MUST_CATCH`` controls and the cache round
  trip rehearsed on the CPU.
"""
import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.core import costmodel as jcm
from repro.core.autotune import cache as jcache
from repro.core.autotune import search as jsearch
from repro.core.autotune import space as jspace
from repro.core.campaign import report as jreport
from repro.core.perfmodel.hardware import HardwareSpec as JHardwareSpec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import autotune
from repro_torch.core import costmodel as tcm
from repro_torch.core.autotune import Autotuner, TuningCache
from repro_torch.core.autotune import cache as tcache
from repro_torch.core.autotune import space as tspace
from repro_torch.core.autotune.cli import main as tune_main
from repro_torch.core.autotune.search import _HIT_KEYS_KEPT
from repro_torch.core.campaign import registry as treg
from repro_torch.core.campaign import report as treport
from repro_torch.core.campaign import runner as trunner
from repro_torch.core.campaign.cli import main as campaign_main
from repro_torch.core.campaign.results import load_results
from repro_torch.core.costmodel import CostModel
from repro_torch.core.perfmodel.hardware import H100_SXM
from repro_torch.kernels import mxu_probe as tmxu
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import CHUNK_TOKENS, CHUNKS
from repro_torch.serve.engine import PagedServingEngine, ServingEngine

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
costmodel_tests = _load("torch_costmodel_tests",
                        ROOT / "tests" / "test_torch_costmodel.py")
engine_tests = _load("torch_engine_tests",
                     ROOT / "tests" / "test_torch_engine.py")
TABLES = costmodel_tests.TABLES
RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _no_global_tuner():
    """No test leaks an installed autotuner into another."""
    prev, jprev = autotune.install(None), jautotune.install(None)
    yield
    autotune.install(prev)
    jautotune.install(jprev)


@pytest.fixture(scope="module")
def cm():
    return CostModel.from_named("hopper_h100")


def _spec():
    return JHardwareSpec(**dataclasses.asdict(H100_SXM))


# -- the cache --------------------------------------------------------------

def test_cache_documents_load_in_either_package(tmp_path, cm):
    """A document written by each package loads in the other with equal
    entries, through ``TuningCache(path)`` and through ``export``."""
    mine, theirs = tmp_path / "mine.json", tmp_path / "theirs.json"
    tuner = Autotuner(cm, TuningCache(mine))
    tuner.tune("paged_attention")
    tuner.tune("mxu_probe", {"m": 256, "k": 128, "n": 256})
    jtuner = jsearch.Autotuner(jcm.CostModel.from_named("tpu_v5e"),
                               jcache.TuningCache(theirs))
    jtuner.tune("wkv6")
    for path, want in ((mine, tuner.cache.entries),
                       (theirs, jtuner.cache.entries)):
        assert tcache.TuningCache(path).entries == want
        assert jcache.TuningCache(path).entries == want
    out = jcache.TuningCache(mine).export(tmp_path / "export.json")
    assert TuningCache(out).entries == tuner.cache.entries
    # a port entry served by the JAX package's reader, and back
    key = tuner.key_for("paged_attention", {})
    jreader = jsearch.Autotuner(jcm.CostModel.from_named("tpu_v5e"),
                                jcache.TuningCache(mine))
    assert jreader.cache.get(key)["config"] == tuner.lookup(
        "paged_attention", {})


def test_cache_keys_equal_jax():
    for parts in (("k", "b", "bf16", "dev", "cal"),
                  ("paged_attention", "batch8_ctx1024", "f32",
                   "cuda-NVIDIA H100 80GB HBM3", "hopper_h100")):
        key = tcache.entry_key(*parts)
        assert key == jcache.entry_key(*parts)
        assert tcache.split_key(key) == jcache.split_key(key) == parts
    for mod in (tcache, jcache):
        with pytest.raises(ValueError):
            mod.entry_key("k|bad", "b", "bf16", "dev", "cal")
        with pytest.raises(ValueError):
            mod.split_key("only|three|parts")
    assert (tcache.SCHEMA_KIND, tcache.SCHEMA_VERSION) == (
        jcache.SCHEMA_KIND, jcache.SCHEMA_VERSION)


@pytest.mark.parametrize("doc,match", [
    ({"entries": {}}, "not an autotune cache"),
    ({"ops": {}, "hardware": "cpu"}, "not an autotune cache"),
    ({"kind": "autotune_cache", "version": 99, "entries": {}}, "newer"),
])
def test_cache_refusals_equal_jax(tmp_path, doc, match):
    path = tmp_path / "doc.json"
    path.write_text(json.dumps(doc))
    errors = []
    for mod in (tcache, jcache):
        with pytest.raises(ValueError, match=match) as e:
            mod.TuningCache(path)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert json.loads(path.read_text()) == doc          # untouched


def test_cache_migrates_an_older_version_like_jax():
    old = {"kind": "autotune_cache", "version": 0, "created": "then",
           "entries": {"whatever": {}}}
    mine = tcache.validate(dict(old))
    theirs = jcache.validate(dict(old))
    assert mine["version"] == theirs["version"] == 1
    assert mine["entries"] == theirs["entries"] == {}
    assert mine["created"] == theirs["created"] == "then"


# -- the space ----------------------------------------------------------------

def test_buckets_and_clamps_equal_jax():
    for v in range(1, 300):
        shapes = {"seq": v, "batch": 1 + v % 7}
        assert tspace.shape_bucket(shapes) == jspace.shape_bucket(shapes)
        for n in (1, 6, 12, 96, 200, 1600):
            assert tspace.divisor_clamp(v, n) == jspace.divisor_clamp(v, n)


def test_registry_equals_jax():
    assert tspace.tunable_names() == jspace.tunable_names()
    for name in tspace.tunable_names():
        mine, theirs = tspace.get_tunable(name), jspace.get_tunable(name)
        assert mine.shape_keys == theirs.shape_keys
        assert mine.default_shapes == theirs.default_shapes
        for tn in (mine, theirs):
            with pytest.raises(KeyError):
                tn.normalize_shapes({"bogus": 3})
    for mod in (tspace, jspace):
        with pytest.raises(KeyError):
            mod.get_tunable("alu_chain")


def test_kernel_defaults_single_sourced():
    assert ops.KERNEL_DEFAULTS == {n: t.default_config
                                   for n, t in tspace.TUNABLES.items()}
    assert ops.KERNEL_DEFAULTS["paged_attention"] == {
        "block_size": 16, "num_splits": 1, "chunk_tokens": CHUNK_TOKENS}
    assert CHUNK_TOKENS == 64


@pytest.mark.parametrize("shapes", [
    {"batch": 8, "heads": 8, "kv_heads": 4, "head_dim": 256, "ctx": 1024},
    {"ctx": 24}, {"ctx": 100, "head_dim": 64}, {}])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_paged_candidates_are_launchable(shapes, dtype):
    tn = tspace.get_tunable("paged_attention")
    full = tn.normalize_shapes(shapes)
    G = full["heads"] // full["kv_heads"]
    cands = tn.candidates(shapes, dtype)
    assert {c["chunk_tokens"] for c in cands} == set(CHUNKS)
    for c in cands:
        assert c["chunk_tokens"] in CHUNKS
        assert 1 <= c["block_size"] <= full["ctx"]
        assert c["num_splits"] == 1
        assert tspace.chunk_smem_bytes(c["chunk_tokens"], full["head_dim"],
                                       G) <= tspace.SMEM_MAX
    keys = [tuple(sorted(c.items())) for c in cands]
    assert len(keys) == len(set(keys))
    assert tn.effective_default(shapes) in cands


@pytest.mark.parametrize("m,k,n", [(512, 512, 512), (256, 128, 384),
                                   (128, 128, 96), (96, 64, 48)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_mxu_candidates_are_launchable(m, k, n, dtype):
    tn = tspace.get_tunable("mxu_probe")
    shapes = {"m": m, "k": k, "n": n}
    tdt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    cands = tn.candidates(shapes, dtype)
    default = tn.effective_default(shapes)
    assert default in cands
    for c in cands:
        if c == default:
            continue
        bm, bn = c["block_m"], c["block_n"]
        assert bm % 16 == 0 and bn % 16 == 0 and m % bm == 0 and n % bn == 0
        assert tmxu.smem_bytes(tdt, k, bm, bn, 1) <= tmxu.SMEM_MAX
    keys = [tuple(sorted(c.items())) for c in cands]
    assert len(keys) == len(set(keys))


def test_candidates_pruned_by_the_footprint_keep_the_default():
    tn = tspace.get_tunable("paged_attention")
    shapes = {"batch": 8, "heads": 8, "kv_heads": 4, "head_dim": 256,
              "ctx": 1024}
    wide = tn.candidates(shapes, "bf16")
    budget = tspace.chunk_smem_bytes(64, 256, 2)
    tight = tn.candidates(shapes, "bf16", budget_bytes=budget)
    assert {c["chunk_tokens"] for c in tight} == {32, 64}
    assert len(tight) < len(wide)
    assert tn.effective_default(shapes) in tn.candidates(
        shapes, "bf16", budget_bytes=1.0)


def test_flash_and_recurrences_take_only_their_launch_choices():
    fa = tspace.get_tunable("flash_attention")
    shapes = {"seq_q": 900, "seq_kv": 900, "head_dim": 256}
    assert fa.candidates(shapes, "bf16") == [fa.effective_default(shapes)]
    opened = fa.candidates(shapes, "bf16", allow_low_precision=True)
    assert opened[0] == fa.effective_default(shapes)
    low = opened[1:]
    assert low and all(c["acc_dtype"] == "bf16" and c["block_q"] == 128
                       for c in low)
    assert max(c["block_k"] for c in low) == 256       # at most MAX_LK
    for name, shapes in (("ssm_scan", {"d_inner": 1600}),
                         ("wkv6", {"heads": 12})):
        tn = tspace.get_tunable(name)
        assert tn.candidates(shapes, "bf16", allow_low_precision=True) == [
            tn.effective_default(shapes)]
    assert tspace.get_tunable("ssm_scan").effective_default(
        {"d_inner": 1600}) == {"block_d": 64}


# -- pricing against the reference ---------------------------------------

@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("shapes", [{"m": 512, "k": 512, "n": 512},
                                    {"m": 256, "k": 128, "n": 384}])
def test_mxu_pricing_equals_jax(table, shapes):
    mine_arg, theirs_arg = TABLES[table]
    mine = Autotuner(tcm.CostModel(tcm.load_calibration(mine_arg),
                                   hw=H100_SXM)).tune("mxu_probe", shapes)
    theirs = jsearch.Autotuner(jcm.CostModel(
        jcm.load_calibration(theirs_arg), hw=_spec())).tune("mxu_probe",
                                                            shapes)
    jrows = {json.dumps(r["config"], sort_keys=True): r
             for r in theirs.ranked}
    shared = [r for r in mine.ranked
              if json.dumps(r["config"], sort_keys=True) in jrows]
    assert len(shared) >= 4
    for r in shared:
        want = jrows[json.dumps(r["config"], sort_keys=True)]["predicted_s"]
        assert r["predicted_s"] == pytest.approx(want, rel=1e-12, abs=0)
    order = [json.dumps(r["config"], sort_keys=True) for r in shared]
    jorder = [k for k in (json.dumps(r["config"], sort_keys=True)
                          for r in theirs.ranked) if k in set(order)]
    assert order == jorder


@pytest.mark.parametrize("shapes", [
    {}, {"batch": 8, "heads": 8, "kv_heads": 4, "head_dim": 256,
         "ctx": 1000}, {"batch": 1, "heads": 4, "kv_heads": 2, "ctx": 4096}])
@pytest.mark.parametrize("bs", [8, 16, 32, 128])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_paged_census_keeps_the_references_flops_and_bytes(shapes, bs,
                                                           dtype):
    mine = tspace.get_tunable("paged_attention")
    full = mine.normalize_shapes(shapes)
    for ct in CHUNKS:
        got = mine.census(shapes, {"block_size": bs, "chunk_tokens": ct},
                          dtype)
        want = jspace.get_tunable("paged_attention").census(
            shapes, {"block_size": bs, "num_splits": 1}, dtype)
        nb = -(-full["ctx"] // bs)
        nc = -(-nb * bs // ct)
        partials = 2.0 * full["batch"] * full["heads"] * nc * (
            full["head_dim"] + 2) * 4.0
        assert got["flops"] == want["flops"]
        assert got["hbm_bytes"] - partials == pytest.approx(
            want["hbm_bytes"], rel=1e-12)
        assert got["grid_cells"] == nc * full["kv_heads"] * full["batch"]


# -- the Autotuner ------------------------------------------------------------

def test_analytic_tune_is_deterministic_and_keyed_by_calibration(cm):
    a = Autotuner(cm).tune("paged_attention")
    b = Autotuner(CostModel.from_named("hopper_h100")).tune(
        "paged_attention")
    assert a.best == b.best and a.key == b.key
    assert [r["config"] for r in a.ranked] == [r["config"] for r in b.ranked]
    assert [r["predicted_s"] for r in a.ranked] == [
        r["predicted_s"] for r in b.ranked]
    ts = [r["predicted_s"] for r in a.ranked]
    assert ts == sorted(ts) and a.predicted_best_s <= a.predicted_default_s
    k1 = Autotuner(cm).key_for("wkv6", {})
    k2 = Autotuner(CostModel.from_named("ampere_a100")).key_for("wkv6", {})
    assert k1 != k2
    assert tcache.split_key(k1)[3:] == ("analytic-h100-sxm-80g",
                                        "hopper_h100")
    assert tcache.split_key(k2)[4] == "ampere_a100"


def test_lookup_unknown_kernel_vs_bad_shapes(cm):
    tuner = Autotuner(cm)
    assert tuner.lookup("alu_chain", {}) is None
    with pytest.raises(KeyError):
        tuner.lookup("flash_attention", {"seq": 64})


def test_hit_keys_stay_bounded(cm):
    tuner = Autotuner(cm)
    tuner.tune("wkv6")
    for _ in range(_HIT_KEYS_KEPT + 40):
        assert tuner.lookup("wkv6", {}) is not None
    assert len(tuner.stats.hit_keys) == _HIT_KEYS_KEPT == 64
    assert tuner.stats.hits == _HIT_KEYS_KEPT + 40


def test_measure_is_fixed_at_construction(cm):
    import inspect
    assert list(inspect.signature(Autotuner.tune).parameters) == [
        "self", "kernel", "shapes", "dtype"]
    assert Autotuner(cm).device_kind == "analytic-h100-sxm-80g"
    assert Autotuner(cm, measure=True, device="cpu").device_kind == "cpu-cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Autotuner(cm, measure=True)


def test_measured_tune_on_cpu_records_wall_time(cm):
    seen = []
    tuner = Autotuner(cm, measure=True, top_k=2, measure_iters=2,
                      measure_warmup=1, device="cpu",
                      check=lambda *a: seen.append(a[:2]))
    res = tuner.tune("mxu_probe", {"m": 64, "k": 64, "n": 64})
    assert res.source == "measured"
    assert res.measured_best_s > 0 and res.measured_default_s > 0
    timed = [r for r in res.ranked if "measured_s" in r]
    assert len(timed) in (2, 3)
    assert [c for _, c in seen] == [r["config"] for r in timed]
    assert tuner.cache.get(res.key)["source"] == "measured"


@pytest.mark.parametrize("kernel,shapes", [
    ("ssm_scan", {"batch": 1, "seq": 8, "d_inner": 32, "state_dim": 4}),
    ("wkv6", {"batch": 1, "seq": 8, "heads": 2, "head_dim": 16})])
def test_a_single_candidate_is_not_timed(cm, kernel, shapes):
    """A shortlist of one config has a fixed pick: the measured tuner
    neither checks nor times it, and its result stays analytic."""
    seen = []
    tuner = Autotuner(cm, measure=True, top_k=3, device="cpu",
                      check=lambda *a: seen.append(a[:2]))
    res = tuner.tune(kernel, shapes)
    assert len(res.ranked) == 1 and res.best == res.default
    assert seen == [] and res.source == "analytic"
    assert res.measured_best_s is None and res.measured_speedup is None
    assert "measured_s" not in res.ranked[0]
    assert tuner.cache.get(res.key)["source"] == "analytic"


def test_device_time_takes_a_call_or_a_list_on_cpu():
    from repro_torch.core.microbench.harness import cold_copies, device_time
    args = (torch.ones(4), 2)
    assert cold_copies(args, "cpu") == [args]
    calls = []
    assert device_time(lambda: calls.append(1), iters=3, warmup=1,
                       device="cpu") > 0
    assert device_time([lambda: calls.append(2), lambda: calls.append(3)],
                       iters=3, warmup=1, device="cpu") > 0
    assert calls == [1] * 4 + [2] * 4


SHARED = {
    "flash_attention": ({"batch": 1, "seq_q": 64, "seq_kv": 64, "heads": 2,
                         "kv_heads": 1, "head_dim": 16},
                        [{"block_q": 16, "junk": 1},
                         {"block_k": 32, "acc_dtype": "bf16"}],
                        [{"block_q": 32, "block_k": None}, {}]),
    "ssm_scan": ({"batch": 1, "seq": 8, "d_inner": 96, "state_dim": 8},
                 [{"block_d": 32}], [{"block_d": 48}, {"block_d": None}]),
    "wkv6": ({"batch": 1, "seq": 8, "heads": 6, "head_dim": 16},
             [{"block_h": 3}], [{"block_h": 2}, {}]),
    "mxu_probe": ({"m": 128, "k": 64, "n": 96},
                  [{"block_m": 64}], [{"block_n": 32}, {}]),
    "paged_attention": ({"batch": 2, "heads": 4, "kv_heads": 2,
                         "head_dim": 16, "ctx": 64},
                        [{"num_splits": 4, "block_size": 8}],
                        [{"num_splits": 2}, {"num_splits": None}]),
}


@pytest.mark.parametrize("kernel", sorted(SHARED))
def test_resolve_precedence_equals_jax(kernel):
    """explicit > config= > tuned > default, on every axis both packages
    share; without a handle tuned=True gives the defaults."""
    shapes, configs, explicits = SHARED[kernel]
    shared = set(ops.KERNEL_DEFAULTS[kernel]) & set(
        jops.KERNEL_DEFAULTS[kernel])
    for config in [None] + configs:
        for explicit in [None] + explicits:
            for tuned in (False, True):
                got = ops.resolve_kernel_config(
                    kernel, shapes, torch.float32, config=config,
                    tuned=tuned, explicit=explicit)
                want = jops.resolve_kernel_config(
                    kernel, shapes, jnp.float32, config=config,
                    tuned=tuned, explicit=explicit)
                assert {k: got[k] for k in shared} == {
                    k: want[k] for k in shared}
                assert set(got) == set(ops.KERNEL_DEFAULTS[kernel])


def test_tuned_dispatch_hits_the_installed_handle(cm, monkeypatch):
    shapes = {"batch": 1, "seq_q": 64, "seq_kv": 64, "heads": 2,
              "kv_heads": 1, "head_dim": 16}
    tuner = Autotuner(cm, dtype="f32", allow_low_precision=True)
    res = tuner.tune("flash_attention", shapes)
    with autotune.using(tuner):
        got = ops.resolve_kernel_config("flash_attention", shapes,
                                        torch.float32, tuned=True)
    assert got == res.best and tuner.stats.hits == 1
    assert ops.resolve_kernel_config(
        "flash_attention", shapes, torch.float32,
        tuned=True) == ops.KERNEL_DEFAULTS["flash_attention"]
    with pytest.raises(ValueError):
        ops.resolve_kernel_config("flash_attention", tuned=True)
    # the paged dispatch launches the cached chunk, at the reference's
    # lookup shapes (ctx: the table's width in tokens)
    seen = []
    monkeypatch.setattr(ops._pa, "paged_attention",
                        lambda *a, **kw: seen.append(kw["chunk_tokens"]))
    q = torch.zeros(2, 4, 16)
    pages = torch.zeros(8, 8, 2, 16)
    bt = torch.zeros(2, 4, dtype=torch.int32)
    ctx = torch.ones(2, dtype=torch.int32)
    pshapes = {"batch": 2, "heads": 4, "kv_heads": 2, "head_dim": 16,
               "ctx": 32}
    tuner.cache.put(tuner.key_for("paged_attention", pshapes),
                    {"config": {"block_size": 8, "num_splits": 1,
                                "chunk_tokens": 128}})
    with autotune.using(tuner):
        ops.paged_attention(q, pages, pages, bt, ctx, tuned=True)
        ops.paged_attention(q, pages, pages, bt, ctx, tuned=True,
                            chunk_tokens=32)
    ops.paged_attention(q, pages, pages, bt, ctx, tuned=True)
    assert seen == [128, 32, CHUNK_TOKENS]


def test_an_unlaunchable_cached_chunk_raises(cm):
    tuner = Autotuner(cm, dtype="f32")
    shapes = {"batch": 2, "heads": 4, "kv_heads": 2, "head_dim": 16,
              "ctx": 32}
    tuner.cache.put(tuner.key_for("paged_attention", shapes),
                    {"config": {"block_size": 8, "chunk_tokens": 48}})
    q = torch.zeros(2, 4, 16)
    pages = torch.zeros(8, 8, 2, 16)
    bt = torch.zeros(2, 4, dtype=torch.int32)
    ctx = torch.ones(2, dtype=torch.int32)
    with autotune.using(tuner), pytest.raises(ValueError, match="48"):
        ops.paged_attention(q, pages, pages, bt, ctx, tuned=True)


def _tol(dt):
    return 2e-2 if dt == "bf16" else 5e-5


def _pair(a, dt):
    """One numpy array as a port tensor and a JAX array of dtype ``dt``."""
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt]
    return torch.from_numpy(a.astype(np.float32)).to(tdt), jnp.asarray(a,
                                                                        jdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("low", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sq,skv", [(24, 36), (100, 100), (7, 129)])
def test_tuned_flash_attention_matches_jax_oracle(cm, low, dt, sq, skv):
    shapes = {"batch": 2, "seq_q": sq, "seq_kv": skv, "heads": 4,
              "kv_heads": 2, "head_dim": 16}
    tuner = Autotuner(cm, dtype=dt, allow_low_precision=low)
    res = tuner.tune("flash_attention", shapes)
    q, jq = _pair(RNG.normal(size=(2, sq, 4, 16)), dt)
    k, jk = _pair(RNG.normal(size=(2, skv, 2, 16)), dt)
    v, jv = _pair(RNG.normal(size=(2, skv, 2, 16)), dt)
    with autotune.using(tuner):
        o = ops.flash_attention(q, k, v, causal=False, tuned=True)
    assert tuner.stats.hits == 1
    r = jref.flash_attention_ref(jq, jk, jv, causal=False)
    tol = 4 * _tol("bf16" if res.best["acc_dtype"] == "bf16" else dt)
    np.testing.assert_allclose(_np(o), _np(r), atol=tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("di,n", [(96, 8), (256, 16)])
def test_tuned_ssm_scan_matches_jax_oracle(cm, dt, di, n):
    shapes = {"batch": 2, "seq": 24, "d_inner": di, "state_dim": n}
    best = Autotuner(cm, dtype=dt).tune("ssm_scan", shapes).best
    x, jx = _pair(RNG.normal(size=(2, 24, di)) * 0.2, dt)
    d, jd = _pair(RNG.uniform(0.001, 0.1, size=(2, 24, di)), dt)
    b, jb = _pair(RNG.normal(size=(2, 24, n)) * 0.2, dt)
    c, jc = _pair(RNG.normal(size=(2, 24, n)) * 0.2, dt)
    a = -np.abs(RNG.normal(size=(di, n))).astype(np.float32)
    o = ops.ssm_scan(x, d, b, c, torch.from_numpy(a), config=best)
    r = jref.ssm_scan_ref(jx, jd, jb, jc, jnp.asarray(a))
    np.testing.assert_allclose(_np(o), _np(r), atol=10 * _tol(dt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("h", [3, 6])
def test_tuned_wkv6_matches_jax_oracle(cm, dt, h):
    N = 16
    shapes = {"batch": 2, "seq": 20, "heads": h, "head_dim": N}
    best = Autotuner(cm, dtype=dt).tune("wkv6", shapes).best
    ins = [_pair(RNG.normal(size=(2, 20, h, N)) * 0.3, dt) for _ in range(3)]
    w, jw = _pair(RNG.uniform(0.7, 0.999, size=(2, 20, h, N)), dt)
    u, ju = _pair(RNG.normal(size=(h, N)) * 0.3, dt)
    o = ops.wkv6(*(p[0] for p in ins), w, u, config=best)
    r = jref.wkv6_ref(*(p[1] for p in ins), jw, ju)
    np.testing.assert_allclose(_np(o), _np(r), atol=10 * _tol(dt))


def test_tuned_mxu_probe_matches_jax_oracle(cm):
    shapes = {"m": 128, "k": 128, "n": 96}
    tuner = Autotuner(cm, dtype="f32")
    tuner.tune("mxu_probe", shapes)
    a = (RNG.normal(size=(128, 128)) * 0.1).astype(np.float32)
    b = (RNG.normal(size=(128, 96)) * 0.1).astype(np.float32)
    with autotune.using(tuner):
        o = ops.mxu_probe(torch.from_numpy(a), torch.from_numpy(b), chain=1,
                          tuned=True)
    assert tuner.stats.hits == 1
    r = jref.mxu_probe_ref(jnp.asarray(a), jnp.asarray(b), chain=1)
    np.testing.assert_allclose(_np(o), _np(r), atol=5e-4, rtol=2e-2)


# -- the engines --------------------------------------------------------------

def test_paged_engines_take_the_tuned_block_size_like_jax(cm):
    """Reduced f32 gemma2's acceptance trace (32 prompts of 1-30 tokens, 4
    new tokens) through a port and a JAX paged engine, each with a tuner
    whose cache holds block_size 32 (the port's also chunk 128): both read
    32, the port records the chunk its dispatch launches, and the tokens
    are identical, as they are to the untuned engine's."""
    cfg, jm, jparams, tm, tparams = engine_tests._models()
    kw = dict(chunk_size=8)          # _serve: max_batch 4, max_len 48
    shapes = {"batch": 4, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
              "head_dim": cfg.head_dim, "ctx": 48}
    tuner = Autotuner(cm)
    tuner.cache.put(tuner.key_for("paged_attention", shapes), {
        "config": {"block_size": 32, "num_splits": 1, "chunk_tokens": 128}})
    tuner.cache.put(tuner.key_for("paged_attention", shapes, "f32"), {
        "config": {"block_size": 32, "num_splits": 1, "chunk_tokens": 128}})
    jtuner = jsearch.Autotuner(jcm.CostModel.from_named("tpu_v5e"))
    jtuner.cache.put(jtuner.key_for("paged_attention", shapes), {
        "config": {"block_size": 32, "num_splits": 1}})
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(1, 31)))
               .astype(np.int32) for _ in range(32)]
    jeng, jtoks = engine_tests._serve(engine_tests.JEngine, jm, jparams,
                                      prompts, 4, autotuner=jtuner, **kw)
    teng, ttoks = engine_tests._serve(PagedServingEngine, tm, tparams,
                                      prompts, 4, autotuner=tuner, **kw)
    _, plain = engine_tests._serve(PagedServingEngine, tm, tparams, prompts,
                                   4, **kw)
    assert jeng.block_size == teng.block_size == 32
    assert (teng.kernel_chunk, teng.kernel_splits) == (128, 1)
    assert ttoks == jtoks == plain
    assert teng.stats.completed == 32
    # the engine's two reads at construction; every decode is then given
    # the resolved chunk and looks nothing up
    assert tuner.stats.hits == 2
    assert autotune.active() is None and jautotune.active() is None
    untuned = PagedServingEngine(tm, tparams, max_batch=4, max_len=48)
    assert (untuned.block_size, untuned.kernel_chunk) == (16, CHUNK_TOKENS)


def test_slot_engine_installs_its_tuner_for_one_step(cm):
    _, _, _, tm, tparams = engine_tests._models()
    tuner, prev = Autotuner(cm), object()
    eng = ServingEngine(tm, tparams, max_batch=2, max_len=16,
                        autotuner=tuner)
    seen = []
    step = eng._step

    def spy():
        seen.append(autotune.active())
        return step()
    eng._step = spy
    eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=3)
    autotune.install(prev)
    eng.run_until_done()
    assert seen and all(t is tuner for t in seen)
    assert autotune.active() is prev
    assert tuner.stats.lookups > 0       # the prefill's tuned flash lookup


# -- the campaign ---------------------------------------------------------

def test_quick_autotune_grid_runs_on_cpu_and_renders_like_jax(tmp_path):
    rep = trunner.run("autotune", out_dir=tmp_path, quick=True,
                      device="cpu")
    doc = load_results(rep.path)
    assert rep.total_cells == 5 and rep.failed == 0
    rows = treport.table_for(doc)
    assert rows == jreport.autotune_table(doc) == treport.autotune_table(doc)
    assert [r[0] for r in rows] == sorted(
        f"autotune/{k}.bf16.analytic" for k in tspace.tunable_names())
    assert treg.get("autotune").tags == ("autotune", "costmodel")


def test_quick_decode_longctx_tokens_equal_the_jax_oracle(tmp_path):
    rep = trunner.run("decode_longctx", out_dir=tmp_path, quick=True,
                      device="cpu")
    doc = load_results(rep.path)
    assert rep.total_cells == 4 and rep.failed == 0
    for rec in doc["cells"].values():
        m = rec["metrics"]
        q, kp, vp, bt, lens, readout = treg.longctx_inputs(
            m["ctx"], "cpu", torch.float32)
        want = jref.paged_attention_ref(*(jnp.asarray(t.numpy())
                                          for t in (q, kp, vp, bt, lens)))
        logits = np.asarray(want).reshape(1, -1) @ readout.numpy()
        assert m["tokens"] == logits.argmax(-1).tolist()
        assert m["identical_tokens"] is True
        assert m["max_abs_err_vs_ref"] <= 1e-6
        assert m["max_abs_ref"] == pytest.approx(
            float(np.abs(np.asarray(want)).max()), rel=1e-5)
        assert m["predicted_best_chunk"] in CHUNKS
        assert m["tuned_chunk"] == m["tuner_best_config"]["chunk_tokens"]
    assert chip_smoke.longctx_gates(doc) == []
    rows = treport.table_for(doc)
    assert sorted(r[0] for r in rows) == sorted(
        f"decode_longctx/ctx{c}.c{k}" for c in (128, 512) for k in (32, 64))
    buf = io.StringIO()
    treport.render_rows(rows, file=buf)
    assert campaign_main(["report", str(rep.path)]) == 0


def test_autotune_grid_costs_and_tags_equal_jax():
    from repro.core.campaign import registry as jreg
    ours, theirs = treg.get("autotune"), jreg.get("autotune")
    for quick in (True, False):
        assert ([c.key for c in ours.cells(quick=quick)]
                == [c.key for c in theirs.cells(quick=quick)])
    assert (ours.cost_per_cell_s, ours.tags) == (theirs.cost_per_cell_s,
                                                 theirs.tags)


def test_decode_longctx_grid_is_the_cards_chunk():
    exp = treg.get("decode_longctx")
    assert exp.grid == {"ctx": (256, 1024, 4096), "chunk_tokens": CHUNKS}
    assert exp.quick_grid == {"ctx": (128, 512), "chunk_tokens": (32, 64)}
    assert len(list(exp.cells())) == 9
    assert "num_splits" in exp.description


# -- chip_smoke's controls, rehearsed ---------------------------------------

def test_autotune_controls_are_caught_on_cpu(cm):
    shapes = {"batch": 2, "heads": 4, "kv_heads": 2, "head_dim": 32,
              "ctx": 128}
    controls, failures = chip_smoke.autotune_controls(torch, "cpu", cm,
                                                      shapes)
    assert failures == []
    assert sorted(controls) == sorted(chip_smoke.AUTOTUNE_MUST_CATCH)
    assert all(c["caught"] for c in controls.values()), controls


def test_cache_round_trip_into_the_paged_engine_on_cpu(tmp_path, cm):
    summary, failures = chip_smoke.autotune_round_trip(
        torch, np, 0, cm, tmp_path / "cache.json", card_dev="cpu")
    assert failures == []
    assert summary["card"]["block_size"] == 32
    assert summary["untuned"]["block_size"] == 16
    assert summary["card"]["tuner_hits"] > 0
    assert summary["card"]["dispatched_chunks"] == [128]
    assert summary["untuned"]["dispatched_chunks"] == [CHUNK_TOKENS]
    assert summary["distinct_tokens"] > 10


def test_the_checker_refuses_a_wrong_candidate(cm):
    records = []
    check = chip_smoke.autotune_checker(torch, records)
    fn, args = Autotuner(cm, measure=True, device="cpu").example_call(
        "wkv6", {"batch": 1, "seq": 12, "heads": 2, "head_dim": 16}, "f32",
        {"block_h": 1})
    check("wkv6", {"block_h": 1}, fn(*args), fn, args)
    with pytest.raises(AssertionError):
        check("wkv6", {"block_h": 1}, fn(*args) * 1.01, fn, args)
    assert [r["ok"] for r in records] == [True, False]


# -- the CLI ------------------------------------------------------------------

def test_cli_tune_show_export_round_trip(tmp_path, capsys):
    cache = str(tmp_path / "cache.json")
    assert tune_main(["tune", "--analytic-only", "--kernel",
                      "paged_attention", "--cache", cache]) == 0
    assert tune_main(["show", "--kernel", "paged_attention",
                      "--cache", cache]) == 0
    out = capsys.readouterr().out
    assert "paged_attention|" in out and "chunk_tokens" in out
    assert tune_main(["show", "--kernel", "wkv6", "--cache", cache]) == 1
    exported = tmp_path / "export.json"
    assert tune_main(["export", str(exported), "--cache", cache]) == 0
    doc = json.loads(exported.read_text())
    assert doc["kind"] == "autotune_cache" and len(doc["entries"]) == 1
    # the JAX package's CLI reads the port's cache
    from repro.core.autotune.cli import main as jtune_main
    assert jtune_main(["show", "--kernel", "paged_attention",
                       "--cache", cache]) == 0
    with pytest.raises(SystemExit, match="seqq"):
        tune_main(["tune", "--analytic-only", "--kernel", "flash_attention",
                   "--shape", "seqq=4096", "--cache", cache])


def test_cli_measure_runs_on_the_named_device(tmp_path, capsys):
    cache = str(tmp_path / "cache.json")
    assert tune_main(["tune", "--measure", "--device", "cpu", "--kernel",
                      "mxu_probe", "--shape", "m=64", "--shape", "k=64",
                      "--shape", "n=64", "--top-k", "2",
                      "--cache", cache]) == 0
    (key, entry), = TuningCache(cache).items()
    assert tcache.split_key(key)[3] == "cpu-cpu"
    assert entry["source"] == "measured"
