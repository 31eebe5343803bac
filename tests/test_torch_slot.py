"""The port's slot-engine path against the JAX package, on the CPU.

``reduced(gemma2-2b, n_layers=2, vocab_size=128)`` in f32 compute (one
local layer with window 8, one global layer, softcaps, post-norms): the
JAX parameters are converted with ``params_from_jax`` and both packages
run the uncached prefill (``Model.prefill``; in the port its attention is
``flash_attention``, here its plain version), decode over the dense slot
cache, and the fused ``ServingEngine``.  Tolerances: logits atol 1e-4 (f32,
other summation order over 2 layers); caches atol 2e-2 (bf16 storage: one
bf16 ulp where the f32 values round differently).  Greedy tokens must be
identical; with a cost model priced from the port's ``hopper_h100`` table,
so must be admission, deferrals and predicted step times.
"""
import dataclasses
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import ShapeCell as JCell
from repro.core.costmodel import CostModel as JCostModel
from repro.core.costmodel.analytic import analytic_census as janalytic
from repro.core.perfmodel.hardware import HardwareSpec as JHardwareSpec
from repro.models.zoo import build_model as jbuild
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.costmodel import CostModel
from repro_torch.core.costmodel.calibration import CALIB_DIR
from repro_torch.core.perfmodel.hardware import H100_SXM
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.telemetry import TelemetryController
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)

KW = dict(n_layers=2, vocab_size=128, compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = jreduced(JARCHS["gemma2-2b"], **KW)
    cfg = reduced(ARCHS["gemma2-2b"], **KW)
    jm = jbuild(jcfg)
    tree = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)

    def perturb(path, x):           # exercise 1 + scale in every norm
        if getattr(path[-1], "key", None) == "scale":
            return (x + rng.normal(size=x.shape) * 0.3).astype(np.float32)
        return x
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    tm = build_model(cfg, device="cpu")
    return cfg, jm, jparams, tm, params_from_jax(tree, cfg, "cpu")


def _prompts(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("S,max_len", [(19, 24), (13, None), (1, 8)])
def test_prefill_logits_and_padded_cache_match(S, max_len):
    """Prompts past the window of 8; the cache comes back stacked
    [L, B, max_len, KH, hd] in bf16, zero past the prompt."""
    cfg, jm, jparams, tm, tparams = _models()
    toks = np.random.default_rng(S).integers(0, 128, size=(2, S)) \
        .astype(np.int32)
    lj, cj = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                        max_len=max_len)
    lt, ct = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                        max_len=max_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    L = max_len or S
    for key in ("k", "v"):
        assert ct[key].shape == (2, 2, L, cfg.n_kv_heads, cfg.head_dim)
        assert ct[key].dtype == torch.bfloat16
        np.testing.assert_allclose(ct[key].float().numpy(),
                                   np.asarray(cj[key], np.float32), atol=2e-2)
        assert torch.all(ct[key][:, :, S:] == 0)


def test_prefill_through_plain_and_ref_attention_agree():
    """``flash_fn=`` swaps the prefill attention: the full-softmax oracle
    gives the same logits as the blocked plain version."""
    _, _, _, tm, tparams = _models()
    toks = torch.from_numpy(np.arange(30, dtype=np.int32)[None] % 128)
    a, _ = tm.prefill(tparams, {"tokens": toks}, max_len=32)
    b, _ = tm.prefill(tparams, {"tokens": toks}, max_len=32,
                      flash_fn=tref.flash_attention_ref)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_dense_decode_after_prefill_matches_including_the_clamp():
    """Decode over the dense slot cache after a prefill, past the window;
    row 1 sits at a position past max_len, so its write is clamped to the
    last slot exactly as ``dynamic_update_slice`` clamps it."""
    cfg, jm, jparams, tm, tparams = _models()
    max_len = 24
    toks = np.random.default_rng(4).integers(0, 128, size=(2, 13)) \
        .astype(np.int32)
    lj, cj = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                        max_len=max_len)
    lt, ct = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                        max_len=max_len)
    nxt = np.asarray(lj).argmax(-1).astype(np.int32)
    pos = np.asarray([13, 30], np.int32)
    for _ in range(6):
        lj, cj = jm.decode(jparams, cj, jnp.asarray(nxt[:, None]),
                           jnp.asarray(pos))
        lt, ct = tm.decode(tparams, ct, torch.from_numpy(nxt[:, None]),
                           torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        nxt = np.asarray(lj).argmax(-1).astype(np.int32)
        pos = pos + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key].float().numpy(),
                                   np.asarray(cj[key], np.float32), atol=2e-2)


def _serve(engine_cls, model, params, prompts, max_new, eos_id=None, **kw):
    eng = engine_cls(model, params, **kw)
    rids = [eng.submit(p, max_new_tokens=max_new, eos_id=eos_id)
            for p in prompts]
    eng.run_until_done()
    return eng, [eng.done[r].tokens for r in rids]


@pytest.mark.parametrize("seed,n_req,max_new,max_batch,max_len", [
    (11, 12, 5, 4, 48),      # three times as many requests as slots
    (5, 6, 40, 2, 32),       # requests retire on the cache ceiling
])
def test_engine_tokens_identical_to_jax(seed, n_req, max_new, max_batch,
                                        max_len):
    cfg, jm, jparams, tm, tparams = _models()
    prompts = _prompts(seed, n_req, 1, 20)
    kw = dict(max_batch=max_batch, max_len=max_len)
    jeng, jtoks = _serve(JServingEngine, jm, jparams, prompts, max_new, **kw)
    teng, ttoks = _serve(ServingEngine, tm, tparams, prompts, max_new, **kw)
    assert ttoks == jtoks
    s, js = teng.stats, jeng.stats
    assert s.completed == n_req
    assert (s.steps, s.prefills, s.admission_order, s.host_syncs,
            s.decoded_tokens) == (js.steps, js.prefills, js.admission_order,
                                  js.host_syncs, js.decoded_tokens)
    assert s.host_syncs <= s.steps
    assert teng.kv_cache_bytes() == jeng.kv_cache_bytes()


def test_engine_eos_retires_like_jax():
    cfg, jm, jparams, tm, tparams = _models()
    prompts = _prompts(2, 5, 3, 18)
    kw = dict(max_batch=2, max_len=40)
    _, free = _serve(ServingEngine, tm, tparams, prompts, 8, **kw)
    eos = free[1][3]
    _, jtoks = _serve(JServingEngine, jm, jparams, prompts, 8, eos_id=eos,
                      **kw)
    teng, ttoks = _serve(ServingEngine, tm, tparams, prompts, 8, eos_id=eos,
                         **kw)
    assert ttoks == jtoks
    assert ttoks[1] == free[1][:free[1].index(eos) + 1]
    assert teng.stats.completed == len(prompts)


class JGated(JServingEngine):
    """The JAX slot engine with the port's decode pricing: the analytic
    census of a decode at (max_len, max_batch), donated and sampled on the
    device (the JAX engine prices the HLO of its compiled step instead)."""

    def _predict_decode(self):
        key = ("decode", self.max_batch)
        if key not in self._pred_cache:
            cell = JCell("decode", "decode", self.max_len, self.max_batch)
            self._pred_cache[key] = self.cost_model.predict(janalytic(
                self.model.cfg, cell, n_devices=1, n_model=1, donated=True,
                device_sampling=True))
        return self._pred_cache[key]


@pytest.mark.parametrize("budget", ["zero", "between", "tight", "loose"])
def test_gated_admission_identical_to_jax(budget):
    """Twelve requests over four slots under a budget of 0, one between
    the median prompt's prefill and the decode step, the decode step plus
    1.5 median prefills, and 1e9 s: tokens, admission order, deferrals,
    steps and predicted step times equal the JAX engine's."""
    cfg, jm, jparams, tm, tparams = _models()
    cm = CostModel.from_named("hopper_h100")
    jcm = JCostModel.from_named(
        CALIB_DIR / "hopper_h100.json",
        hw=JHardwareSpec(**dataclasses.asdict(H100_SXM)))
    prompts = _prompts(11, 12, 1, 20)
    kw = dict(max_batch=4, max_len=48)
    probe = ServingEngine(tm, tparams, cost_model=cm, **kw)
    median = sorted(len(p) for p in prompts)[len(prompts) // 2]
    decode_s = probe._predict_decode().step_s
    prefill_s = probe._predict_prefill(median).step_s
    assert 0 < prefill_s < decode_s
    b = {"zero": 0.0, "between": (prefill_s + decode_s) / 2,
         "tight": decode_s + 1.5 * prefill_s, "loose": 1e9}[budget]
    jeng, jtoks = _serve(JGated, jm, jparams, prompts, 5, cost_model=jcm,
                         step_budget_s=b, **kw)
    teng, ttoks = _serve(ServingEngine, tm, tparams, prompts, 5,
                         cost_model=cm, step_budget_s=b, **kw)
    s, js = teng.stats, jeng.stats
    assert ttoks == jtoks
    assert (s.admission_order, s.deferred_prefills, s.steps) == (
        js.admission_order, js.deferred_prefills, js.steps)
    np.testing.assert_allclose(s.predicted_step_s, js.predicted_step_s,
                               rtol=1e-12, atol=0)
    assert s.completed == len(prompts)
    assert len(s.predicted_step_s) == len(s.measured_step_s) == s.steps
    assert s.host_syncs <= s.steps + 1
    assert (s.deferred_prefills == 0) == (budget == "loose")


class _StubCostModel:
    """Prices a prefill at its flops (seconds), the decode step (the one
    census with ``boundary_bytes``) at 0."""

    def predict(self, census, **kw):
        decode = "boundary_bytes" in census
        return types.SimpleNamespace(step_s=0.0 if decode
                                     else census["flops"])


def test_deferred_count_excludes_requests_that_would_fit():
    """A huge prompt at the queue head and a small one behind it: only the
    huge one is deferred by the budget; the small one (which would fit)
    waits on FIFO order and is not counted.  As the reference's
    ``test_slot_deferred_count_excludes_requests_that_would_fit``."""
    _, _, _, tm, tparams = _models()
    cm = _StubCostModel()
    kw = dict(max_batch=4, max_len=96, cost_model=cm)
    probe = ServingEngine(tm, tparams, **kw)

    def cost(n):
        return probe._predict_prefill(n).step_s
    budget = cost(4) + cost(6) + 1.0          # fits small + tiny, not huge
    assert cost(64) > budget
    eng = ServingEngine(tm, tparams, step_budget_s=budget, **kw)
    eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=2)    # admitted
    eng.submit(np.arange(64, dtype=np.int32), max_new_tokens=2)   # too big
    eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=2)    # would fit
    eng.step()
    assert eng.stats.prefills == 1
    assert eng.stats.deferred_prefills == 1
    assert len(eng.queue) == 2                # FIFO: no admission around
    assert eng.run_until_done().completed == 3


def test_engine_refuses_unported_options_and_long_prompts():
    """``telemetry=`` is ported: the slot engine binds the controller and
    hands it one record a productive step and one a retirement; an
    over-long prompt is still refused."""
    _, _, _, tm, tparams = _models()
    ctl = TelemetryController(drift=False)
    eng = ServingEngine(tm, tparams, max_batch=2, max_len=16, telemetry=ctl)
    assert ctl.engine is eng and ctl.engine_name == "slot"
    for n in (3, 5, 4):
        eng.submit(np.arange(1, n + 1, dtype=np.int32), max_new_tokens=3)
    productive = 0
    while True:
        active = eng.step()
        productive += active > 0
        if active == 0 and not eng.queue:
            break
    steps = ctl.sink.steps()
    assert len(steps) == productive == eng.stats.steps
    assert [r.step for r in steps] == list(range(1, eng.stats.steps + 1))
    assert all(r.engine == "slot" and r.decode_ran for r in steps)
    assert sum(r.n_prefill_units for r in steps) == 3
    assert sorted(r.rid for r in ctl.sink.requests()) == [0, 1, 2]
    with pytest.raises(ValueError):
        eng.submit(np.zeros(16, np.int32))


@pytest.mark.parametrize("paged", [False, True])
def test_launcher_serves_reduced_model_on_cpu(paged, capsys):
    """``python -m repro_torch.launch.serve --arch gemma2-2b --reduced
    --device cpu [--paged]``: the slot engine by default, the paged engine
    with ``--paged``; 8 requests of 32 tokens each."""
    argv = ["--arch", "gemma2-2b", "--reduced", "--device", "cpu"]
    tserve.main(argv + ["--paged"] if paged else argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["engine"] == ("paged" if paged else "slot")
    assert out["completed"] == 8 and out["decoded_tokens"] == 8 * 31
    assert out["host_syncs"] <= out["steps"] + 1
