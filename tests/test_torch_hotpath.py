"""The port's legacy blocking decode path (``fused=False``) against the JAX
package's, on the CPU.

Reduced gemma2-2b (2 layers, vocab 128) in f32 compute on weights converted
from the JAX package's seed-0 init, through both engines of both packages
with ``fused=False``: the 32-request acceptance trace of
``tests/test_decode_hotpath.py`` (rng 11, ``max_batch=4``, ``max_len=48``;
paged: ``block_size=8``, ``n_blocks=10``, ``chunk_size=8``) and the
minimal-pool eviction trace (rng 5, 8 requests, ``n_blocks=6``, eos 7).
Tokens and the engines' counters must be equal.  Then the reference's
hot-path contracts, held on the port: fused tokens equal legacy tokens, the
legacy paths read the device more than once a step, the legacy step holds
two KV stores at its peak where the fused step holds one, the
``stale_token`` control of ``chip_smoke.py``'s hotpath phase is caught by
the parity check, and cost-gated legacy runs admit and defer as the JAX
legacy engines do.
"""
import dataclasses
import functools
import gc
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import ShapeCell as JCell
from repro.core.costmodel import CostModel as JCostModel
from repro.core.costmodel.analytic import analytic_census as janalytic
from repro.core.perfmodel.hardware import HardwareSpec as JHardwareSpec
from repro.models.zoo import build_model as jbuild
from repro.serve import PagedServingEngine as _JPaged
from repro.serve import ServingEngine as _JSlot
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.costmodel import CostModel
from repro_torch.core.costmodel.calibration import CALIB_DIR
from repro_torch.core.perfmodel.hardware import H100_SXM
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zoo import build_model, fused_decode_step
from repro_torch.serve.engine import PagedServingEngine, ServingEngine
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)

ROOT = Path(__file__).resolve().parents[1]
_chip = importlib.util.spec_from_file_location(
    "chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_chip)
_chip.loader.exec_module(chip_smoke)


class _PortPricing:
    """The port's decode pricing on a JAX engine: the analytic census of a
    decode at (max_len, max_batch), donated and sampled on the device on
    the fused path and neither on the legacy one (the JAX engines price
    the HLO of their compiled step instead)."""

    def _predict_decode(self):
        key = ("decode", self.max_batch)
        if key not in self._pred_cache:
            cell = JCell("decode", "decode", self.max_len, self.max_batch)
            self._pred_cache[key] = self.cost_model.predict(janalytic(
                self.model.cfg, cell, n_devices=1, n_model=1,
                donated=self.fused, device_sampling=self.fused))
        return self._pred_cache[key]


class JPaged(_PortPricing, _JPaged):
    """The JAX paged engine with each host->device upload taken from a
    private copy (``jnp.asarray`` may alias the host block table, which the
    engine grows in place while a step that reads it can be in flight; see
    ``tests/test_torch_engine.py``)."""

    def _dev(self, x, kind="repl"):
        return super()._dev(np.array(x, copy=True), kind)


class JSlot(_PortPricing, _JSlot):
    pass


@functools.lru_cache(maxsize=None)
def _models():
    kw = dict(n_layers=2, vocab_size=128, compute_dtype="float32")
    jm = jbuild(jreduced(JARCHS["gemma2-2b"], **kw))
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = reduced(ARCHS["gemma2-2b"], **kw)
    tm = build_model(cfg, device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    return cfg, jm, jparams, tm, tparams


def _prompts(seed, n_req, max_prompt):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=int(rng.integers(1, max_prompt)))
            .astype(np.int32) for _ in range(n_req)]


# (seed, n_req, max_prompt, max_new, eos, n_blocks)
TRACES = {"acceptance": (11, 32, 31, 4, None, 10),
          "minimal_pool": (5, 8, 28, 5, 7, 6)}
ENGINES = {"paged": (JPaged, PagedServingEngine),
           "slot": (JSlot, ServingEngine)}


def _kw(kind, n_blocks):
    kw = dict(max_batch=4, max_len=48)
    if kind == "paged":
        kw.update(block_size=8, n_blocks=n_blocks, chunk_size=8)
    return kw


def _serve(cls, model, params, prompts, max_new, eos=None, fault=None,
           **kw):
    eng = cls(model, params, **kw)
    if fault is not None:
        chip_smoke.hotpath_fault(fault, eng)
    rids = [eng.submit(p, max_new_tokens=max_new, eos_id=eos)
            for p in prompts]
    eng.run_until_done(max_steps=20_000)
    return eng, [eng.done[r].tokens for r in rids]


def _counters(s):
    return dict(steps=s.steps, host_syncs=s.host_syncs, prefills=s.prefills,
                prefill_chunks=s.prefill_chunks, preemptions=s.preemptions,
                decoded_tokens=s.decoded_tokens, completed=s.completed,
                admission_order=s.admission_order)


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_legacy_engine_equals_jax_legacy_engine(kind, trace):
    cfg, jm, jparams, tm, tparams = _models()
    seed, n_req, max_prompt, max_new, eos, n_blocks = TRACES[trace]
    prompts = _prompts(seed, n_req, max_prompt)
    jcls, tcls = ENGINES[kind]
    kw = dict(_kw(kind, n_blocks), fused=False)
    jeng, jtoks = _serve(jcls, jm, jparams, prompts, max_new, eos, **kw)
    teng, ttoks = _serve(tcls, tm, tparams, prompts, max_new, eos, **kw)
    assert ttoks == jtoks
    assert _counters(teng.stats) == _counters(jeng.stats)
    assert teng.stats.completed == n_req
    if kind == "paged":
        teng.allocator.check()
        assert teng.allocator.n_free == teng.n_blocks
        if trace == "minimal_pool":
            assert teng.stats.preemptions > 0


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_fused_tokens_equal_legacy_and_legacy_syncs_more(kind):
    """The reference's hot-path contracts on the port: fused and legacy
    give the same greedy tokens on the acceptance trace; the legacy path
    reads the device more than once a step, the fused one at most once a
    step beyond the first; ``chip_smoke.hotpath_gates`` passes them."""
    cfg, _, _, tm, tparams = _models()
    seed, n_req, max_prompt, max_new, eos, n_blocks = TRACES["acceptance"]
    prompts = _prompts(seed, n_req, max_prompt)
    runs = {}
    for fused in (True, False):
        eng, toks = _serve(ENGINES[kind][1], tm, tparams, prompts, max_new,
                           fused=fused, **_kw(kind, n_blocks))
        runs[fused] = dict(tokens=toks, steps=eng.stats.steps,
                           host_syncs=eng.stats.host_syncs)
    assert runs[True]["tokens"] == runs[False]["tokens"]
    assert runs[False]["host_syncs"] > runs[False]["steps"]
    assert runs[True]["host_syncs"] <= runs[True]["steps"] + 1
    assert chip_smoke.hotpath_gates(runs[False], runs[True]) == []


def _store_census(model, kind, n_blocks):
    """A copy of ``model`` whose decode counts, at each call, the live
    tensors of the KV store's shape; returns (model, the counts, shape)."""
    counts = []
    probe = (PagedServingEngine if kind == "paged" else ServingEngine)(
        model, None, **_kw(kind, n_blocks))
    shape = tuple(probe.cache["k"].shape)
    del probe

    def decode(params, cache, tokens, pos, block_tables=None, **kw):
        counts.append(sum(1 for o in gc.get_objects()
                          if type(o) is torch.Tensor
                          and tuple(o.shape) == shape))
        return model.decode(params, cache, tokens, pos, block_tables, **kw)
    return dataclasses.replace(model, decode=decode,
                               decode_step=fused_decode_step(decode)), counts


@pytest.mark.parametrize("fault", [None, "legacy_in_place"])
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_legacy_step_holds_two_stores(kind, fault):
    """Live-tensor census inside every decode call: the fused step sees one
    K and one V store, the legacy step two of each (the live store and its
    copy), as the reference's undonated step does; the ``legacy_in_place``
    control (no copy) holds one and so fails the census."""
    cfg, _, _, tm, tparams = _models()
    prompts = _prompts(7, 3, 20)
    peaks = {}
    for fused in (True, False):
        model, counts = _store_census(tm, kind, 10)
        eng, _ = _serve(ENGINES[kind][1], model, tparams, prompts, 3,
                        fused=fused, fault=None if fused else fault,
                        **_kw(kind, 10))
        assert eng.stats.completed == len(prompts)
        peaks[fused] = max(counts)
        del eng                              # its stores are not the next's
    assert peaks[True] == 2                  # the K store + the V store
    if fault is None:
        assert peaks[False] == 4
    else:
        assert "legacy_in_place" in chip_smoke.HOTPATH_MUST_CATCH
        assert peaks[False] == 2


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_stale_token_control_caught_by_parity(kind):
    """``stale_token``: each legacy step uploads the tokens of the step
    before; its tokens must differ from the JAX legacy engine's, and the
    hotpath token gate must catch it."""
    cfg, jm, jparams, tm, tparams = _models()
    seed, n_req, max_prompt, max_new, eos, n_blocks = TRACES["acceptance"]
    prompts = _prompts(seed, n_req, max_prompt)
    jcls, tcls = ENGINES[kind]
    kw = dict(_kw(kind, n_blocks), fused=False)
    jeng, jtoks = _serve(jcls, jm, jparams, prompts, max_new, **kw)
    teng, ttoks = _serve(tcls, tm, tparams, prompts, max_new,
                         fault="stale_token", **kw)
    assert "stale_token" in chip_smoke.HOTPATH_MUST_CATCH
    assert ttoks != jtoks
    got = dict(tokens=ttoks, steps=teng.stats.steps,
               host_syncs=teng.stats.host_syncs)
    want = dict(tokens=jtoks, steps=jeng.stats.steps,
                host_syncs=jeng.stats.host_syncs)
    assert any(b.startswith("tokens differ")
               for b in chip_smoke.hotpath_gates(got, want))


@pytest.mark.parametrize("budget", ["tight", "loose"])
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_gated_legacy_admission_equals_jax(kind, budget):
    """Cost-gated legacy runs (``cost_model=``, ``step_budget_s=``) priced
    from the port's ``hopper_h100`` table: tokens, admission order,
    deferrals, steps and predicted step times equal the JAX legacy
    engine's; the legacy decode is priced undonated and host-sampled,
    above the fused one."""
    cfg, jm, jparams, tm, tparams = _models()
    cm = CostModel.from_named("hopper_h100")
    jcm = JCostModel.from_named(
        CALIB_DIR / "hopper_h100.json",
        hw=JHardwareSpec(**dataclasses.asdict(H100_SXM)))
    prompts = _prompts(11, 12, 20)
    jcls, tcls = ENGINES[kind]
    kw = _kw(kind, 10)
    probe = tcls(tm, tparams, cost_model=cm, fused=False, **kw)
    decode_s = probe._predict_decode().step_s
    assert decode_s > tcls(tm, tparams, cost_model=cm,
                           **kw)._predict_decode().step_s
    median = sorted(len(p) for p in prompts)[len(prompts) // 2]
    unit_s = (probe._predict_chunk() if kind == "paged"
              else probe._predict_prefill(median)).step_s
    b = {"tight": decode_s + 1.5 * unit_s, "loose": 1e9}[budget]
    gated = dict(kw, fused=False, step_budget_s=b)
    jeng, jtoks = _serve(jcls, jm, jparams, prompts, 5, cost_model=jcm,
                         **gated)
    teng, ttoks = _serve(tcls, tm, tparams, prompts, 5, cost_model=cm,
                         **gated)
    s, js = teng.stats, jeng.stats
    assert ttoks == jtoks
    assert (s.admission_order, s.deferred_prefills, s.steps) == (
        js.admission_order, js.deferred_prefills, js.steps)
    np.testing.assert_allclose(s.predicted_step_s, js.predicted_step_s,
                               rtol=1e-12, atol=0)
    assert len(s.predicted_step_s) == len(s.measured_step_s) == s.steps
    assert (s.deferred_prefills == 0) == (budget == "loose")


def test_mesh_with_the_legacy_path_is_refused_as_in_jax():
    _, _, _, tm, tparams = _models()
    with pytest.raises(ValueError, match="fused decode path"):
        PagedServingEngine(tm, tparams, max_batch=2, max_len=16,
                           block_size=8, mesh=object(), fused=False)


def test_hotpath_phase_reduced_parity_rehearsed_on_the_cpu():
    """``chip_smoke.hotpath_reduced`` with the CPU standing in for the
    card: legacy tokens equal fused and CPU tokens on both engines, the
    legacy paths sync more than once a step, and ``stale_token`` breaks
    the parity on both."""
    runs, failures, caught = chip_smoke.hotpath_reduced(torch, np, 0, "cpu")
    assert failures == []
    for kind in ("paged", "slot"):
        assert runs[kind]["identical_to_fused"]
        assert runs[kind]["identical_to_cpu"]
        assert runs[kind]["host_syncs"] > runs[kind]["steps"]
        assert runs[kind]["distinct_tokens"] > 8
        assert caught[kind] and caught[kind][0].startswith("tokens differ")
