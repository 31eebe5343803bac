"""The port's ``PagedServingEngine`` against the JAX package's, on the CPU.

The 32-request acceptance trace of ``tests/test_paged_serving.py`` (rng 11,
``max_batch=4``, ``max_len=48``, ``block_size=8``, ``n_blocks=10``,
``chunk_size=8``, 4 new tokens) and the minimal-pool trace (``n_blocks=6``,
eviction churn) run through both engines on the same converted weights in
f32 compute.  Greedy tokens must be identical, the pool must be returned
whole, and the fused path must read the device once per step.  With a
cost model priced from the port's ``hopper_h100`` table (the JAX engine
from the same table on the same spec, its decode step priced from the
same analytic census), admission, deferrals and predicted step times must
be identical too.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import ShapeCell as JCell
from repro.core.costmodel import CostModel as JCostModel
from repro.core.costmodel.analytic import analytic_census as janalytic
from repro.core.perfmodel.hardware import HardwareSpec as JHardwareSpec
from repro.models.zoo import build_model as jbuild
from repro.serve import PagedServingEngine as _JaxEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.costmodel import CostModel
from repro_torch.core.costmodel.calibration import CALIB_DIR
from repro_torch.core.perfmodel.hardware import H100_SXM
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import PagedServingEngine
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)


class JEngine(_JaxEngine):
    """The JAX engine as the reference, with each host->device upload
    taken from a private copy.  Unchanged, it uploads its block table with
    ``jnp.asarray``, which may alias the host array, and then grows that
    table in place while a step that reads it can still be in flight.
    Under CPU load this race changed its greedy tokens in 4 of 21 runs of
    the acceptance trace; with copied uploads all 21 runs gave the same
    tokens.  Copying changes no value the engine means to upload."""

    def _dev(self, x, kind="repl"):
        return super()._dev(np.array(x, copy=True), kind)

    def _predict_decode(self):
        """The port's decode pricing: the analytic census of a decode at
        (max_len, max_batch), donated and sampled on the device (the JAX
        engine prices the HLO of its compiled step instead)."""
        key = ("decode", self.max_batch)
        if key not in self._pred_cache:
            cell = JCell("decode", "decode", self.max_len, self.max_batch)
            self._pred_cache[key] = self.cost_model.predict(janalytic(
                self.model.cfg, cell, n_devices=1, n_model=1, donated=True,
                device_sampling=True))
        return self._pred_cache[key]


def _cost_models():
    """The port's and the JAX package's model of the port's table, on the
    H100 spec's values."""
    spec = JHardwareSpec(**dataclasses.asdict(H100_SXM))
    return (CostModel.from_named("hopper_h100"),
            JCostModel.from_named(CALIB_DIR / "hopper_h100.json", hw=spec))


@functools.lru_cache(maxsize=None)
def _models():
    kw = dict(n_layers=2, vocab_size=128, compute_dtype="float32")
    jcfg = jreduced(JARCHS["gemma2-2b"], **kw)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = reduced(ARCHS["gemma2-2b"], **kw)
    tm = build_model(cfg, device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    return cfg, jm, jparams, tm, tparams


def _serve(engine_cls, model, params, prompts, max_new, eos_id=None, **kw):
    eng = engine_cls(model, params, max_batch=4, max_len=48, **kw)
    rids = [eng.submit(p, max_new_tokens=max_new, eos_id=eos_id)
            for p in prompts]
    eng.run_until_done(max_steps=20_000)
    return eng, [eng.done[r].tokens for r in rids]


@pytest.mark.parametrize("seed,n_req,max_new,n_blocks,max_prompt", [
    (11, 32, 4, 10, 31),      # the acceptance trace
    (5, 8, 5, 6, 28),         # the minimal pool: one max_len sequence
])
def test_tokens_identical_to_jax_engine(seed, n_req, max_new, n_blocks,
                                        max_prompt):
    cfg, jm, jparams, tm, tparams = _models()
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(1, max_prompt)))
               .astype(np.int32) for _ in range(n_req)]
    kw = dict(block_size=8, n_blocks=n_blocks, chunk_size=8)
    jeng, jtoks = _serve(JEngine, jm, jparams, prompts, max_new, **kw)
    teng, ttoks = _serve(PagedServingEngine, tm, tparams, prompts, max_new,
                         **kw)
    assert teng.stats.completed == n_req
    assert ttoks == jtoks
    s, js = teng.stats, jeng.stats
    assert (s.preemptions, s.compactions, s.prefill_chunks, s.steps) == (
        js.preemptions, js.compactions, js.prefill_chunks, js.steps)
    if n_blocks == 6:
        assert s.preemptions > 0
    teng.allocator.check()
    assert teng.allocator.n_free == teng.n_blocks        # no leaked block
    # one sync per decode dispatch, as many as the JAX engine makes
    assert s.host_syncs == s.decode_dispatches == js.host_syncs <= s.steps
    # tables re-upload only after a row mutated, exactly when JAX's do
    assert s.table_uploads == js.table_uploads


def test_eos_retires_like_jax():
    """A request stops at its first eos token (a retirement the host
    learns only from the synced echo); tokens still equal JAX's."""
    cfg, jm, jparams, tm, tparams = _models()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in (5, 17, 9, 12)]
    kw = dict(block_size=8, n_blocks=12, chunk_size=8)
    _, free = _serve(PagedServingEngine, tm, tparams, prompts, 6, **kw)
    eos = free[0][2]
    _, jtoks = _serve(JEngine, jm, jparams, prompts, 6, eos_id=eos, **kw)
    teng, ttoks = _serve(PagedServingEngine, tm, tparams, prompts, 6,
                         eos_id=eos, **kw)
    assert ttoks == jtoks
    assert ttoks[0] == free[0][:free[0].index(eos) + 1]
    assert teng.allocator.n_free == teng.n_blocks


@pytest.mark.parametrize("budget", ["zero", "between", "tight", "loose"])
def test_gated_admission_identical_to_jax_engine(budget):
    """The acceptance trace under a budget of 0, one between the chunk and
    decode prices, the decode step plus 1.5 chunks, and 1e9 s: tokens,
    admission order, deferrals, steps and predicted step times equal the
    JAX engine's; 1e9 defers nothing, a binding budget defers and still
    completes every request, at one sync a step."""
    cfg, jm, jparams, tm, tparams = _models()
    cm, jcm = _cost_models()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(1, 31))).astype(np.int32)
               for _ in range(32)]
    kw = dict(block_size=8, n_blocks=10, chunk_size=8)
    probe = PagedServingEngine(tm, tparams, max_batch=4, max_len=48,
                               cost_model=cm, **kw)
    decode_s, chunk_s = (probe._predict_decode().step_s,
                         probe._predict_chunk().step_s)
    assert 0 < chunk_s < decode_s
    b = {"zero": 0.0, "between": (chunk_s + decode_s) / 2,
         "tight": decode_s + 1.5 * chunk_s, "loose": 1e9}[budget]
    jeng, jtoks = _serve(JEngine, jm, jparams, prompts, 4, cost_model=jcm,
                         step_budget_s=b, **kw)
    teng, ttoks = _serve(PagedServingEngine, tm, tparams, prompts, 4,
                         cost_model=cm, step_budget_s=b, **kw)
    s, js = teng.stats, jeng.stats
    assert ttoks == jtoks
    assert (s.admission_order, s.deferred_prefills, s.steps) == (
        js.admission_order, js.deferred_prefills, js.steps)
    np.testing.assert_allclose(s.predicted_step_s, js.predicted_step_s,
                               rtol=1e-12, atol=0)
    assert s.completed == 32
    assert len(s.predicted_step_s) == len(s.measured_step_s) == s.steps
    assert s.host_syncs <= s.steps + 1
    assert (s.deferred_prefills == 0) == (budget == "loose")


def test_set_cost_model_reprices():
    """Swapping the model clears the cached prices."""
    _, _, _, tm, tparams = _models()
    cm = CostModel.from_named("hopper_h100")
    eng = PagedServingEngine(tm, tparams, max_batch=2, max_len=16,
                             block_size=8, cost_model=cm)
    before = eng._predict_chunk().step_s
    eng.set_cost_model(CostModel.from_named("ampere_a100"))
    assert eng._predict_chunk().step_s != before
    assert eng._predict_chunk().hw == "a100-40g"


def test_engine_refuses_unported_options():
    _, _, _, tm, tparams = _models()
    with pytest.raises(NotImplementedError, match="mesh"):
        PagedServingEngine(tm, tparams, max_batch=2, max_len=16,
                           block_size=8, mesh=object())
