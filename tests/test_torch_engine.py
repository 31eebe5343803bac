"""The port's ``PagedServingEngine`` against the JAX package's, on the CPU.

The 32-request acceptance trace of ``tests/test_paged_serving.py`` (rng 11,
``max_batch=4``, ``max_len=48``, ``block_size=8``, ``n_blocks=10``,
``chunk_size=8``, 4 new tokens) and the minimal-pool trace (``n_blocks=6``,
eviction churn) run through both engines on the same converted weights in
f32 compute.  Greedy tokens must be identical, the pool must be returned
whole, and the fused path must read the device once per step.
"""
import functools

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models.zoo import build_model as jbuild
from repro.serve import PagedServingEngine as _JaxEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import PagedServingEngine


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


def test_engine_refuses_unported_options():
    _, _, _, tm, tparams = _models()
    for kw in (dict(cost_model=object()), dict(autotuner=object()),
               dict(telemetry=object()), dict(mesh=object()),
               dict(fused=False)):
        with pytest.raises(NotImplementedError):
            PagedServingEngine(tm, tparams, max_batch=2, max_len=16,
                               block_size=8, **kw)
