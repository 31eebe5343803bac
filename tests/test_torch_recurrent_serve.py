"""The recurrent families served by the port's slot engine, against the
JAX package on the CPU; the refusals; the launcher; and ``chip_smoke.py``'s
phase ``recurrent_serve`` rehearsed.

Reduced f32 rwkv6-1.6b and hymba-1.5b from the JAX seed-0 init through
``params_from_jax``; 5 requests of 3-20 prompt tokens over 2 rows (rows
reused, so an admission splices over a retired row's state), 6 new tokens
each, ``max_len`` 48.

* rwkv6: the port's engine gives the JAX ``ServingEngine``'s tokens, on
  the fused and the legacy path.
* hymba: the port's engine gives the JAX package's teacher-forced greedy
  decode, ``model.prefill`` then ``model.decode`` at ``meta_tokens + S +
  t``.  The JAX engine does not: it starts each row at the prompt length
  ``S`` (``src/repro/serve/engine.py:414``, ``:422``), so its decode
  rotates and writes the new K/V ``meta_tokens`` positions short, over
  the prompt's own slots.  A test records that the two differ, as the
  reference's fault.
"""
import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models.zoo import build_model as jbuild
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve as tserve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import PagedServingEngine, ServingEngine
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

RECURRENT = ("rwkv6-1.6b", "hymba-1.5b")
KW = dict(max_batch=2, max_len=48)
MAX_NEW = 6


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = jreduced(JARCHS[arch], compute_dtype="float32")
    cfg = reduced(ARCHS[arch], compute_dtype="float32")
    jm = jbuild(jcfg)
    tree = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return (jm, jax.tree.map(jnp.asarray, tree), cfg,
            build_model(cfg, device="cpu"), params_from_jax(tree, cfg, "cpu"))


def _prompts(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in rng.integers(3, 21, size=5)]


def _serve(engine_cls, model, params, prompts, **kw):
    eng = engine_cls(model, params, **KW, **kw)
    rids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.run_until_done()
    assert eng.stats.completed == len(prompts)
    return [list(map(int, eng.done[r].tokens)) for r in rids], eng


@functools.lru_cache(maxsize=None)
def _jax_teacher(arch):
    """Each request's greedy decode through the JAX model: prefill, then
    decode at ``meta_tokens + S + t``."""
    jm, jparams, cfg, _, _ = _setup(arch)
    prefill = jax.jit(jm.prefill, static_argnames="max_len")
    decode = jax.jit(jm.decode)
    out = []
    for prompt in _prompts(cfg.vocab_size):
        lg, cache = prefill(jparams, {"tokens": jnp.asarray(prompt[None])},
                            max_len=KW["max_len"])
        toks = [int(jnp.argmax(lg[0]))]
        pos = cfg.meta_tokens + len(prompt)
        for t in range(MAX_NEW - 1):
            lg, cache = decode(jparams, cache,
                               jnp.asarray([[toks[-1]]], jnp.int32),
                               jnp.asarray([pos + t], jnp.int32))
            toks.append(int(jnp.argmax(lg[0])))
        out.append(toks)
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_rwkv6_slot_engine_tokens_equal_the_jax_engines(fused):
    jm, jparams, cfg, tm, tparams = _setup("rwkv6-1.6b")
    prompts = _prompts(cfg.vocab_size)
    want, _ = _serve(JServingEngine, jm, jparams, prompts, fused=fused)
    got, eng = _serve(ServingEngine, tm, tparams, prompts, fused=fused)
    assert got == want
    assert eng.stats.prefills == len(prompts)


@pytest.mark.parametrize("fused", [True, False])
def test_hymba_slot_engine_tokens_equal_the_jax_teacher_forced_decode(fused):
    jm, jparams, cfg, tm, tparams = _setup("hymba-1.5b")
    prompts = _prompts(cfg.vocab_size)
    got, eng = _serve(ServingEngine, tm, tparams, prompts, fused=fused)
    assert got == _jax_teacher("hymba-1.5b")
    assert eng.prefix == cfg.meta_tokens == 4


def test_jax_engine_serves_hymba_at_the_prompt_length_as_the_reference():
    """The reference's fault, recorded: its engine's first token (the
    prefill's argmax) is the teacher's, and later tokens are not, because
    each row starts decoding at S instead of meta_tokens + S."""
    jm, jparams, cfg, _, _ = _setup("hymba-1.5b")
    prompts = _prompts(cfg.vocab_size)
    jax_eng, _ = _serve(JServingEngine, jm, jparams, prompts)
    teacher = _jax_teacher("hymba-1.5b")
    assert [t[0] for t in jax_eng] == [t[0] for t in teacher]
    assert sum(a != b for a, b in zip(jax_eng, teacher)) >= 3


@pytest.mark.parametrize("arch", RECURRENT)
def test_kv_cache_bytes_count_the_state_leaves_as_the_jax_engines(arch):
    jm, jparams, cfg, tm, tparams = _setup(arch)
    jeng = JServingEngine(jm, jparams, **KW)
    eng = ServingEngine(tm, tparams, **KW)
    assert eng.kv_cache_bytes() == jeng.kv_cache_bytes()
    state = {"rwkv6-1.6b": ("tm_shift", "cm_shift", "wkv"),
             "hymba-1.5b": ("k", "v", "conv", "h")}[arch]
    assert sorted(eng.cache) == sorted(state)
    assert eng.kv_cache_bytes() == sum(t.numel() * t.element_size()
                                       for t in eng.cache.values())


def test_submit_refuses_a_prompt_with_no_decode_slot_after_the_meta_tokens():
    cfg = reduced(ARCHS["hymba-1.5b"], compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    eng = ServingEngine(model, model.init(0), **KW)
    eng.submit(np.zeros(KW["max_len"] - cfg.meta_tokens - 1, np.int32))
    with pytest.raises(ValueError):
        eng.submit(np.zeros(KW["max_len"] - cfg.meta_tokens, np.int32))


@pytest.mark.parametrize("arch", RECURRENT)
def test_paged_engine_and_pool_refuse_the_recurrent_families(arch):
    cfg = reduced(ARCHS[arch], compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    with pytest.raises(NotImplementedError):
        model.init_paged_cache(8, 4)
    with pytest.raises(NotImplementedError):
        PagedServingEngine(model, params, max_batch=2, max_len=32,
                           block_size=4, chunk_size=4)
    cache = model.init_cache(1, 16)
    with pytest.raises(NotImplementedError):
        model.decode(params, cache, torch.zeros((1, 1), dtype=torch.int32),
                     torch.zeros(1, dtype=torch.int32),
                     torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        ServingEngine(model, params, cost_model=object(), **KW)


def test_launcher_serves_rwkv6_reduced_on_the_cpu(capsys):
    tserve.main(["--arch", "rwkv6-1.6b", "--reduced", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["engine"] == "slot" and out["arch"] == "rwkv6-1.6b"
    assert out["completed"] == 8
    assert out["decoded_tokens"] == 8 * (tserve.MAX_NEW - 1)
    assert out["host_syncs"] <= out["steps"] + 1


@pytest.mark.parametrize("arch", RECURRENT)
def test_launcher_paged_raises_for_the_recurrent_families(arch):
    with pytest.raises(NotImplementedError):
        tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--paged"])


# -- chip_smoke.py's phase recurrent_serve, rehearsed on the CPU --------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_serve_gates_hold_with_no_kernel_call(arch, monkeypatch):
    """(a) on a reduced bf16 model: the engine serves every request with
    one sync a step and never reaches the recurrence kernels' wrappers
    (they raise here), so the card's zero-launch gate holds by path."""
    def refuse(*args, **kw):
        raise AssertionError("a recurrence kernel was called while serving")
    monkeypatch.setattr(kops, "wkv6", refuse)
    monkeypatch.setattr(kops, "ssm_scan", refuse)
    cfg = reduced(ARCHS[arch])
    model = build_model(cfg, device="cpu")
    eng = ServingEngine(model, model.init(0), max_batch=4, max_len=96)
    prompts = chip_smoke.recurrent_prompts(
        np, cfg.vocab_size, 0, n_requests=8, lo=16, hi=48)
    rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
    _, _, counts = chip_smoke.drive(torch, eng)
    assert chip_smoke.recurrent_serve_gates(eng, rids, counts, 8) == []
    assert eng.stats.prefills == 8 and eng.stats.steps >= 16


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_equivalence_gate_holds_and_catches_each_control(arch,
                                                                   dtype,
                                                                   seed):
    """(b) on a reduced model (S0 64, T 8; the runs behind
    ``RECURRENT_LOGIT_TOL`` and ``RECURRENT_STATE_TOL``): the sound decode
    passes both parts of the gate; each of the arch's
    ``RECURRENT_MUST_CATCH`` controls fails one, and all but
    ``h_not_carried`` fail the logits' part, at least 2x past its
    tolerance."""
    cfg = reduced(ARCHS[arch], compute_dtype=dtype)
    model = build_model(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(seed + 3).integers(
        0, cfg.vocab_size, size=(2, 72)).astype(np.int32))
    sound, controls = chip_smoke.recurrent_equivalence(
        torch, model, model.init(seed), toks, 64, 8, dtype)
    assert sound["failed"] == []
    assert sorted(controls) == sorted(
        n for n, a in chip_smoke.RECURRENT_MUST_CATCH.items() if a == arch)
    for name, c in controls.items():
        assert "state" in c["caught_by"], name
        if name != "h_not_carried":
            assert c["logit_rel"] > 2 * chip_smoke.RECURRENT_LOGIT_TOL[dtype]


def test_recurrent_reduced_engines_equal_the_teacher_on_the_cpu():
    """(c) with the CPU standing in for the card: fused and legacy
    engines' tokens equal the port's teacher-forced greedy decode."""
    tokens, bad = chip_smoke.recurrent_reduced(torch, np, 0, "cpu")
    assert bad == []
    assert sorted(tokens) == sorted(RECURRENT)
    assert all(len(t) == chip_smoke.RECURRENT_REDUCED["max_new"]
               for ts in tokens.values() for t in ts)
