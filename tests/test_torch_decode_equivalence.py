"""Decode equivalence for every arch the port serves, on the CPU: prefill
then step-by-step decode against the JAX package, and the reference's own
gate (``tests/test_decode_equivalence.py``) mirrored.

Every arch whose ``supported_modes`` holds ``"decode"`` (gemma2-2b,
gemma3-1b, internlm2-20b, yi-34b, rwkv6-1.6b, hymba-1.5b), reduced, from
the JAX package's seed-0 init through ``params_from_jax``; B=2 rows, a
prefill of S0=12 tokens, then T=3 teacher-forced decode steps at
``meta_tokens + S0 + t`` (hymba's prefill prepends its meta tokens).

* In f32, each step's logits within atol 1e-4 of the JAX package's
  ``prefill``/``decode`` (the same f32 arithmetic in another summation
  order; measured at most 3.1e-6), and every cache leaf after each call:
  the bf16 leaves (K/V, token shifts, conv rows) within 2e-2, one bf16
  ulp where the f32 values round differently (measured at most 9.8e-4);
  the f32 states (``wkv``, ``h``) within 1e-4 (measured 1.4e-6).
* At the default dtype (bf16), the reference's gate: the largest logit
  error over the prefill's last position and the T steps under 0.05 x
  max(max|teacher|, 1).  The teacher is the train-mode forward of all
  S0+T tokens, as the reference's gate takes it, for every arch (the
  dense archs have a train mode too).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models.zoo import build_model as jbuild
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import transformer as tlm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zoo import build_model
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)

DECODE_ARCHS = tuple(a for a in sorted(ARCHS)
                     if "decode" in tlm.supported_modes(reduced(ARCHS[a])))
B, S0, T = 2, 12, 3
BF16_LEAVES = {"k", "v", "tm_shift", "cm_shift", "conv"}


def _setup(arch, dtype=None):
    kw = {} if dtype is None else {"compute_dtype": dtype}
    jcfg, cfg = jreduced(JARCHS[arch], **kw), reduced(ARCHS[arch], **kw)
    jm = jbuild(jcfg)
    tree = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(B, S0 + T)).astype(np.int32)
    return (jm, jax.tree.map(jnp.asarray, tree), cfg,
            build_model(cfg, device="cpu"), params_from_jax(tree, cfg, "cpu"),
            toks)


def _leaves_close(ct, cj):
    assert set(ct) == set(cj)
    for key, t in ct.items():
        want = np.asarray(cj[key], np.float32)
        assert tuple(t.shape) == want.shape
        assert str(t.dtype).split(".")[-1] == str(cj[key].dtype)
        np.testing.assert_allclose(t.float().numpy(), want,
                                   atol=2e-2 if key in BF16_LEAVES else 1e-4,
                                   err_msg=key)


def test_the_decode_archs_are_the_six_served():
    assert DECODE_ARCHS == ("gemma2-2b", "gemma3-1b", "hymba-1.5b",
                            "internlm2-20b", "rwkv6-1.6b", "yi-34b")


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_match_jax_f32(arch):
    jm, jparams, cfg, tm, tparams, toks = _setup(arch, "float32")
    pfx = cfg.meta_tokens
    max_len = S0 + T + pfx
    lj, cj = jm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S0])},
                        max_len=max_len)
    lt, ct = tm.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S0])},
                        max_len=max_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    _leaves_close(ct, cj)
    for t in range(T):
        pos = np.full(B, pfx + S0 + t, np.int32)
        tok = toks[:, S0 + t][:, None]
        lj, cj = jm.decode(jparams, cj, jnp.asarray(tok), jnp.asarray(pos))
        lt, ct = tm.decode(tparams, ct, torch.from_numpy(tok),
                           torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        _leaves_close(ct, cj)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_full_forward(arch):
    _, _, cfg, tm, tparams, toks = _setup(arch)
    assert cfg.compute_dtype == "bfloat16"
    V, pfx = cfg.vocab_size, cfg.meta_tokens
    toks = torch.from_numpy(toks)
    assert "train" in tlm.supported_modes(cfg)
    with torch.no_grad():
        full, _ = tlm.lm_apply(tparams, cfg, tokens=toks, mode="train")
        full = full[..., :V].float()
        scale = max(full.abs().max().item(), 1.0)
        lg, cache = tm.prefill(tparams, {"tokens": toks[:, :S0]},
                               max_len=S0 + T + pfx)
        errs = [(lg[:, :V].float() - full[:, S0 - 1]).abs().max().item()]
        for t in range(T):
            pos = torch.full((B,), pfx + S0 + t, dtype=torch.int32)
            lg, cache = tm.decode(tparams, cache, toks[:, S0 + t][:, None],
                                  pos)
            errs.append((lg[:, :V].float() - full[:, S0 + t]).abs().max()
                        .item())
    assert max(errs) < 0.05 * scale, f"divergence {max(errs)} vs {scale}"
