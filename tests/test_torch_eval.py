"""The port's train-mode forward, ``Model.loss`` and ``make_eval_step`` for
rwkv6 and hymba against the JAX package on the CPU, and its numpy data
source against ``repro.data.synthetic``.

``reduced(rwkv6-1.6b)`` and ``reduced(hymba-1.5b)`` at 16 tokens: the
reduced window of 8, the 4 meta tokens and ``attn_chunk=8`` all bind (20
positions with the meta tokens: query chunks of 5, one local layer).  The
JAX tree (constant leaves perturbed so each is exercised) converts with
``params_from_jax``.  Tolerances: f32 logits atol 1e-4 and loss 1e-5
relative (the same f32 arithmetic in another summation order over 2
layers); bf16 logits atol 2e-2 and loss 1e-3 relative (the two frameworks
round bf16 at other points: matmul outputs, norms, the recurrences'
inputs; the reduced models' logits lie within +-0.7, where a bf16 ulp is
2^-8 = 0.0039, and differ by at most 0.0083 measured).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.models import transformer as jlm
from repro.models.zoo import build_model as jbuild
from repro.train.step import make_eval_step as jmake_eval_step
from repro_torch.configs import ARCHS, reduced
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.kernels import ref
from repro_torch.models import transformer as tlm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zoo import build_model
from repro_torch.train.step import make_eval_step
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)

ARCH_NAMES = ("rwkv6-1.6b", "hymba-1.5b")
NOISY = {"scale", "bias", "mu", "mu_k", "mu_r", "w_base", "dt_bias",
         "d_skip"}


def _tree(jcfg, seed=0):
    """``init_lm``'s tree as numpy, constant leaves perturbed."""
    rng = np.random.default_rng(seed)
    tree = jax.device_get(jbuild(jcfg).init(jax.random.PRNGKey(seed)))

    def perturb(path, x):
        if getattr(path[-1], "key", None) in NOISY:
            return (x + rng.normal(size=x.shape) * 0.3).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _setup(arch, dtype="float32", use_pallas=False):
    jcfg = jreduced(JARCHS[arch], compute_dtype=dtype, use_pallas=use_pallas)
    cfg = reduced(ARCHS[arch], compute_dtype=dtype)
    tree = _tree(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_jax(tree, cfg, "cpu"))


def _batch(vocab, seq=16, rows=2, seed=0):
    return SyntheticLM(DataConfig(vocab, seq, rows, seed=seed)).batch(0)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_logits_and_loss_match_jax_f32(arch, use_pallas):
    jcfg, jparams, cfg, tparams = _setup(arch, use_pallas=use_pallas)
    batch = _batch(cfg.vocab_size)
    want, _, _ = jlm.lm_apply(jparams, jcfg, tokens=jnp.asarray(
        batch["tokens"]), mode="train", remat=False)
    model = build_model(cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, cache = tlm.lm_apply(tparams, cfg, tokens=tb["tokens"], mode="train")
    assert cache is None
    assert tuple(got.shape) == (2, 16, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    jloss, _ = jbuild(jcfg).loss(jparams, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    tloss, aux = model.loss(tparams, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(aux["ce"]) == float(tloss)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_logits_and_loss_match_jax_bf16(arch):
    """bf16 compute on both sides, against the Pallas path (the port's
    recurrences round ``u`` and read their inputs as the kernels do)."""
    jcfg, jparams, cfg, tparams = _setup(arch, "bfloat16", use_pallas=True)
    batch = _batch(cfg.vocab_size, seed=1)
    want, _, _ = jlm.lm_apply(jparams, jcfg, tokens=jnp.asarray(
        batch["tokens"]), mode="train", remat=False)
    got, _ = tlm.lm_apply(tparams, cfg, tokens=torch.from_numpy(
        batch["tokens"]), mode="train")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)
    jloss, _ = jbuild(jcfg).loss(jparams, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    tloss, _ = build_model(cfg, device="cpu").loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_eval_step_loss_matches_jax_on_synthetic_batch(arch):
    jcfg, jparams, cfg, tparams = _setup(arch)
    jdata = JSyntheticLM(JDataConfig(jcfg.vocab_size, 16, 2, seed=3))
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 16, 2, seed=3)).batch(5)
    want = jmake_eval_step(jbuild(jcfg))(jparams, jdata.batch(5))["loss"]
    got = make_eval_step(build_model(cfg, device="cpu"))(tparams, batch)
    assert got["loss"].dim() == 0
    np.testing.assert_allclose(float(got["loss"]), float(want), rtol=1e-5)


@pytest.mark.parametrize("vocab,seq,rows,seed,step", [
    (256, 16, 2, 0, 0), (65536, 257, 3, 7, 11), (32001, 40, 1, 2, 3)])
def test_synthetic_batches_equal_jax_bit_for_bit(vocab, seq, rows, seed,
                                                 step):
    want = JSyntheticLM(JDataConfig(vocab, seq, rows, seed=seed)).batch(step)
    got = SyntheticLM(DataConfig(vocab, seq, rows, seed=seed)).batch(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    nxt = next(SyntheticLM(DataConfig(vocab, seq, rows, seed=seed))
               .iterate(step + 1))
    np.testing.assert_array_equal(
        nxt["tokens"], JSyntheticLM(JDataConfig(vocab, seq, rows, seed=seed))
        .batch(step + 1)["tokens"])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_conversion_keeps_f32_leaves(arch):
    """In bf16 compute: matrices land in bf16; 1-D leaves, ``a_log`` and
    ``u_bonus`` stay f32 (the reference uses them in f32)."""
    jcfg = jreduced(JARCHS[arch])
    cfg = reduced(ARCHS[arch])
    p = params_from_jax(_tree(jcfg), cfg, "cpu")
    lp = p["layers"][1]
    if arch == "rwkv6-1.6b":
        assert lp["tmix"]["u_bonus"].dtype == torch.float32
        assert lp["tmix"]["w_base"].dtype == torch.float32
        assert lp["tmix"]["wr"].dtype == torch.bfloat16
        assert p["embed"]["unembed"].dtype == torch.bfloat16
        assert p["ln0"]["bias"].dtype == torch.float32
    else:
        assert lp["mamba"]["a_log"].dtype == torch.float32
        assert lp["mamba"]["dt_bias"].dtype == torch.float32
        assert lp["mamba"]["w_in"].dtype == torch.bfloat16
        assert p["meta"].dtype == torch.bfloat16
        assert lp["norm_attn"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_seeded_init_has_the_jax_layout(arch):
    """``Model.init`` draws a tree of the converted JAX tree's keys,
    shapes and dtypes, deterministic in the seed, inside init_lm's
    bounds."""
    jcfg = jreduced(JARCHS[arch])
    cfg = reduced(ARCHS[arch])
    want = params_from_jax(_tree(jcfg), cfg, "cpu")
    model = build_model(cfg, device="cpu")
    got, again, other = model.init(4), model.init(4), model.init(5)

    def layout(t):
        if isinstance(t, dict):
            return {k: layout(v) for k, v in t.items()}
        if isinstance(t, list):
            return [layout(v) for v in t]
        return (tuple(t.shape), t.dtype)
    assert layout(got) == layout(want)
    flat = lambda t: torch.cat([x.float().flatten() for x in  # noqa: E731
                                jax.tree.leaves(t)])
    assert torch.equal(flat(got), flat(again))
    assert not torch.equal(flat(got), flat(other))
    lp = got["layers"][0]
    d = cfg.d_model
    if arch == "rwkv6-1.6b":
        assert float(lp["tmix"]["wk"].abs().max()) <= d ** -0.5
        assert float(lp["tmix"]["u_bonus"].abs().max()) <= 1.0
        assert torch.all(lp["tmix"]["w_base"] == -6.0)
    else:
        assert float(lp["mamba"]["w_in"].abs().max()) <= d ** -0.5
        a_log = np.log(np.arange(1, cfg.ssm.state_dim + 1))
        np.testing.assert_allclose(lp["mamba"]["a_log"].numpy(),
                                   np.tile(a_log, (d, 1)), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serving_modes_of_recurrent_families_raise(arch):
    """What still raises when a recurrent family serves: the paged modes
    (the pool, and decode through block tables).  The slot modes they
    are refused beside run (prefill, then decode over ``init_cache``'s
    state): only the paged ones raise."""
    cfg = reduced(ARCHS[arch])
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    logits, cache = model.prefill(params, {"tokens": toks}, max_len=16)
    assert logits.shape == (1, cfg.padded_vocab)
    assert {k: t.shape[:2] for k, t in cache.items()} == {
        k: t.shape[:2] for k, t in model.init_cache(1, 16).items()}
    pos = torch.full((1,), cfg.meta_tokens + 4, dtype=torch.int32)
    logits, _ = model.decode(params, cache, toks[:, :1], pos)
    assert torch.isfinite(logits).all()
    with pytest.raises(NotImplementedError):
        model.init_paged_cache(4, 4)
    with pytest.raises(NotImplementedError):
        model.decode(params, cache, toks[:, :1], pos,
                     torch.zeros((1, 4), dtype=torch.int32))


def test_dense_train_mode_raises():
    """What dense train mode still refuses: the reference's ``save_attn``
    remat policy (not ported) under autograd, and families the port does
    not build (moe).  The mode itself runs (the test below)."""
    cfg = reduced(ARCHS["gemma2-2b"])
    model = build_model(cfg.replace(remat_policy="save_attn"), device="cpu")
    params = model.init(0)
    params["ln_f"]["scale"].requires_grad_()
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        model.loss(params, {"tokens": toks, "labels": toks})
    with torch.no_grad():       # no remat without autograd: it runs
        loss, _ = model.loss(params, {"tokens": toks, "labels": toks})
    assert torch.isfinite(loss)
    assert "train" not in tlm.supported_modes(reduced(ARCHS["olmoe-1b-7b"]))


@pytest.mark.parametrize("arch", ["gemma2-2b", "internlm2-20b"])
def test_dense_train_logits_match_jax_f32(arch):
    """Dense ``mode="train"``: the f32 logits of every position against
    the reference's ``lm_apply(mode="train", remat=False)`` (atol 1e-4, as
    the recurrent families' above), and ``Model.loss`` against its loss
    (1e-5 relative)."""
    jcfg, jparams, cfg, tparams = _setup(arch)
    batch = _batch(cfg.vocab_size)
    want, _, _ = jlm.lm_apply(jparams, jcfg, tokens=jnp.asarray(
        batch["tokens"]), mode="train", remat=False)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, cache = tlm.lm_apply(tparams, cfg, tokens=tb["tokens"], mode="train")
    assert cache is None
    assert tuple(got.shape) == (2, 16, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    jloss, _ = jbuild(jcfg).loss(jparams, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    tloss, _ = build_model(cfg, device="cpu").loss(tparams, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_through_the_plain_versions_passed_explicitly(arch):
    """``wkv_fn``/``ssm_fn`` reach the layers: the plain versions passed
    by hand give the default path's loss (on the CPU the default is the
    plain version), and a recurrence that returns zeros does not."""
    _, _, cfg, tparams = _setup(arch)
    model = build_model(cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size).items()}
    base, _ = model.loss(tparams, tb)
    same, _ = model.loss(tparams, tb, wkv_fn=ref.wkv6_plain,
                         ssm_fn=ref.ssm_scan_plain)
    assert float(same) == float(base)
    zero, _ = model.loss(tparams, tb,
                         wkv_fn=lambda r, *a: torch.zeros_like(r),
                         ssm_fn=lambda x, *a: torch.zeros_like(x))
    assert float(zero) != float(base)
