"""The port's dense model against ``repro.models.zoo`` on the CPU.

``reduced(gemma2-2b, n_layers=2, vocab_size=128)`` in f32 compute: one
local layer (window 8) and one global layer, attention and final softcaps,
post-norms, scaled embeddings.  The JAX parameters (norm scales perturbed
away from zero so ``1 + scale`` is exercised) are converted with
``params_from_jax``; both packages then run the same chunked prefill and
decode steps over their paged pools, with contexts past the window.
Tolerance: logits atol 1e-4 (f32; other summation order across 2 layers).
The other dense decoders (gemma3-1b, internlm2-20b, yi-34b), reduced the
same way, are held at the same tolerance through a prefill and decode
steps over the slot cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models.zoo import build_model as jbuild
from repro_torch.configs import ARCHS, reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zoo import build_model

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def pair():
    jcfg = jreduced(JARCHS["gemma2-2b"], n_layers=2, vocab_size=128,
                    compute_dtype="float32")
    cfg = reduced(ARCHS["gemma2-2b"], n_layers=2, vocab_size=128,
                  compute_dtype="float32")
    assert [cfg.layer_is_global(i) for i in range(2)] == [False, True]
    jm = jbuild(jcfg)
    tree = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)

    def perturb(path, x):
        if getattr(path[-1], "key", None) == "scale":
            return (x + rng.normal(size=x.shape) * 0.3).astype(np.float32)
        return x
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    tm = build_model(cfg, device="cpu")
    return jm, jparams, tm, params_from_jax(tree, cfg, "cpu")


def test_chunked_prefill_then_decode_logits_match(pair):
    jm, jparams, tm, tparams = pair
    nb, bs, C = 12, 4, 8
    jcache = jm.init_paged_cache(nb, bs)
    tcache = tm.init_paged_cache(nb, bs)
    bt = np.asarray([[0, 1, 2, 3, 4, 5], [6, 7, 8, 9, 10, 11]], np.int32)
    bt[1, 5] = -1                       # row 1 never reaches its 6th block
    rng = np.random.default_rng(1)
    lens = (13, 19)
    prompts = [rng.integers(0, 128, size=n).astype(np.int32) for n in lens]

    def both(tokens, pos):
        nonlocal jcache
        lj, jcache = jm.decode(jparams, jcache, jnp.asarray(tokens),
                               jnp.asarray(pos), jnp.asarray(bt))
        lt, _ = tm.decode(tparams, tcache, torch.from_numpy(tokens),
                          torch.from_numpy(pos), torch.from_numpy(bt))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        return np.asarray(lj).argmax(-1).astype(np.int32)

    # chunked prefill through the decode path, both rows per call; the
    # first chunk is left-padded (negative positions), the last overlaps
    filled = [0, 0]
    nxt = np.zeros(2, np.int32)
    while any(f < n for f, n in zip(filled, lens)):
        toks = np.zeros((2, C), np.int32)
        start = np.zeros(2, np.int32)
        for r, (f, n) in enumerate(zip(filled, lens)):
            end = min(f + C, n)          # a finished row reruns its last
            s = end - C
            lo = max(s, 0)
            toks[r, C - (end - lo):] = prompts[r][lo:end]
            start[r] = s
            filled[r] = end
        nxt = both(toks, start)
    # decode past the local window (8) on both rows
    pos = np.asarray(lens, np.int32)
    for _ in range(5):
        nxt = both(nxt[:, None], pos)
        pos = pos + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(
            tcache[key][:, :nb].float().numpy(),
            np.asarray(jcache[key], np.float32), atol=2e-2)


def test_decode_with_an_inactive_row(pair):
    """Rows at write_pos = -1 write nothing and do not disturb the live
    rows' logits."""
    jm, jparams, tm, tparams = pair
    nb, bs = 6, 4
    jcache = jm.init_paged_cache(nb, bs)
    tcache = tm.init_paged_cache(nb, bs)
    bt = np.asarray([[0, 1, 2], [-1, -1, -1]], np.int32)
    pos = np.asarray([0, -1], np.int32)
    tok = np.asarray([[5], [9]], np.int32)
    for step in range(10):
        lj, jcache = jm.decode(jparams, jcache, jnp.asarray(tok),
                               jnp.asarray(pos), jnp.asarray(bt))
        lt, _ = tm.decode(tparams, tcache, torch.from_numpy(tok),
                          torch.from_numpy(pos), torch.from_numpy(bt))
        np.testing.assert_allclose(lt.numpy()[0], np.asarray(lj)[0],
                                   atol=1e-4)
        tok = np.asarray([[int(np.asarray(lj)[0].argmax())], [9]], np.int32)
        pos = pos + np.asarray([1, 0], np.int32)
    np.testing.assert_array_equal(
        tcache["k"][:, 3:nb].float().numpy(), 0.0)


def test_unported_families_raise():
    for arch in ("olmoe-1b-7b", "deepseek-v2-236b", "seamless-m4t-medium",
                 "llava-next-34b"):
        with pytest.raises(NotImplementedError):
            build_model(reduced(ARCHS[arch]), device="cpu")
    # the recurrent families build for their train-mode forward; serving
    # them is not ported
    for arch in ("rwkv6-1.6b", "hymba-1.5b"):
        m = build_model(reduced(ARCHS[arch]), device="cpu")
        with pytest.raises(NotImplementedError):
            m.prefill(m.init(0), {"tokens": torch.zeros((1, 4),
                                                        dtype=torch.int32)})


def test_seeded_init_is_deterministic_and_shaped():
    cfg = reduced(ARCHS["gemma2-2b"], n_layers=2, vocab_size=100)
    m = build_model(cfg, device="cpu")
    a, b = m.init(5), m.init(5)
    assert a["embed"]["table"].shape == (128, cfg.d_model)
    assert torch.equal(a["layers"][1]["ffn"]["w_down"],
                       b["layers"][1]["ffn"]["w_down"])
    assert not torch.equal(a["layers"][0]["attn"]["wq"],
                           m.init(6)["layers"][0]["attn"]["wq"])
    lim = cfg.d_model ** -0.5
    assert float(a["layers"][0]["attn"]["wk"].abs().max()) <= lim
    assert float(a["ln_f"]["scale"].abs().max()) == 0.0


DENSE_ARCHS = ("gemma3-1b", "internlm2-20b", "yi-34b")


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_arch_logits_match_jax(arch):
    """The other dense decoders, reduced (2 layers, vocab 128) in f32 from
    the JAX package's seed-0 init through ``params_from_jax``: a prefill of
    a 13-token prompt into a 24-position slot cache, then 4 decode steps
    over it; logits within atol 1e-4 (other summation order over 2
    layers)."""
    kw = dict(n_layers=2, vocab_size=128, compute_dtype="float32")
    jm = jbuild(jreduced(JARCHS[arch], **kw))
    cfg = reduced(ARCHS[arch], **kw)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    toks = np.random.default_rng(7).integers(0, 128, size=(2, 13)) \
        .astype(np.int32)
    lj, cj = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=24)
    lt, ct = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                        max_len=24)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    nxt = np.asarray(lj).argmax(-1).astype(np.int32)
    pos = np.full(2, 13, np.int32)
    for _ in range(4):
        lj, cj = jm.decode(jparams, cj, jnp.asarray(nxt[:, None]),
                           jnp.asarray(pos))
        lt, ct = tm.decode(tparams, ct, torch.from_numpy(nxt[:, None]),
                           torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        nxt = np.asarray(lj).argmax(-1).astype(np.int32)
        pos = pos + 1
