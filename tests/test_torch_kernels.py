"""The port's paged-attention wrapper against the JAX package.

On the CPU the wrapper runs its plain version, so these tests hold that
version (unsplit oracle, and split pass + log-sum-exp merge) against JAX's
oracle ``repro.kernels.ref.paged_attention_ref`` and its interpret-mode
Pallas kernel (staged lowering).  Inputs are numpy arrays from a seed,
handed to both packages.  Tolerance: f32 atol 1e-5 (the two differ only in
summation order).  The CUDA kernel itself is tested on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_attention import paged_attention


def _case(B, H, KH, D, bs, ctxs, n_pages, seed=0, hole=None):
    """Random pages and per-row shuffled block tables for ``ctxs``;
    ``hole=(row, j)`` punches a -1 entry inside that row's context."""
    rng = np.random.default_rng(seed)
    NB = max(max(-(-c // bs) for c in ctxs), 1)
    q = (rng.normal(size=(B, H, D)) * 0.3).astype(np.float32)
    kp = (rng.normal(size=(n_pages, bs, KH, D)) * 0.3).astype(np.float32)
    vp = (rng.normal(size=(n_pages, bs, KH, D)) * 0.3).astype(np.float32)
    perm = rng.permutation(n_pages)
    bt = np.full((B, NB), -1, np.int32)
    used = 0
    for b, c in enumerate(ctxs):
        nb = -(-c // bs)
        bt[b, :nb] = perm[used:used + nb]
        used += nb
    if hole is not None:
        bt[hole] = -1
    return q, kp, vp, bt, np.asarray(ctxs, np.int32)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


CASES = [
    dict(),
    dict(window=5),
    dict(softcap=8.0),
    dict(window=3, softcap=4.0),
]


@pytest.mark.parametrize("kw", CASES)
@pytest.mark.parametrize("bs,ctxs,hole", [
    (4, (1, 7, 18), None),
    (8, (8, 3, 21), (2, 1)),          # -1 inside row 2's context
    (4, (0, 9, 13), None),            # ctx == 0 row
])
def test_plain_matches_jax_oracle_and_interpret_kernel(kw, bs, ctxs, hole):
    """GQA (4 query heads over 2 KV heads), window, softcap, -1 entries
    inside ctx and ctx == 0 rows, through the unsplit plain version."""
    arrs = _case(3, 4, 2, 16, bs, ctxs, n_pages=16, hole=hole)
    out = paged_attention(*_torch(*arrs), **kw).numpy()
    want = np.asarray(jref.paged_attention_ref(*_jax(*arrs), **kw))
    np.testing.assert_allclose(out, want, atol=1e-5)
    kern = np.asarray(jops.paged_attention(*_jax(*arrs), hbm=False,
                                           interpret=True, **kw))
    np.testing.assert_allclose(out, kern, atol=1e-5)


@pytest.mark.parametrize("ns", [1, 2, 3, 5])
@pytest.mark.parametrize("kw", CASES)
def test_split_merge_matches_jax(ns, kw):
    """The split-KV form (partials per contiguous page slice + merge)
    through ``ops.paged_attention`` against the oracle and JAX's staged
    interpret-mode kernel at the same split factor."""
    arrs = _case(3, 4, 2, 16, 4, (1, 7, 18), n_pages=16)
    out = tops.paged_attention(*_torch(*arrs), num_splits=ns, **kw).numpy()
    want = np.asarray(jref.paged_attention_ref(*_jax(*arrs), **kw))
    np.testing.assert_allclose(out, want, atol=1e-5)
    kern = np.asarray(jops.paged_attention(*_jax(*arrs), num_splits=ns,
                                           hbm=False, interpret=True, **kw))
    np.testing.assert_allclose(out, kern, atol=1e-5)


@pytest.mark.parametrize("ns", [2, 3, 5])
def test_split_zero_ctx_and_unbacked_page(ns):
    """Empty splits give the identity partial; a ctx == 0 row merges to
    zeros; a -1 entry inside ctx is masked in every split."""
    arrs = list(_case(2, 2, 1, 8, 4, (4, 8), n_pages=6))
    arrs[4] = np.asarray([0, 8], np.int32)
    out = tops.paged_attention(*_torch(*arrs), num_splits=ns).numpy()
    assert np.all(out[0] == 0.0)
    np.testing.assert_allclose(
        out, np.asarray(jref.paged_attention_ref(*_jax(*arrs))), atol=1e-5)
    arrs[3] = np.asarray([[2, -1, 3]], np.int32)
    arrs[4] = np.asarray([12], np.int32)
    arrs[0] = arrs[0][:1]
    out = tops.paged_attention(*_torch(*arrs), num_splits=ns).numpy()
    want = np.asarray(jref.paged_attention_ref(*_jax(*arrs)))
    np.testing.assert_allclose(out, want, atol=1e-5)
    m, l, acc = tref.paged_attention_partials_ref(
        *_torch(*arrs), num_splits=ns)
    empty = l == 0
    assert torch.all(m[empty] == tref.NEG_INF)
    assert torch.all(acc[empty] == 0)


def test_bf16_pool_matches_jax():
    """The serving layout: bf16 pools with f32 queries (what the f32 CPU
    model hands the kernel); both packages read the same bf16 values."""
    q, kp, vp, bt, ctx = _case(2, 4, 2, 16, 4, (3, 13), n_pages=8)
    kp16 = torch.from_numpy(kp).to(torch.bfloat16)
    vp16 = torch.from_numpy(vp).to(torch.bfloat16)
    out = tops.paged_attention(torch.from_numpy(q), kp16, vp16,
                               torch.from_numpy(bt), torch.from_numpy(ctx),
                               window=4, softcap=50.0).numpy()
    want = np.asarray(jref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(bt), jnp.asarray(ctx),
        window=4, softcap=50.0))
    np.testing.assert_allclose(out, want, atol=1e-5)


def test_gather_pages_matches_jax():
    q, kp, vp, bt, ctx = _case(3, 4, 2, 16, 4, (1, 7, 18), n_pages=16,
                               hole=(2, 1))
    got = tref.gather_pages(torch.from_numpy(kp), torch.from_numpy(bt))
    want = np.asarray(jref.gather_pages(jnp.asarray(kp), jnp.asarray(bt)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_num_splits_resolution():
    """explicit > config= > default, clamped to the table width."""
    assert tops.resolve_kernel_config("paged_attention") == {
        "block_size": 16, "num_splits": 1}
    got = tops.resolve_kernel_config("paged_attention",
                                     config={"num_splits": 4},
                                     explicit={"num_splits": 2})
    assert got["num_splits"] == 2
    got = tops.resolve_kernel_config("paged_attention",
                                     config={"num_splits": 4},
                                     explicit={"num_splits": None})
    assert got["num_splits"] == 4
    arrs = _case(3, 4, 2, 16, 4, (1, 7, 18), n_pages=16)   # NB = 5
    a = tops.paged_attention(*_torch(*arrs), num_splits=64).numpy()
    b = tops.paged_attention(*_torch(*arrs), num_splits=5).numpy()
    np.testing.assert_array_equal(a, b)


def test_wrapper_rejects_bad_arguments():
    arrs = _torch(*_case(2, 4, 2, 16, 4, (3, 5), n_pages=8))
    with pytest.raises(ValueError):
        paged_attention(*arrs, window=0)
    with pytest.raises(ValueError):
        paged_attention(arrs[0].to("meta"), *arrs[1:])
