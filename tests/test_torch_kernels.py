"""The port's paged-attention wrapper against the JAX package.

On the CPU the wrapper runs its plain version, so these tests hold that
version (unsplit oracle, and split pass + log-sum-exp merge) and the CUDA
kernel's partition into fixed token chunks against JAX's oracle
``repro.kernels.ref.paged_attention_ref`` and its interpret-mode Pallas
kernel (staged lowering).  Inputs are numpy arrays from a seed,
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
from repro_torch.kernels.paged_attention import (CHUNK_TOKENS, CHUNKS,
                                                 chunk_grid, paged_attention)


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
        "block_size": 16, "num_splits": 1, "chunk_tokens": 64}
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


def _live(ctxs, window, L):
    """Per row, the live slots [lo, hi) the CUDA kernel reads."""
    return [(max(c - window, 0) if window else 0, min(max(c, 0), L))
            for c in ctxs]


@pytest.mark.parametrize("kw", [dict(), dict(window=3),
                                dict(window=9, softcap=4.0),
                                dict(window=40)])
@pytest.mark.parametrize("bs,ctxs,chunk", [
    (4, (0, 7, 8, 9, 16, 17, 24), 4),
    (4, (0, 7, 8, 9, 16, 17, 24), 8),
    (4, (0, 7, 8, 9, 16, 17, 24), 32),      # one chunk holds the table
    (16, (1, 31, 32, 33, 63, 64, 65, 129), 32),
    (16, (1, 31, 32, 33, 63, 64, 65, 129), 64),
    (16, (1, 31, 32, 33, 63, 64, 65, 129), 128),
])
def test_chunked_partition_matches_jax(bs, ctxs, chunk, kw):
    """The CUDA kernel's partition in plain torch: partials per fixed chunk
    of ``chunk`` tokens (``chunk / bs`` pages, or a page over several
    chunks), folded by ``merge_partials``, against JAX's oracle.  Contexts
    on and beside chunk boundaries, ctx 0, an unbacked page inside a
    context (row 5), windows that start mid-chunk and chunks wholly
    outside the window.  The chunks the kernel skips (no live slot) are
    identity partials, so leaving them out of the merge changes nothing."""
    arrs = _case(len(ctxs), 4, 2, 16, bs, ctxs, n_pages=40, hole=(5, 2))
    m, l, acc = tref.paged_attention_chunk_partials(
        *_torch(*arrs), chunk_tokens=chunk, **kw)
    L = arrs[3].shape[1] * bs
    assert m.shape[-1] == -(-L // chunk)
    out = tref.merge_partials(m, l, acc, torch.float32).numpy()
    want = np.asarray(jref.paged_attention_ref(*_jax(*arrs), **kw))
    np.testing.assert_allclose(out, want, atol=1e-5)
    skipped = 0
    for b, (lo, hi) in enumerate(_live(ctxs, kw.get("window"), L)):
        for c in range(m.shape[-1]):
            if max(lo, c * chunk) >= min(hi, (c + 1) * chunk):
                skipped += 1
                assert torch.all(m[b, :, c] == tref.NEG_INF)
                assert torch.all(l[b, :, c] == 0)
                assert torch.all(acc[b, :, c] == 0)
    assert skipped > 0


def test_chunk_grid_comes_from_the_table_width():
    """The kernel grid's chunk axis: ceil(NB * bs / chunk_tokens), the
    serving shapes' 64 x 16 slots giving 16 chunks of 64 tokens."""
    assert CHUNK_TOKENS in CHUNKS
    assert chunk_grid(64, 16) == 64 * 16 // CHUNK_TOKENS
    assert [chunk_grid(64, 16, c) for c in CHUNKS] == [32, 16, 8]
    assert chunk_grid(5, 4, 32) == 1
    assert chunk_grid(3, 100, 128) == 3        # pages span chunks
    assert chunk_grid(0, 16, 64) == 0
    with pytest.raises(ValueError):
        chunk_grid(4, 16, 48)
    arrs = _torch(*_case(2, 4, 2, 16, 4, (3, 5), n_pages=8))
    with pytest.raises(ValueError):
        paged_attention(*arrs, chunk_tokens=16)
