"""The port's paged-attention wrapper against the JAX package.

On the CPU the wrapper runs its plain version, so these tests hold that
version (unsplit oracle, and split pass + log-sum-exp merge) and the CUDA
kernel's partition into fixed token chunks against JAX's oracle
``repro.kernels.ref.paged_attention_ref`` and its interpret-mode Pallas
kernel (staged lowering).  Inputs are numpy arrays from a seed,
handed to both packages.  Tolerance: f32 atol 1e-5 (the two differ only in
summation order).  The CUDA kernel itself is tested on the card by
``tests/test_torch_cuda.py``.

The flash backward: ``ref.flash_attention_bwd_plain`` (the arithmetic of
``csrc/flash_attention_bwd.cu``) against ``torch.autograd.grad`` of
``flash_attention_plain`` in f64 and f32 over causal x window 8 at 24
tokens x softcap 50 x GQA groups 1, 2, 4 x D 16, 32, each gradient within
1e-5 of its max|want| (the same f32 function in another order); against
``jax.grad`` of the reference's flash oracle at one windowed, softcapped
GQA shape (1e-5), beside its interpret-mode kernel's forward; the
CUDA-core kernels' split rehearsed (``ref.flash_attention_bwd_split_plain``:
each part's partial added in part order) against both (1e-5), the split
rule (``bwd_work``) at the card's f32 shapes; ``chip_smoke.py``'s
``FLASH_BWD_MUST_CATCH`` faults each failing that gate; the wiring of
``FlashAttentionFn`` on the CPU (saved tensors, ``needs_input_grad``, a
strided cotangent, bf16) and the no-backward guards of the other kernels.

The tensor-core backward's plain version ``ref.flash_attention_bwd_mma_plain``
(L from the forward, P and dS rounded to bf16): in bf16 against
``jax.grad`` of the reference's flash oracle on the same bf16 values
(1.5e-2 of each gradient's max|want|: O, P, dS and the gradients are each
rounded to bf16, 2^-9 relative apiece; sound runs read 2e-3 to 7e-3), in
f32 against ``flash_attention_bwd_plain`` with L from ``flash_lse_plain``
(1e-5: nothing rounds in f32, only the order of sums differs); the
backward's dispatch rule and split; ``chip_smoke.py``'s
``FLASH_BWD_MMA_MUST_CATCH`` faults each failing the card's bf16 gate.
"""
import importlib.util
import itertools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.paged_attention import (CHUNK_TOKENS, CHUNKS,
                                                 chunk_grid, paged_attention)
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


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


# -- the flash backward ------------------------------------------------------

BWD_TOL = 1e-5      # of each gradient's max|want|


def _bwd_inputs(B, S, H, KH, D, dtype, seed=0, q_mul=1.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)) * q_mul
    k, v = (rng.normal(size=(B, S, KH, D)) for _ in range(2))
    dout = rng.normal(size=(B, S, H, D))
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v, dout)]


def _ratios(got, want):
    return [((g.double() - w.double()).abs().max()
             / w.double().abs().max()).item() for g, w in zip(got, want)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("causal,window,softcap,G,D", list(itertools.product(
    (True, False), (None, 8), (None, 50.0), (1, 2, 4), (16, 32))))
def test_flash_bwd_plain_matches_autograd(causal, window, softcap, G, D,
                                          dtype):
    q, k, v, dout = _bwd_inputs(2, 24, 2 * G, 2, D, dtype,
                                q_mul=8.0 if softcap else 1.0)
    kw = dict(causal=causal, window=window, softcap=softcap,
              scale=D ** -0.5)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tref.flash_attention_plain(*xs, block_q=8, block_k=8, **kw)
    want = torch.autograd.grad(out, xs, dout)
    got = tref.flash_attention_bwd_plain(q, k, v, out.detach(), dout, **kw)
    assert [t.dtype for t in got] == [dtype] * 3
    assert max(_ratios(got, want)) < BWD_TOL


def test_flash_bwd_plain_matches_jax_grad_of_the_reference():
    """``jax.grad`` of the reference's flash oracle
    ``repro.kernels.ref.flash_attention_ref`` (the function its Pallas
    kernel is held to) at a windowed, softcapped GQA shape, and the
    interpret-mode Pallas forward equal to the port's.  ``jax.grad``
    through the interpret-mode kernel itself stops in Pallas
    (``program_id`` outside a grid context, with or without a window);
    ``tests/test_pallas_integration.py``'s grad test never reaches the
    kernel for gemma2 (a traced layer flag with a window keeps
    ``use_pallas`` off)."""
    q, k, v, dout = _bwd_inputs(2, 24, 4, 2, 16, torch.float32, q_mul=8.0)
    kw = dict(causal=True, window=8, softcap=50.0, scale=0.25)
    jq, jk, jv = _jax(q.numpy(), k.numpy(), v.numpy())

    def f(q_, k_, v_):
        return jnp.vdot(jref.flash_attention_ref(q_, k_, v_, **kw),
                        jnp.asarray(dout.numpy()))
    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    out = tref.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jops.flash_attention(
            jq, jk, jv, interpret=True, block_q=8, block_k=8, **kw)),
        atol=1e-5)
    got = tref.flash_attention_bwd_plain(q, k, v, out, dout, **kw)
    assert max(_ratios(got, [torch.from_numpy(np.asarray(w))
                             for w in want])) < BWD_TOL


@pytest.mark.parametrize("name", chip_smoke.FLASH_BWD_MUST_CATCH)
def test_flash_bwd_faults_fail_the_gate(name):
    """Each of ``chip_smoke.py``'s faults, on its control case cut to 64
    tokens and a window of 16, fails the f32 gates (the card's 1e-4 and
    this file's 1e-5)."""
    g = torch.Generator().manual_seed(0)
    q, k, v, out, dout, kw = chip_smoke.flash_bwd_inputs(
        torch, g, "cpu", chip_smoke.FLASH_BWD_CONTROL_CASE, torch.float32,
        S=64)
    kw["window"] = 16
    lse = tref.flash_lse_plain(q, k, **kw)
    want = tref.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    sound = chip_smoke.flash_bwd_ratios(
        tref.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw), want)
    assert max(sound) == 0.0
    controls = chip_smoke.flash_bwd_controls(torch, tref, q, k, v, out,
                                             dout, lse, kw, want)
    assert controls[name]["caught"]
    assert max(controls[name]["ratios"]) > BWD_TOL


# the bf16 gate of the rounded plain version against the JAX oracle's f32
# gradient of the same bf16 values (see the module docstring)
BWD_MMA_BF16_TOL = 1.5e-2
BWD_MMA_SHAPES = [
    ((2, 40, 4, 2, 32), dict(causal=True, window=8, softcap=50.0), 8.0),
    ((2, 40, 4, 1, 16), dict(causal=True, window=None, softcap=None), 1.0),
    ((1, 33, 2, 2, 64), dict(causal=False, window=None, softcap=None), 1.0),
    ((1, 130, 2, 1, 32), dict(causal=True, window=None, softcap=None), 1.0)]


@pytest.mark.parametrize("shape,kw,q_mul", BWD_MMA_SHAPES)
def test_flash_bwd_mma_plain_matches_jax_grad_in_bf16(shape, kw, q_mul):
    """The tensor-core backward's arithmetic in bf16 against ``jax.grad``
    of ``repro.kernels.ref.flash_attention_ref`` at the same bf16 values
    (taken in f32), with L from ``flash_lse_plain``; the wrapper's CPU
    path (``flash_attention_bwd`` with that L) is the same function."""
    B, S, H, KH, D = shape
    q, k, v, dout = _bwd_inputs(B, S, H, KH, D, torch.bfloat16, q_mul=q_mul)
    kw = dict(kw, scale=D ** -0.5)
    jq, jk, jv = _jax(*(t.float().numpy() for t in (q, k, v)))

    def f(q_, k_, v_):
        return jnp.vdot(jref.flash_attention_ref(q_, k_, v_, **kw),
                        jnp.asarray(dout.float().numpy()))
    want = [torch.from_numpy(np.array(w))
            for w in jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)]
    out = tref.flash_attention_plain(q, k, v, **kw)
    lse = tref.flash_lse_plain(q, k, **kw)
    got = tref.flash_attention_bwd_mma_plain(q, k, v, out, dout, lse, **kw)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3
    assert max(_ratios(got, want)) < BWD_MMA_BF16_TOL
    for a, b in zip(tfa.flash_attention_bwd(q, k, v, out, dout, lse, **kw),
                    got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,kw,q_mul", BWD_MMA_SHAPES + [
    ((1, 24, 2, 2, 16), dict(causal=True, window=30, softcap=None), 1.0)])
def test_flash_bwd_mma_plain_is_the_f32_backward_with_lse_given(shape, kw,
                                                                q_mul):
    """In f32 nothing rounds: the tensor-core arithmetic with L from
    ``flash_lse_plain`` is ``flash_attention_bwd_plain`` (1e-5 of each
    max|want|).  In bf16 its rounding of P and dS moves the gradients
    (but not past the card's gate)."""
    B, S, H, KH, D = shape
    kw = dict(kw, scale=D ** -0.5)
    q, k, v, dout = _bwd_inputs(B, S, H, KH, D, torch.float32, q_mul=q_mul)
    out = tref.flash_attention_plain(q, k, v, **kw)
    lse = tref.flash_lse_plain(q, k, **kw)
    want = tref.flash_attention_bwd_plain(q, k, v, out, dout, **kw)
    got = tref.flash_attention_bwd_mma_plain(q, k, v, out, dout, lse, **kw)
    assert max(_ratios(got, want)) < BWD_TOL
    qb, kb, vb, ob, gb = (t.bfloat16() for t in (q, k, v, out, dout))
    rounded = tref.flash_attention_bwd_mma_plain(qb, kb, vb, ob, gb, lse,
                                                 **kw)
    unrounded = tref.flash_attention_bwd_plain(qb, kb, vb, ob, gb, **kw)
    r = _ratios(rounded, unrounded)
    assert 0 < max(r) < chip_smoke.FLASH_BWD_TOL["bfloat16"]


def test_flash_lse_plain_gives_inf_to_a_row_with_no_key():
    """L is each row's log-sum-exp of its kept scores, and +inf where the
    mask keeps no key (causal with more queries than keys and a window),
    so that P = exp(S - L) = 0 there."""
    q, k, _, _ = _bwd_inputs(1, 12, 2, 1, 16, torch.float32)
    k = k[:, :5]
    kw = dict(causal=True, window=3, softcap=None, scale=0.25)
    lse = tref.flash_lse_plain(q, k, **kw)
    assert lse.shape == (1, 2, 12) and lse.dtype == torch.float32
    assert torch.isinf(lse[..., 7:]).all() and (lse[..., 7:] > 0).all()
    s = torch.einsum("bqhd,bkhd->bhqk", q[:, :7] * 0.25,
                     k.expand(1, 5, 2, 16))
    qi, ki = torch.arange(7)[:, None], torch.arange(5)[None, :]
    s = torch.where((ki <= qi) & (qi - ki < 3), s, -torch.inf)
    torch.testing.assert_close(lse[..., :7], torch.logsumexp(s, dim=-1))


@pytest.mark.parametrize("dtype,acc_dtype,D,want", [
    (torch.bfloat16, "f32", 16, tfa.BWD_MMA),
    (torch.bfloat16, "f32", 256, tfa.BWD_MMA),
    (torch.bfloat16, "f32", 48, tfa.BWD_MMA),
    (torch.bfloat16, "f32", 24, tfa.BWD),
    (torch.bfloat16, "f32", 264, tfa.BWD),
    (torch.bfloat16, "bf16", 64, tfa.BWD),
    (torch.float32, "f32", 64, tfa.BWD),
    (torch.float32, "bf16", 256, tfa.BWD)])
def test_flash_bwd_dispatch_follows_the_forward(dtype, acc_dtype, D, want):
    """The backward takes the tensor-core kernel exactly where the forward
    does, and on the CPU the plain version of the kernel it picks; both
    classes need the forward's L (``flash_attention_with_lse`` gives it,
    on the CPU ``flash_lse_plain``) and raise without it."""
    assert tfa.bwd_kernel_for(dtype, acc_dtype, D) == want
    assert (want == tfa.BWD_MMA) == (tfa.kernel_for(dtype, acc_dtype, D)
                                     == tfa.MMA)
    if D > 64:
        return
    q, k, v, dout = _bwd_inputs(1, 20, 2, 1, D, dtype)
    kw = dict(causal=True, window=None, softcap=None, scale=D ** -0.5)
    out, lse = tfa.flash_attention_with_lse(q, k, v, acc_dtype=acc_dtype,
                                            **kw)
    assert torch.equal(out, tfa.flash_attention(q, k, v, acc_dtype=acc_dtype,
                                                **kw))
    got = tfa.flash_attention_bwd(q, k, v, out, dout, lse,
                                  acc_dtype=acc_dtype, **kw)
    assert torch.equal(lse, tref.flash_lse_plain(q, k, **kw))
    if want == tfa.BWD:
        plain = tref.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    else:
        plain = tref.flash_attention_bwd_mma_plain(q, k, v, out, dout, lse,
                                                   **kw)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd(q, k, v, out, dout, acc_dtype=acc_dtype,
                                **kw)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,ns", [
    ((4, 512, 8, 4), 2),      # gemma2-2b's train shape: 128 blocks unsplit
    ((4, 512, 4, 1), 4),      # gemma3-1b: a single KV head, 32 unsplit
    ((2, 512, 48, 8), 2),     # internlm2-20b: 2 of its group of 6 -> 256
    ((1, 512, 16, 1), 8),     # 8 tiles x 8 parts < 132: the most, 8 of 16
    ((64, 4096, 8, 4), 1),    # enough blocks without a split
    ((1, 64, 6, 6), 1)])      # no group to split
def test_flash_bwd_split_rule(shape, ns):
    assert tfa.bwd_split(*shape) == ns


@pytest.mark.parametrize("S,Skv,H,KH,causal,window,softcap", [
    (70, 70, 4, 2, True, None, 50.0), (64, 64, 6, 2, True, 16, None),
    (40, 12, 2, 1, True, 4, None), (33, 50, 2, 2, False, 20, None)])
def test_flash_bwd_split_plain_matches_plain_and_jax_grad(S, Skv, H, KH,
                                                          causal, window,
                                                          softcap):
    """The CUDA-core backward's split, rehearsed: every segment's partial
    as a block forms it, added in block order, against
    ``flash_attention_bwd_plain`` with the same L (1e-5 of each max|want|:
    the same f32 function, other sums) and, where every row keeps a key,
    against ``jax.grad`` of ``repro.kernels.ref.flash_attention_ref``
    (1e-5; the oracle's softmax gives a row with no key uniform weights
    over the masked keys, the kernels P = 0); the rule's split over 3 and
    5 blocks, so that units are shared at these sizes; ragged, windowed,
    non-causal and with rows that keep no key."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(1, S, H, 16)) * 2).float()
    k, v = (torch.from_numpy(rng.normal(size=(1, Skv, KH, 16))).float()
            for _ in range(2))
    dout = torch.from_numpy(rng.normal(size=(1, S, H, 16))).float()
    kw = dict(causal=causal, window=window, softcap=softcap, scale=0.25)
    out = tref.flash_attention_plain(q, k, v, **kw)
    lse = tref.flash_lse_plain(q, k, **kw)
    uq, uk = tfa.bwd_units(1, S, Skv, H, KH, causal=causal, window=window)
    work = tfa.bwd_schedule(S, Skv, (uq, uk),
                            (tfa.bwd_table(uq, tfa.stream_k(uq, 3)),
                             tfa.bwd_table(uk, tfa.stream_k(uk, 5))))
    assert work.empty == tfa.bwd_work(1, S, Skv, H, KH, 16, causal=causal,
                                      window=window).empty
    assert len(work.dkdv.folds) and int(work.dkdv.folds[:, 4].max()) > 1
    got = tref.flash_attention_bwd_split_plain(q, k, v, out, dout, lse, work,
                                               **kw)
    want = tref.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    assert max(_ratios(got, want)) < BWD_TOL
    if not torch.isfinite(lse).all():
        return
    jq, jk, jv = _jax(q.numpy(), k.numpy(), v.numpy())

    def f(q_, k_, v_):
        return jnp.vdot(jref.flash_attention_ref(q_, k_, v_, **kw),
                        jnp.asarray(dout.numpy()))
    jwant = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    assert max(_ratios(got, [torch.from_numpy(np.asarray(w))
                             for w in jwant])) < BWD_TOL


@pytest.mark.parametrize("case", chip_smoke.FLASH_BWD_CASES + (
    chip_smoke.FLASH_BWD_CONTROL_CASE,), ids=lambda c: f"{c['arch']}-"
                         f"w{c['window']}-cap{c['softcap']}")
def test_flash_bwd_work_fills_the_card(case):
    """The CUDA-core backward's schedule at the card's f32 shapes (B 1, 512
    tokens): each kernel launches one block an SM (the dq kernel two at
    D 128), every block's cost (``BWD_STEP_COST`` a step,
    ``BWD_SEGMENT_COST`` a segment) within a step and two segments of the
    mean, every step of every unit (tile x head; every key tile of a
    query tile, every head x query tile of a key tile) in exactly one
    segment, in order, the block offsets in step order, a segment's dest
    -1 where it is the whole unit, else its partial numbered in step
    order, each shared unit's partials consecutive (at least two), and at
    most two partials a block; the longest query tile first."""
    S = chip_smoke.FLASH_BWD_S
    w = tfa.bwd_work(1, S, S, case["H"], case["KH"], case["D"], causal=True,
                     window=case["window"])
    assert w.blocks() == (tfa.SMS * (2 if case["D"] <= 128 else 1), tfa.SMS)
    G = case["H"] // case["KH"]
    for table, reps in ((w.dq, 1), (w.dkdv, G)):
        segs, off = table.segs.tolist(), table.offsets.tolist()
        nb = len(off) - 1
        assert off[0] == 0 and off[-1] == len(segs) and off == sorted(off)
        units = {}
        cost, shared = [0] * nb, [0] * nb
        for blk in range(nb):
            for tile, b, h, lo, per, u, ue, dest in segs[off[blk]:
                                                      off[blk + 1]]:
                units.setdefault((tile, b, h), []).append((u, ue, dest))
                cost[blk] += tfa.BWD_STEP_COST * (ue - u) + \
                    tfa.BWD_SEGMENT_COST
                shared[blk] += dest >= 0
        # every unit (tile x batch row x head with a step) once
        ranges = ([tfa.tile_range(i, w.T, w.T, S, S, True, case["window"])
                   for i in range(-(-S // w.T))] if reps == 1 else
                  [tfa._query_range(j, w.T, S, S, True, case["window"])
                   for j in range(-(-S // w.T))])
        assert set(units) == {(t, 0, h) for t, (lo, hi) in enumerate(ranges)
                              if hi > lo
                              for h in range(case["H"] // reps)}
        W = 0
        for (tile, b, h), ss in units.items():
            per = next(x[4] for x in segs if x[:3] == [tile, b, h])
            n = reps * per
            W += n
            assert [s for u, ue, _ in ss for s in range(u, ue)] == \
                list(range(n))
            assert (ss[0][2] == -1) == (len(ss) == 1)
        dests = [x[7] for x in segs if x[7] >= 0]
        assert dests == list(range(table.partials))
        for tile, b, h, p0, n in table.folds.tolist():
            assert n >= 2 and [x[7] for x in segs if x[:3] == [tile, b, h]] \
                == list(range(p0, p0 + n))
        mean = (tfa.BWD_STEP_COST * W + tfa.BWD_SEGMENT_COST * len(units)) / nb
        assert max(cost) <= mean + tfa.BWD_STEP_COST + \
            2 * tfa.BWD_SEGMENT_COST
        assert max(shared) <= 2
    nq = -(-S // w.T)
    assert [x[0] for x in w.dq.segs.tolist()][:case["H"]] == [nq - 1] * \
        case["H"]
    assert tfa.bwd_work(1, S, S, case["H"], case["KH"], case["D"],
                        causal=True, window=case["window"]) is w  # cached


def test_flash_forward_gives_lse_on_the_cuda_core_route():
    """``flash_attention_with_lse`` gives L for the CUDA-core forward's
    inputs too (f32, the bf16 accumulator, bf16 at D % 16 == 8): on the
    CPU ``flash_lse_plain``, beside the same O; ``FlashAttentionFn``
    saves it."""
    for dtype, acc_dtype, D in ((torch.float32, "f32", 32),
                                (torch.bfloat16, "bf16", 32),
                                (torch.bfloat16, "f32", 24)):
        assert tfa.kernel_for(dtype, acc_dtype, D) == tfa.SIMT
        q, k, v, _ = _bwd_inputs(1, 20, 4, 2, D, dtype)
        kw = dict(causal=True, window=6, softcap=30.0, scale=D ** -0.5)
        out, lse = tfa.flash_attention_with_lse(q, k, v, acc_dtype=acc_dtype,
                                                **kw)
        assert torch.equal(lse, tref.flash_lse_plain(q, k, **kw))
        assert torch.equal(out, tfa.flash_attention(q, k, v,
                                                    acc_dtype=acc_dtype, **kw))
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    node = tfa.flash_attention(*xs, acc_dtype="f32", **kw).grad_fn
    assert torch.equal(node.saved_tensors[4], lse)


@pytest.mark.parametrize("name", chip_smoke.FLASH_BWD_MMA_MUST_CATCH)
def test_flash_bwd_mma_faults_fail_the_bf16_gate(name):
    """Each of ``chip_smoke.py``'s tensor-core faults, on its control case
    cut to 128 tokens (two 64-row tiles), 4 heads over 2, D 32 and a window
    of 32, fails the card's bf16 gate; the sound version passes it."""
    g = torch.Generator().manual_seed(0)
    c = dict(chip_smoke.FLASH_BWD_MMA_CONTROL_CASE, B=1, H=4, KH=2, D=32,
             window=32)
    q, k, v, out, dout, kw = chip_smoke.flash_bwd_inputs(
        torch, g, "cpu", c, torch.bfloat16, S=128)
    lse, o_same = chip_smoke.flash_bwd_lse(torch, q, k, v, out, kw)
    assert o_same
    want = tref.flash_attention_bwd_mma_plain(q, k, v, out, dout, lse, **kw)
    controls = chip_smoke.flash_bwd_mma_controls(torch, tref, q, k, v, out,
                                                 dout, lse, kw, want)
    assert controls[name]["caught"]
    assert max(controls[name]["ratios"]) > chip_smoke.FLASH_BWD_TOL[
        "bfloat16"]


@pytest.mark.parametrize("name", chip_smoke.FLASH_LSE_MUST_CATCH)
def test_flash_lse_faults_fail_the_lse_gate(name):
    """Each of ``chip_smoke.py``'s faults of the forward's L, on its bf16
    control case cut to 128 tokens, 4 heads over 2 and D 32, fails the L
    gate (``FLASH_LSE_TOL`` against the f64 plain L); the forward's own L
    (on the CPU, ``flash_lse_plain`` of the bf16 inputs in f32) passes."""
    g = torch.Generator().manual_seed(0)
    c = dict(chip_smoke.FLASH_BWD_MMA_CONTROL_CASE, B=1, H=4, KH=2, D=32,
             window=32)
    q, k, v, out, dout, kw = chip_smoke.flash_bwd_inputs(
        torch, g, "cpu", c, torch.bfloat16, S=128)
    lse, _ = chip_smoke.flash_bwd_lse(torch, q, k, v, out, kw)
    want = chip_smoke.flash_lse_want(torch, tref, q, k, kw)
    assert chip_smoke.flash_lse_err(torch, lse, want) <= \
        chip_smoke.FLASH_LSE_TOL
    controls = chip_smoke.flash_lse_controls(torch, tref, q, k, lse, want,
                                             kw)
    assert controls[name]["caught"]
    assert controls[name]["err"] > chip_smoke.FLASH_LSE_TOL


def test_flash_lse_err_refuses_inf_rows_and_nan():
    """The L gate's error is inf where a row's +inf differs from the plain
    L's or L holds a NaN, and 0 where every row is +inf in both."""
    q = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 40, 2, 16))).float()
    k = q[:, :12, :1]
    kw = dict(causal=True, window=4, softcap=None, scale=0.25)
    want = chip_smoke.flash_lse_want(torch, tref, q, k, kw)
    got = tref.flash_lse_plain(q, k, **kw)
    assert torch.isinf(want).any()
    assert chip_smoke.flash_lse_err(torch, got, want) < 1e-5
    finite = torch.where(torch.isinf(got), 0.0, got)
    nan = got.clone()
    nan[0, 0, 0] = torch.nan
    for bad in (finite, nan):
        assert chip_smoke.flash_lse_err(torch, bad, want) == float("inf")
    inf = torch.full_like(got, torch.inf)
    assert chip_smoke.flash_lse_err(torch, inf, inf.double()) == 0.0


@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False),
                                   (False, True, True), (False, False, True)])
def test_flash_attention_fn_wiring(needs):
    """Through ``ops.flash_attention`` with grad on: a ``FlashAttentionFn``
    node whose gradients are the plain backward's at the saved tensors,
    None where an input needs none, from a strided cotangent."""
    q, k, v, _ = _bwd_inputs(2, 20, 4, 2, 16, torch.float32)
    xs = [t.clone().requires_grad_(n) for t, n in zip((q, k, v), needs)]
    kw = dict(causal=True, window=8, softcap=50.0)
    out = tops.flash_attention(*xs, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    # a cotangent laid out [B,H,S,D] and transposed: not contiguous
    dout = torch.randn(2, 4, 20, 16).transpose(1, 2)
    assert not dout.is_contiguous()
    out.backward(dout)
    want = tref.flash_attention_bwd_plain(q, k, v, out.detach(), dout,
                                          scale=0.25, **kw)
    for x, n, w in zip(xs, needs, want):
        if n:
            torch.testing.assert_close(x.grad, w, rtol=0, atol=0)
        else:
            assert x.grad is None


def test_flash_attention_fn_bf16_and_no_grad_paths():
    """bf16 gradients come back in bf16; with grad off, or with no input
    needing it, the forward runs alone (no autograd node)."""
    q, k, v, dout = _bwd_inputs(1, 16, 2, 1, 16, torch.bfloat16)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention(*xs)
    grads = torch.autograd.grad(out, xs, dout)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    # the tensor-core class: the plain version of that backward, at L
    lse = tref.flash_lse_plain(q, k, scale=0.25)
    for g, w in zip(grads, tref.flash_attention_bwd_mma_plain(
            q, k, v, out.detach(), dout, lse, scale=0.25)):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert tfa.flash_attention(*xs).grad_fn is None
    assert tfa.flash_attention(q, k, v).grad_fn is None
    assert tfa.flash_attention.bwd_launches == 0   # the CPU launches nothing
    assert tfa.flash_attention.bwd_mma_launches == 0


@pytest.mark.parametrize("name", ["paged_attention"])
def test_kernels_without_a_backward_refuse_grad(name):
    """``paged_attention`` raises, naming itself, on inputs that require
    grad (on the CPU as on the card: ``chip_smoke.guards_raise``), and runs
    under ``torch.no_grad()``."""
    assert chip_smoke.guards_raise(torch, "cpu")[name]
    with torch.no_grad():
        assert not chip_smoke.guards_raise(torch, "cpu")[name]


def test_build_waits_for_a_running_build_of_the_same_library(tmp_path,
                                                            monkeypatch):
    """``_build.build`` called while another thread compiles the same
    library waits for that compile instead of starting nvcc again (so
    ``chip_smoke.py``'s phases may load kernels while the card phase's
    builds run), and then loads the library as cached."""
    import threading
    import time

    from repro_torch.kernels import _build

    calls = []

    def compile_(name, source, text, out):
        calls.append(name)
        time.sleep(0.2)
        out.write_bytes(b"lib")
        _build.BUILD_LOG[name] = {"cached": False, "seconds": 0.2, "log": ""}
        return out
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    monkeypatch.setattr(_build, "_compile", compile_)
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        _build.build("wkv6"))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert calls == ["wkv6"] and len(set(got)) == 1 and got[0].exists()
    assert _build.BUILD_LOG["wkv6"]["cached"] is False   # the compile's log
    assert _build._RUNNING == {}
