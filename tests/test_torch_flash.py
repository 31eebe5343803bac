"""The port's flash-attention wrapper against the JAX package, on the CPU.

On the CPU the wrapper runs its plain version (``flash_attention_plain``,
the blocked online softmax), so these tests hold it against JAX's
interpret-mode Pallas kernel and its oracle ``ref.flash_attention_ref``,
and the port's own oracle against JAX's.  Inputs are numpy arrays from a
seed, handed to both packages.  Tolerances are the JAX kernel tests' own
(``tests/test_kernels.py``): f32 atol 2e-4, bf16 atol 8e-2 for the
kernel-shape sweep; atol 2e-4 for the ragged tails.  The CUDA kernel
itself is tested on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (MMA, SIMT, flash_attention,
                                                  kernel_for, kernel_tiles,
                                                  smem_bytes, split_plain,
                                                  work_split)
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 8e-2)}


def _inputs(B, Sq, Skv, H, KH, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, h, D)).astype(np.float32)
            for S, h in ((Sq, H), (Skv, KH), (Skv, KH))]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 128, 4, 2, 32), (2, 256, 4, 4, 64)])
@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=64),
                                dict(causal=False),
                                dict(causal=True, softcap=30.0)])
def test_plain_matches_jax_kernel_and_oracle(dtype, shape, kw):
    """The cases of the JAX kernel sweep, blocks of 64."""
    jdt, tdt, atol = DTYPES[dtype]
    B, S, H, KH, D = shape
    q, k, v = _inputs(B, S, S, H, KH, D)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, block_q=64, block_k=64, **kw)
    assert got.dtype == tdt and got.shape == tq.shape
    want_k = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                  interpret=True, **kw)
    want_r = jref.flash_attention_ref(jq, jk, jv, **kw)
    np.testing.assert_allclose(_np(got), _np(want_k), atol=atol)
    np.testing.assert_allclose(_np(got), _np(want_r), atol=atol)
    np.testing.assert_allclose(_np(tref.flash_attention_ref(tq, tk, tv, **kw)),
                               _np(want_r), atol=atol)


@pytest.mark.parametrize("sq,skv,bq,bk", [
    (12, 13, 8, 8),        # kv tail: 13 % 8 != 0
    (100, 100, 64, 64),    # both tails ragged
    (5, 9, 128, 128),      # blocks larger than the problem
    (37, 53, 16, 32),      # coprime everything
])
@pytest.mark.parametrize("kw", [dict(causal=False), dict(causal=True),
                                dict(causal=True, window=7)])
def test_plain_ragged_tails(sq, skv, bq, bk, kw):
    """seq % block != 0 pads and masks, as the Pallas kernel does."""
    q, k, v = _inputs(2, sq, skv, 4, 2, 16, seed=1)
    got = tref.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), block_q=bq, block_k=bk,
        **kw)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    want_k = jops.flash_attention(*jargs, block_q=bq, block_k=bk,
                                  interpret=True, **kw)
    want_r = jref.flash_attention_ref(*jargs, **kw)
    np.testing.assert_allclose(_np(got), _np(want_k), atol=2e-4)
    np.testing.assert_allclose(_np(got), _np(want_r), atol=2e-4)


@pytest.mark.parametrize("bq,bk,kw", [
    (32, 16, dict(causal=True)),
    (16, 32, dict(causal=True, softcap=20.0)),
    (64, 64, dict(causal=True, window=24)),
])
def test_plain_bf16_accumulator_matches_jax_kernel(bq, bk, kw):
    """``acc_dtype="bf16"`` rounds m, l and acc after every KV tile where
    the Pallas kernel does.  The result moves away from the f32 one by
    bf16 rounding (> 1e-3) and stays within 1e-2 of the interpret-mode
    kernel with the same blocks (XLA may keep excess precision between
    the rounding points, so the two are not bit-equal)."""
    q, k, v = _inputs(2, 100, 100, 4, 2, 16, seed=2)
    targs = [torch.from_numpy(a) for a in (q, k, v)]
    got = tops.flash_attention(*targs, block_q=bq, block_k=bk,
                               acc_dtype="bf16", **kw)
    f32 = tops.flash_attention(*targs, block_q=bq, block_k=bk, **kw)
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                block_q=bq, block_k=bk, acc_dtype="bf16",
                                interpret=True, **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-2)
    assert np.abs(_np(got) - _np(f32)).max() > 1e-3


def test_ops_resolution_explicit_over_config_over_default():
    c = tops.resolve_kernel_config("flash_attention")
    assert c == {"block_q": 128, "block_k": 128, "acc_dtype": "f32"}
    c = tops.resolve_kernel_config(
        "flash_attention", config={"block_k": 32, "acc_dtype": "bf16"},
        explicit={"block_k": 16, "block_q": None})
    assert c == {"block_q": 128, "block_k": 16, "acc_dtype": "bf16"}
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 40, 40, 4, 2, 16))
    via_config = tops.flash_attention(q, k, v, config={"block_k": 8,
                                                       "acc_dtype": "bf16"})
    direct = tref.flash_attention_plain(q, k, v, block_k=8, acc_dtype="bf16")
    assert torch.equal(via_config, direct)


def test_wrapper_rejects_what_neither_version_takes():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, acc_dtype="f16")
    with pytest.raises(ValueError):                  # 4 heads over 3
        flash_attention(q, k[:, :, :1].expand(1, 8, 3, 16).contiguous(),
                        v[:, :, :1].expand(1, 8, 3, 16).contiguous())
    with pytest.raises(ValueError):                  # k and v differ
        flash_attention(q, k, v[:, :5])
    with pytest.raises(ValueError):                  # head dims differ
        flash_attention(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError):                  # batch differs
        flash_attention(q, torch.cat([k, k]), torch.cat([v, v]))
    with pytest.raises(ValueError):
        flash_attention(q[:, :, 0], k, v)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=0)


def test_kernel_tiles():
    """The CUDA-core kernel (f32 inputs, or a bf16 accumulator): 64 query
    rows over the group, O in 1 (D <= 128) or 2 16-byte column chunks a
    thread, 64-key KV tiles with an f32 accumulator whatever the hints;
    with a bf16 one the KV tile is block_k clamped to Skv, at most 256
    keys, refused here, before any launch, past that.  Its shared memory:
    Q (64 x (D + 4) f32), a 4-slot ring whose slots hold a K slab (64 x
    80) or a V slab (16 x (D + 16 / elem)) in the inputs' type, the P
    tile (ceil(lk / 64) x 64 keys x 68 f32) and 7 x 64 f32.  The
    tensor-core kernel (bf16 inputs, f32 accumulator): 64 query rows of
    one head and 64-key tiles whatever the hints or the group, its head
    dim padded to the next built DP, and shared memory for Q and a 2-slot
    K/V ring of 64 x (DP + 8) bf16."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert kernel_tiles(8, 4, 256, 900, 128, "f32", bf16) == (32, 64, 64)
    assert kernel_tiles(8, 4, 256, 52, 7, "f32", bf16) == (32, 64, 64)
    assert kernel_tiles(56, 8, 128, 900, 128, "f32", bf16) == (16, 64, 64)
    assert kernel_tiles(4, 2, 16, 37, 128, "f32", bf16) == (2, 64, 64)
    assert kernel_tiles(4, 2, 96, 37, 128, "f32", bf16) == (16, 64, 64)
    assert kernel_tiles(128, 1, 64, 900, 128, "f32", bf16) == (8, 64, 64)
    assert smem_bytes(256, 64, MMA) == 101376        # 3 x 64 x 264 x 2
    assert smem_bytes(128, 64, MMA) == 52224
    assert smem_bytes(96, 64, MMA) == smem_bytes(128, 64, MMA)
    assert smem_bytes(16, 64, MMA) == 9216
    # bf16 that the tensor-core kernel does not take: the CUDA-core tiles
    assert kernel_tiles(8, 4, 24, 900, 128, "f32", bf16) == (1, 32, 64)
    assert kernel_tiles(8, 4, 256, 900, 128, "bf16", bf16) == (2, 32, 128)
    with pytest.raises(ValueError):
        kernel_tiles(8, 4, 272, 900, 128, "f32", bf16)  # head_dim > 256
    assert kernel_tiles(8, 4, 256, 900, 128, "f32", f32) == (2, 32, 64)
    assert kernel_tiles(56, 8, 128, 900, 128, "f32", f32) == (1, 9, 64)
    assert kernel_tiles(4, 2, 16, 900, 7, "f32", f32) == (1, 32, 64)
    assert kernel_tiles(8, 1, 128, 52, 128, "bf16", f32) == (1, 8, 52)
    assert kernel_tiles(8, 4, 256, 900, 256, "bf16", f32) == (2, 32, 256)
    # 66,560 Q + 4 x 20,480 ring + 17,408 P + 1,792
    assert smem_bytes(256, 64) == 167680
    assert smem_bytes(256, 256) == 219904            # P of 256 keys
    assert smem_bytes(256, 256, elem=2) == 178944    # a bf16 ring
    assert smem_bytes(16, 64) == 5120 + 81920 + 17408 + 1792
    with pytest.raises(ValueError):
        kernel_tiles(8, 4, 256, 900, 512, "bf16", f32)  # a 512-key tile
    with pytest.raises(ValueError):
        kernel_tiles(8, 4, 260, 900, 128, "f32", f32)   # head_dim > 256
    with pytest.raises(ValueError):
        kernel_tiles(8, 4, 20, 900, 128, "f32", f32)    # 20 % 8 != 0
    with pytest.raises(ValueError):
        kernel_tiles(128, 1, 64, 900, 128, "f32", f32)  # group of 128


SPLIT_SHAPES = [
    # B, Sq, Skv, H, KH, causal, window, acc_dtype, block_k
    (1, 900, 900, 8, 4, True, None, "f32", 128),     # the f32 prefill
    (1, 900, 900, 8, 4, True, 64, "f32", 128),
    (1, 900, 900, 8, 4, False, None, "f32", 128),
    (8, 512, 512, 8, 4, True, 4096, "f32", 128),
    (1, 4096, 4096, 8, 4, True, None, "f32", 128),
    (2, 2048, 2048, 8, 4, True, 64, "f32", 128),
    (1, 2048, 2048, 8, 4, False, 300, "f32", 128),
    (1, 70, 127, 56, 8, True, None, "f32", 128),     # a GQA group of 7
    (3, 37, 53, 4, 2, True, 7, "f32", 128),          # Sq < Skv
    (1, 5, 1, 4, 2, True, None, "f32", 128),         # Skv = 1
    (1, 300, 300, 8, 4, True, 100, "bf16", 52),
    (1, 900, 900, 8, 4, False, 20, "bf16", 16),
    (1, 900, 900, 8, 4, True, None, "bf16", 256),
]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_work_split_covers_every_kept_pair_once(shape):
    """The kernel's work split, a function of the shapes: every (query
    row, key) pair the mask keeps lies in exactly one item of its query
    tile, no item walks more than T KV tiles, and the bf16 accumulator is
    never split (one item a query tile)."""
    B, Sq, Skv, H, KH, causal, window, acc, block_k = shape
    sp = work_split(B, Sq, Skv, H, KH, causal=causal, window=window,
                    acc_dtype=acc, block_k=block_k)
    assert (sp.bq, sp.lk) == kernel_tiles(H, KH, 128, Skv, block_k, acc,
                                          torch.float32)[1:]
    assert sp.nq == -(-Sq // sp.bq)
    most = 1
    for i in range(sp.nq):
        items = sp.items(i)
        most = max(most, len(items))
        assert all(je - jb <= sp.T for jb, je in items)
        if acc == "bf16":
            assert len(items) == 1
        cover = np.zeros(Skv, int)
        for jb, je in items:
            cover[jb * sp.lk:min(je * sp.lk, Skv)] += 1
        for qp in range(i * sp.bq, min((i + 1) * sp.bq, Sq)):
            keep = np.ones(Skv, bool)
            kp = np.arange(Skv)
            if causal:
                keep &= kp <= qp
            if window is not None:
                keep &= qp - kp < window
            assert np.all(cover[keep] == 1), (i, qp)
            assert np.all(cover <= 1)
    assert sp.smax == most
    if acc == "bf16":
        assert sp.smax == 1


def test_work_split_at_the_prefill():
    """The f32 prefill (B=1, Sq=Skv=900, H=8, KH=4): 29 query tiles of 32
    positions and 225 KV tiles of 64 keys a KV head, 900 in all; T = 900
    over 2 x 132 = 4, so the last query tile's 15 KV tiles make 4 items."""
    sp = work_split(1, 900, 900, 8, 4)
    assert (sp.bq, sp.lk, sp.nq, sp.T, sp.smax) == (32, 64, 29, 4, 4)
    assert sum(hi - lo for lo, hi in sp.ranges) == 225
    assert sp.items(28) == [(0, 3), (3, 7), (7, 11), (11, 15)]
    assert work_split(1, 900, 900, 8, 4, acc_dtype="bf16").smax == 1


@pytest.mark.parametrize("shape,kw", [
    ((1, 300, 300, 8, 4, 32), dict()),
    ((1, 300, 300, 8, 4, 32), dict(window=40)),
    ((1, 300, 300, 8, 4, 32), dict(softcap=5.0)),
    ((2, 200, 200, 4, 2, 16), dict(causal=False)),
    ((1, 150, 150, 14, 2, 16), dict()),               # a group of 7
    ((2, 70, 200, 4, 2, 16), dict()),                 # Sq < Skv
    ((2, 70, 200, 4, 2, 16), dict(causal=False, window=30)),
    ((1, 9, 1, 4, 2, 16), dict()),                    # Skv = 1
])
def test_split_rehearsal_matches_plain(shape, kw):
    """The kernel's split on the CPU: the plain version on each item's
    keys, merged by the merge kernel's formula (``split_plain``), equals
    ``flash_attention_plain`` within 1e-5 (f32; the two differ in
    summation order only)."""
    B, Sq, Skv, H, KH, D = shape
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, Sq, Skv, H, KH, D,
                                                      seed=3))
    sp = work_split(B, Sq, Skv, H, KH, causal=kw.get("causal", True),
                    window=kw.get("window"))
    assert sp.smax > 1 or Skv == 1          # the split is exercised
    got = split_plain(q, k, v, **kw)
    want = tref.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype,acc_dtype,D,kernel", [
    (torch.bfloat16, "f32", 256, MMA),      # gemma2-2b, gemma3-1b prefill
    (torch.bfloat16, "f32", 128, MMA),      # internlm2-20b, yi-34b
    (torch.bfloat16, "f32", 16, MMA),       # the reduced configs
    (torch.bfloat16, "f32", 96, MMA),       # padded to DP=128
    (torch.bfloat16, "f32", 24, SIMT),      # D % 16 == 8
    (torch.bfloat16, "f32", 272, SIMT),     # past 256: refused there
    (torch.bfloat16, "bf16", 256, SIMT),    # the bf16 accumulator
    (torch.float32, "f32", 256, SIMT),      # f32 stays full f32
    (torch.float32, "bf16", 64, SIMT),
])
def test_dispatch_rule_picks_the_kernel(dtype, acc_dtype, D, kernel):
    """The wrapper's dispatch is a function of (dtype, acc_dtype, D)
    alone: the tensor-core kernel for bf16 with an f32 accumulator and
    D % 16 == 0, D <= 256; the CUDA-core kernel for everything else."""
    assert kernel_for(dtype, acc_dtype, D) == kernel
