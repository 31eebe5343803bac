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
                                                  smem_bytes)

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
    """The CUDA-core kernel (f32 inputs, or a bf16 accumulator), with an
    f32 accumulator: its own tiles (64 query rows over the group, 64-key
    KV tiles) whatever the hints; with a bf16 one: the KV tile is block_k
    clamped to Skv, and a tile past 227 KB of shared memory is refused
    here, before any launch.  The tensor-core kernel (bf16 inputs, f32
    accumulator): 64 query rows of one head and 64-key tiles whatever the
    hints or the group, its head dim padded to the next built DP, and
    shared memory for Q and a 2-slot K/V ring of 64 x (DP + 8) bf16."""
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
    assert kernel_tiles(8, 4, 24, 900, 128, "f32", bf16) == (2, 32, 64)
    assert kernel_tiles(8, 4, 256, 900, 128, "bf16", bf16) == (16, 32, 128)
    with pytest.raises(ValueError):
        kernel_tiles(8, 4, 272, 900, 128, "f32", bf16)  # head_dim > 256
    assert kernel_tiles(8, 4, 256, 900, 128, "f32", f32) == (16, 32, 64)
    assert kernel_tiles(4, 2, 16, 900, 7, "f32", f32) == (1, 32, 64)
    assert kernel_tiles(8, 1, 128, 52, 128, "bf16", f32) == (8, 8, 52)
    assert kernel_tiles(8, 4, 256, 900, 256, "bf16", f32) == (16, 32, 256)
    assert smem_bytes(256, 64) == 148992
    with pytest.raises(ValueError):
        kernel_tiles(8, 4, 256, 900, 512, "bf16", f32)  # 263,680 bytes
    with pytest.raises(ValueError):
        kernel_tiles(8, 4, 260, 900, 128, "f32", f32)   # head_dim > 256
    with pytest.raises(ValueError):
        kernel_tiles(8, 4, 20, 900, 128, "f32", f32)    # 20 % 8 != 0
    with pytest.raises(ValueError):
        kernel_tiles(128, 1, 64, 900, 128, "f32", f32)  # group of 128


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
