"""Tests of the port that need the card: the CUDA kernel against its plain
version, the wrapper's refusals, and the engine on the card against the
engine on the CPU.  Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False.  This file imports no JAX, so it
runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.convert import params_to
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import PagedServingEngine

pytestmark = pytest.mark.cuda

# bf16 outputs may differ by one bf16 ulp (other summation order)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
F32_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, B, H, KH, D, bs, ctxs, qdtype, seed=0, hole=None):
    rng = np.random.default_rng(seed)
    NB = max(max(-(-c // bs) for c in ctxs), 1)
    P = sum(-(-c // bs) for c in ctxs) + 3
    perm = rng.permutation(P)
    bt = np.full((B, NB), -1, np.int32)
    used = 0
    for b, c in enumerate(ctxs):
        n = -(-c // bs)
        bt[b, :n] = perm[used:used + n]
        used += n
    if hole is not None:
        bt[hole] = -1
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, D), generator=g, device=dev).to(qdtype)
    kp = torch.randn((P, bs, KH, D), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((P, bs, KH, D), generator=g, device=dev).to(torch.bfloat16)
    return (q, kp, vp, torch.from_numpy(bt).to(dev),
            torch.tensor(ctxs, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("ns", [1, 3, 4])
@pytest.mark.parametrize("kw", [dict(), dict(window=64, softcap=50.0),
                                dict(window=8)])
@pytest.mark.parametrize("shape", [
    (8, 4, 256),      # gemma2-2b: 8 query heads over 4 KV heads, hd 256
    (4, 2, 16),       # the reduced test model
    (14, 2, 128),     # a GQA group of 7 (yi-34b's)
    (4, 4, 64),       # no grouping
])
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain(dev, qdtype, shape, kw, ns):
    H, KH, D = shape
    args = _case(dev, 5, H, KH, D, 16, (0, 1, 17, 300, 64), qdtype,
                 hole=(3, 2))
    before = paged_attention.launches
    out = paged_attention(*args, num_splits=ns, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = ref.paged_attention_plain(*args, num_splits=ns, **kw)
    tol = BF16_TOL if qdtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(out.float(), want.float(), **tol)
    assert torch.all(out[0] == 0)                 # the ctx == 0 row


def test_kernel_split_partials_identity(dev):
    """More splits than pages: empty splits merge to nothing."""
    args = _case(dev, 2, 8, 4, 256, 16, (5, 40), torch.float32)
    out = paged_attention(*args, num_splits=16)
    want = ref.paged_attention_plain(*args)
    torch.testing.assert_close(out, want, **F32_TOL)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, kp, vp, bt, ctx = _case(dev, 2, 8, 4, 256, 16, (5, 40), torch.float32)
    with pytest.raises(TypeError):
        paged_attention(q, kp.float(), vp.float(), bt, ctx)
    with pytest.raises(TypeError):
        paged_attention(q, kp, vp, bt.long(), ctx)
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp, bt.cpu(), ctx)
    with pytest.raises(ValueError):
        paged_attention(q[:, ::2], kp, vp, bt, ctx)
    with pytest.raises(ValueError):
        paged_attention(q[..., :90].contiguous(), kp[..., :90].contiguous(),
                        vp[..., :90].contiguous(), bt, ctx)    # 90 % 4 != 0
    with pytest.raises(ValueError):                          # group of 16
        paged_attention(torch.zeros(2, 16, 64, device=dev),
                        kp[:, :, :1, :64].contiguous(),
                        vp[:, :, :1, :64].contiguous(), bt, ctx)


def test_engine_on_card_matches_cpu(dev):
    """Reduced f32 gemma2: the card (kernel) and the CPU (plain version)
    serve identical greedy tokens, with the kernel launched in every layer
    of every decode dispatch."""
    cfg = reduced(ARCHS["gemma2-2b"], n_layers=2, vocab_size=128,
                  compute_dtype="float32")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 128, size=int(rng.integers(1, 31)))
               .astype(np.int32) for _ in range(12)]
    cpu_params = build_model(cfg, device="cpu").init(0)
    out = {}
    for d in ("cpu", "cuda"):
        m = build_model(cfg, device=d)
        params = params_to(cpu_params, d)
        eng = PagedServingEngine(m, params, max_batch=4, max_len=48,
                                 block_size=8, n_blocks=10, chunk_size=8)
        rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        before = paged_attention.launches
        eng.run_until_done()
        out[d] = [eng.done[r].tokens for r in rids]
        if d == "cuda":
            assert paged_attention.launches - before == (
                cfg.n_layers * eng.stats.decode_dispatches)
        assert eng.allocator.n_free == eng.n_blocks
    assert out["cuda"] == out["cpu"]
