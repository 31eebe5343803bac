"""Tests of the port that need the card: the CUDA kernels against their
plain versions, the wrappers' refusals, and the engines on the card
against the engines on the CPU.  Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False.  This file imports no JAX, so it
runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.core.microbench import harness, memory, mxu, tables
from repro_torch.kernels import ops, ref
from repro_torch.kernels.alu_chain import alu_chain
from repro_torch.kernels.alu_chain import tolerance as alu_tolerance
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mxu_probe import REL_TOL as MXU_REL_TOL
from repro_torch.kernels.mxu_probe import mxu_probe
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.pointer_chase import pointer_chase
from repro_torch.models.convert import params_to
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import PagedServingEngine, ServingEngine

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


def _fa_inputs(dev, B, Sq, Skv, H, KH, D, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, S, h, D), generator=g, device=dev).to(dtype)
            for S, h in ((Sq, H), (Skv, KH), (Skv, KH))]


@pytest.mark.parametrize("kw", [dict(), dict(window=64), dict(softcap=50.0),
                                dict(window=4096, softcap=50.0),
                                dict(causal=False),
                                dict(causal=False, window=20)])
@pytest.mark.parametrize("shape", [
    (1, 900, 900, 8, 4, 256),     # gemma2-2b prefill, ragged tail
    (2, 52, 52, 8, 4, 256),
    (1, 1, 1, 8, 4, 256),
    (3, 37, 53, 4, 2, 16),        # the reduced model's heads, Sq < Skv
    (2, 70, 70, 14, 2, 128),      # a GQA group of 7
    (1, 100, 100, 4, 4, 64),      # no grouping
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_matches_plain(dev, dtype, shape, kw):
    B, Sq, Skv, H, KH, D = shape
    q, k, v = _fa_inputs(dev, B, Sq, Skv, H, KH, D, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = ref.flash_attention_plain(q, k, v, **kw)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(out.float(), want.float(), **tol)


@pytest.mark.parametrize("block_k", [16, 52, 128, 256])
def test_flash_kernel_bf16_accumulator_matches_plain(dev, block_k):
    """acc_dtype="bf16": the kernel honours block_k as the tile after
    which m, l and acc round, so it follows the plain version's rounding."""
    q, k, v = _fa_inputs(dev, 1, 300, 300, 8, 4, 256, torch.bfloat16)
    for kw in (dict(), dict(window=100, softcap=50.0)):
        out = flash_attention(q, k, v, block_k=block_k, acc_dtype="bf16",
                              **kw)
        want = ref.flash_attention_plain(q, k, v, block_k=block_k,
                                         acc_dtype="bf16", **kw)
        torch.testing.assert_close(out.float(), want.float(), **BF16_TOL)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, k, v = _fa_inputs(dev, 1, 16, 16, 8, 4, 256, torch.bfloat16)
    with pytest.raises(TypeError):
        flash_attention(q, k.float(), v.float())
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v.cpu())
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError):                   # 27 % 8 != 0
        flash_attention(q[..., :27].contiguous(), k[..., :27].contiguous(),
                        v[..., :27].contiguous())
    q, k, v = _fa_inputs(dev, 1, 600, 600, 8, 4, 256, torch.bfloat16)
    with pytest.raises(ValueError):                   # 512-key bf16 tile
        flash_attention(q, k, v, block_k=512, acc_dtype="bf16")


def test_slot_engine_on_card_matches_cpu(dev):
    """Reduced f32 gemma2 through the slot engine: the card (flash kernel
    in every prefill layer) and the CPU (plain version) serve identical
    greedy tokens."""
    cfg = reduced(ARCHS["gemma2-2b"], n_layers=2, vocab_size=128,
                  compute_dtype="float32")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 128, size=int(rng.integers(1, 31)))
               .astype(np.int32) for _ in range(12)]
    cpu_params = build_model(cfg, device="cpu").init(0)
    out = {}
    for d in ("cpu", "cuda"):
        m = build_model(cfg, device=d)
        eng = ServingEngine(m, params_to(cpu_params, d), max_batch=4,
                            max_len=48)
        rids = [eng.submit(p, max_new_tokens=5) for p in prompts]
        before = flash_attention.launches
        eng.run_until_done()
        out[d] = [eng.done[r].tokens for r in rids]
        if d == "cuda":
            assert flash_attention.launches - before == (
                cfg.n_layers * eng.stats.prefills) > 0
    assert out["cuda"] == out["cpu"]


# --- the paper's probes ------------------------------------------------------

ALU_CASES = [(op, dt, dep)
             for dt in (torch.float32, torch.bfloat16, torch.int32)
             for op in ref.ALU_OPS if ref.alu_legal(op, dt)
             for dep in (True, False)]


def _alu_input(dev, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        x = rng.integers(-2 ** 31, 2 ** 31, size=(8, 128), dtype=np.int64)
        return torch.from_numpy(x.astype(np.int32)).to(dev)
    x = (rng.normal(size=(8, 128)) + 2.0).astype(np.float32)
    return torch.from_numpy(x).to(dtype).to(dev)


@pytest.mark.parametrize("length", [12, 1, 37])
@pytest.mark.parametrize("op,dtype,dependent", ALU_CASES)
def test_alu_chain_kernel_matches_plain(dev, op, dtype, dependent, length):
    x = _alu_input(dev, dtype)
    c = torch.tensor(1.0009765625).to(dtype)
    before = alu_chain.launches
    out = alu_chain(x, c, op=op, length=length, dependent=dependent)
    torch.cuda.synchronize()
    assert alu_chain.launches == before + 1
    want = ref.alu_chain_plain(x, c.to(dev), op=op, length=length,
                               dependent=dependent)
    torch.testing.assert_close(out.double(), want.double(), equal_nan=True,
                               **alu_tolerance(op, dtype, length))


def test_alu_chain_kernel_writes_its_clock(dev):
    x = _alu_input(dev, torch.float32)
    rows = []
    for k in (16, 256):
        t = torch.zeros(2, dtype=torch.int64, device=dev)
        alu_chain(x, 1.0, op="add", length=k, timing=t)
        rows.append(t.tolist())
    assert rows[1][0] > rows[0][0] > 0
    assert rows[1][0] - rows[0][0] >= 240       # >= 1 cycle per dependent op


def test_alu_chain_wrapper_refusals(dev):
    x = _alu_input(dev, torch.float32)
    with pytest.raises(ValueError):
        alu_chain(x, 1.0, op="xor")                   # int op on floats
    with pytest.raises(ValueError):
        alu_chain(torch.zeros((16, 128), device=dev), 1.0, op="add")
    with pytest.raises(ValueError):
        alu_chain(x, 1.0, op="nope")
    with pytest.raises(TypeError):
        alu_chain(x.double(), 1.0, op="add")


@pytest.mark.parametrize("n", [64, 4096, 1 << 20])
@pytest.mark.parametrize("space,cache_op", [("shared", "ca"),
                                            ("global", "ca"),
                                            ("global", "cg"),
                                            ("global", "cv")])
def test_pointer_chase_kernel_matches_plain(dev, n, space, cache_op):
    if space == "shared" and n == 1 << 20:
        pytest.skip("4 MiB does not fit a block's shared memory")
    nxt = torch.from_numpy(memory._random_cycle(n, seed=n)).to(dev)
    for start, hops in ((0, 257), (n // 3, 1000), (5, 0)):
        got = pointer_chase(nxt, start, hops=hops, space=space,
                            cache_op=cache_op)
        want = ref.pointer_chase_plain(nxt, start, hops)
        assert got.dtype == torch.int32 and int(got) == int(want)


def test_pointer_chase_kernel_any_table_and_refusals(dev):
    rng = np.random.default_rng(3)
    nxt = torch.from_numpy(rng.integers(0, 500, 500).astype(np.int32)).to(dev)
    for space in ("shared", "global"):
        got = pointer_chase(nxt, 7, hops=300, space=space)
        assert int(got) == int(ref.pointer_chase_plain(nxt, 7, 300))
    with pytest.raises(ValueError):
        pointer_chase(torch.zeros(60000, dtype=torch.int32, device=dev), 0,
                      space="shared")
    with pytest.raises(TypeError):
        pointer_chase(nxt.long(), 0)
    with pytest.raises(ValueError):
        pointer_chase(nxt, 500)


def _mxu_close(out, want):
    err = (out.float() - want.float()).abs().max().item()
    assert err <= MXU_REL_TOL * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,chain,block", [
    (128, 128, 128, 1, None), (128, 128, 128, 4, None),
    (256, 256, 128, 1, None), (256, 256, 256, 1, None),
    (512, 128, 512, 1, None), (256, 256, 256, 3, (256, 64)),
    (128, 128, 256, 2, (128, 32)), (64, 64, 192, 5, (64, 64))])
def test_mxu_probe_kernel_matches_plain(dev, dtype, m, k, n, chain, block):
    rng = np.random.default_rng(m + n + chain)
    a = torch.from_numpy(rng.normal(size=(m, k)) * 0.1).to(dtype).to(dev)
    b = torch.from_numpy(rng.normal(size=(k, n)) * 0.1).to(dtype).to(dev)
    before = mxu_probe.launches
    out = ops.mxu_probe(a, b, chain=chain, block=block)
    torch.cuda.synchronize()
    assert mxu_probe.launches == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (m, n)
    _mxu_close(out, ref.mxu_probe_plain(a, b, chain=chain))


def test_mxu_probe_kernel_refusals(dev):
    a = torch.randn(192, 192, device=dev)
    with pytest.raises(ValueError, match="must divide the problem"):
        ops.mxu_probe(a, a, chain=1, block=(128, 128))
    with pytest.raises(AssertionError, match="square A"):
        ops.mxu_probe(a[:, :64].contiguous(), a[:64].contiguous(), chain=2)
    with pytest.raises(ValueError, match="multiples of 16"):
        ops.mxu_probe(a[:40, :40].contiguous(), a[:40, :40].contiguous(),
                      chain=1)
    big = torch.randn(512, 512, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        ops.mxu_probe(big, big, chain=3, block=(512, 128))


def test_harness_on_card_reads_cycles(dev):
    r = harness.run_chain(harness.OPS["fma"], "fma", torch.float32,
                          lengths=(4, 16, 64), device=dev)
    assert r.cycles_per_op >= 1 and 0.5e9 < r.clock_hz < 3e9
    assert r.per_op_s == pytest.approx(r.cycles_per_op / r.clock_hz)
    c = memory.run_chase(16 * 1024, hop_counts=(64, 256), device=dev)
    assert c.cycles_per_hop >= 1 and c.clock_hz > 0
    m = mxu.run_mxu("bfloat16", (128, 128, 128), True, (1, 2), device=dev)
    assert m.cycles_per_op > 0 and m.tflops > 0
    with pytest.raises(AssertionError):
        mxu.run_mxu("bfloat16", (512, 512, 128), True, (1, 2), device=dev)


def test_quick_calibration_on_card(dev, tmp_path):
    table = tables.calibrate(quick=True, results_dir=tmp_path, device=dev)
    assert table["hardware"] == "gpu" and table["clock_mhz"] > 500
    assert all(np.isfinite(r["per_op_ns"]) for r in table["ops"].values())
