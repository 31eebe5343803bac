"""Tests of the port that need the card: the CUDA kernels against their
plain versions, the wrappers' refusals, the engines on the card against
the engines on the CPU, and the recurrent models' eval step on the card
against the CPU.  Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False.  This file imports no JAX, so it
runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import importlib.util
from pathlib import Path

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
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models.convert import params_to
from repro_torch.models.zoo import build_model
from repro_torch.train.step import make_eval_step
from repro_torch.serve.engine import PagedServingEngine, ServingEngine

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

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


# contexts at and beside the kernel's chunk boundaries (32, 64 and 128
# tokens) and the full 64-page table of 16-token pages
BOUNDARY_CTXS = (31, 32, 33, 63, 64, 65, 128, 1024)


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
@pytest.mark.parametrize("ctxs", [(0, 1, 17, 300, 64), BOUNDARY_CTXS])
def test_kernel_matches_plain(dev, ctxs, qdtype, shape, kw, ns):
    H, KH, D = shape
    args = _case(dev, len(ctxs), H, KH, D, 16, ctxs, qdtype, hole=(3, 2))
    before = paged_attention.launches
    out = paged_attention(*args, num_splits=ns, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = ref.paged_attention_plain(*args, num_splits=ns, **kw)
    tol = BF16_TOL if qdtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(out.float(), want.float(), **tol)
    for b, c in enumerate(ctxs):
        if c == 0:
            assert torch.all(out[b] == 0)


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("kw", [dict(), dict(window=40, softcap=50.0),
                                dict(window=8)])
def test_kernel_chunk_sizes_match_plain(dev, chunk, kw):
    """Every chunk the kernel takes, at the serving head shape, with
    windows that start mid-chunk."""
    args = _case(dev, 8, 8, 4, 256, 16, BOUNDARY_CTXS, torch.bfloat16,
                 hole=(3, 2))
    out = paged_attention(*args, chunk_tokens=chunk, **kw)
    want = ref.paged_attention_plain(*args, **kw)
    torch.testing.assert_close(out.float(), want.float(), **BF16_TOL)


def test_kernel_is_deterministic(dev):
    """Fixed summation order, no atomics: two calls are bit-equal."""
    args = _case(dev, 8, 8, 4, 256, 16, BOUNDARY_CTXS, torch.bfloat16,
                 hole=(3, 2))
    a = paged_attention(*args, softcap=50.0)
    b = paged_attention(*args, softcap=50.0)
    assert torch.equal(a, b)


def test_kernel_replays_from_a_cuda_graph(dev):
    """The launch reads no device value: captured once, the graph replays
    correctly after the contexts and the block tables change in place."""
    q, kp, vp, bt, ctx = _case(dev, 4, 8, 4, 256, 16, (5, 40, 300, 64),
                               torch.float32)
    kw = dict(window=64, softcap=50.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up: build and load
        paged_attention(q, kp, vp, bt, ctx, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention(q, kp, vp, bt, ctx, **kw)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, ref.paged_attention_plain(q, kp, vp, bt, ctx, **kw), **F32_TOL)
    # each row takes another row's pages, one of them with a hole
    bt.copy_(bt.flip(0))
    bt[1, 3] = -1
    ctx.copy_(torch.tensor([60, 299, 0, 5], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    want = ref.paged_attention_plain(q, kp, vp, bt, ctx, **kw)
    torch.testing.assert_close(out, want, **F32_TOL)
    assert torch.all(out[2] == 0)


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
                                dict(causal=False, window=20),
                                dict(window=20),          # < one KV tile
                                dict(softcap=2.0)])       # binds at N(0,1)
@pytest.mark.parametrize("shape", [
    (1, 900, 900, 8, 4, 256),     # gemma2-2b prefill, ragged tail
    (2, 52, 52, 8, 4, 256),
    (1, 1, 1, 8, 4, 256),
    (3, 37, 53, 4, 2, 16),        # the reduced model's heads, Sq < Skv
    (2, 70, 70, 14, 2, 128),      # a GQA group of 7
    (1, 100, 100, 4, 4, 64),      # no grouping
    (2, 65, 127, 8, 4, 256),      # neither length a multiple of 64
    (1, 127, 127, 7, 1, 128),     # yi-34b's group of 7, ragged
    (1, 40, 40, 4, 2, 24),        # D % 16 == 8: the CUDA-core kernel
    (1, 4096, 4096, 8, 4, 256),   # long: the f32 split's many items
    (1, 2048, 2048, 8, 4, 256),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_matches_plain(dev, dtype, shape, kw):
    """bf16 with D % 16 == 0 takes the tensor-core kernel; f32 and bf16
    with D % 16 == 8 the CUDA-core one, whose f32 accumulator splits long
    KV ranges into items merged by a second kernel (at 2048 and 4096
    keys: causal, windows of 20, 64 and 4096 keys, and non-causal)."""
    B, Sq, Skv, H, KH, D = shape
    q, k, v = _fa_inputs(dev, B, Sq, Skv, H, KH, D, dtype)
    before, before_mma = flash_attention.launches, flash_attention.mma_launches
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    mma = dtype == torch.bfloat16 and D % 16 == 0
    assert flash_attention.mma_launches == before_mma + int(mma)
    want = ref.flash_attention_plain(q, k, v, **kw)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(out.float(), want.float(), **tol)


@pytest.mark.parametrize("block_k", [16, 52, 128, 256])
def test_flash_kernel_bf16_accumulator_matches_plain(dev, block_k):
    """acc_dtype="bf16": the kernel honours block_k as the tile after
    which m, l and acc round, so it follows the plain version's rounding."""
    q, k, v = _fa_inputs(dev, 1, 300, 300, 8, 4, 256, torch.bfloat16)
    for kw in (dict(), dict(window=100, softcap=50.0)):
        before_mma = flash_attention.mma_launches
        out = flash_attention(q, k, v, block_k=block_k, acc_dtype="bf16",
                              **kw)
        assert flash_attention.mma_launches == before_mma
        want = ref.flash_attention_plain(q, k, v, block_k=block_k,
                                         acc_dtype="bf16", **kw)
        torch.testing.assert_close(out.float(), want.float(), **BF16_TOL)


def test_flash_kernel_replays_from_a_cuda_graph(dev):
    """The CUDA-core kernel's split (its items, workspace and merge) is a
    function of the shapes: captured once, the graph replays correctly
    after q, k and v change in place."""
    from repro_torch.kernels.flash_attention import work_split
    q, k, v = _fa_inputs(dev, 1, 900, 900, 8, 4, 256, torch.float32)
    assert work_split(1, 900, 900, 8, 4).smax > 1
    kw = dict(window=4096, softcap=50.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up: build and load
        flash_attention(q, k, v, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_attention(q, k, v, **kw)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, ref.flash_attention_plain(q, k, v, **kw), **F32_TOL)
    for t, new in zip((q, k, v), _fa_inputs(dev, 1, 900, 900, 8, 4, 256,
                                            torch.float32, seed=1)):
        t.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, ref.flash_attention_plain(q, k, v, **kw), **F32_TOL)


def test_flash_kernel_is_deterministic(dev):
    """Fixed summation order and item order, no atomics: two calls of the
    split f32 path and of the bf16 accumulator are bit-equal."""
    for dtype, kw in ((torch.float32, dict()),
                      (torch.bfloat16, dict(acc_dtype="bf16", block_k=52))):
        q, k, v = _fa_inputs(dev, 1, 900, 900, 8, 4, 256, dtype)
        assert torch.equal(flash_attention(q, k, v, **kw),
                           flash_attention(q, k, v, **kw))


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
    before = (flash_attention.launches, flash_attention.mma_launches)
    for dtype in (torch.bfloat16, torch.float32):     # head_dim 272 > 256
        q, k, v = _fa_inputs(dev, 1, 16, 16, 2, 1, 272, dtype)
        with pytest.raises(ValueError):
            flash_attention(q, k, v)
    q, k, v = _fa_inputs(dev, 65536, 1, 1, 1, 1, 16, torch.bfloat16)
    with pytest.raises(ValueError):                   # grid's B > 65535
        flash_attention(q, k, v)
    assert (flash_attention.launches, flash_attention.mma_launches) == before


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
        before_mma = flash_attention.mma_launches
        eng.run_until_done()
        out[d] = [eng.done[r].tokens for r in rids]
        if d == "cuda":
            assert flash_attention.launches - before == (
                cfg.n_layers * eng.stats.prefills) > 0
            assert flash_attention.mma_launches == before_mma  # f32
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


@pytest.mark.parametrize("length", [12, 1, 37, 4, 16, 64, 256])
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
    with pytest.raises(ValueError):
        alu_chain(x, 1.0, op="add", length=0)
    # a CUDA c must be x's dtype: converting it would be device work
    with pytest.raises(TypeError):
        alu_chain(x, torch.tensor(1.0, device=dev).double(), op="add")
    with pytest.raises(TypeError):
        alu_chain(x, torch.ones(2, device=dev), op="add")
    with pytest.raises(ValueError):
        alu_chain(x, 1.0, op="add",
                  timing=torch.zeros(2, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("form", ["number", "cuda_tensor", "cpu_tensor"])
@pytest.mark.parametrize("dependent", [True, False])
def test_alu_chain_call_is_one_launch(dev, form, dependent):
    """One call runs one device kernel and copies nothing, whatever form c
    takes, and counts one launch."""
    x = _alu_input(dev, torch.float32)
    c = {"number": 1.0009765625,
         "cuda_tensor": torch.tensor(1.0009765625, device=dev),
         "cpu_tensor": torch.tensor(1.0009765625)}[form]
    before = alu_chain.launches
    kernels, copies = chip_smoke.alu_device_work(
        torch, lambda: alu_chain(x, c, op="fma", length=256,
                                 dependent=dependent))
    assert alu_chain.launches == before + 2         # a warm-up, the traced
    assert len(kernels) == 1 and "alu_chain_kernel" in kernels[0], kernels
    assert copies == []


def test_alu_chain_host_side_cbuf_is_more_than_one_launch(dev):
    """The one_kernel gate's control, the wrapper's old staging of c, shows
    extra device work under the profiler in every form of c."""
    x = _alu_input(dev, torch.float32)
    for c in (1.0, torch.tensor(1.0, device=dev), torch.tensor(1.0)):
        kernels, copies = chip_smoke.alu_device_work(
            torch, lambda: chip_smoke.alu_host_side_cbuf(torch, x, c,
                                                         op="add", length=4))
        assert len(kernels) + len(copies) > 1, (kernels, copies)


@pytest.mark.parametrize("dependent", [True, False])
def test_alu_chain_timing_advances_with_length(dev, dependent):
    """The in-kernel cycles grow with the sweep's lengths, at least one
    cycle per op, in each mode, read as the harness reads them: after
    warm-up launches (a body's first launch also fetches its code)."""
    x = _alu_input(dev, torch.float32)
    cyc = []
    for k in (4, 16, 64, 256, 1000):
        t = torch.zeros(2, dtype=torch.int64, device=dev)
        for _ in range(3):
            alu_chain(x, 1.0, op="add", length=k, dependent=dependent,
                      timing=t)
        cyc.append(t[0].item())
        assert t[1].item() > 0
    assert all(b > a for a, b in zip(cyc, cyc[1:])), cyc
    assert cyc[3] - cyc[1] >= 240, cyc


@pytest.mark.parametrize("op", ["add", "mul", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_alu_chain_independent_tail_is_bit_equal(dev, op, dtype):
    """The independent chain's rotated accumulators, summed after the
    clock, give the plain chain's result bit for bit (up to a NaN's
    payload) at length 256, with terms that give +-0, inf and NaN."""
    x = _alu_input(dev, dtype).cpu()
    if dtype == torch.int32:
        x[0, :6] = torch.tensor([0, -1, 2 ** 31 - 1, -2 ** 31, -3, 1])
    else:
        x[0, :9] = torch.tensor([-0.0, 0.0, float("inf"), float("-inf"),
                                 float("nan"), -3.0009765625, -1e6, 1e38,
                                 -2.5]).to(dtype)
    x = x.to(dev)
    for c in ((1.0009765625, 0.5) if dtype != torch.int32 else (1, 3)):
        cv = torch.tensor(c).to(dtype)
        got = alu_chain(x, cv, op=op, length=256, dependent=False).cpu()
        want = ref.alu_chain_plain(x.cpu(), cv, op=op, length=256,
                                   dependent=False)
        if dtype == torch.int32:
            assert torch.equal(got, want)
            continue
        view = torch.int32 if dtype == torch.float32 else torch.int16
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got.view(view)[~nan], want.view(view)[~nan])


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
    (128, 128, 256, 2, (128, 32)), (64, 64, 192, 5, (64, 64)),
    (256, 256, 256, 8, (256, 64)), (256, 256, 256, 8, (256, 32)),
    (256, 256, 256, 1, (256, 128)), (128, 256, 384, 1, (64, 192)),
    (48, 48, 96, 3, (48, 48)), (512, 512, 512, 2, (512, 32)),
    (64, 48, 64, 1, (64, 64)), (128, 512, 128, 1, None),
    (384, 384, 128, 2, (384, 32)), (256, 512, 384, 1, (256, 192))])
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


@pytest.mark.parametrize("dtype,m,n,chain,bn", [
    (torch.float32, 256, 256, 3, 64),      # f32 K=256: A streams
    (torch.bfloat16, 256, 256, 8, 128),    # two row passes a step
    (torch.bfloat16, 512, 128, 4, 64),
    (torch.float32, 512, 64, 3, 32),
    (torch.bfloat16, 256, 256, 8, 64)])    # A resident, for contrast
def test_mxu_probe_kernel_chains_stream_or_keep_a(dev, dtype, m, n, chain,
                                                  bn):
    from repro_torch.kernels.mxu_probe import plan
    rng = np.random.default_rng(m + n + chain)
    a = torch.from_numpy(rng.normal(size=(m, m)) * 0.1).to(dtype).to(dev)
    b = torch.from_numpy(rng.normal(size=(m, n)) * 0.1).to(dtype).to(dev)
    staged = plan(dtype, m, m, bn, chain)["staged"]
    assert staged == (dtype == torch.bfloat16 and (m, bn) == (256, 64))
    out = ops.mxu_probe(a, b, chain=chain, block=(m, bn))
    torch.cuda.synchronize()
    _mxu_close(out, ref.mxu_probe_plain(a, b, chain=chain))


def test_mxu_smem_bytes_c_and_python_agree(dev):
    from repro_torch.kernels.mxu_probe import _launchers, smem_bytes
    c_smem = _launchers()[1]
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for K in (16, 48, 64, 128, 256, 512):
            for bm in (16, 64, 128, 256, 512):
                for bn in (16, 32, 48, 64, 96, 128, 192, 256):
                    for chain in (1, 2, 5):
                        if chain > 1 and bm != K:
                            continue
                        want = smem_bytes(dtype, K, bm, bn, chain)
                        got = c_smem(int(dtype == torch.bfloat16), K, bm, bn,
                                     chain)
                        assert got == want, (dtype, K, bm, bn, chain)
                        n += 1
    assert n > 500


@pytest.mark.parametrize("dtype,peak", [("bfloat16", 989.0),
                                        ("float32", 495.0)])
def test_independent_run_mxu_fills_the_card_below_the_dense_peak(
        dev, dtype, peak):
    from repro_torch.kernels.mxu_probe import blocks_per_sm
    r = mxu.run_mxu(dtype, (128, 128, 128), False, (1, 2, 4), device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = blocks_per_sm(getattr(torch, dtype), 128, 128, 128)
    assert per_sm >= 1 and r.block == (128, 128)
    assert r.reps == sms * per_sm
    assert 0 < r.tflops <= peak and r.per_op_s > mxu.PER_OP_FLOOR_S
    assert r.tflops == pytest.approx(r.flops / r.per_op_s / 1e12)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n,k,L", [(128, 128, 128, 8), (256, 256, 256, 8),
                                     (512, 512, 128, 8), (512, 512, 512, 4)])
def test_independent_widest_launch_matches_plain(dev, dtype, m, n, k, L):
    # run_mxu's independent launch at its longest L: L * reps products'
    # panels side by side, reps one full wave of blocks on this card
    block = ops.resolve_mxu_block(m, n)
    reps = mxu.card_reps(m, n, k, dtype, block, dev)
    gen = torch.Generator(device=dev).manual_seed(m + n + k)
    a = (torch.randn((m, k), device=dev, generator=gen) * 0.1).to(dtype)
    b = (torch.randn((k, L * reps * n), device=dev, generator=gen)
         * 0.1).to(dtype)
    out = ops.mxu_probe(a, b, chain=1, block=block)
    torch.cuda.synchronize()
    _mxu_close(out, ref.mxu_probe_plain(a, b))


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


# --- the recurrences: wkv6 and ssm_scan --------------------------------------

def _wkv_inputs(dev, B, S, H, N, dtype, seed=0, case="short"):
    """``chip_smoke.wkv_inputs`` of ``WKV_CASES[case]``, from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return chip_smoke.wkv_inputs(torch, g, dev, B, S, H, N, dtype, case)


# the kernel's chunk is 16 steps: S = 70, 77 and 53 end on a ragged chunk
# after three or more whole ones, 33 after two; B 1 and 4; N 16, 32 and
# 64; rwkv6-1.6b's 32 heads of 64 (two blocks a head); "long" and "fast"
# over 2,048 steps and more; block_h as the Pallas kernel's, which changes
# no value on the card
@pytest.mark.parametrize("shape,case,block_h", [
    ((2, 24, 2, 32), "short", 1), ((2, 24, 4, 64), "short", 2),
    ((1, 70, 4, 16), "short", 1), ((3, 33, 2, 64), "short", 2),
    ((4, 77, 32, 64), "short", 1), ((1, 53, 3, 32), "short", 3),
    ((4, 70, 2, 16), "short", 2), ((1, 16, 1, 64), "short", 1),
    ((1, 2049, 32, 64), "long", 1), ((2, 2048, 4, 16), "long", 4),
    ((1, 3000, 2, 32), "long", 1), ((1, 2049, 32, 64), "fast", 8),
    ((4, 2050, 2, 16), "fast", 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_matches_plain(dev, dtype, shape, case, block_h):
    args = _wkv_inputs(dev, *shape, dtype, case=case)
    before = wkv6.launches
    out = ops.wkv6(*args, block_h=block_h)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    want = ref.wkv6_plain(*args)
    assert out.dtype == dtype
    # f32 over thousands of steps ("long", "fast"): atol at the scale of y,
    # whose largest value reaches ~20 where a state carries that far; the
    # kernel rounds w S + k v once (an FMA), the plain version the product
    # and the sum.  The cases at the scale of 1 ("short") keep F32_TOL.
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    if dtype == torch.float32 and case != "short":
        scale = max(1.0, want.float().abs().max().item())
        tol = dict(tol, atol=tol["atol"] * scale)
    torch.testing.assert_close(out.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_is_deterministic(dev, dtype):
    """Partial sums in a fixed order, no atomics: two calls are bit-equal,
    whatever ``block_h`` the caller names."""
    args = _wkv_inputs(dev, 2, 100, 32, 64, dtype, case="long")
    a = wkv6(*args)
    for block_h in (1, 2, 32):
        assert torch.equal(wkv6(*args, block_h=block_h), a)


def test_wkv6_kernel_replays_from_a_cuda_graph(dev):
    """The launch reads no device value: captured once, the graph replays
    correctly after every input changes in place."""
    r, k, v, w, u = _wkv_inputs(dev, 2, 90, 4, 64, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up: build and load
        wkv6(r, k, v, w, u)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = wkv6(r, k, v, w, u)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(),
                               ref.wkv6_plain(r, k, v, w, u).float(),
                               **BF16_TOL)
    for t, new in zip((r, k, v, w, u), _wkv_inputs(dev, 2, 90, 4, 64,
                                                   torch.bfloat16, seed=1,
                                                   case="fast")):
        t.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(),
                               ref.wkv6_plain(r, k, v, w, u).float(),
                               **BF16_TOL)


def test_wkv6_wrapper_refuses_what_the_kernel_does_not_take(dev):
    r, k, v, w, u = _wkv_inputs(dev, 1, 4, 32, 64, torch.bfloat16)
    # the Pallas kernel's widest head tile runs: the grid ignores block_h
    torch.testing.assert_close(wkv6(r, k, v, w, u, block_h=32).float(),
                               ref.wkv6_plain(r, k, v, w, u).float(),
                               **BF16_TOL)
    with pytest.raises(TypeError):
        wkv6(r, k.float(), v, w, u)
    with pytest.raises(ValueError):
        wkv6(r, k, v, w, u.cpu())
    with pytest.raises(ValueError):
        wkv6(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u)
    with pytest.raises(ValueError):                    # r not 16-byte aligned
        wkv6(torch.empty(r.numel() + 1, dtype=r.dtype, device=dev)[1:]
             .view(r.shape), k, v, w, u)
    r, k, v, w, u = _wkv_inputs(dev, 1, 4, 2, 48, torch.float32)
    with pytest.raises(ValueError):                    # N = 48 not built
        wkv6(r, k, v, w, u)


# dt ranges: the reference tests' and a long memory, where a state carries
# over thousands of steps
SSM_DT = {"short": (0.001, 0.1), "long": (1e-4, 2e-3)}


def _ssm_inputs(dev, Bt, S, Di, N, dtype, seed=0, memory="short"):
    lo, hi = SSM_DT[memory]
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((Bt, S, Di), generator=g, device=dev).mul(0.2).to(dtype)
    dt = torch.rand((Bt, S, Di), generator=g, device=dev) * (hi - lo) + lo
    B, C = (torch.randn((Bt, S, N), generator=g, device=dev).mul(0.2)
            .to(dtype) for _ in range(2))
    A = -torch.randn((Di, N), generator=g, device=dev).abs()   # per channel
    return x, dt, B, C, A


# the kernel's chunk is 32 steps: S = 100 and 161 end on a ragged chunk
# after three or more whole ones; hymba's Di 1600 at its block_d 64, Bt 1
# and 4, N 4, 8 and 16, and the reduced model's (64, 4)
@pytest.mark.parametrize("shape,block_d,memory", [
    ((2, 32, 256, 8), 128, "short"), ((2, 32, 512, 16), 256, "short"),
    ((1, 100, 1600, 16), 64, "short"), ((2, 45, 64, 4), 64, "short"),
    ((1, 9, 96, 8), 32, "short"), ((4, 100, 1600, 16), 64, "short"),
    ((4, 161, 1600, 4), 64, "short"), ((1, 161, 1600, 8), 64, "short"),
    ((4, 100, 1600, 16), 64, "long"), ((1, 3000, 1600, 16), 64, "long"),
    ((2, 2049, 64, 4), 64, "long")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_kernel_matches_plain(dev, dtype, shape, block_d, memory):
    args = _ssm_inputs(dev, *shape, dtype, memory=memory)
    before = ssm_scan.launches
    out = ssm_scan(*args, block_d=block_d)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    want = ref.ssm_scan_plain(*args)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), want.float(),
                               **(F32_TOL if dtype == torch.float32
                                  else BF16_TOL))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_block_d_changes_no_value_on_the_card(dev, dtype):
    """block_d keeps the Pallas kernel's meaning but not its grid: every
    divisor of d_inner gives the same bits."""
    args = _ssm_inputs(dev, 2, 77, 320, 16, dtype)
    want = ssm_scan(*args, block_d=320)
    for block_d in (8, 40, 64, 160):
        assert torch.equal(ssm_scan(*args, block_d=block_d), want)


def test_ssm_scan_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, dt, B, C, A = _ssm_inputs(dev, 1, 4, 100, 16, torch.bfloat16)
    with pytest.raises(ValueError):                    # 100 channels, not 8k
        ssm_scan(x, dt, B, C, A, block_d=100)
    x, dt, B, C, A = _ssm_inputs(dev, 1, 4, 2048, 16, torch.bfloat16)
    with pytest.raises(ValueError):                    # x not 16-byte aligned
        ssm_scan(torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
                 .view(x.shape), dt, B, C, A)
    with pytest.raises(TypeError):
        ssm_scan(x, dt, B.float(), C, A)
    with pytest.raises(ValueError):
        ssm_scan(x, dt, B, C, A.cpu())
    x, dt, B, C, A = _ssm_inputs(dev, 1, 4, 64, 32, torch.float32)
    with pytest.raises(ValueError):                    # N = 32 not built
        ssm_scan(x, dt, B, C, A)


@pytest.mark.parametrize("arch,kernel", [("rwkv6-1.6b", wkv6),
                                         ("hymba-1.5b", ssm_scan)])
def test_eval_step_on_card_matches_cpu(dev, arch, kernel):
    """Reduced f32 models: the eval loss on the card (kernels) and on the
    CPU (plain versions) agree to 1e-5 relative, with the kernel launched
    once a layer."""
    cfg = reduced(ARCHS[arch], compute_dtype="float32")
    cpu_params = build_model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 41)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss = {}
    for d in ("cpu", "cuda"):
        m = build_model(cfg, device=d)
        before = kernel.launches
        loss[d] = float(make_eval_step(m)(params_to(cpu_params, d),
                                          batch)["loss"])
        if d == "cuda":
            assert kernel.launches - before == cfg.n_layers
    assert loss["cuda"] == pytest.approx(loss["cpu"], rel=1e-5)


def test_sim_scenarios_on_card_equal_cpu(dev):
    """Phase telemetry's part (a): the drift and overload scenarios with the
    fake model's tensors on the card return the CPU's dicts exactly, every
    step record built with sync debugging set to "error"."""
    want = chip_smoke.telemetry_scenarios("cpu")
    with chip_smoke.record_sync_gate(torch):
        got = chip_smoke.telemetry_scenarios(dev)
    assert chip_smoke.scenario_gate(got, want) == []
    assert got["drift"]["n_events"] == 1 and got["overload"]["slo_held"]
