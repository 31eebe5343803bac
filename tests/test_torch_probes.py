"""The port's probe wrappers against the JAX package, on the CPU.

On the CPU each wrapper runs its plain version (``repro_torch.kernels.ref``),
so these tests hold that version against the JAX Pallas kernels in interpret
mode (through ``repro.kernels.ops``, as ``tests/test_kernels.py`` runs them)
and against the jnp oracles of ``repro.kernels.ref``, on the same seeded
numpy inputs.  Tolerances:

* ALU chains: int32 exact; f32 rtol 1e-5 (libm and XLA's transcendental
  approximations differ in the last bits; 12 ops compound them); bf16
  rtol 1.6e-2, two bf16 ulps (XLA may keep f32 across a fused bf16 chain
  where torch rounds after every op).
* the ALU kernel's independent tail (``_tail_plain`` below, its
  rotated accumulators summed pairwise): bit-equal to the plain chain, and
  to JAX's chain for every op but the transcendentals (libm and XLA differ
  there in the last bits; their NaNs agree).
* pointer chase: the index must be equal.
* mxu probe: f32 atol 1e-6 · max|ref| (summation order only); bf16 one
  bf16 ulp of max|ref| per chain step (2^-8 · chain · max|ref|), the rounding
  after each step landing on the other side of a tie.

The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda.py``.  Here also: the tensor-core kernel's shared
memory budget (``mxu_probe.smem_bytes``, which the card test holds equal to
the C function's) and the panel the dependent harness picks from it; the
throughput harness's products a wave (``reps``); and ``chip_smoke.py``'s
``MXU_MUST_CATCH`` fault controls, rehearsed on the plain version at the
card's cases, each beyond the gate's ``REL_TOL``.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.microbench.memory import _random_cycle as jax_random_cycle
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.microbench_alu import _KERNEL_OPS
from repro_torch.core.microbench.memory import _random_cycle
from repro_torch.core.microbench import mxu as tmxu
from repro_torch.kernels import alu_chain as talu
from repro_torch.kernels import mxu_probe as tprobe
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

C = 1.0009765625
DTYPES = ("float32", "bfloat16", "int32")
ALU_CASES = [(op, dt, dep) for dt in DTYPES for op in tref.ALU_OPS
             if tref.alu_legal(op, getattr(torch, dt))
             for dep in (True, False)]


def _alu_input(dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-2 ** 31, 2 ** 31, size=(8, 128),
                            dtype=np.int64).astype(np.int32)
    return (rng.normal(size=(8, 128)) + 2.0).astype(np.float32)


def _alu_tol(dtype):
    return {"float32": dict(rtol=1e-5, atol=1e-6),
            "bfloat16": dict(rtol=1.6e-2, atol=1e-5),
            "int32": dict(rtol=0, atol=0)}[dtype]


def test_alu_grid_is_the_harness_grid():
    """46 legal (op, dtype) pairs x 2 modes = the 92 alu_chain cells."""
    assert len(ALU_CASES) == 92
    assert set(tref.ALU_OPS) >= set(_KERNEL_OPS)


@pytest.mark.parametrize("op,dtype,dependent", ALU_CASES)
def test_alu_chain_plain_matches_jax(op, dtype, dependent):
    xn = _alu_input(dtype)
    xj, cj = jnp.asarray(xn, dtype), jnp.asarray(C, dtype)
    want = np.asarray(jref.alu_chain_ref(xj, cj, op=op, length=12,
                                         dependent=dependent), np.float64)
    tdt = getattr(torch, dtype)
    got = tops.alu_chain(torch.from_numpy(xn).to(tdt),
                         torch.tensor(C).to(tdt), op=op, length=12,
                         dependent=dependent)
    assert got.dtype == tdt and tuple(got.shape) == (8, 128)
    np.testing.assert_allclose(got.double().numpy(), want, **_alu_tol(dtype))
    if op in _KERNEL_OPS and not (dtype == "int32" and op == "div"):
        # the Pallas kernel in interpret mode takes the same inputs
        kern = np.asarray(jops.alu_chain(xj, cj, op=op, length=12,
                                         dependent=dependent,
                                         interpret=True), np.float64)
        np.testing.assert_allclose(got.double().numpy(), kern,
                                   **_alu_tol(dtype))


@pytest.mark.parametrize("n,seed", [(16, 0), (64, 1), (1000, 7),
                                    (4096, 0), (1 << 16, 3)])
def test_random_cycle_byte_identical(n, seed):
    ours, theirs = _random_cycle(n, seed), jax_random_cycle(n, seed)
    assert ours.dtype == theirs.dtype and ours.tobytes() == theirs.tobytes()


@pytest.mark.parametrize("n", [64, 512, 4096])
def test_pointer_chase_plain_matches_jax(n):
    nxt = _random_cycle(n, seed=n)
    hops = min(n, 257)
    want = int(jops.pointer_chase(jnp.asarray(nxt), 0, hops=hops,
                                  interpret=True))
    assert want == int(jref.pointer_chase_ref(jnp.asarray(nxt),
                                              jnp.int32(0), hops))
    got = tops.pointer_chase(torch.from_numpy(nxt), 0, hops=hops)
    assert got.dtype == torch.int32 and int(got) == want


def test_pointer_chase_any_table_and_full_cycle():
    """Any int32 table, not only a cycle; a full cycle returns home."""
    rng = np.random.default_rng(5)
    nxt = rng.integers(0, 300, size=300).astype(np.int32)
    want = int(jref.pointer_chase_ref(jnp.asarray(nxt), jnp.int32(17), 100))
    assert int(tops.pointer_chase(torch.from_numpy(nxt), 17,
                                  hops=100)) == want
    cyc = torch.from_numpy(_random_cycle(128))
    assert int(tops.pointer_chase(cyc, 0, hops=128)) == 0


def _mxu_inputs(m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(m, k)) * 0.1).astype(np.float32),
            (rng.normal(size=(k, n)) * 0.1).astype(np.float32))


def _mxu_close(got, want, dtype, chain):
    scale = float(np.abs(want).max())
    atol = (2.0 ** -8 * chain if dtype == "bfloat16" else 1e-6) * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,chain", [(128, 128, 128, 1),
                                         (128, 128, 128, 4),
                                         (256, 256, 128, 1)])
def test_mxu_probe_plain_matches_jax(dtype, m, k, n, chain):
    an, bn = _mxu_inputs(m, k, n, dtype)
    aj, bj = jnp.asarray(an, dtype), jnp.asarray(bn, dtype)
    kern = np.asarray(jops.mxu_probe(aj, bj, chain=chain, interpret=True),
                      np.float32)
    oracle = np.asarray(jref.mxu_probe_ref(aj, bj, chain=chain), np.float32)
    tdt = getattr(torch, dtype)
    got = tops.mxu_probe(torch.from_numpy(an).to(tdt),
                         torch.from_numpy(bn).to(tdt), chain=chain)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    _mxu_close(got.float().numpy(), oracle, dtype, chain)
    _mxu_close(got.float().numpy(), kern, dtype, chain)


def test_mxu_probe_strict_block_and_clamped_config():
    """An explicit block= that does not divide the problem is refused
    with the reference's message; a config= block is clamped to a
    divisor, as ``repro.kernels.ops.mxu_probe`` does."""
    an, bn = _mxu_inputs(192, 192, 192, "float32")
    a, b = torch.from_numpy(an), torch.from_numpy(bn)
    with pytest.raises(ValueError, match="must divide the problem"):
        tops.mxu_probe(a, b, chain=1, block=(128, 128))
    with pytest.raises(ValueError, match="must divide the problem"):
        jops.mxu_probe(jnp.asarray(an), jnp.asarray(bn), chain=1,
                       block=(128, 128), interpret=True)
    cfg = {"block_m": 128, "block_n": 128}
    got = tops.mxu_probe(a, b, chain=1, config=cfg)
    want = np.asarray(jops.mxu_probe(jnp.asarray(an), jnp.asarray(bn),
                                     chain=1, config=cfg, interpret=True))
    _mxu_close(got.numpy(), want, "float32", 1)
    assert tops.resolve_mxu_block(192, 192, config=cfg) == (64, 64)
    assert tops.resolve_mxu_block(192, 192) == (64, 64)
    assert tops.resolve_mxu_block(256, 512) == (128, 128)
    assert tops.resolve_mxu_block(256, 512, block=(256, 64)) == (256, 64)
    with pytest.raises(AssertionError, match="square A"):
        tops.mxu_probe(a[:, :64].contiguous(), b[:64], chain=2)


# (dtype, K, bm, bn, chain) -> (bytes after the 2 KB head of mbarriers and
# alignment, staged, tma): the layout of ``csrc/mxu_probe.cu``.  Every tile
# is a row of 128-byte column panels (64 bf16, 32 f32; the last padded).
# Staged where it fits: B's panel [K, bn] (two at chain > 1) and A [bm, K].
# Else a ring of 3 slots, each a 128-byte k-slab of min(pm, bm) A rows and,
# at chain 1, of that slab's rows of min(pn, bn) B columns (8 warps of 32 x
# 64 outputs in bf16, 32 x 32 in f32: pm x pn = 128 x 2 warp tiles where bn
# holds two, 256 x 1 below).  The TMA unit loads them where K and
# bn fill whole panels (and a staged bm <= 256), cp.async otherwise.
SMEM_CASES = [
    # chain 1, staged: panel K x pan_b x 128 and A bm x pan_a x 128
    ("bfloat16", 128, 128, 128, 1, 128 * 2 * 128 + 128 * 2 * 128, True,
     True),
    ("bfloat16", 256, 128, 128, 1, 256 * 2 * 128 + 128 * 4 * 128, True,
     True),
    ("float32", 128, 128, 128, 1, 128 * 4 * 128 + 128 * 4 * 128, True, True),
    ("bfloat16", 128, 64, 32, 1, 128 * 1 * 128 + 64 * 2 * 128, True, False),
    ("bfloat16", 48, 64, 64, 1, 48 * 1 * 128 + 64 * 1 * 128, True, False),
    # chain 1 over the budget: the ring alone
    ("float32", 256, 128, 128, 1, 3 * (128 * 128 + 32 * 2 * 128), False,
     True),
    ("bfloat16", 512, 128, 128, 1, 3 * (128 * 128 + 64 * 2 * 128), False,
     True),
    # chain > 1, staged: two panels and A
    ("bfloat16", 128, 128, 128, 4, 2 * 128 * 2 * 128 + 128 * 2 * 128, True,
     True),
    ("bfloat16", 256, 256, 64, 8, 2 * 256 * 1 * 128 + 256 * 4 * 128, True,
     True),
    ("float32", 128, 128, 128, 4, 2 * 128 * 4 * 128 + 128 * 4 * 128, True,
     True),
    ("float32", 64, 64, 64, 5, 2 * 64 * 2 * 128 + 64 * 2 * 128, True, True),
    ("bfloat16", 48, 48, 48, 3, 2 * 48 * 1 * 128 + 48 * 1 * 128, True,
     False),
    # chain > 1 streaming A through the ring beside the two panels
    ("bfloat16", 256, 256, 128, 8, 2 * 256 * 2 * 128 + 3 * 128 * 128, False,
     True),
    ("float32", 256, 256, 64, 3, 2 * 256 * 2 * 128 + 3 * 128 * 128, False,
     True),
    ("bfloat16", 512, 512, 64, 3, 2 * 512 * 1 * 128 + 3 * 256 * 128, False,
     True),
    ("float32", 512, 512, 32, 3, 2 * 512 * 1 * 128 + 3 * 256 * 128, False,
     True),
    ("bfloat16", 512, 512, 48, 3, 2 * 512 * 1 * 128 + 3 * 128 * 128, False,
     False),
    # over a block's 227 KB: refused by the wrapper
    ("float32", 512, 512, 128, 3, 2 * 512 * 4 * 128 + 3 * 128 * 128, False,
     True),
]


@pytest.mark.parametrize("dtype,K,bm,bn,chain,nbytes,staged,tma",
                         SMEM_CASES)
def test_mxu_smem_bytes_is_the_documented_layout(dtype, K, bm, bn, chain,
                                                 nbytes, staged, tma):
    dt = getattr(torch, dtype)
    assert tprobe.smem_bytes(dt, K, bm, bn, chain) == 2048 + nbytes
    got = tprobe.plan(dt, K, bm, bn, chain)
    assert (got["staged"], got["tma"]) == (staged, tma)


@pytest.mark.parametrize("dtype,shape,chain,want", [
    ("bfloat16", (128, 128, 128), 8, (128, 128)),
    ("bfloat16", (256, 256, 256), 8, (256, 128)),   # A streams
    ("float32", (128, 128, 128), 8, (128, 128)),
    ("float32", (256, 256, 256), 8, (256, 64)),
    ("bfloat16", (512, 512, 512), 8, (512, 64)),
    ("float32", (512, 512, 512), 8, (512, 32)),
    ("float32", (64, 48, 64), 8, (64, 16)),         # only 16 divides 48
])
def test_dependent_block_is_the_widest_panel_that_fits(dtype, shape, chain,
                                                       want):
    m, n, k = shape
    dt = getattr(torch, dtype)
    got = tmxu.dependent_block(m, n, k, dt, chain)
    assert got == want
    assert tprobe.smem_bytes(dt, k, m, got[1], chain) <= tprobe.SMEM_MAX
    for wider in (128, 64, 32):
        if wider > got[1] and n % wider == 0:
            assert tprobe.smem_bytes(dt, k, m, wider, chain) \
                > tprobe.SMEM_MAX


@pytest.mark.parametrize("sms,blocks,tiles,reps", [
    (132, 1, 1, 132), (132, 2, 1, 264), (132, 1, 4, 33), (132, 2, 4, 66),
    (132, 1, 16, 9), (132, 2, 16, 17), (132, 3, 200, 2), (132, 1, 132, 1),
    (132, 1, 1000, 1)])
def test_throughput_reps_fill_one_wave(sms, blocks, tiles, reps):
    got = tprobe.throughput_reps(sms, blocks, tiles)
    assert got == reps
    # one wave: the products' tiles cover every resident block slot, and
    # one product fewer would not
    assert got * tiles >= sms * blocks
    assert got == 1 or (got - 1) * tiles < sms * blocks


@pytest.mark.parametrize("dependent", [True, False])
def test_run_mxu_on_cpu_keeps_one_product_a_unit(dependent):
    r = tmxu.run_mxu("float32", (64, 64, 64), dependent, (1, 2),
                     device="cpu")
    assert r.reps == (None if dependent else 1)
    assert r.block is None and r.per_op_s >= tmxu.PER_OP_FLOOR_S


# tolerance ratios (error over REL_TOL) of the controls at seed 0 on the
# CPU: stale_panel 6.1e12 (bf16) / 6.1e12 (f32), last_kslab_dropped 13.8 /
# 13.7, neighbour_rows 75.6 / 75.7
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(chip_smoke.MXU_MUST_CATCH))
def test_mxu_must_catch_controls_exceed_the_gate(name, dtype):
    m, k, n, chain = chip_smoke.MXU_MUST_CATCH[name]
    an, bn = chip_smoke.mxu_inputs(np, m, k, n, 0)
    dt = getattr(torch, dtype)
    a, b = torch.from_numpy(an).to(dt), torch.from_numpy(bn).to(dt)
    want = tref.mxu_probe_plain(a, b, chain=chain)
    # the sound kernel's path on the CPU passes the gate
    assert chip_smoke._rel_err(tops.mxu_probe(a, b, chain=chain,
                                              block=(m, 64) if chain > 1
                                              else None), want) \
        <= tprobe.REL_TOL
    got = chip_smoke.mxu_fault(torch, tref, name, a, b, chain)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert chip_smoke._rel_err(got, want) > 10 * tprobe.REL_TOL
    row = chip_smoke.mxu_controls(torch, np, tref, dt, torch.device("cpu"),
                                  0)[name]
    assert row["caught"] and row["tol_ratio"] > 10


ALU_PAIRS = sorted({(op, dt) for op, dt, _ in ALU_CASES})


def _alu_special(dtype, seed=0):
    """``_alu_input`` with terms that give +-0, inf and NaN in the tail: +-0,
    +-inf, NaN, x + i + c near 0, and values that keep every term of one
    sign."""
    x = _alu_input(dtype, seed)
    if dtype == "int32":
        x[0, :6] = [0, -1, 2 ** 31 - 1, -2 ** 31, -3, 1]
    else:
        x[0, :9] = [-0.0, 0.0, np.inf, -np.inf, np.nan, -3.0009765625,
                    -1e6, 1e38, -2.5]
    return x


def _same_bits(a, b):
    """Bit-equal up to a NaN's payload."""
    a, b = a.contiguous(), b.contiguous()
    assert a.dtype == b.dtype and a.shape == b.shape
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int32: torch.int32}[a.dtype]
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    zero = torch.zeros((), dtype=view)
    return torch.equal(na, nb) and torch.equal(
        torch.where(na, zero, a.view(view)), torch.where(nb, zero, b.view(view)))


def _tail_plain(x, c, *, op="fma", length=64, accumulators=8):
    """The kernel's independent chain in plain PyTorch: y0 = f(x + 0, c),
    each f(x + i, c) * 0 into accumulator i % ``accumulators`` (starting at
    -0, the identity), the accumulators summed pairwise, then y0 + that
    sum.  Equal to ``alu_chain_plain(..., dependent=False)`` bit for bit up
    to a NaN's payload (every term is +-0 or NaN)."""
    f = tref.ALU_OPS[op]
    c = torch.as_tensor(c, dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    acc = [torch.full_like(x, -0.0) if x.is_floating_point()
           else torch.zeros_like(x) for _ in range(accumulators)]
    for i in range(1, int(length)):
        acc[i % accumulators] = acc[i % accumulators] + f(x + i, c) * zero
    while len(acc) > 1:
        h = len(acc) // 2
        acc = [acc[j] + acc[j + h] for j in range(h)]
    return f(x + 0, c) + acc[0]


@pytest.mark.parametrize("op,dtype", ALU_PAIRS)
def test_alu_rotated_tail_is_the_plain_chain_bit_for_bit(op, dtype):
    """The kernel's independent chain (terms into 8 accumulators in turn,
    summed pairwise after the chain) is the reference's sequential
    ``out + y * 0`` at every length the kernel has a body for, and at 12."""
    tdt = getattr(torch, dtype)
    xn = _alu_special(dtype)
    x = torch.from_numpy(xn).to(tdt)
    xj = jnp.asarray(xn, dtype)
    for c in ((C, 0.5) if dtype != "int32" else (C, 3)):
        cv = torch.tensor(c).to(tdt)
        for length in (1, 4, 12, 256):
            got = _tail_plain(x, cv, op=op, length=length)
            want = tref.alu_chain_plain(x, cv, op=op, length=length,
                                        dependent=False)
            assert _same_bits(got, want), (c, length)
            jv = np.asarray(jref.alu_chain_ref(
                xj, jnp.asarray(c, dtype), op=op, length=length,
                dependent=False)).astype(np.float32 if dtype == "bfloat16"
                                         else xn.dtype)
            jt = torch.from_numpy(jv).to(tdt)
            if op in talu.MUFU_OPS:
                torch.testing.assert_close(got.double(), jt.double(),
                                           equal_nan=True, **_alu_tol(dtype))
            else:
                assert _same_bits(got, jt), (c, length)


@pytest.mark.parametrize("dtype", DTYPES)
def test_alu_scalar_bits_are_the_bits_torch_holds(dtype):
    """The wrapper passes c to the kernel as its bits in x's dtype: the
    bits ``torch.as_tensor(c, dtype)`` holds, for numbers of every kind."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    if dtype == "int32":
        values = [0, 1, -1, 2 ** 31 - 1, -2 ** 31, C, -2.7, 3.99, True] + [
            int(v) for v in rng.integers(-2 ** 31, 2 ** 31, 50)]
        for v in values:
            want = torch.as_tensor(v, dtype=tdt).item() & 0xFFFFFFFF
            assert talu.scalar_bits(v, tdt) == want, v
        with pytest.raises(OverflowError):
            talu.scalar_bits(2 ** 31, tdt)
        return
    view = torch.int32 if dtype == "float32" else torch.int16
    mask = 0xFFFFFFFF if dtype == "float32" else 0xFFFF
    values = [C, 0.0, -0.0, 1.0, -2.5, float("inf"), float("-inf"), 1e39,
              -1e39, 3.4028235e38, 3.4028236e38, 1e-45, -1e-46, 2 ** -149,
              1 + 2 ** -8, 1 + 3 * 2 ** -8, 1 + 2 ** -8 + 2 ** -30,
              1 - 2 ** -9, 65504.0, 7, -3] + list(rng.normal(size=200) *
                                                  10.0 ** rng.integers(
                                                      -40, 40, 200))
    for v in values:
        want = torch.as_tensor(v, dtype=tdt).view(view).item() & mask
        assert talu.scalar_bits(v, tdt) == want, v
    nan = talu.scalar_bits(float("nan"), tdt)
    assert nan == (torch.as_tensor(float("nan"), dtype=tdt).view(view)
                   .item() & mask)


def test_alu_kernel_instances_are_the_legal_pairs():
    """The kernel's instance lists (``FLOAT_OPS``, ``INT_OPS`` in
    ``csrc/alu_chain.cu``) and the wrapper's id table hold every pair the
    harness runs, and no other; the ids are the kernel's ``enum Op``."""
    import re
    src = (Path(tprobe.__file__).parent / "csrc" / "alu_chain.cu").read_text()
    lists = {m.group(1): re.findall(r"X\((\w+)\)", m.group(2)) for m in
             re.finditer(r"#define (\w+_OPS)\(X\)((?:[^\n]*\\\n)*[^\n]*)",
                         src)}
    enum = re.search(r"enum Op \{([^}]*)\}", src).group(1)
    assert [e.strip().lower() for e in enum.split(",")] == list(tref.ALU_OPS)
    for macro, dts in (("FLOAT_OPS", ("float32", "bfloat16")),
                       ("INT_OPS", ("int32",))):
        for dt in dts:
            legal = [op for op in tref.ALU_OPS
                     if tref.alu_legal(op, getattr(torch, dt))]
            assert [o.lower() for o in lists[macro]] == legal, (macro, dt)
    assert sorted((op, str(dt).split(".")[1]) for op, dt in talu._IDS) == \
        sorted((op, dt) for op, dt in ALU_PAIRS)


def _sass(fn, blocks):
    """cuobjdump-style SASS for one function: each block a list of
    opcodes, a label line before every block but the first."""
    lines = [f"        Function : {fn}", "        .headerflags  @\"EF_CUDA\""]
    addr = 0
    for b, ops in enumerate(blocks):
        if b:
            lines.append(f".L_x_{b}:")
        for o in ops:
            lines.append(f"        /*{addr:04x}*/                   {o} R0, R1 "
                         f"; /* 0x000fe40000000800 */")
            lines.append("                                              "
                         "/* 0x000fe40000000800 */")
            addr += 16
    return "\n".join(lines)


def test_alu_timed_body_counts_the_longest_block():
    """``alu_chain.timed_body`` reads each instance's 256-op body from the
    SASS: its longest basic block, over 256 (dependent) or 255 ops."""
    dep = "_ZN12_GLOBAL__N_116alu_chain_kernelIfLi0ELb1EEEvPKT_PKvjjjPS1_iPx"
    ind = ("_ZN12_GLOBAL__N_116alu_chain_kernelI13__nv_bfloat16Li3ELb0EEEv"
           "PKT_PKvjjjPS2_iPx")
    rem = "_ZN12_GLOBAL__N_116alu_chain_kernelIiLi12ELb1EEEvPKT_PKvjjjPS1_iPx"
    text = "\n".join([
        _sass(dep, [["S2R", "CS2R", "ISETP.NE.AND", "@P0 BRA"],
                    ["FADD", "LOP3.LUT"] * 256 + ["BRA"], ["EXIT"]]),
        _sass(ind, [["CS2R"], ["HADD2.BF16_V2", "HFMA2.BF16_V2", "HFMA2"]
                    * 255, ["EXIT"]]),
        _sass(rem, [["IMAD"] * 40 + ["BRA"], ["IADD3"] * 30])])
    body = talu.timed_body(text)
    assert set(body) == {("add", "float32", True), ("fma", "bfloat16", False),
                         ("rem", "int32", True)}
    d = body[("add", "float32", True)]
    assert d["instructions"] == 513 and d["per_op"] == 513 / 256
    assert d["top"]["FADD"] == 256 and d["top"]["LOP3.LUT"] == 256
    assert body[("fma", "bfloat16", False)]["per_op"] == 3.0
    assert body[("rem", "int32", True)]["per_op"] is None


@pytest.mark.parametrize("name", sorted(chip_smoke.ALU_FAULTS))
def test_alu_fault_controls_apply_to_the_kernel_source(name):
    """Each built control of ``chip_smoke.py``'s ``ALU_MUST_CATCH`` is the
    kernel's source with its substitutions (each found once) and its
    instance lists cut to the controls' ops, and differs from the kernel."""
    src = chip_smoke.alu_source(chip_smoke.ALU_FAULTS[name],
                                chip_smoke.ALU_CONTROL_OPS)
    kernel = chip_smoke.alu_source([], chip_smoke.ALU_CONTROL_OPS)
    assert src != kernel
    assert "#define FLOAT_OPS(X) X(ADD) X(MUL) X(FMA) X(MAX)\n" in src
    assert "#define INT_OPS(X) X(ADD) X(MUL) X(AND) X(MAX)\n" in src
    assert set(chip_smoke.ALU_MUST_CATCH[name]) <= {
        "one_kernel", "launch_cost", "folded", "serial"}
    for op, dt, _ in chip_smoke.ALU_FAULT_CELLS[name]:
        assert f"X({op.upper()})" in src.split(
            "#define INT_OPS" if dt == "int32" else "#define FLOAT_OPS")[1] \
            .splitlines()[0]
    assert set(chip_smoke.ALU_MUST_CATCH) == set(chip_smoke.ALU_FAULTS) | {
        "host_side_cbuf"}


def test_alu_gates_flag_folded_and_serial_readings():
    """The folded gate flags readings under one cycle per op in either
    mode; the serial gate an independent reading past ALU_SERIAL_FACTOR x
    its body's SASS instructions per op."""
    readings = {("max", "float32", True): 0.02, ("add", "float32", False):
                3.1, ("mul", "float32", False): 4.2, ("add", "int32", False):
                0.4}
    body = {k: {"per_op": 3.0} for k in readings}
    assert chip_smoke.alu_folded(readings) == ["add.int32.ind",
                                               "max.float32.dep"]
    assert chip_smoke.alu_serial(readings, body) == ["mul.float32"]


def test_dispatch_overhead_detail_names_the_launch_intercept():
    """The ``dispatch_overhead_us`` term says what it reads: the intercept
    of one call's time, which on the card is its one kernel launch."""
    from repro_torch.core.campaign import registry
    r = registry.run_roofline_cal_cell({"term": "dispatch_overhead_us"},
                                       quick=True, device="cpu")
    assert r["unit"] == "us" and r["value"] >= 0
    assert r["detail"] == registry.DISPATCH_DETAIL
    assert "launch intercept" in r["detail"] and "alu_chain" in r["detail"]
