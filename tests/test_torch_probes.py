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
* pointer chase: the index must be equal.
* mxu probe: f32 atol 1e-6 · max|ref| (summation order only); bf16 one
  bf16 ulp of max|ref| per chain step (2^-8 · chain · max|ref|), the rounding
  after each step landing on the other side of a tie.

The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.microbench.memory import _random_cycle as jax_random_cycle
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.microbench_alu import _KERNEL_OPS
from repro_torch.core.microbench.memory import _random_cycle
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

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
