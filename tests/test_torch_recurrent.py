"""The port's recurrences against the JAX package on the CPU, from the same
numpy inputs: the plain versions of the ``wkv6`` and ``ssm_scan`` kernels
against ``repro.kernels.ref`` and the Pallas kernels in interpret mode (the
sweeps of ``tests/test_kernels.py``), the launch-parameter resolution, and
the rwkv6 and mamba layers in train mode against ``use_pallas=False`` and
``use_pallas=True``.  Also ``chip_smoke.py``'s recurrence checks rehearsed
on the plain version: the ``WKV_MUST_CATCH`` and ``SSM_MUST_CATCH`` fault
controls, the long-memory (and for wkv6 fast-decay) cases against the JAX
reference, the bounds, and the CUDA wrappers' refusals.

Tolerances: f32 atol/rtol 1e-5 (the same f32 arithmetic in another
summation order); bf16 atol/rtol 1e-2 (outputs rounded to bf16 may differ
by one bf16 ulp where the f32 values straddle a rounding boundary).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core.autotune.space import divisor_clamp as jdivisor_clamp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import mamba as jmamba
from repro.models.layers import rwkv as jrwkv
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as tssm
from repro_torch.kernels import wkv6 as twkv
from repro_torch.models.layers import mamba as tmamba
from repro_torch.models.layers import rwkv as trwkv
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _pair(a, jdt, tdt):
    """One numpy array as a JAX array and a torch tensor of one dtype
    (bf16 rounded once, in numpy order, on both sides)."""
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j, np.float32)).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,n", [(2, 32), (4, 64)])
def test_wkv6_plain_matches_ref_and_pallas(dtype, h, n):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(11)
    B, S = 2, 24
    arrs = [rng.normal(size=(B, S, h, n)) * 0.3 for _ in range(3)]
    arrs.append(rng.uniform(0.7, 0.999, size=(B, S, h, n)))
    arrs.append(rng.normal(size=(h, n)) * 0.3)
    pairs = [_pair(a, jdt, tdt) for a in arrs]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    want_ref = jref.wkv6_ref(*js)
    want_pallas = jops.wkv6(*js, interpret=True)
    for got in (ref.wkv6_plain(*ts), ops.wkv6(*ts)):
        assert got.dtype == tdt and tuple(got.shape) == (B, S, h, n)
        _close(got, want_ref, tol)
        _close(got, want_pallas, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("di,n,block", [(256, 8, 128), (512, 16, 256)])
def test_ssm_scan_plain_matches_ref_and_pallas(dtype, di, n, block):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(12)
    Bt, S = 2, 32
    x, dt, Bm, Cm = (_pair(a, jdt, tdt) for a in (
        rng.normal(size=(Bt, S, di)) * 0.2,
        rng.uniform(0.001, 0.1, size=(Bt, S, di)),
        rng.normal(size=(Bt, S, n)) * 0.2,
        rng.normal(size=(Bt, S, n)) * 0.2))
    A = _pair(-np.abs(rng.normal(size=(di, n))), jnp.float32, torch.float32)
    js = (x[0], dt[0], Bm[0], Cm[0], A[0])
    ts = (x[1], dt[1], Bm[1], Cm[1], A[1])
    want_ref = jref.ssm_scan_ref(*js)
    want_pallas = jops.ssm_scan(*js, block_d=block, interpret=True)
    for got in (ref.ssm_scan_plain(*ts, block_d=block),
                ops.ssm_scan(*ts, block_d=block)):
        assert got.dtype == tdt and tuple(got.shape) == (Bt, S, di)
        _close(got, want_ref, tol)
        _close(got, want_pallas, tol)


@pytest.mark.parametrize("kernel,n,explicit,config", [
    ("ssm_scan", 1600, None, None),          # hymba: 256 -> 64
    ("ssm_scan", 512, 128, None),
    ("ssm_scan", 1600, None, {"block_d": 96}),
    ("ssm_scan", 64, 512, {"block_d": 32}),  # explicit wins, clamped to 64
    ("wkv6", 32, None, None),                # rwkv6: 1
    ("wkv6", 32, 3, None),
    ("wkv6", 4, None, {"block_h": 8}),
    ("wkv6", 32, None, {"block_h": 12}),
])
def test_launch_parameter_resolves_as_in_jax(monkeypatch, kernel, n,
                                             explicit, config):
    """explicit > config= > default, then clamped to a divisor of the axis:
    the block the port launches is the block the Pallas kernel runs."""
    seen = {}
    if kernel == "ssm_scan":
        monkeypatch.setattr(ops._ssm, "ssm_scan",
                            lambda *a, block_d: seen.setdefault("b", block_d))
        x = torch.zeros(1, 2, n)
        ops.ssm_scan(x, x, torch.zeros(1, 2, 4), torch.zeros(1, 2, 4),
                     torch.zeros(n, 4), block_d=explicit, config=config)
        shapes = {"batch": 1, "seq": 2, "d_inner": n, "state_dim": 4}
        key = "block_d"
    else:
        monkeypatch.setattr(ops._wkv, "wkv6",
                            lambda *a, block_h: seen.setdefault("b", block_h))
        r = torch.zeros(1, 2, n, 16)
        ops.wkv6(r, r, r, r, torch.zeros(n, 16), block_h=explicit,
                 config=config)
        shapes = {"batch": 1, "seq": 2, "heads": n, "head_dim": 16}
        key = "block_h"
    c = jops.resolve_kernel_config(kernel, shapes, jnp.float32, config=config,
                                   explicit={key: explicit})
    assert seen["b"] == jdivisor_clamp(c[key], n)


def test_wrappers_refuse_bad_shapes_on_cpu():
    r = torch.zeros(1, 3, 4, 16)
    with pytest.raises(ValueError):
        twkv.wkv6(r, r, r, r, torch.zeros(4, 8))
    with pytest.raises(ValueError):
        twkv.wkv6(r, r, r, r, torch.zeros(4, 16), block_h=3)
    x = torch.zeros(1, 3, 8)
    with pytest.raises(ValueError):
        tssm.ssm_scan(x, x, torch.zeros(1, 3, 4), torch.zeros(1, 3, 5),
                      torch.zeros(8, 4))
    with pytest.raises(ValueError):
        tssm.ssm_scan(x, x, torch.zeros(1, 3, 4), torch.zeros(1, 3, 4),
                      torch.zeros(8, 4), block_d=3)


# --- chip_smoke.py's recurrence checks, rehearsed on the CPU ----------------

@pytest.mark.parametrize("name", sorted(chip_smoke.WKV_MUST_CATCH))
def test_wkv_must_catch_controls_exceed_the_gate(name):
    """Each fault of ``WKV_MUST_CATCH`` on its case, at a small shape (three
    256-step carries, N 16): the phase's bf16 gate catches it by 10x, by
    the scale-relative tolerance or by the share of outputs not bit-equal
    (w_bf16 passes the tolerance), and the sound plain version passes the
    same gate."""
    g = torch.Generator().manual_seed(0)
    case = chip_smoke.WKV_MUST_CATCH[name]
    args = chip_smoke.wkv_inputs(torch, g, "cpu", 1, 1024, 2, 16,
                                 torch.bfloat16, case)
    want = ref.wkv6_plain(*args)
    chip_smoke._check_close(torch, ops.wkv6(*args), want)
    got = chip_smoke.wkv_fault(torch, ref, name, *args)
    assert got.shape == want.shape and got.dtype == want.dtype
    row = chip_smoke._kernel_controls(torch, want, {name: lambda: got})[name]
    assert row["caught"]
    assert max(row["tol_ratio"],
               row["mismatch"] / chip_smoke.REC_MISMATCH_BF16) > 10


@pytest.mark.parametrize("case", ["long", "fast"])
def test_wkv6_matches_ref_on_long_and_fast_decay(case):
    """The card's "long" (w = exp(-exp(x)), x in [-9, -5]: w in [0.99328,
    0.99988], a state carried over the whole sequence) and "fast" (x in
    [-1, 2.5]: w in [5.1e-6, 0.692]) cases through ``ops.wkv6`` against
    the JAX reference, in f32."""
    g = torch.Generator().manual_seed(14)
    ts = chip_smoke.wkv_inputs(torch, g, "cpu", 2, 300, 2, 16,
                               torch.float32, case)
    x_lo, x_hi = {"long": (-9, -5), "fast": (-1, 2.5)}[case]
    assert np.exp(-np.exp(x_hi)) <= ts[3].min()
    assert ts[3].max() <= np.exp(-np.exp(x_lo))
    want = jref.wkv6_ref(*(jnp.asarray(t.numpy()) for t in ts))
    got = ops.wkv6(*ts)
    assert got.dtype == torch.float32 and got.shape == ts[0].shape
    _close(got, want, F32_TOL)


def test_wkv_bound_counts_the_recurrence():
    """At the eval shape the recurrence's 5 N^2 + 5 N f32 operations a
    (row, step, head) at 67 TFLOP/s bound the kernel, above the bytes'
    0.120 ms (r, k, v, y bf16 and w f32 once)."""
    ms, by = chip_smoke.wkv_bound(4, 4096, 32, 64)
    assert by == "operations"
    assert ms == pytest.approx(4 * 4096 * 32 * (5 * 64 * 64 + 5 * 64)
                               / 67e12 * 1e3)
    assert 0.1627 < ms < 0.1628
    t_bytes, _ = chip_smoke._bound(4 * 4096 * 32 * 64 * 12 + 32 * 64 * 2, 0,
                                   1.0)
    assert t_bytes == pytest.approx(0.1202, abs=1e-4)


def _wkv_case(N=16, dtype=torch.bfloat16):
    r = torch.zeros(1, 4, 2, N, dtype=dtype)
    return r, r.clone(), r.clone(), torch.zeros(1, 4, 2, N), torch.zeros(2, N)


@pytest.mark.parametrize("fault,exc", [
    ("head_48", ValueError),         # N = 48 not built
    ("r_f16", TypeError),
    ("r_misaligned", ValueError),
    ("k_misaligned", ValueError),
    ("v_misaligned", ValueError),
    ("w_misaligned", ValueError),
])
def test_wkv6_cuda_wrapper_refuses_what_the_kernel_does_not_take(fault, exc):
    """The checks the wrapper makes before a launch (``_check_cuda``), on
    CPU tensors: the plain version takes all of these, the kernel none."""
    twkv._check_cuda(*_wkv_case())         # the sound case passes
    r, k, v, w, u = _wkv_case(N=48) if fault == "head_48" else _wkv_case()
    if fault == "r_f16":
        r, k, v = r.half(), k.half(), v.half()
    if fault.endswith("_misaligned"):
        name = fault.split("_")[0]
        r, k, v, w = (_misaligned(t) if n == name else t
                      for n, t in zip("rkvw", (r, k, v, w)))
    assert twkv.wkv6(r, k, v, w, u, block_h=2).shape == r.shape
    with pytest.raises(exc):
        twkv._check_cuda(r, k, v, w, u)


# --- chip_smoke.py's scan checks, rehearsed on the CPU -----------------------

@pytest.mark.parametrize("name", sorted(chip_smoke.SSM_MUST_CATCH))
def test_ssm_must_catch_controls_exceed_the_gate(name):
    """Each fault of ``SSM_MUST_CATCH`` on its case, at a small shape (three
    256-step carries): the phase's bf16 gate catches it, and the sound plain
    version passes the same gate."""
    g = torch.Generator().manual_seed(0)
    case = chip_smoke.SSM_MUST_CATCH[name]
    args = chip_smoke.ssm_inputs(torch, g, "cpu", 1, 1024, 64, 16,
                                 torch.bfloat16, case)
    want = ref.ssm_scan_plain(*args)
    chip_smoke._check_close(torch, ops.ssm_scan(*args), want)
    got = chip_smoke.ssm_fault(torch, ref, name, *args)
    assert got.shape == want.shape and got.dtype == want.dtype
    row = chip_smoke._kernel_controls(torch, want, {name: lambda: got})[name]
    assert row["caught"]
    # beyond the gate by 10x: dt_bf16 by its share of outputs not
    # bit-equal (the scale-relative tolerance passes it), the rest by it
    assert (row["mismatch"] > 10 * chip_smoke.REC_MISMATCH_BF16
            if name == "dt_bf16" else row["tol_ratio"] > 10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_plain_matches_ref_on_long_memory(dtype):
    """dt in [1e-4, 2e-3] and an A drawn for each channel (the card's
    "long" case): a state carries over the whole sequence."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(13)
    Bt, S, di, n = 1, 600, 64, 16
    x, dt, Bm, Cm = (_pair(a, jdt, tdt) for a in (
        rng.normal(size=(Bt, S, di)),
        rng.uniform(1e-4, 2e-3, size=(Bt, S, di)),
        rng.normal(size=(Bt, S, n)),
        rng.normal(size=(Bt, S, n))))
    A = _pair(-np.abs(rng.normal(size=(di, n))), jnp.float32, torch.float32)
    want = jref.ssm_scan_ref(x[0], dt[0], Bm[0], Cm[0], A[0])
    got = ops.ssm_scan(x[1], dt[1], Bm[1], Cm[1], A[1])
    assert got.dtype == tdt and tuple(got.shape) == (Bt, S, di)
    _close(got, want, tol)


def test_ssm_bound_counts_the_exponentials():
    """At the eval shape the N exponentials a (row, step, channel), one
    MUFU.EX2 each at 16 a cycle on 132 SMs, bound the scan, above the
    bytes' 0.065 ms."""
    ms, by = chip_smoke.ssm_bound(4, 4224, 1600, 16)
    assert by == "exponentials"
    assert ms == pytest.approx(4 * 4224 * 1600 * 16 / (132 * 16 * 1.98e9)
                               * 1e3)
    assert 0.103 < ms < 0.104
    t_bytes, _ = chip_smoke._bound(4 * 4224 * 1600 * 8 + 4 * 4224 * 64
                                   + 1600 * 64, 0, 1.0)
    assert t_bytes == pytest.approx(0.0649, abs=1e-4)


def _ssm_case(Di=64, N=16, dtype=torch.bfloat16):
    x = torch.zeros(1, 4, Di, dtype=dtype)
    B = torch.zeros(1, 4, N, dtype=dtype)
    return x, torch.zeros(1, 4, Di), B, B.clone(), torch.zeros(Di, N)


def _misaligned(t):
    """``t``'s values in a contiguous view 2 elements into a new buffer."""
    buf = torch.zeros(t.numel() + 2, dtype=t.dtype)[2:]
    return buf.view(t.shape)


@pytest.mark.parametrize("fault,exc", [
    ("d_inner_100", ValueError),     # not a multiple of 8 channels
    ("state_32", ValueError),        # N = 32 not built
    ("x_f16", TypeError),
    ("x_misaligned", ValueError),
    ("dt_misaligned", ValueError),
])
def test_ssm_cuda_wrapper_refuses_what_the_kernel_does_not_take(fault, exc):
    """The checks the wrapper makes before a launch (``_check_cuda``), on
    CPU tensors: the plain version takes all of these, the kernel none."""
    tssm._check_cuda(*_ssm_case())         # the sound case passes
    x, dt, B, C, A = {"d_inner_100": lambda: _ssm_case(Di=100),
                      "state_32": lambda: _ssm_case(N=32)}.get(
        fault, _ssm_case)()
    if fault == "x_f16":
        x, B, C = x.half(), B.half(), C.half()
    if fault == "x_misaligned":
        x = _misaligned(x)
    if fault == "dt_misaligned":
        dt = _misaligned(dt)
    tssm._check_args(x, dt, B, C, A, 4)
    assert tssm.ssm_scan(x, dt, B, C, A, block_d=4).shape == x.shape
    with pytest.raises(exc):
        tssm._check_cuda(x, dt, B, C, A)


# --- layers ----------------------------------------------------------------

def _perturbed(tree, seed):
    """A JAX layer tree as numpy, with its constant leaves (norm scales and
    biases, mixes, decay base, dt bias, skip) perturbed so each is
    exercised."""
    rng = np.random.default_rng(seed)
    noisy = {"scale", "bias", "mu", "mu_k", "mu_r", "w_base", "dt_bias",
             "d_skip"}

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if name in noisy:
            a = a + (rng.normal(size=a.shape) * 0.3).astype(np.float32)
        return a
    return walk(jax.device_get(tree))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree.copy())


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _cfgs(arch, use_pallas):
    jcfg = jreduced(JARCHS[arch], compute_dtype="float32",
                    use_pallas=use_pallas)
    return jcfg, reduced(ARCHS[arch], compute_dtype="float32")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_rwkv_time_mix_matches_jax(use_pallas):
    jcfg, cfg = _cfgs("rwkv6-1.6b", use_pallas)
    tree = _perturbed(jrwkv.init_rwkv_tmix(jax.random.PRNGKey(1), jcfg), 1)
    x = np.random.default_rng(2).normal(size=(2, 16, cfg.d_model))
    x = x.astype(np.float32)
    want, _ = jrwkv.rwkv_time_mix(_jax_tree(tree), jnp.asarray(x), jcfg,
                                  need_state=False)
    got, _ = trwkv.rwkv_time_mix(_torch_tree(tree), torch.from_numpy(x),
                                 cfg)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_rwkv_channel_mix_matches_jax(use_pallas):
    jcfg, cfg = _cfgs("rwkv6-1.6b", use_pallas)
    tree = _perturbed(jrwkv.init_rwkv_cmix(jax.random.PRNGKey(3), jcfg), 3)
    x = np.random.default_rng(4).normal(size=(2, 16, cfg.d_model))
    x = x.astype(np.float32)
    want, _ = jrwkv.rwkv_channel_mix(_jax_tree(tree), jnp.asarray(x), jcfg)
    got, _ = trwkv.rwkv_channel_mix(_torch_tree(tree), torch.from_numpy(x),
                                    cfg)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mamba_mixer_matches_jax(use_pallas):
    jcfg, cfg = _cfgs("hymba-1.5b", use_pallas)
    tree = _perturbed(jmamba.init_mamba(jax.random.PRNGKey(5), jcfg), 5)
    x = np.random.default_rng(6).normal(size=(2, 16, cfg.d_model))
    x = x.astype(np.float32)
    want, _ = jmamba.mamba_mixer(_jax_tree(tree), jnp.asarray(x), jcfg,
                                 need_state=False)
    got, _ = tmamba.mamba_mixer(_torch_tree(tree), torch.from_numpy(x), cfg)
    _close(got, want, F32_TOL)


def test_layers_pass_the_recurrence_to_the_injected_fn():
    """``wkv_fn``/``ssm_fn`` replace the kernel: each layer calls its fn
    once, with the kernel's arguments."""
    calls = []

    def spy(plain):
        def fn(*args):
            calls.append(tuple(a.dtype for a in args))
            return plain(*args)
        return fn
    cfg = reduced(ARCHS["rwkv6-1.6b"])           # bf16 compute
    tree = _perturbed(jrwkv.init_rwkv_tmix(jax.random.PRNGKey(1),
                                           jreduced(JARCHS["rwkv6-1.6b"])), 1)
    p = _torch_tree(tree)
    x = torch.randn(1, 5, cfg.d_model).bfloat16()
    trwkv.rwkv_time_mix(p, x, cfg, wkv_fn=spy(ref.wkv6_plain))
    assert calls == [(torch.bfloat16,) * 3 + (torch.float32, torch.bfloat16)]
    cfg = reduced(ARCHS["hymba-1.5b"])
    tree = _perturbed(jmamba.init_mamba(jax.random.PRNGKey(5),
                                        jreduced(JARCHS["hymba-1.5b"])), 5)
    x = torch.randn(1, 5, cfg.d_model).bfloat16()
    calls.clear()
    tmamba.mamba_mixer(_torch_tree(tree), x, cfg,
                       ssm_fn=spy(ref.ssm_scan_plain))
    assert calls == [(torch.bfloat16, torch.float32, torch.bfloat16,
                      torch.bfloat16, torch.float32)]


# --- carried state (prefill and decode) ---------------------------------------

def _state(rng, shapes):
    """Random carried state in f32, ``scale`` times a standard normal per
    leaf; the callers round the token shifts and conv rows to bf16, as
    the caches store them."""
    return {k: rng.normal(size=shape).astype(np.float32) * scale
            for k, (shape, scale) in shapes.items()}


@pytest.mark.parametrize("S", [1, 7])
def test_rwkv_time_mix_with_state_matches_jax(S):
    """A decode step (S=1) and a multi-token call from a carried state:
    the output and the new state (shift in bf16, WKV state in f32) equal
    the reference scan path's."""
    jcfg, cfg = _cfgs("rwkv6-1.6b", False)
    tree = _perturbed(jrwkv.init_rwkv_tmix(jax.random.PRNGKey(1), jcfg), 1)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    H, N = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    st = _state(rng, {"shift": ((2, cfg.d_model), 1.0),
                      "wkv": ((2, H, N, N), 0.3)})
    jst = {"shift": jnp.asarray(st["shift"], jnp.bfloat16),
           "wkv": jnp.asarray(st["wkv"])}
    want, wnew = jrwkv.rwkv_time_mix(_jax_tree(tree), jnp.asarray(x), jcfg,
                                     jst)
    got, new = trwkv.rwkv_time_mix(
        _torch_tree(tree), torch.from_numpy(x), cfg,
        {"shift": torch.from_numpy(st["shift"]).bfloat16(),
         "wkv": torch.from_numpy(st["wkv"])}, need_state=True)
    _close(got, want, F32_TOL)
    assert new["shift"].dtype == torch.bfloat16
    _close(new["shift"], wnew["shift"], F32_TOL)
    _close(new["wkv"], wnew["wkv"], F32_TOL)


def test_rwkv_channel_mix_with_state_matches_jax():
    jcfg, cfg = _cfgs("rwkv6-1.6b", False)
    tree = _perturbed(jrwkv.init_rwkv_cmix(jax.random.PRNGKey(3), jcfg), 3)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    shift = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
    want, wnew = jrwkv.rwkv_channel_mix(_jax_tree(tree), jnp.asarray(x), jcfg,
                                        jnp.asarray(shift, jnp.bfloat16))
    got, new = trwkv.rwkv_channel_mix(_torch_tree(tree), torch.from_numpy(x),
                                      cfg, torch.from_numpy(shift).bfloat16())
    _close(got, want, F32_TOL)
    assert new.dtype == torch.bfloat16
    _close(new, wnew, F32_TOL)


@pytest.mark.parametrize("S", [1, 2, 7])
def test_mamba_mixer_with_state_matches_jax(S):
    """From a carried conv buffer and SSM state, including a call shorter
    than the buffer (S=2 < W-1=3): the output, the new conv rows (bf16)
    and the new state (f32) equal the reference's."""
    jcfg, cfg = _cfgs("hymba-1.5b", False)
    tree = _perturbed(jmamba.init_mamba(jax.random.PRNGKey(5), jcfg), 5)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    W, N = cfg.ssm.conv_width, cfg.ssm.state_dim
    st = _state(rng, {"conv": ((2, W - 1, cfg.d_model), 1.0),
                      "h": ((2, cfg.d_model, N), 0.5)})
    jst = {"conv": jnp.asarray(st["conv"], jnp.bfloat16),
           "h": jnp.asarray(st["h"])}
    want, wnew = jmamba.mamba_mixer(_jax_tree(tree), jnp.asarray(x), jcfg,
                                    jst)
    got, new = tmamba.mamba_mixer(
        _torch_tree(tree), torch.from_numpy(x), cfg,
        {"conv": torch.from_numpy(st["conv"]).bfloat16(),
         "h": torch.from_numpy(st["h"])}, need_state=True)
    _close(got, want, F32_TOL)
    assert new["conv"].dtype == torch.bfloat16
    _close(new["conv"], wnew["conv"], F32_TOL)
    _close(new["h"], wnew["h"], F32_TOL)


def test_carried_scans_split_anywhere_equal_one_scan():
    """``wkv6_carry`` and ``ssm_scan_carry``: two calls carrying the state
    give one call's outputs and final state, and from zero they are the
    plain versions."""
    g = torch.Generator().manual_seed(11)
    B, S, H, N = 2, 9, 2, 8
    r, k, v = (torch.randn(B, S, H, N, generator=g) for _ in range(3))
    w = torch.rand(B, S, H, N, generator=g) * 0.5 + 0.45
    u = torch.randn(H, N, generator=g)
    s0 = torch.randn(B, H, N, N, generator=g)
    y, sT = ref.wkv6_carry(r, k, v, w, u, s0)
    y1, s1 = ref.wkv6_carry(r[:, :4], k[:, :4], v[:, :4], w[:, :4], u, s0)
    y2, s2 = ref.wkv6_carry(r[:, 4:], k[:, 4:], v[:, 4:], w[:, 4:], u, s1)
    _close(torch.cat([y1, y2], 1), y.numpy(), F32_TOL)
    _close(s2, sT.numpy(), F32_TOL)
    assert torch.equal(ref.wkv6_carry(r, k, v, w, u, 0 * s0)[0],
                       ref.wkv6_plain(r, k, v, w, u))
    Di = 16
    x = torch.randn(B, S, Di, generator=g)
    dt = torch.rand(B, S, Di, generator=g) * 0.1
    Bm, Cm = (torch.randn(B, S, N, generator=g) for _ in range(2))
    A = -torch.rand(Di, N, generator=g)
    h0 = torch.randn(B, Di, N, generator=g)
    y, hT = ref.ssm_scan_carry(x, dt, Bm, Cm, A, h0)
    y1, h1 = ref.ssm_scan_carry(x[:, :4], dt[:, :4], Bm[:, :4], Cm[:, :4], A,
                                h0)
    y2, h2 = ref.ssm_scan_carry(x[:, 4:], dt[:, 4:], Bm[:, 4:], Cm[:, 4:], A,
                                h1)
    _close(torch.cat([y1, y2], 1), y.numpy(), F32_TOL)
    _close(h2, hT.numpy(), F32_TOL)
    assert torch.equal(ref.ssm_scan_carry(x, dt, Bm, Cm, A, 0 * h0)[0],
                       ref.ssm_scan_plain(x, dt, Bm, Cm, A))
